"""Checkpoint and resume of the port's flagship trainer on the CPU (32^2,
f32), the counterpart of
``tests/test_resume.py::test_end2end_resume_reproduces_uninterrupted_run``:
three iterations cut short (no final checkpoint), then a resume to four,
equal the four run straight through — every parameter, BN buffer,
optimizer state, arch table and generator state, best_val, the best U-Net
and the plateau, exactly (the CPU is deterministic). With three training
images at batch 1 the cut falls where a plateau step is taken and a new
epoch of the index streams begins, whose order differs from the first. A resume asked for no more iterations than the checkpoint holds
runs none and leaves the state as saved. The engine's ``load_state_dict``
restores both generators (the hypergradients' draws come from the second)
and every optimizer in place."""
import io
import os

import torch

from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.train import train_end2end

ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=3",
        "--data.n_val=1", "--data.n_test=1", "--data.batch_size=1",
        "--model.compute_dtype=float32", "--model.netG=unet_32",
        "--model.ngf=8", "--model.ndf=8", "--model.base_features=8",
        "--engine.valid_step=1", "--run.save_every=1"]


def _cfg(tmp_path, name, *extra):
    return parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                                f"--run.name={name}", *extra],
                        preset="end2end_jsrt")


def _checkpoint(tmp_path, name, step):
    return torch.load(os.path.join(tmp_path, name, "ckpt", str(step),
                                   "state.pt"), weights_only=True)


def assert_same_tree(a, b, path="state"):
    """Equal structure; tensors bit for bit, other leaves ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b.to(a.device)), path
    else:
        assert a == b, path


def test_resume_reproduces_uninterrupted_run(tmp_path):
    engine_full, full = train_end2end.train(_cfg(tmp_path, "full"),
                                            train_iters=4, device="cpu")
    # cut short: no final checkpoint, the resume starts from the periodic one
    train_end2end.train(_cfg(tmp_path, "cut", "--run.final_checkpoint=false"),
                        train_iters=3, device="cpu")
    engine, resumed = train_end2end.train(
        _cfg(tmp_path, "cut", "--run.resume=true"), train_iters=4,
        device="cpu")
    assert engine.step == engine_full.step == 4
    assert resumed["best_val"] == full["best_val"]
    assert resumed["test_dice"] == full["test_dice"]
    assert [c["it"] for c in resumed["chunks"]] == [4]
    for k, val in full["chunks"][-1].items():
        if k != "seconds":
            assert resumed["chunks"][-1][k] == val, k
    assert_same_tree(engine_full.state_dict(), engine.state_dict())
    # the host trajectory too: best_val, best U-Net, plateau
    assert_same_tree(_checkpoint(tmp_path, "full", 4),
                     _checkpoint(tmp_path, "cut", 4))


def test_resume_at_the_saved_step_runs_nothing(tmp_path):
    train_end2end.train(_cfg(tmp_path, "run"), train_iters=1, device="cpu")
    saved = _checkpoint(tmp_path, "run", 1)
    engine, results = train_end2end.train(
        _cfg(tmp_path, "run", "--run.resume=true"), train_iters=1,
        device="cpu")
    assert results["chunks"] == [] and engine.step == 1
    assert_same_tree(saved["engine"], engine.state_dict())
    # the final checkpoint rewrites step 1 with what it restored
    assert_same_tree(saved, _checkpoint(tmp_path, "run", 1))
    assert results["best_val"] == saved["host"]["best_val"]


def test_engine_state_round_trip():
    cfg = _cfg("unused", "x", "--engine.hypergrad=unroll")
    engine, _, _ = train_end2end.build_engine(cfg, "cpu")
    buf = io.BytesIO()                     # a copy, as a checkpoint holds
    torch.save(engine.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    params = [p for pr in engine.problems for p in pr.params]
    with torch.no_grad():                  # move everything the state holds
        for p in params + list(engine.arch.values()):
            p.add_(1.0)
    for gen in (engine.generator, engine.hyper_generator):
        torch.rand(8, generator=gen)
    for pr in engine.problems:
        pr.optimizer.state[pr.params[0]] = {"step": torch.tensor(9.0)}
    engine.step = 9
    engine.load_state_dict(saved)
    assert_same_tree(saved, engine.state_dict())
    # in place: the optimizers still step the modules' own parameters
    for pr in engine.problems:
        assert all(a is b for a, b in zip(pr.optimizer.param_groups[0][
            "params"], pr.module.parameters()))

