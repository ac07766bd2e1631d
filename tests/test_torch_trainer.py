"""The port's flagship trainer end to end on the CPU at 32px, and its device
rule: entry points run on CUDA unless asked for the CPU, and raise (never
fall back) when CUDA is absent."""
import os

import numpy as np
import pytest
import torch

from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.train import train_end2end

ARGV = ["--data.synthetic=true", "--data.image_size=32", "--data.n_train=4",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.netG=unet_32", "--model.ngf=8", "--model.ndf=8",
        "--model.base_features=8", "--engine.valid_step=2"]


def test_train_end_to_end_on_cpu(tmp_path):
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}"],
                       preset="end2end_jsrt")
    kernels.reset_launches()
    engine, results = train_end2end.train(cfg, train_iters=5, device="cpu")
    assert engine.step == 5
    assert [c["it"] for c in results["chunks"]] == [2, 4, 5]
    for c in results["chunks"]:
        for k in ("loss_netG", "loss_netD", "loss_unet", "val_score"):
            assert np.isfinite(c[k]), (k, c)
    assert 0.0 <= results["best_val"] <= 1.0
    assert 0.0 <= results["test_dice"] <= 1.0
    # CPU tensors take the plain versions: no kernel launched
    assert kernels.LAUNCHES == {"warp_affine": 0, "equalize_uint8": 0,
                                "histogram256": 0, "conv_down4": 0}
    best = torch.load(os.path.join(tmp_path, cfg.run.name, "unet_best.pt"))
    assert "outc.weight" in best


def test_arch_moves_by_weight_decay_only(tmp_path):
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}"],
                       preset="end2end_jsrt")
    engine, p2p, _ = train_end2end.build_engine(cfg, "cpu")
    before = {k: v.clone() for k, v in p2p.arch.items()}
    engine._arch_decay_step()
    for k, v in p2p.arch.items():
        # Adam on g = wd * a (a zero hypergradient): every entry steps
        # toward 0, by about lr
        delta = v - before[k]
        assert torch.equal(torch.sign(delta), -torch.sign(before[k]))
        assert delta.abs().max() <= cfg.optim.arch_lr * 1.01


def test_entry_point_without_device_raises_when_cuda_absent(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}"],
                       preset="end2end_jsrt")
    assert cfg.run.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_end2end.train(cfg, train_iters=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_end2end.main(ARGV + [f"--run.save_dir={tmp_path}"])


@pytest.mark.parametrize("mode", ["darts", "unroll"])
def test_hypergrad_modes_train_on_cpu(mode, tmp_path):
    # darts under the reference wiring (its hypergradient is structurally
    # zero: the arch moves by weight decay alone); unroll under end2end_nas,
    # whose hypergradient is live: the arch moves otherwise
    preset = "end2end_jsrt" if mode == "darts" else "end2end_nas"
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                               f"--engine.hypergrad={mode}"], preset=preset)
    engine, results = train_end2end.train(cfg, train_iters=2, device="cpu")
    assert engine.hypergrad == mode and engine.step == 2
    for c in results["chunks"]:
        for k in ("loss_netG", "loss_netD", "loss_unet", "outer_loss",
                  "arch_grad_norm", "replay_loss_unet", "val_score"):
            assert np.isfinite(c[k]), (k, c)
    _, fresh, _ = train_end2end.build_engine(cfg, "cpu")
    decayed, _, _ = train_end2end.build_engine(cfg, "cpu")
    for _ in range(2):
        decayed._arch_decay_step()
    for k, v in engine.arch.items():
        assert not torch.equal(v, fresh.arch[k])
    moved_otherwise = max((v - decayed.arch[k]).abs().max().item()
                          for k, v in engine.arch.items())
    if mode == "darts":
        assert results["chunks"][-1]["arch_grad_norm"] == 0.0
        assert moved_otherwise == 0.0
    else:
        assert results["chunks"][-1]["arch_grad_norm"] > 0.0
        assert moved_otherwise > 1e-8


def test_photometric_postprocess_is_refused(tmp_path):
    # the photometric post-process was refused until the ISIC slice ported
    # it: now it trains, and a post-process of another name is refused
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                               "--engine.fake_postprocess=photometric"])
    engine, results = train_end2end.train(cfg, train_iters=2, device="cpu")
    assert np.isfinite(results["chunks"][-1]["loss_unet"])
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                               "--engine.fake_postprocess=sepia"])
    with pytest.raises(ValueError, match="sepia"):
        train_end2end.build_engine(cfg, "cpu")


def test_hypergrad_none_leaves_arch(tmp_path):
    cfg = parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                               "--engine.hypergrad=none"])
    engine, results = train_end2end.train(cfg, train_iters=2, device="cpu")
    assert engine.hypergrad == "none" and np.isfinite(results["best_val"])
    _, fresh, _ = train_end2end.build_engine(cfg, "cpu")
    for k, v in engine.arch.items():
        assert torch.equal(v, fresh.arch[k])


@pytest.mark.parametrize("argv", [["--run.data_axis=data"],
                                  ["--model.init_type=xavier"],
                                  ["--preset=end2end_3d"]])
def test_unported_options_are_refused(argv):
    # an option the port does not implement yet fails loudly instead of
    # being ignored
    with pytest.raises(SystemExit, match="unknown"):
        parse_config(argv)
