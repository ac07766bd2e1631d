"""The long-horizon experiments of the port on the CPU at smoke width (32^2,
ngf = ndf = U-Net base 8, float32, a few iterations): ``train_end2end``'s
``init_state`` hook (the JAX ``train(cfg, train_iters, init_state)``,
``semantic_segmentation_tpu/train/train_end2end.py:267``), the scripts that
use it or drive the trainer (``scripts/validate_torch_learning.py``,
``nas_torch_flagship.py``, ``nas_torch_win.py``,
``drift_torch_chaos_control.py``), whose records keep the JAX scripts'
fields, and the port's launchers beside the JAX package's."""
import pathlib
import re
import shlex

import pytest
import torch

from semantic_segmentation_torch.core.config import PRESETS, parse_config
from semantic_segmentation_torch.train import train_end2end
from tests.test_torch_resume import assert_same_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--data.image_size=32", "--model.netG=unet_32", "--model.ngf=8",
         "--model.ndf=8", "--model.base_features=8",
         "--model.compute_dtype=float32"]
ARGV = ["--data.synthetic=true", "--data.n_train=3", "--data.n_val=2",
        "--data.n_test=2", "--engine.valid_step=1", "--run.device=cpu",
        *SMALL]

# The fields of the JAX scripts' records, each of which the port's record
# keeps: scripts/validate_learning_tpu.py:36-39 (``train``'s results),
# nas_flagship_tpu.py:107-125, nas_win_tpu.py:116-132,
# drift_chaos_control.py:153-162.
JAX_FIELDS = {
    "validate": ("best_val", "test_dice", "iters"),
    "nas_flagship": ("summary", "iters", "genotype_upconv",
                     "arch_abs_max_final", "arch_abs_max_frozen_control",
                     "arch_abs_max_trajectory", "arch_grad_norm_mean",
                     "arch_grad_norm_max", "softmax_rows", "best_val_nas",
                     "test_dice_nas", "best_val_frozen", "test_dice_frozen",
                     "wall_s"),
    "nas_win": ("mode", "kernel", "seed", "iters", "bias", "arch_lr", "size",
                "n_train", "test_dice", "best_val", "genotype_final",
                "arch_col_means_final", "bias_col_lead_final", "wall_sec"),
    "chaos": ("n_steps", "final_dice_base", "final_dice_ulp",
              "torch_vs_torch_ulp_dice_gap_pt", "windowed_unet_loss_rel_max",
              "perturbation"),
}


def _cfg(tmp_path, name, *extra, preset="end2end_jsrt"):
    return parse_config(ARGV + [f"--run.save_dir={tmp_path}",
                                f"--run.name={name}", *extra], preset=preset)


def _trees(engine, results):
    return engine.state_dict(), [{k: v for k, v in c.items()
                                  if k != "seconds"}
                                 for c in results["chunks"]]


def test_fresh_init_state_gives_the_same_run(tmp_path):
    """``train(init_state=build_state(cfg))`` equals ``train()`` bit for
    bit: every tensor of the engine state, the generators' states and every
    chunk's losses and validation Dice."""
    plain = _trees(*train_end2end.train(_cfg(tmp_path, "plain"), 3))
    cfg = _cfg(tmp_path, "init")
    state = train_end2end.build_state(cfg)
    assert state["step"] == 0
    assert_same_tree(plain, _trees(*train_end2end.train(
        cfg, 3, init_state=state)))


def test_init_state_without_arch_optimizer_and_resume(tmp_path):
    """A state whose arch optimizer is None starts a fresh one, as the JAX
    NAS warm start does; a run from a biased state cut short and resumed
    (the same ``init_state`` given again) equals the uninterrupted one bit
    for bit; an unknown key raises."""
    cfg = _cfg(tmp_path, "full", "--run.save_every=1")
    state = train_end2end.build_state(cfg)
    state["arch"]["upconv"][:, 0] += 1.0
    state["arch_optimizer"] = None
    full = _trees(*train_end2end.train(cfg, 3, init_state=state))
    train_end2end.train(_cfg(tmp_path, "cut", "--run.save_every=1",
                             "--run.final_checkpoint=false"), 2,
                        init_state=state)
    resumed = _trees(*train_end2end.train(
        _cfg(tmp_path, "cut", "--run.save_every=1", "--run.resume=true"), 3,
        init_state=state))
    assert_same_tree(full[0], resumed[0])
    assert full[1][-1] == resumed[1][-1]
    with pytest.raises(ValueError, match="unknown keys"):
        train_end2end.train(cfg, 1, init_state={**state, "opt_arch": None})


def test_init_state_reaches_every_rank(tmp_path, monkeypatch):
    """At ``run.data_axis=2`` the state reaches the ranks ``train`` starts:
    a frozen run (``hypergrad=none``) from biased tables ends on them."""
    from semantic_segmentation_torch.parallel import launch
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", 120.0)
    cfg = _cfg(tmp_path, "dp", "--run.data_axis=2",
               "--engine.hypergrad=none", preset="end2end_nas")
    state = train_end2end.build_state(cfg)
    state["arch"]["upconv"][:, 2] += 2.0
    engine, _ = train_end2end.train(cfg, 2, init_state=state)
    assert torch.equal(engine.arch["upconv"], state["arch"]["upconv"])


@pytest.mark.parametrize("mode", ["frozen", "searched"])
def test_nas_win_arm(tmp_path, mode):
    """A ``nas_torch_win`` arm from tables biased +2 toward k8 through the
    hook: frozen, the tables end bit for bit where they started and the
    biased column leads by about 2; searched, they moved under a live
    hypergradient. The record has the JAX script's fields."""
    from scripts import nas_torch_win
    spec = {"mode": mode, "kernel": 8, "seed": 0}
    rec, start, final = nas_torch_win.run_arm(
        spec, 2, "cpu", SMALL[2:], str(tmp_path), size=32)
    fresh = train_end2end.build_state(nas_torch_win.arm_config(
        spec, "cpu", SMALL[2:], str(tmp_path), size=32))
    assert torch.equal(start[:, :2], fresh["arch"]["upconv"][:, :2])
    assert torch.equal(start[:, 2], fresh["arch"]["upconv"][:, 2] + 2.0)
    assert set(JAX_FIELDS["nas_win"]) <= set(rec)
    if mode == "frozen":
        assert torch.equal(start, final)
        assert abs(rec["bias_col_lead_final"] - 2.0) <= 5e-3
        assert rec["genotype_final"] == ["k8"] * 8
    else:
        assert rec["arch_max_moved"] > 0 and rec["arch_grad_norm_mean"] > 0


def test_validate_and_nas_flagship_records(tmp_path):
    """The two trainer scripts' records at smoke width: the JAX scripts'
    fields, finite losses, the frozen control's tables unmoved against the
    search's."""
    from scripts import nas_torch_flagship, validate_torch_learning
    rec = validate_torch_learning.validate(
        2, "cpu", SMALL + ["--engine.valid_step=1"], str(tmp_path / "v"))
    assert set(JAX_FIELDS["validate"]) <= set(rec) and rec["losses_finite"]
    assert [it for it, _ in rec["val_trajectory"]] == [1, 2]
    rec = nas_torch_flagship.nas_flagship(2, "cpu", SMALL + [
        "--engine.valid_step=1"], str(tmp_path / "n"))
    assert set(JAX_FIELDS["nas_flagship"]) <= set(rec)
    assert len(rec["arch_abs_max_trajectory"]) == 2
    assert rec["arch_max_moved_vs_frozen"] > 0
    assert rec["arch_grad_norm_max"] > 0


def test_validate_equalized_folder_is_the_synthetic_split(tmp_path):
    """``validate_torch_learning --equalized``'s folder holds the synthetic
    split in its order: through the JSRT loader the masks and the pix2pix
    images are the synthetic ones (the images to a uint8 level), and the
    segmenter's images are their equalize and gamma(0.5)."""
    import numpy as np

    from scripts import validate_torch_learning
    from semantic_segmentation_torch.train.common import load_splits
    cfg = parse_config(validate_torch_learning.ARGV + SMALL,
                       preset="end2end_jsrt")
    synth = load_splits(cfg)
    cfg.data.dataroot = validate_torch_learning.write_jsrt_folder(
        cfg, str(tmp_path / "jsrt"))
    cfg.data.synthetic = False
    folder = load_splits(cfg)
    for split in ("train", "val", "test"):
        a, b = synth[split], folder[split]
        assert np.array_equal(a["mask"], b["mask"])
        assert np.abs(a["image_pix2pix"] - b["image_pix2pix"]).max() <= 1 / 255
        eq = b["image"][..., 0]
        assert not np.allclose(eq, b["image_pix2pix"][..., 0], atol=0.05)
        # equalize spreads each image's levels over [0, 1] before gamma
        assert eq.max(axis=(1, 2)).min() > 0.99


def test_chaos_control_zero_perturbation_is_bit_for_bit():
    """The chaos control on the CPU: the repeated base run equals the base
    bit for bit (losses and Dice), the 1-ulp run parts from it; the record
    has the JAX script's fields."""
    from scripts import drift_torch_chaos_control as chaos
    threads = torch.get_num_threads()
    try:
        rec = chaos.chaos_control(3, "cpu", repeat=True)
    finally:
        torch.set_num_threads(threads)
    assert set(JAX_FIELDS["chaos"]) <= set(rec)
    assert all(v == {"max": 0.0, "last": 0.0}
               for v in rec["loss_rel_repeat"].values())
    assert rec["run_to_run_dice_gap_pt"] == 0.0
    assert rec["loss_rel_ulp"]["unet"]["max"] > 0


JAX_LAUNCHERS = ("train_end2end_jsrt", "train_end2end_isic",
                 "train_pix2pix_lung", "train_pix2pix_isic", "test_lung",
                 "test_isic")


def _launcher(path: pathlib.Path):
    """(module, fixed options) of a launcher's ``exec python -m``."""
    text = path.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.startswith("exec "))
    words = shlex.split(line)
    i = words.index("-m")
    return words[i + 1], [w for w in words[i + 2:] if w != "$@"]


@pytest.mark.parametrize("stem", JAX_LAUNCHERS)
def test_launchers_match_the_jax_ones(stem):
    """``scripts/<stem>_torch.sh`` runs the port's entry of the JAX
    launcher's module with its options; the module and its preset exist
    in the port."""
    import importlib.util
    module, opts = _launcher(ROOT / "scripts" / f"{stem}_torch.sh")
    jmodule, jopts = _launcher(ROOT / "scripts" / f"{stem}.sh")
    assert module == jmodule.replace("semantic_segmentation_tpu",
                                     "semantic_segmentation_torch")
    assert opts == jopts
    assert importlib.util.find_spec(module) is not None
    for o in opts:
        m = re.fullmatch(r"--preset=(\w+)", o)
        if m:
            assert m.group(1) in PRESETS
        else:
            parse_config([o])
    assert '"$@"' in (ROOT / "scripts" / f"{stem}_torch.sh").read_text()
