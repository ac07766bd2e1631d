"""The port's ``test_seg`` against the JAX package's: a reference milesial
U-Net ``state_dict`` (``tests/torch_oracles.TorchMilesialUNet``, random
weights and BN statistics) saved as ``.pth`` scores the same test and OOD
Dice through both entries' ``run`` on one folder fixture with an OOD folder,
within 1e-5; the port's own ``unet_best.pt`` and its two checkpoint layouts
resolve; a bilinear-layout state dict is refused by the transposed-conv
net, and a ``.msgpack`` by both; a milesial-named bilinear state dict at the
JAX package's widths scores through both entries at ``--model.bilinear``,
while one at milesial's published widths (the DoubleConv mid width half the
concatenated input's, not the upsampled input's) fits neither package."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.train import test_seg as jtest_seg
from semantic_segmentation_torch.core.checkpoint import CheckpointManager
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.train import test_seg
from semantic_segmentation_torch.train.common import (build_seg_problem,
                                                      load_seg_state,
                                                      load_splits)
from semantic_segmentation_torch.train.train_unet import evaluate_split
from semantic_segmentation_torch.utils.torch_port import milesial_key_map
from torch_oracles import TorchMilesialUNet


def _write_folder(root, n, size, seed, suffix=""):
    (root / "Images").mkdir(parents=True)
    (root / "Masks").mkdir()
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        cy, cx = rng.uniform(0.3, 0.7, 2) * size
        r = rng.uniform(0.15, 0.3) * size
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8) * 255
        img = np.clip(80 + 0.5 * m + rng.normal(0, 20, (size, size)), 0, 255)
        Image.fromarray(img.astype(np.uint8), "L").save(
            root / "Images" / f"case{i}.png")
        Image.fromarray(m, "L").save(root / "Masks" / f"case{i}{suffix}.png")
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    base = tmp_path_factory.mktemp("test_seg")
    return (_write_folder(base / "jsrt", 7, 64, seed=1),
            _write_folder(base / "sz", 2, 64, seed=2, suffix="_mask"), base)


def _argv(folders, name="run", *extra):
    jsrt, sz, base = folders
    return [f"--data.dataroot={jsrt}", f"--data.ood_roots=sz:{sz}:_mask",
            "--data.image_size=32", "--data.n_train=2", "--data.n_val=1",
            "--data.n_test=4", "--model.base_features=8",
            "--model.compute_dtype=float32", f"--run.save_dir={base}",
            f"--run.name={name}", *extra]


def _milesial(seed: int):
    torch.manual_seed(seed)
    net = TorchMilesialUNet(1, 1, f=8)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        net.outc.conv.bias.fill_(0.3)
    return net


def test_milesial_pth_scores_as_jax_test_seg(folders, tmp_path):
    path = str(tmp_path / "unet.pth")
    torch.save(_milesial(0).state_dict(), path)
    argv = _argv(folders, "milesial", f"--run.model_file={path}")
    ref = jtest_seg.run(jparse(argv), model_file=path)
    got = test_seg.run(parse_config(argv + ["--run.device=cpu"]),
                       model_file=path)
    assert sorted(got) == sorted(ref) == ["ood_sz", "test_dice"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    print("test_seg against JAX:", {k: (got[k], ref[k]) for k in ref})
    assert 0.0 < got["test_dice"] < 1.0


def test_port_unet_best_round_trip(folders, tmp_path):
    cfg = parse_config(_argv(folders, "own", "--run.device=cpu"))
    seg = build_seg_problem(cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in seg.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    path = str(tmp_path / "unet_best.pt")
    torch.save(seg.net.state_dict(), path)
    got = test_seg.run(cfg, model_file=path)
    splits = load_splits(cfg)
    assert got["test_dice"] == evaluate_split(seg.net, splits["test"], 2)
    assert got["ood_sz"] == evaluate_split(seg.net, splits["ood"][0][1], 2)


@pytest.mark.parametrize("layout", ["engine", "supervised", "none"])
def test_run_checkpoint_resolves(layout, folders):
    cfg = parse_config(_argv(folders, f"layout-{layout}"))
    net = build_seg_problem(cfg, "cpu").net
    sd = {k: v + 1.0 for k, v in net.state_dict().items()}
    ckpt = os.path.join(cfg.run.save_dir, cfg.run.name, "ckpt")
    if layout != "none":
        mgr = CheckpointManager(ckpt)
        other = {k: v - 1.0 for k, v in sd.items()}
        tree = ({"engine": {}, "host": {"best_unet": sd}}
                if layout == "engine" else {"unet": sd})
        worse = ({"engine": {}, "host": {"best_unet": other}}
                 if layout == "engine" else {"unet": other})
        mgr.save(2, tree, {"val_score": 0.8})
        mgr.save(4, worse, {"val_score": 0.3})       # latest, not best
    _, loaded = load_seg_state(cfg, net)
    assert loaded == (layout != "none")
    if loaded:
        for k, v in net.state_dict().items():
            assert torch.equal(v, sd[k]), k
    else:
        assert not os.path.exists(os.path.dirname(ckpt))


def test_bilinear_layout_and_msgpack_are_refused(folders, tmp_path):
    sd = _milesial(1).state_dict()
    assert set(milesial_key_map(sd)) <= set(sd)
    bilinear = {k: v for k, v in sd.items()
                if not (k.startswith("up") and ".up." in k)}
    cfg = parse_config(_argv(folders))
    net = build_seg_problem(cfg, "cpu").net
    path = str(tmp_path / "bilinear.pth")
    torch.save(bilinear, path)
    with pytest.raises(ValueError, match="bilinear"):
        load_seg_state(cfg, net, path)
    with pytest.raises(NotImplementedError, match="msgpack"):
        load_seg_state(cfg, net, str(tmp_path / "unet_best.msgpack"))


def _bilinear_milesial(seed: int, published_widths: bool = False) -> dict:
    """A milesial-named state dict of the bilinear U-Net at base 8: the
    port's ``UNet(bilinear=True)`` keys renamed to the reference's, random
    weights (the port's init moved a little) and BN statistics.
    ``published_widths`` widens each up
    block's mid conv to milesial's ``in_channels // 2``."""
    gen = torch.Generator().manual_seed(seed)
    port = build_seg_problem(parse_config(
        ["--model.base_features=8", "--model.bilinear=true"]), "cpu").net
    own = port.state_dict()
    keys = milesial_key_map({})         # no up{i}.up: the bilinear layout
    assert "up1.up.weight" not in keys
    sd = {}
    for src, dst in keys.items():
        shape = list(own[dst].shape)
        if published_widths and dst.startswith("up") and ".conv." in dst:
            mid = own[dst.rsplit(".conv.", 1)[0] + ".conv.conv0.weight"
                      ].shape[1] // 2
            if ".conv0." in dst or ".bn0." in dst:
                shape[0] = mid
            elif ".conv1." in dst:
                shape[1] = mid
        if dst.endswith("running_var"):
            sd[src] = torch.rand(shape, generator=gen) + 0.5
        elif dst.endswith("running_mean"):
            sd[src] = 0.1 * torch.randn(shape, generator=gen)
        elif list(own[dst].shape) == shape:   # the init, moved a little
            sd[src] = own[dst] + 0.01 * torch.randn(shape, generator=gen)
        else:
            sd[src] = 0.1 * torch.randn(shape, generator=gen)
        sd[src.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
            torch.tensor(3)
    sd["outc.conv.bias"] = torch.full_like(sd["outc.conv.bias"], 0.3)
    return sd


def test_bilinear_milesial_scores_as_jax_test_seg(folders, tmp_path):
    path = str(tmp_path / "bilinear.pth")
    torch.save(_bilinear_milesial(2), path)
    argv = _argv(folders, "bilinear", "--model.bilinear=true",
                 f"--run.model_file={path}")
    ref = jtest_seg.run(jparse(argv), model_file=path)
    got = test_seg.run(parse_config(argv + ["--run.device=cpu"]),
                       model_file=path)
    assert sorted(got) == sorted(ref) == ["ood_sz", "test_dice"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    print("bilinear test_seg against JAX:",
          {k: (got[k], ref[k]) for k in ref})
    assert 0.05 < got["test_dice"] < 1.0
    # milesial's published widths fit neither package
    wide = str(tmp_path / "published.pth")
    torch.save(_bilinear_milesial(2, published_widths=True), wide)
    argv = _argv(folders, "published", "--model.bilinear=true")
    with pytest.raises(Exception, match="shape"):
        jtest_seg.run(jparse(argv), model_file=wide)
    with pytest.raises(RuntimeError, match="size mismatch"):
        test_seg.run(parse_config(argv + ["--run.device=cpu"]),
                     model_file=wide)
