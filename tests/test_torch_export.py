"""The port's serving export (``core/export.py``, ``train/export_seg.py``)
on the CPU, mirroring ``tests/test_export.py`` of the JAX package (32^2,
U-Net width 8; DeepLabV3 at layers 1-1-1-1):

- the artifact, exported with a symbolic batch, equals the eager predict
  head within 2e-7 at batches 1 and 3 (f32), sigmoid probabilities in
  [0, 1]; in bf16 (the net inside ``torch.autocast``, captured by export)
  it equals the eager bf16 head within 2e-7 too;
- a pinned batch refuses another size;
- multi-class softmax probabilities sum to 1;
- the entry refuses a fresh init unless ``export_allow_fresh``, writes
  ``<save_dir>/<name>/serving.pt2`` by default, resolves a trained net
  through ``run.model_file``, and refuses a TPU;
- the port's probabilities equal the JAX artifact's on bridged weights
  within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_segmentation_torch.train.common as common
from semantic_segmentation_tpu.core.export import export_seg as jexport_seg
from semantic_segmentation_tpu.core.export import \
    load_exported as jload_exported
from semantic_segmentation_tpu.models.seg import SegProblem as JSegProblem
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.core.export import (export_seg,
                                                     load_exported,
                                                     make_predict_fn)
from semantic_segmentation_torch.train import export_seg as cli
from semantic_segmentation_torch.train.common import build_seg_problem
from semantic_segmentation_torch.utils.bridge import load_flax
from tests.test_torch_train_unet import random_seg_state

ARGV = ["--data.synthetic=true", "--data.image_size=32",
        "--model.base_features=8", "--model.compute_dtype=float32",
        "--run.device=cpu"]


def _cfg(*extra):
    return parse_config(ARGV + list(extra))


def _images(batch, seed=0, c=1):
    return torch.rand(batch, 32, 32, c,
                      generator=torch.Generator().manual_seed(seed))


def _export(tmp_path, net, classes=1, batch=0, dtype="float32", c=1):
    path = str(tmp_path / f"a{classes}{batch}{dtype}.pt2")
    torch.export.save(export_seg(net, classes, 32, c, batch, dtype), path)
    return load_exported(path)


@pytest.mark.parametrize("seg_model", ["unet", "deeplab"])
def test_artifact_equals_eager_at_two_batches(seg_model, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(common, "seg_model_kwargs", lambda cfg: (
        {"layers": (1, 1, 1, 1)} if seg_model == "deeplab" else
        {"base_features": 8}))
    net = build_seg_problem(_cfg(f"--model.seg_model={seg_model}"),
                            "cpu").net
    call = _export(tmp_path, net)
    eager = make_predict_fn(net, 1)
    for batch in (1, 3):
        x = _images(batch, batch)
        with torch.no_grad():
            got, want = call(x), eager(x)
        assert got.shape == (batch, 32, 32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-7,
                                   atol=2e-7)
        assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


def test_bf16_artifact_equals_eager_bf16(tmp_path):
    net = build_seg_problem(_cfg(), "cpu").net
    call = _export(tmp_path, net, dtype="bfloat16")
    eager = make_predict_fn(net, 1, "bfloat16")
    f32 = make_predict_fn(net, 1)
    x = _images(3, 9)
    with torch.no_grad():
        got, want, full = call(x), eager(x), f32(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-7,
                               atol=2e-7)
    assert float((got - full).abs().max()) > 1e-4     # it is bf16


def test_multiclass_softmax(tmp_path):
    net = build_seg_problem(_cfg("--model.classes=3"), "cpu").net
    probs = _export(tmp_path, net, classes=3, batch=2)(torch.ones(2, 32, 32,
                                                                  1))
    assert probs.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def test_pinned_batch_rejects_other_sizes(tmp_path):
    call = _export(tmp_path, build_seg_problem(_cfg(), "cpu").net, batch=2)
    assert call(_images(2)).shape == (2, 32, 32)
    with pytest.raises(Exception, match=r"(?i)shape|dimension|size"):
        call(_images(3))


def test_cli_entry(tmp_path):
    cfg = _cfg(f"--run.save_dir={tmp_path}", "--run.name=fresh")
    with pytest.raises(FileNotFoundError, match="refusing to serialize"):
        cli.run(cfg)
    cfg.run.export_allow_fresh = True
    paths = cli.run(cfg)
    assert paths == {"cpu": str(tmp_path / "fresh" / "serving.pt2")}
    out = load_exported(paths["cpu"])(_images(2))
    assert out.shape == (2, 32, 32)
    # a trained net resolves through run.model_file; a TPU is refused
    net = build_seg_problem(cfg, "cpu").net
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.01)
    model = str(tmp_path / "unet_best.pt")
    torch.save(net.state_dict(), model)
    cfg = _cfg(f"--run.model_file={model}", "--run.export_platforms=cpu",
               f"--run.export_path={tmp_path / 'out' / 'unet.pt2'}")
    with pytest.raises(ValueError, match="no TPU"):
        cli.run(_cfg("--run.export_platforms=cpu,tpu",
                     "--run.export_allow_fresh=true"))
    paths = cli.run(cfg)
    assert paths == {"cpu": str(tmp_path / "out" / "unet.pt2")}
    x = _images(1, 4)
    with torch.no_grad():
        np.testing.assert_allclose(load_exported(paths["cpu"])(x).numpy(),
                                   make_predict_fn(net, 1)(x).numpy(),
                                   rtol=2e-7, atol=2e-7)


@pytest.mark.parametrize("classes", [1, 3])
def test_probabilities_equal_the_jax_artifact(classes, tmp_path):
    problem = JSegProblem("unet", 1, classes, compute_dtype=jnp.float32,
                          base_features=8, bilinear=False)
    state = random_seg_state(problem, 32, seed=3)
    jcall = jload_exported(jexport_seg(problem, state.params, state.stats,
                                       32))
    net = build_seg_problem(_cfg(f"--model.classes={classes}"), "cpu").net
    load_flax(net, *jax.device_get((state.params, state.stats)))
    call = _export(tmp_path, net, classes=classes)
    for batch in (1, 3):
        x = _images(batch, 10 + batch)
        want = np.asarray(jcall(jnp.asarray(x.numpy())))
        got = call(x).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
