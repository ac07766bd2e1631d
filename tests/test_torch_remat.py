"""``model.remat`` in the port's flagship: one ``decay_only`` engine
iteration with remat on and one with it off, from the same state and the
same seeds, give bit for bit the same losses, parameters, BN running
statistics (each folded once per forward, not again when the backward
recomputes it) and draws' generator state, on the CPU. G is ``unet_64`` at
64^2, so its dropout is live (depth 4); the segmenter is DeepLabV3 at
layers 1-1-1-1 (ASPP dropout) or the U-Net. Under remat every draw is made
before its checkpointed call, in the order the forward would make it."""
import pytest
import torch

import semantic_segmentation_torch.train.train_end2end as t_e2e
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.ops.layers import BatchNorm2d, checkpointed
from semantic_segmentation_torch.train.common import load_splits

ARGV = ["--data.synthetic=true", "--data.image_size=64", "--data.n_train=4",
        "--data.n_val=2", "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.netG=unet_64", "--model.ngf=4", "--model.ndf=4",
        "--model.base_features=4", "--run.device=cpu"]


def _iteration(seg_model, remat, monkeypatch):
    if seg_model == "deeplab":
        monkeypatch.setattr(t_e2e, "seg_model_kwargs",
                            lambda cfg: {"layers": (1, 1, 1, 1)})
    cfg = parse_config(ARGV + [f"--model.seg_model={seg_model}",
                               f"--model.remat={str(remat).lower()}"],
                       preset="end2end_jsrt")
    calls = []
    plain = t_e2e.checkpointed
    monkeypatch.setattr(t_e2e, "checkpointed",
                        lambda fn, *a: calls.append(fn) or plain(fn, *a))
    engine, _, _ = t_e2e.build_engine(cfg, "cpu")
    train = to_device_split(load_splits(cfg)["train"], "cpu")
    batches = {n: take_batch(train, [i % 4, (i + 1) % 4])
               for i, n in enumerate(t_e2e.PROBLEMS)}
    metrics = engine.engine_step([batches], None)
    # G 3x, D 3x, the segmenter 2x (the real and the fake branch)
    assert len(calls) == (8 if remat else 0)
    return ({k: float(v) for k, v in metrics.items()},
            {p.name: {k: v.clone() for k, v in p.module.state_dict().items()}
             for p in engine.problems},
            engine.generator.get_state())


@pytest.mark.parametrize("seg_model", ["deeplab", "unet"])
def test_remat_is_bit_identical(seg_model, monkeypatch):
    m0, s0, g0 = _iteration(seg_model, False, monkeypatch)
    m1, s1, g1 = _iteration(seg_model, True, monkeypatch)
    assert m0 == m1
    for name in s0:
        for k, v in s0[name].items():
            assert torch.equal(v, s1[name][k]), (name, k)
    assert torch.equal(g0, g1)


def test_checkpointed_folds_statistics_once():
    torch.manual_seed(0)
    bn = BatchNorm2d(3)
    conv = torch.nn.Conv2d(3, 3, 3, padding=1)
    x = torch.randn(2, 3, 8, 8)
    ref = BatchNorm2d(3)
    ref.load_state_dict(bn.state_dict())
    y = checkpointed(lambda t: bn(conv(t)), x.requires_grad_(True))
    y.square().sum().backward()
    ref(conv(x))
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
