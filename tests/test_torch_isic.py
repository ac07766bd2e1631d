"""Three engine iterations of the ISIC family against the JAX package's
``BilevelEngine``, f32, 32^2, from bridged weights and the same index
streams, each iteration from the JAX engine's state (as
``tests/test_torch_engine_modes.py`` does), with every random draw of the
JAX iteration injected into the port's: the augment affines, the
generator's dropout masks, the photometric coins and saturation factor,
and the Swin's drop-path masks, re-derived from the JAX engine's key chain
(bilevel.py:249 ``rng_r`` -> :152 split K -> :120 fold_in(problem) ->
train_end2end.py:107 split 3 and fold_in 101 / 102). The cases:

- ``end2end_isic`` on synthetic data: ``unet_32``, ngf = ndf = U-Net base
  8, the photometric post-process and the Jaccard loss;
- ``end2end_isic`` from a tiny ISIC-layout folder of RGB PNGs at
  ``--model.output_nc=3``: RGB fakes through the photometric chain, a
  3-channel segmenter;
- ``end2end_isic224`` on synthetic data with ``resnet_6blocks`` (ngf 8,
  dropout live in every block) and a small Swin-UNet (embed 12, depths
  2-2-2-2, heads 1-2-2-4, window 4, drop-path 0.2, set through
  ``seg_model_kwargs`` in both packages), under ``decay_only``, three
  iterations, from ``tests/test_torch_isic224.py``;
- the same under the preset's own ``darts``, one iteration (its JAX
  compile is the longest), from ``tests/test_torch_isic224_darts.py``: the
  pre-arch unroll's draws (``rng_u``) injected as well as the replay's,
  and the Swin's drop paths of the outer loss (train_end2end.py:151-154,
  ``fold_in(key(2), step)``) injected into the port's outer loss. The
  hypergradient is exactly 0 in both packages (outer loss on the unet
  only, child netG), and the port's darts iteration equals, bit for bit,
  the port's ``decay_only`` iteration from the same state and replay
  draws: its losses, weights, BN statistics and arch tables;
- the flagship ``end2end_jsrt`` with DeepLabV3 at layers 1-1-1-1 (set
  through ``seg_model_kwargs`` in both packages) and the Dice loss, its
  ASPP dropout masks injected, from ``tests/test_torch_deeplab_engine.py``:
  with the preset's uint8 chain, losses within 1e-3 relative (a fake's
  quantisation level can move, as in ``tests/test_torch_engine.py``;
  measured 6.8e-5, the real branch alone 3.9e-6), and with the min-max
  post-process within 1e-5 (measured 2.3e-6).

The cases run from separate files so that their JAX compiles run on
separate test workers. Losses within 5e-5 relative (the ISIC cases); the
largest gaps are printed (``-s``)."""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_segmentation_tpu.train.common as jcommon
import semantic_segmentation_torch.train.train_end2end as t_e2e
from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.data.pipeline import device_put_split
from semantic_segmentation_tpu.models import swin_unet as jswin
from semantic_segmentation_tpu.models.pix2pix.networks import ResnetGenerator
from semantic_segmentation_tpu.ops.augment import sample_affine_batch
from semantic_segmentation_tpu.train.common import load_splits as jload_splits
from semantic_segmentation_tpu.train.train_end2end import \
    build_engine_and_state
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.data.pipeline import (epoch_index_batches,
                                                       take_batch,
                                                       to_device_split)
from semantic_segmentation_torch.train.common import load_splits
from tests.test_torch_engine_modes import _sync_port
from tests.test_torch_nets import _nchw
from tests.test_torch_photometric import _jax_draws

PROBLEMS = t_e2e.PROBLEMS
BASE = ["--data.image_size=32", "--data.n_train=4", "--data.n_val=2",
        "--data.n_test=2", "--model.compute_dtype=float32",
        "--model.ngf=8", "--model.ndf=8", "--model.base_features=8"]
SMALL_SWIN = {"embed_dim": 12, "depths": (2, 2, 2, 2),
              "num_heads": (1, 2, 2, 4), "window_size": 4}
SMALL_DEEPLAB = {"layers": (1, 1, 1, 1)}
CASES = {
    "isic": (["--data.synthetic=true", "--model.netG=unet_32"],
             "end2end_isic"),
    "isic_rgb_folder": (["--data.synthetic=false", "--model.netG=unet_32",
                         "--model.output_nc=3"], "end2end_isic"),
    "isic224_swin": (["--data.synthetic=true", "--model.netG=resnet_6blocks",
                      "--engine.hypergrad=decay_only"], "end2end_isic224"),
    "isic224_swin_darts": (["--data.synthetic=true",
                            "--model.netG=resnet_6blocks"], "end2end_isic224"),
    "jsrt_deeplab": (["--data.synthetic=true", "--model.netG=unet_32",
                      "--model.seg_model=deeplab"], "end2end_jsrt"),
    "jsrt_deeplab_minmax": (["--data.synthetic=true", "--model.netG=unet_32",
                             "--model.seg_model=deeplab",
                             "--engine.fake_postprocess=minmax"],
                            "end2end_jsrt"),
}
ITERS = {"decay_only": 3, "darts": 1}
# the uint8 chain can move a quantisation level of a fake (as in
# tests/test_torch_engine.py); the min-max post-process cannot
RTOL = {"jsrt_deeplab": 1e-3, "jsrt_deeplab_minmax": 1e-5}


def write_isic_folder(root, n: int = 8, size=(40, 36), seed: int = 0):
    """An ISIC-layout folder: RGB PNG images and binary masks (0/255) at
    ``size``, so the loader resizes both (the masks NEAREST)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    (root / "Images").mkdir(parents=True)
    (root / "Masks").mkdir()
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        cx, cy = rng.uniform(12, 28), rng.uniform(10, 26)
        r = rng.uniform(6, 12)
        lesion = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        img = rng.integers(90, 200, (h, w, 3))
        img[lesion] = img[lesion] // 2
        Image.fromarray(img.astype(np.uint8), "RGB").save(
            root / "Images" / f"ISIC_{i:04d}.png")
        Image.fromarray((lesion * 255).astype(np.uint8), "L").save(
            root / "Masks" / f"ISIC_{i:04d}.png")


class MaskCapture:
    """Records the keep-masks of one train-mode forward of a JAX net from
    inside a jitted apply (``jax.debug.callback``), so that the forward
    compiles once for the test: the generator's Dropout layers, keyed by
    ResNet block (each fed ones in place of its input, whose ReLU zeros
    would read as dropped; the values are not used), and the Swin's
    drop paths, keyed by block (``swin_unet.drop_path`` wrapped while the
    apply is traced), and DeepLabV3's ASPP Dropout, keyed 'aspp' and
    returned NCHW. A mask depends on the key and the shape only."""

    def __init__(self, module, monkeypatch):
        self.records = []
        current = [None]
        plain = jswin.drop_path

        def sink(name, i):
            return lambda m: self.records.append((name, i, np.asarray(m)))

        def recording_drop_path(v, rate, rng):
            mask = jax.random.bernoulli(rng, 1.0 - rate, (v.shape[0],))
            slot = sum(r == current[0] for r in self.traced)
            self.traced.append(current[0])
            jax.debug.callback(sink(current[0], slot), mask, ordered=True)
            return plain(v, rate, rng)

        def track(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, jswin.SwinBlock):
                current[0] = mod.name
            if not isinstance(mod, fnn.Dropout):
                return next_fun(*args, **kwargs)
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            block = (mod.parent.name if mod.parent.name == "aspp"
                     else int(mod.parent.name[len("res"):]))
            jax.debug.callback(sink(block, 0), out != 0, ordered=True)
            return out

        def forward(variables, x, key):
            self.traced = []
            with monkeypatch.context() as m:
                m.setattr(jswin, "drop_path", recording_drop_path)
                with fnn.intercept_methods(track):
                    return module.apply(variables, x, train=True,
                                        rngs={"dropout": key},
                                        mutable=["batch_stats"])

        self.forward = jax.jit(forward)

    def __call__(self, variables, x, key, nchw: bool = False) -> dict:
        self.records.clear()
        jax.block_until_ready(self.forward(variables, x, key))
        jax.effects_barrier()
        out = {}
        for name, slot, m in sorted(self.records, key=lambda r: (str(r[0]),
                                                                   r[1])):
            out.setdefault(name, []).append(m)
        return {k: _nchw(v[0]) if nchw or k == "aspp"
                else torch.from_numpy(np.stack(v)) for k, v in out.items()}


def phase_draws(root, it: int, phase: str, captures: dict, state,
                batches: dict, postprocess: str):
    """{problem: draws} of the JAX iteration ``it`` (K = 1): what its
    ``phase`` unroll, 'unroll' (``rng_u``) or 'replay' (``rng_r``), draws
    for each problem. ``captures``: the ``MaskCapture`` of the generator
    and of the segmenter, or None for a net that draws nothing."""
    keys = jax.random.split(jax.random.fold_in(root, jnp.int32(it)), 3)
    r = jax.random.split(keys[{"unroll": 0, "replay": 2}[phase]], 1)[0]
    g_vars = {"params": state.params["netG"],
              "batch_stats": state.stats["netG"]}
    u_vars = {"params": state.params["unet"],
              "batch_stats": state.stats["unet"]}
    g_cap, u_cap = captures["netG"], captures["unet"]

    def g_masks(x, rng):
        return {} if g_cap is None else g_cap(g_vars, x, rng, nchw=True)

    out = {}
    for i, name in enumerate(PROBLEMS):
        rng_p = jax.random.fold_in(r, i)
        b = batches[name]
        if name != "unet":
            out[name] = {"dropout": g_masks(jnp.asarray(b["mask_pix2pix"]),
                                            rng_p)}
            continue
        rng_aug, rng_drop, rng_phot = jax.random.split(rng_p, 3)
        n, h, w, _ = b["mask"].shape
        d = {"affine": torch.from_numpy(np.array(sample_affine_batch(
                 rng_aug, n, h, w))),
             "dropout": g_masks(jnp.zeros((n, h, w, 1)), rng_drop)}
        if postprocess == "photometric":
            d["photometric"] = _jax_draws(rng_phot, n, False)
        if u_cap is not None:
            x = jnp.asarray(b["image"], jnp.float32)
            d["seg_real"] = u_cap(u_vars, x, jax.random.fold_in(rng_p, 101))
            d["seg_fake"] = u_cap(u_vars, x, jax.random.fold_in(rng_p, 102))
        out[name] = d
    return out


def engine_iterations_against_jax(case: str, tmp_path, monkeypatch):
    extra, preset = CASES[case]
    if case == "isic_rgb_folder":
        write_isic_folder(tmp_path / "isic")
        extra = extra + [f"--data.dataroot={tmp_path / 'isic'}"]
    if case.startswith("isic224_swin"):
        def small_swin(cfg):
            return {"drop_path_rate": cfg.model.drop_path_rate,
                    "use_checkpoint": cfg.model.use_checkpoint,
                    "img_size": cfg.data.image_size, **SMALL_SWIN}
        monkeypatch.setattr(jcommon, "seg_model_kwargs", small_swin)
        monkeypatch.setattr(t_e2e, "seg_model_kwargs", small_swin)
    if case.startswith("jsrt_deeplab"):
        for mod in (jcommon, t_e2e):
            monkeypatch.setattr(mod, "seg_model_kwargs",
                                lambda cfg: dict(SMALL_DEEPLAB))
    jcfg = jparse(BASE + extra, preset=preset)
    cfg = parse_config(BASE + extra + ["--run.device=cpu"], preset=preset)
    mode = cfg.engine.hypergrad
    assert mode == jcfg.engine.hypergrad in ITERS
    isic = preset.startswith("end2end_isic")
    assert (cfg.engine.fake_postprocess == "photometric") == isic
    engine_j, state, p2p_j, seg_j = build_engine_and_state(
        jcfg, jax.random.key(0))
    assert seg_j.loss_type == ("jaccard" if isic else "dice")
    jsplits = jload_splits(jcfg)
    splits = load_splits(cfg)
    for k in ("image", "mask", "image_pix2pix", "mask_pix2pix"):
        np.testing.assert_array_equal(splits["train"][k],
                                      jsplits["train"][k])
    train_j = device_put_split(jsplits["train"])
    val_j = device_put_split(jsplits["val"])

    engine, _, seg = t_e2e.build_engine(cfg, "cpu")
    assert seg.loss_type == seg_j.loss_type
    train_t = to_device_split(splits["train"], "cpu")
    val_t = to_device_split(splits["val"], "cpu")
    bs = cfg.data.batch_size
    n_train = len(splits["train"]["image"])
    streams = {n: epoch_index_batches(n_train, bs, seed=cfg.run.seed * 7 + i)
               for i, n in enumerate(PROBLEMS)}
    val_stream = epoch_index_batches(2, bs, seed=cfg.run.seed + 99)
    root = jax.random.key(cfg.run.seed + 5)

    captures = {
        "netG": (MaskCapture(p2p_j.G, monkeypatch)
                 if isinstance(p2p_j.G, ResnetGenerator) else None),
        "unet": (MaskCapture(seg_j.model, monkeypatch)
                 if seg_j.model.__class__.__name__ in ("SwinUnet",
                                                       "DeepLabV3")
                 else None)}
    outer_masks = {}
    if mode == "darts":
        # the JAX outer loss's drop paths, injected into the port's
        plain_outer, plain_apply = engine.outer_loss, seg.apply

        def outer_loss(params, val_batch):
            with monkeypatch.context() as m:
                m.setattr(seg, "apply", lambda *a, **kw: plain_apply(
                    *a, **kw, drop_masks=outer_masks["unet"]))
                return plain_outer(params, val_batch)
        engine.outer_loss = outer_loss
    gaps = {}
    for it in range(ITERS[mode]):
        idx = {n: next(s) for n, s in streams.items()}
        vidx = next(val_stream)
        host = jax.device_get(state)
        _sync_port(engine, host)
        batches = {n: take_batch(train_t, idx[n]) for n in PROBLEMS}
        host_batches = {n: {k: v.numpy() for k, v in b.items()}
                        for n, b in batches.items()}
        draws = {phase: [phase_draws(root, it, phase, captures, host,
                                     host_batches,
                                     cfg.engine.fake_postprocess)]
                 for phase in (("unroll", "replay") if mode == "darts"
                               else ("replay",))}
        if mode == "darts":
            u_vars = {"params": host.params["unet"],
                      "batch_stats": host.stats["unet"]}
            outer_masks["unet"] = captures["unet"](
                u_vars, jnp.asarray(jsplits["val"]["image"][vidx],
                                    jnp.float32),
                jax.random.fold_in(jax.random.key(2), it))
        state, mj = engine_j.engine_step_sampled(
            state, train_j, val_j, {n: idx[n][None] for n in PROBLEMS},
            vidx, jnp.int32(it), root, PROBLEMS)
        mt = engine.engine_step([batches], take_batch(val_t, vidx), draws)
        assert set(mt) == set(mj), (sorted(mt), sorted(mj))
        if mode == "darts":
            same_as_decay_only(cfg, engine, host, batches, draws["replay"],
                               mt)
        for k in mj:
            a, b = float(mt[k]), float(mj[k])
            assert np.isfinite(a), (it, k)
            if k == "arch_grad_norm":
                assert a == b == 0.0
                continue
            gap = abs(a - b) / abs(b)
            gaps[k] = max(gaps.get(k, 0.0), gap)
            assert gap < RTOL.get(case, 5e-5), (case, it, k, a, b)
    print(f"{case}: largest relative gaps over {ITERS[mode]} iterations:",
          {k: f"{v:.1e}" for k, v in gaps.items()})


def same_as_decay_only(cfg, engine, host, batches, replay, metrics):
    """The port's ``decay_only`` iteration from the JAX state ``host``
    with the ``replay`` draws gives, bit for bit, the losses ``metrics``
    and the state of the ``darts`` ``engine`` after its iteration."""
    cfg_d = copy.deepcopy(cfg)
    cfg_d.engine.hypergrad = "decay_only"
    engine_d, _, _ = t_e2e.build_engine(cfg_d, "cpu")
    _sync_port(engine_d, host)
    md = engine_d.engine_step([batches], None, {"replay": replay})
    for k in md:
        if k.startswith("replay_"):
            assert float(md[k]) == float(metrics[k]), (k, md[k], metrics[k])
    for p, q in zip(engine.problems, engine_d.problems):
        a, b = p.module.state_dict(), q.module.state_dict()
        assert all(torch.equal(a[n], b[n]) for n in a), p.name
    assert all(torch.equal(engine.arch[k], engine_d.arch[k])
               for k in engine.arch)


@pytest.mark.parametrize("case", ["isic", "isic_rgb_folder"])
def test_three_iterations_match_jax(case, tmp_path, monkeypatch):
    engine_iterations_against_jax(case, tmp_path, monkeypatch)


def test_isic_presets_match_jax():
    for preset in ("pix2pix_isic", "end2end_isic", "end2end_isic224"):
        j = jparse([], preset=preset)
        t = parse_config([], preset=preset)
        for section in ("data", "model", "optim", "engine"):
            tj = getattr(t, section).__dict__
            jj = getattr(j, section).__dict__
            for k, v in tj.items():
                assert v == jj[k], (preset, section, k, v, jj[k])
        assert t.run.name == j.run.name
    assert parse_config([], preset="end2end_isic").model.output_nc == 1


@pytest.mark.parametrize("n_classes,loss_type", [(1, "dice"), (1, "jaccard"),
                                                 (3, "dice")])
def test_seg_loss_fn_matches_jax(n_classes, loss_type):
    """``seg_loss_fn`` whole: binary BCE + Dice, binary BCE + Jaccard and
    multi-class CE + Dice, against the JAX package's, f32, within 1e-6
    relative (NCHW logits in the port, NHWC in the JAX package)."""
    from semantic_segmentation_tpu.models.seg import seg_loss_fn as jloss
    from semantic_segmentation_torch.models.seg import seg_loss_fn
    rng = np.random.default_rng(n_classes)
    logits = rng.normal(size=(2, 16, 12, n_classes)).astype(np.float32) * 3
    masks = rng.integers(0, max(n_classes, 2), (2, 16, 12, 1))
    want = float(jloss(jnp.asarray(logits), jnp.asarray(masks), n_classes,
                       loss_type))
    got = float(seg_loss_fn(_nchw(logits), _nchw(masks), n_classes,
                            loss_type))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # masks without their channel axis
    got = float(seg_loss_fn(_nchw(logits), torch.from_numpy(masks[..., 0]),
                            n_classes, loss_type))
    np.testing.assert_allclose(got, want, rtol=1e-6)
