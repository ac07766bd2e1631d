"""The port's GenSeg-3D nets against the JAX package's on bridged weights,
in f32 (NCDHW against NDHWC):

- ``MixedConv`` in 2-D and 3-D, ``InstanceNorm`` (also on a 2^3 map) and
  ``linear_additive_upsample``;
- ``UnetGenerator3D`` ('linear' and 'deconvolution', each with batch and
  instance norm) at nd 3, 32^3, ngf 4; ``NLayerDiscriminator3D`` at 32^3
  (``tests/test_torch_3d_nets_deep.py``: the nd-6 generator with the JAX
  keep-mask injected, and ``UNet3D``);
- parameter counts at full width (ngf = ndf = 64, nd 6, 64^3; UNet3D base
  64), counted with ``jax.eval_shape`` and the ``meta`` device.

Train- and eval-mode forward within 1e-5 of the largest output magnitude,
gradients (parameters, input or arch) within 5e-5 of each leaf's largest
magnitude, BN running statistics after one train forward within 1e-5;
float64 where f32 conditioning dominates (the discriminator's and UNet3D's
gradients, the nd-6 forwards), as each of those tests states. The
bias of a conv that an instance norm follows has a gradient that is 0 in
exact arithmetic (the norm removes a per-channel constant): there each
package's gradient, rounding noise, must lie within 5e-5 of the net's
largest gradient instead. The largest gaps are printed (``-s``)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.models.pix2pix.networks3d import (
    NLayerDiscriminator3D as JD3, UnetGenerator3D as JG3,
    linear_additive_upsample as jupsample)
from semantic_segmentation_tpu.models.unet3d import UNet3D as JUNet3D
from semantic_segmentation_tpu.ops.nas import MixedConv as JMixedConv
from semantic_segmentation_torch.models.pix2pix.networks3d import (
    NLayerDiscriminator3D, UnetGenerator3D, linear_additive_upsample)
from semantic_segmentation_torch.models.unet3d import UNet3D
from semantic_segmentation_torch.ops.layers import InstanceNorm
from semantic_segmentation_torch.ops.nas import MixedConv, arch_softmax
from semantic_segmentation_torch.utils.bridge import (load_flax,
                                                      state_dict_to_flax)
from tests.test_torch_nets import _dropout_masks

FWD, GRAD, STATS = 1e-5, 5e-5, 1e-5


@pytest.fixture(autouse=True)
def _native_cpu_conv3d():
    """torch's CPU conv3d through oneDNN returns a wrong weight gradient on
    one thread (torch 2.13.0+cpu, oneDNN 3.12, AVX-512: 1e29 off at k8,
    s2, p3, while eight threads or the native kernels agree with float64
    to 2e-7), and ``tests/test_torch_long_drift.py`` sets one thread at
    import in every test worker. The port's CPU path is held on torch's
    native conv kernels here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _to_torch(x):
    """channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.array(np.moveaxis(x, -1, 1), order="C"))


def _to_np(t):
    """channels-first tensor -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(np.asarray(b)))), 1e-12))


def _tree_rel(port, ref, zero_modules=()) -> float:
    """The largest leaf gap relative to the leaf's largest magnitude; the
    biases of ``zero_modules`` (mathematically zero gradients) are held to
    the tree's largest magnitude instead."""
    fp = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    fr = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert fp.keys() == fr.keys(), (sorted(map(str, fp)), sorted(map(str,
                                                                     fr)))
    top = max(float(np.max(np.abs(np.asarray(r)))) for r in fr.values())
    worst = 0.0
    for k, r in fr.items():
        name = jax.tree_util.keystr(k)
        if any(f"['{m}']['bias" in name for m in zero_modules):
            for v in (fp[k], r):
                assert np.max(np.abs(np.asarray(v))) <= GRAD * top, name
            continue
        gap = _rel(fp[k], r)
        assert gap <= GRAD, (name, gap)
        worst = max(worst, gap)
    return worst


def _check(jnet, variables, tnet, x, jargs=(), targs=(), t_kwargs=None,
           rng=None, zero_modules=(), grads=True, forward=True):
    """Eval and train forward (asserted unless ``forward`` is False),
    parameter and arch gradients (unless ``grads`` is False), BN stats."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    load_flax(tnet, params, stats)
    rngs = {"dropout": rng} if rng is not None else None
    tnet.eval()
    ref = np.asarray(jnet.apply(variables, x, *jargs, train=False))
    with torch.no_grad():
        # a throwaway first call: in a process that has run XLA:CPU, the
        # first CPU conv3d call of torch sometimes returned results up to
        # 5e-5 of the largest output off its own later calls (torch
        # 2.13.0+cpu; not reproduced in a torch-only process)
        tnet(_to_torch(np.asarray(x)), *targs)
        out = _to_np(tnet(_to_torch(np.asarray(x)), *targs))
    gaps = {"eval forward": _rel(out, ref)}
    w = np.random.default_rng(11).normal(size=ref.shape).astype(ref.dtype)

    def jloss(p, jargs_):
        y, mut = jnet.apply({"params": p, "batch_stats": stats}, x, *jargs_,
                            train=True, rngs=rngs, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (yj, stats_j)), (gp_j, ga_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jargs)
    tnet.train()
    tnet.zero_grad(set_to_none=True)
    targs_t = [a.clone().requires_grad_(True) for a in targs]
    yt = tnet(_to_torch(np.asarray(x)), *targs_t, **(t_kwargs or {}))
    gaps["train forward"] = _rel(_to_np(yt), yj)
    (yt * _to_torch(w)).sum().backward()
    gp_t, _ = state_dict_to_flax(
        tnet, {k: p.grad for k, p in tnet.named_parameters()})
    for a_t, a_j in zip(targs_t, ga_j if grads else ()):
        # the deconvolution variant does not read the arch: zero in both
        g_t = (torch.zeros_like(a_t) if a_t.grad is None else a_t.grad)
        gaps["arch grad"] = _tree_rel({"a": g_t.numpy()},
                                      {"a": np.asarray(a_j)})
    if grads:
        gaps["param grads"] = _tree_rel(gp_t, jax.device_get(gp_j),
                                        zero_modules)
    _, stats_t = state_dict_to_flax(tnet, tnet.state_dict())
    flat_t = jax.tree_util.tree_leaves(stats_t)
    flat_j = jax.tree_util.tree_leaves(jax.device_get(stats_j))
    assert len(flat_t) == len(flat_j)
    if flat_t:
        gaps["BN stats (abs)"] = max(float(np.max(np.abs(a - b)))
                                     for a, b in zip(flat_t, flat_j))
        assert gaps["BN stats (abs)"] <= STATS
    print(type(tnet).__name__, {k: f"{v:.2e}" for k, v in gaps.items()})
    if forward:
        assert gaps["eval forward"] <= FWD and gaps["train forward"] <= FWD
    return gaps


class _MixedConvNet(torch.nn.Module):
    """MixedConv with its arch row as an input, the way the nets call it."""

    def __init__(self, c_in, c_out, nsp):
        super().__init__()
        self.m = MixedConv(c_in, c_out, True, nsp)

    def forward(self, x, arch_row):
        return self.m(x, arch_softmax(arch_row))


class _JMixedConvNet(fnn.Module):
    features: int
    nsp: int

    @fnn.compact
    def __call__(self, x, arch_row, train=False):
        del train
        return JMixedConv(self.features, True, self.nsp,
                          kernel_init=fnn.initializers.normal(0.2),
                          name="m")(x, jax.nn.softmax(arch_row))


@pytest.mark.parametrize("nsp", [2, 3])
def test_mixed_conv(nsp):
    size = 16 if nsp == 2 else 8
    x = np.random.default_rng(nsp).normal(
        size=(2,) + (size,) * nsp + (3,)).astype(np.float32)
    arch = np.array([0.3, -0.5, 0.9], np.float32)
    jm = _JMixedConvNet(5, nsp)
    variables = jax.jit(jm.init)(jax.random.key(nsp), jnp.asarray(x), arch)
    # non-zero biases, so their mixture is checked too
    variables = jax.tree.map(lambda v: v + 0.1 if v.ndim == 1 else v,
                             variables)
    tm = _MixedConvNet(3, 5, nsp)
    gaps = _check(jm, variables, tm, jnp.asarray(x), (jnp.asarray(arch),),
                  (torch.from_numpy(arch),))
    assert tm(_to_torch(x), torch.from_numpy(arch)).shape[2:] == \
        (size // 2,) * nsp and gaps["arch grad"] >= 0


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 3), (1, 2, 2, 2, 4)],
                         ids=["5x6x7", "2x2x2"])
def test_instance_norm(shape):
    x = (np.random.default_rng(3).normal(size=shape) * 2 + 1).astype(
        np.float32)
    m = fnn.InstanceNorm(use_scale=False, use_bias=False, epsilon=1e-5)
    w = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    y, vjp = jax.vjp(lambda v: m.apply({}, v), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(w))
    xt = _to_torch(x).requires_grad_(True)
    yt = InstanceNorm()(xt)
    (yt * _to_torch(w)).sum().backward()
    fwd, grad = _rel(_to_np(yt), y), _rel(_to_np(xt.grad), gx)
    print("InstanceNorm", shape, f"forward {fwd:.2e} input grad {grad:.2e}")
    assert fwd <= FWD and grad <= GRAD
    assert not list(InstanceNorm().parameters()) and \
        not list(InstanceNorm().buffers())


def test_linear_additive_upsample_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 5, 8)).astype(
        np.float32)
    ref = np.asarray(jupsample(jnp.asarray(x), 2, 4))
    out = _to_np(linear_additive_upsample(_to_torch(x), 2, 4))
    assert out.shape == ref.shape == (2, 6, 8, 10, 2)
    gap = float(np.max(np.abs(out - ref)))
    print("linear_additive_upsample max abs gap", f"{gap:.2e}")
    assert gap <= 1e-5


def _arch(nd, seed=1):
    return np.array(300.0 * 1e-3 * jax.random.normal(
        jax.random.key(seed), (nd, 3)), np.float32)


@pytest.mark.parametrize("upsampling", ["linear", "deconvolution"])
@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_generator3d(upsampling, norm):
    nd, ngf, size = 3, 4, 32
    x = np.random.default_rng(0).normal(size=(2, size, size, size, 1)).astype(
        np.float32)
    arch = _arch(nd)
    jg = JG3(1, nd, ngf, upsampling, False, norm, dtype=jnp.float32)
    variables = jax.jit(jg.init)(jax.random.key(0), jnp.asarray(x), arch)
    if norm == "instance":
        assert "batch_stats" not in variables
    tg = UnetGenerator3D(1, 1, nd, ngf, upsampling, False, norm)
    _check(jg, variables, tg, jnp.asarray(x), (jnp.asarray(arch),),
           (torch.from_numpy(arch),), zero_modules=_normed(norm, nd))


def _normed(norm, nd):
    """The generator's convs an instance norm follows."""
    if norm != "instance":
        return ()
    return tuple(f"down{d}" for d in range(1, nd - 1)) + tuple(
        f"up{d}" for d in range(1, nd))


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_discriminator3d(norm):
    """In float64 on both sides: the first conv's bias gradient is a sum
    over 8,192 output voxels that cancel, whose f32 value depends on the
    order of the sum (the port's on one torch thread lies 5.9e-5 to 2.8e-4
    of it from the JAX package's). D's f32 path is held in the engine and
    trainer tests."""
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 32, 2))
    v32 = jax.jit(JD3(4, 3, norm, dtype=jnp.float32).init)(
        jax.random.key(1), jnp.asarray(x, jnp.float32))
    td = NLayerDiscriminator3D(2, 4, 3, norm)
    assert td(_to_torch(x.astype(np.float32))).shape == (2, 1, 2, 2, 2)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda v: v.astype(jnp.float64), v32)
        _check(JD3(4, 3, norm, dtype=jnp.float64), v64, td.double(),
               jnp.asarray(x), zero_modules=("conv1", "conv2", "conv3")
               if norm == "instance" else ())
    td.float()


def _count_jax(module, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    shapes_out = jax.eval_shape(
        lambda *a: module.init(jax.random.key(0), *a), *args)
    return sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes_out["params"]))


def _count_torch(make):
    with torch.device("meta"):
        net = make()
    return sum(p.numel() for p in net.parameters())


def test_parameter_counts_at_full_width():
    nd, size = 6, 64
    vol = (1, size, size, size)
    counts = {
        "G linear instance": (
            _count_jax(JG3(1, nd, 64, "linear", True, "instance"),
                       vol + (1,), (nd, 3)),
            _count_torch(lambda: UnetGenerator3D(1, 1, nd, 64, "linear",
                                                 True, "instance"))),
        "G deconvolution batch": (
            _count_jax(JG3(1, nd, 64, "deconvolution", True, "batch"),
                       vol + (1,), (nd, 3)),
            _count_torch(lambda: UnetGenerator3D(1, 1, nd, 64,
                                                 "deconvolution", True,
                                                 "batch"))),
        "D instance": (_count_jax(JD3(64, 3, "instance"), vol + (2,)),
                       _count_torch(lambda: NLayerDiscriminator3D(
                           2, 64, 3, "instance"))),
        "UNet3D base 64": (_count_jax(JUNet3D(1, 2), vol + (1,)),
                           _count_torch(lambda: UNet3D(1, 2))),
    }
    print("parameter counts (JAX, port):", counts)
    for name, (j, t) in counts.items():
        assert j == t, (name, j, t)
    # the six fused 8-tap downs: 792 * C_in * C_out weights each
    assert counts["G linear instance"][0] > 550e6
