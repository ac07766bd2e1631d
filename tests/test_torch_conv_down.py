"""The port's k4-s2-p1 down-conv (``ops/conv.py``) against the JAX
benchmark script's ``conv_pallas`` (which runs itself in interpret mode on
the CPU) and ``conv_xla``: float32 within 1e-5 of the largest output
magnitude, bfloat16 within 1e-2 of it (one bf16 rounding of each output),
C_in < 8 refused by both, and a CPU tensor taking the plain version. The
largest gaps are printed (``-s``)."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.bench.conv_down import LAYERS
from semantic_segmentation_torch.ops.conv import conv_down4, conv_down4_ref

_SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "bench_conv_down.py"


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_conv_down", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, H, W, C_in, C_out)
SHAPES = [(2, 16, 16, 8, 16), (2, 8, 8, 64, 32), (2, 16, 16, 12, 8),
          (2, 2, 2, 16, 8)]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (0.05 * rng.standard_normal((4, 4, cin, cout))).astype(np.float32)
    return x, k


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_conv_pallas_and_xla_f32(bench, shape):
    x, k = _inputs(shape)
    ours = conv_down4_ref(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert ours.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[4])
    gaps = {}
    for name in ("conv_pallas", "conv_xla"):
        ref = np.asarray(getattr(bench, name)(jnp.asarray(x), jnp.asarray(k)))
        gaps[name] = _rel(ours, ref)
        assert gaps[name] <= 1e-5, (name, gaps[name])
    print(f"f32 {shape}: relative gaps {gaps}")


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(
    map(str, s)))
def test_plain_matches_conv_pallas_bf16(bench, shape):
    x, k = _inputs(shape, seed=1)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    ref = bench.conv_pallas(xb, kb)
    assert ref.dtype == jnp.bfloat16
    # the same bf16 values on both sides
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    kt = torch.from_numpy(np.array(kb.astype(jnp.float32))).bfloat16()
    ours = conv_down4_ref(xt, kt)
    assert ours.dtype == torch.bfloat16
    gap = _rel(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert gap <= 1e-2, gap
    print(f"bf16 {shape}: relative gap {gap:.3e}")


@pytest.mark.parametrize("cin", [1, 2])
def test_small_c_in_is_refused_by_both(bench, cin):
    x, k = _inputs((2, 8, 8, cin, 8))
    with pytest.raises(NotImplementedError):
        bench.conv_pallas(jnp.asarray(x), jnp.asarray(k))
    with pytest.raises(NotImplementedError):
        conv_down4(torch.from_numpy(x), torch.from_numpy(k))
    # the plain version computes any C_in (the library layers' math)
    ours = conv_down4_ref(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert _rel(ours, bench.conv_xla(jnp.asarray(x), jnp.asarray(k))) <= 1e-5


def test_cpu_tensor_takes_the_plain_version():
    x, k = _inputs(SHAPES[2])
    kernels.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        xt, kt = torch.from_numpy(x).to(dtype), torch.from_numpy(k).to(dtype)
        assert torch.equal(conv_down4(xt, kt), conv_down4_ref(xt, kt))
    assert kernels.LAUNCHES["conv_down4"] == 0


@pytest.mark.parametrize("x_shape,w_shape", [((2, 7, 8, 8), (4, 4, 8, 8)),
                                             ((2, 8, 8, 8), (3, 3, 8, 8)),
                                             ((8, 8, 8), (4, 4, 8, 8))])
def test_bad_shapes_are_refused(x_shape, w_shape):
    with pytest.raises(ValueError):
        conv_down4(torch.zeros(x_shape), torch.zeros(w_shape))


def test_bench_bounds_and_weighted_sums():
    """The bench's per-layer bounds at batch 2: the 128^2..32^2 layers
    bound by the tensor cores at 2.15 GFLOP (2.17 us), the 512-channel
    layers at 16^2..2^2 by their 8.4 MB bf16 weight (2.5 to 2.7 us); the
    sum over the 9 layers the kernel takes, weighted by mult, about 59 us."""
    from semantic_segmentation_torch.bench.conv_down import (LAYERS,
                                                             layer_bound,
                                                             summarize)
    rows = []
    for tag, hw, cin, cout, mult in LAYERS:
        ms, why = layer_bound(hw, cin, cout)
        row = {"layer": tag, "cin": cin, "mult": mult, "bound_us": ms * 1e3,
               "cudnn_us": 10.0}
        if cin >= 8:
            row.update(kernel_err=0.0, kernel_us=20.0, plain_us=30.0)
        rows.append(row)
        if tag in ("G_d2", "G_d3", "G_d4", "D_c1", "D_c2"):
            assert why == "operations" and abs(ms * 1e3 - 2.1714) < 1e-3
        if tag in ("G_d5", "G_d6", "G_d7", "G_d8"):
            assert why == "bytes" and 2.5 < ms * 1e3 < 2.71
    s = summarize(rows)
    assert s["kernel_layers"] == ["G_d2", "G_d3", "G_d4", "G_d5", "G_d6",
                                  "G_d7", "G_d8", "D_c1", "D_c2"]
    assert abs(s["kernel_layers_bound_us"] - 59.06) < 0.01
    # a layer the kernel does not take counts cuDNN's time in the total
    assert s["weighted_fwd_us"]["kernel"] == 7 * 3 * 20 + 2 * 2 * 20 + \
        3 * 10 + 2 * 10


@pytest.mark.parametrize("layer", [r for r in LAYERS if r[2] >= 8],
                         ids=lambda r: r[0])
def test_plan_fills_the_card_at_flagship_layers(layer):
    """Every flagship layer the kernel takes: the wgmma path with at least
    one CTA per SM of an H100 (132), K split into ranges of whole K-tiles
    that cover it exactly (the last may be shorter), swap-AB exactly where
    M < 64, and a workspace that holds one f32 tile per CTA."""
    from semantic_segmentation_torch.ops.conv import (K_TILE, N_TILE, SMS,
                                                      conv_down4_k_ranges,
                                                      conv_down4_plan,
                                                      x_tma_box)
    _, hw, cin, cout, _ = layer
    m, k = 2 * (hw // 2) ** 2, 16 * cin
    plan = conv_down4_plan(2, hw, hw, cin, cout)
    assert plan.path == "wgmma" and plan.ctas >= SMS == 132
    assert plan.swap == (m < 64)
    assert plan.rows >= m if plan.swap else plan.rows == 64
    assert plan.tiles == -(-m // plan.rows) * -(-cout // N_TILE)
    assert plan.ctas == plan.tiles * plan.split
    assert plan.k_tiles * K_TILE == k
    ranges = conv_down4_k_ranges(plan)
    assert len(ranges) == plan.split and ranges[0][0] == 0
    assert ranges[-1][1] == plan.k_tiles
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    assert all(b - a == plan.k_per_split for a, b in ranges[:-1])
    assert plan.workspace_bytes == (
        plan.split * plan.tiles * plan.rows * N_TILE * 4
        if plan.split > 1 else 0)
    # the pixel tile by one TMA box on G_d2..G_d6, by cp.async on the
    # 8-pixel tiles of G_d7 and G_d8; a box holds exactly a tile's pixels
    assert plan.x_tma == (plan.rows >= 32)
    tb, th, tw = x_tma_box(plan.rows, hw // 2, hw // 2, cin)
    assert tb * th * tw == plan.rows and (hw // 2) % tw == 0


@pytest.mark.parametrize("shape", [(2, 32, 32, 12, 64), (2, 32, 32, 16, 20),
                                   (2, 32, 32, 12, 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_off_multiples_of_8_takes_the_generic_path(shape):
    from semantic_segmentation_torch.ops.conv import conv_down4_plan
    plan = conv_down4_plan(*shape)
    assert plan.path == "generic" and plan.split == 1 and not plan.x_tma
    assert plan.workspace_bytes == 0


def test_bench_cold_sums_weight_rows_as_the_warm_ones():
    """The cold summary weights each row by its uses, as the warm one does,
    and lets cuDNN's cold time stand in where the kernel refuses a layer."""
    from semantic_segmentation_torch.bench.conv_down import summarize
    rows = []
    for i, (tag, hw, cin, cout, mult) in enumerate(LAYERS):
        row = {"layer": tag, "cin": cin, "mult": mult, "bound_us": 1.0,
               "cudnn_us": 10.0 + i, "cudnn_cold_us": 10.0 + i}
        if cin >= 8:
            row.update(kernel_err=0.0, kernel_us=20.0 + i,
                       kernel_cold_us=20.0 + i, plain_us=30.0)
        rows.append(row)
    s = summarize(rows)
    assert s["weighted_fwd_cold_us"] == {
        f: s["weighted_fwd_us"][f] for f in ("cudnn", "kernel")}
    assert s["kernel_layers_fwd_cold_us"] == {
        f: s["kernel_layers_fwd_us"][f] for f in ("cudnn", "kernel")}
    for r in rows:
        r["kernel_cold_us"] = r.get("kernel_cold_us", 0.0) * 2
        r["cudnn_cold_us"] *= 3
    s2 = summarize(rows)
    assert s2["kernel_layers_fwd_cold_us"]["kernel"] == pytest.approx(
        2 * s["kernel_layers_fwd_us"]["kernel"])
    assert s2["weighted_fwd_cold_us"]["cudnn"] == pytest.approx(
        3 * s["weighted_fwd_us"]["cudnn"])
