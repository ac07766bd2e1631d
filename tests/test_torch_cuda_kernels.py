"""The port's CUDA kernels against their plain PyTorch versions, on the card
and at the trainer's and the benchmarks' shapes: the warp exact (max |err|
0, identical > 0.1 masks; identity and flip exact) at c = 1 and 3, n = 1 to
3 and a width off multiples of 4; the equalize and the histogram bit for
bit (the histogram also against np.bincount) on random, constant, two-value
and generator-like images, at the benchmark's (64, 512, 512), at N = 1 and
N = 70,000, at hw off multiples of 16, at c = 3, on a view 1 byte off a
16-byte boundary, with slices kept in and streamed past shared memory,
and the same from call to call; the down-conv within 1e-2 of the plain version's largest magnitude
(one bf16 rounding of each output; f32 sums in another order) at the
flagship's layers, at M = 2, 8, 32 and 130, at a split whose last K range is
ragged and at shapes off multiples of 8 (the generic path), and the same
bit for bit from call to call. Each kernel call counts one launch. The
wrappers with float inputs refuse one that requires grad (no kernel has a
backward) and launch nothing. Marked
``cuda``: without a card these skip. On a machine with one (no JAX needed
there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from semantic_segmentation_torch import kernels
from semantic_segmentation_torch.bench.conv_down import LAYERS, layer_inputs
from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
from semantic_segmentation_torch.ops import augment, image
from semantic_segmentation_torch.ops.conv import (conv_down4,
                                                  conv_down4_k_ranges,
                                                  conv_down4_plan,
                                                  conv_down4_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


def _warp_input(kind: str, dev):
    if kind == "mask":
        ds = SyntheticSegDataset(n=2, size=256, seed=3)
        x = np.stack([ds[i]["mask"] for i in range(2)]).astype(np.float32)
        return torch.from_numpy(x).to(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    return torch.rand(2, 256, 256, 3, generator=g, device=dev)


@pytest.mark.parametrize("kind", ["mask", "rgb"])
def test_warp_kernel_matches_plain(dev, kind):
    x = _warp_input(kind, dev)
    mats = augment.sample_affine_batch(
        2, 256, 256, torch.Generator(device=dev).manual_seed(5))
    before = kernels.LAUNCHES["warp_affine"]
    out = augment.warp_affine_batch(x, mats)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["warp_affine"] == before + 1
    ref = augment.warp_affine_batch_ref(x, mats)
    assert (out - ref).abs().max().item() == 0.0
    assert torch.equal(out > 0.1, ref > 0.1)


# (n, h, w, c): each channel count and batch size, a width off multiples of
# 4 (the masked scalar stores) and one that is a multiple (float4 stores);
# the ISIC224 trainer's masks
@pytest.mark.parametrize("shape", [(1, 64, 64, 1), (3, 64, 64, 1),
                                   (1, 40, 37, 3), (3, 33, 50, 3),
                                   (2, 31, 45, 1), (2, 224, 224, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_warp_kernel_exact_across_shapes(dev, shape):
    n, h, w, _ = shape
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand(shape, generator=g, device=dev)
    mats = augment.sample_affine_batch(n, h, w, g)
    out = augment.warp_affine_batch(x, mats)
    ref = augment.warp_affine_batch_ref(x, mats)
    assert (out - ref).abs().max().item() == 0.0
    assert torch.equal(out > 0.1, ref > 0.1)


def test_warp_kernel_identity_and_flip_exact(dev):
    x = _warp_input("rgb", dev)
    eye = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    assert torch.equal(augment.warp_affine_batch(x, eye), x)
    flip = torch.tensor([[-1.0, 0.0, 255.0], [0.0, 1.0, 0.0],
                         [0.0, 0.0, 1.0]], device=dev).expand(2, 3, 3)
    assert torch.equal(augment.warp_affine_batch(x, flip.contiguous()),
                       x.flip(2))


def _planes(family: str, dev):
    g = torch.Generator(device=dev).manual_seed(6)
    if family == "random":
        return torch.randint(0, 256, (2, 256, 256, 1), generator=g,
                             device=dev, dtype=torch.uint8)
    if family == "random_3ch":
        return torch.randint(0, 256, (2, 64, 48, 3), generator=g, device=dev,
                             dtype=torch.uint8)
    if family == "constant":
        return torch.full((2, 256, 256, 1), 77, device=dev, dtype=torch.uint8)
    if family == "two_value":
        u = torch.rand(2, 256, 256, 1, generator=g, device=dev)
        return torch.where(u < 0.3, 10, 200).to(torch.uint8)
    # a min-max normalised smooth field, as the generator's output gives
    f = torch.tanh(torch.randn(2, 256, 256, 1, generator=g, device=dev))
    return image.to_uint8(image.minmax_normalize(f))


@pytest.mark.parametrize("family", ["random", "random_3ch", "constant",
                                    "two_value", "generator_like"])
def test_equalize_kernel_bit_exact(dev, family):
    x = _planes(family, dev)
    before = kernels.LAUNCHES["equalize_uint8"]
    out = image.equalize_uint8(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["equalize_uint8"] == before + 1
    assert torch.equal(out, image.equalize_uint8_ref(x))


@pytest.mark.parametrize("family", ["random", "constant", "two_value",
                                    "generator_like"])
@pytest.mark.parametrize("n", [2, 4])
def test_histogram_kernel_bit_exact(dev, family, n):
    x = _planes(family, dev)[..., 0].repeat(2, 1, 1)[:n].contiguous()
    before = kernels.LAUNCHES["histogram256"]
    out = image.histogram256(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["histogram256"] == before + 1
    assert torch.equal(out, image.histogram256_ref(x))
    ref = np.stack([np.bincount(p.ravel(), minlength=256)
                    for p in x.cpu().numpy()])
    np.testing.assert_array_equal(out.cpu().numpy(), ref)


def test_histogram_kernel_odd_size(dev):
    x = _planes("random_3ch", dev)[..., 0][:, :63, :45].contiguous()
    assert torch.equal(image.histogram256(x), image.histogram256_ref(x))


def _random_u8(shape, dev, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=dev,
                         dtype=torch.uint8)


def _unaligned(x):
    """The same values in a contiguous view that starts 1 byte past a
    16-byte boundary."""
    base = torch.empty(x.numel() + 16, dtype=torch.uint8, device=x.device)
    view = base[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 1 and view.is_contiguous()
    return view


def _both_exact(x):
    """The equalize on the NHWC batch ``x`` and the histogram on its first
    channel, each one launch and bit-exact against its plain version (the
    histogram also against np.bincount)."""
    planes = x[..., 0].contiguous() if x.shape[-1] > 1 else x[..., 0]
    before = dict(kernels.LAUNCHES)
    eq, hist = image.equalize_uint8(x), image.histogram256(planes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["equalize_uint8"] == before["equalize_uint8"] + 1
    assert kernels.LAUNCHES["histogram256"] == before["histogram256"] + 1
    assert torch.equal(eq, image.equalize_uint8_ref(x))
    assert torch.equal(hist, image.histogram256_ref(planes))
    ref = np.stack([np.bincount(p.ravel(), minlength=256)
                    for p in planes.cpu().numpy()])
    np.testing.assert_array_equal(hist.cpu().numpy(), ref)
    return eq, hist


# the benchmark's cold shape; N = 1; hw off multiples of 16 (250^2 = 62,500
# and 7 x 9); an image too large to keep its slices in shared memory; c = 3
# at 256^2 and 224^2 (the ISIC trainers' RGB fakes); 70,000 tiny images
# (past the old 65,535-image grid limit)
CLUSTER_SHAPES = [(64, 512, 512, 1), (1, 256, 256, 1), (2, 250, 250, 1),
                  (3, 7, 9, 1), (1, 2048, 2048, 1), (2, 256, 256, 3),
                  (2, 224, 224, 3), (70000, 8, 8, 1)]


@pytest.mark.parametrize("shape", CLUSTER_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("family", ["random", "constant", "generator_like"])
def test_cluster_kernels_exact_across_shapes(dev, shape, family):
    if family == "random":
        x = _random_u8(shape, dev)
    elif family == "constant":
        x = torch.full(shape, 201, device=dev, dtype=torch.uint8)
    else:
        g = torch.Generator(device=dev).manual_seed(2)
        f = torch.tanh(torch.randn(shape, generator=g, device=dev))
        x = image.to_uint8(image.minmax_normalize(f))
    _both_exact(x)


def test_cluster_kernels_plan_keeps_or_streams_the_slice(dev):
    assert image.hist256_plan(64, 512 * 512, 1, True).keep
    assert not image.hist256_plan(1, 2048 * 2048, 1, True).keep


@pytest.mark.parametrize("shape", [(2, 256, 256, 1), (2, 250, 250, 1),
                                   (2, 64, 48, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_kernels_exact_on_unaligned_view(dev, shape):
    x = _unaligned(_random_u8(shape, dev, seed=12))
    _both_exact(x)


def test_cluster_kernels_bit_identical_calls(dev):
    x = _planes("generator_like", dev)
    eq, hist = _both_exact(x)
    for _ in range(3):
        assert torch.equal(image.equalize_uint8(x), eq)
        assert torch.equal(image.histogram256(x[..., 0]), hist)


def _conv_close(x, w):
    before = kernels.LAUNCHES["conv_down4"]
    out = conv_down4(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_down4"] == before + 1
    ref = conv_down4_ref(x, w)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 1e-2, err.item()


@pytest.mark.parametrize("layer", [r for r in LAYERS if r[2] >= 8],
                         ids=lambda r: r[0])
def test_conv_kernel_matches_plain_at_flagship_layers(dev, layer):
    tag, hw, cin, cout, _ = layer
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = layer_inputs(hw, cin, cout, np.random.default_rng(0), dev)
    _conv_close(x, w)


# C_in and C_out off multiples of 8 take the generic kernel's element loads
@pytest.mark.parametrize("cin,cout", [(12, 64), (16, 20), (12, 20)])
def test_conv_kernel_matches_plain_off_multiples_of_8(dev, cin, cout):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = layer_inputs(32, cin, cout, np.random.default_rng(1), dev)
    _conv_close(x, w)


# (B, H, W, C_in, C_out) at M = 2, 8 and 32 (swap-AB, split-K; C_out 40
# and 136 leave a part-filled C_out tile) and M = 130 (a part-filled pixel
# tile)
SMALL_M = [(1, 2, 4, 64, 40), (2, 4, 4, 256, 64), (2, 8, 8, 128, 136),
           (2, 10, 26, 64, 64)]


@pytest.mark.parametrize("shape", SMALL_M, ids=lambda s: "x".join(map(str, s)))
def test_conv_kernel_matches_plain_at_small_m(dev, shape):
    b, h, w, cin, cout = shape
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin))).to(
        dev, torch.bfloat16)
    wt = torch.from_numpy(0.05 * rng.standard_normal((4, 4, cin, cout))).to(
        dev, torch.bfloat16)
    assert conv_down4_plan(b, h, w, cin, cout).path == "wgmma"
    _conv_close(x, wt)


def test_conv_kernel_ragged_split_and_bit_identical(dev):
    """G_d5 (M = 128) splits K into 9 ranges, the last shorter; G_d8 (M = 2)
    swaps the operands and splits too. Two calls give the same bits."""
    for hw in (16, 2):
        plan = conv_down4_plan(2, hw, hw, 512, 512)
        ranges = conv_down4_k_ranges(plan)
        assert plan.split > 1
        if hw == 16:
            assert ranges[-1][1] - ranges[-1][0] < plan.k_per_split
        x, w = layer_inputs(hw, 512, 512, np.random.default_rng(8), dev)
        _conv_close(x, w)
        first = conv_down4(x, w)
        for _ in range(3):
            assert torch.equal(conv_down4(x, w), first)


@pytest.mark.parametrize("cin", [1, 2])
def test_conv_kernel_refuses_small_c_in(dev, cin):
    x, w = layer_inputs(16, cin, 8, np.random.default_rng(2), dev)
    with pytest.raises(NotImplementedError):
        conv_down4(x, w)


def test_conv_kernel_refuses_float32(dev):
    x, w = layer_inputs(16, 8, 8, np.random.default_rng(3), dev)
    with pytest.raises(TypeError):
        conv_down4(x.float(), w.float())


def _grad_case(name: str, dev):
    x = torch.rand(2, 32, 32, 1, device=dev)
    if name == "warp_affine":
        return lambda t: augment.warp_affine_batch(
            t, torch.eye(3, device=dev).expand(2, 3, 3).contiguous()), x
    if name == "equalize_uint8":
        return lambda t: image.equalize_gamma_chain(t, 0.5), x
    w = torch.rand(4, 4, 8, 16, device=dev, dtype=torch.bfloat16)
    x = torch.rand(2, 32, 32, 8, device=dev, dtype=torch.bfloat16)
    return lambda t: conv_down4(t, w), x


@pytest.mark.parametrize("name", ["warp_affine", "equalize_uint8",
                                  "conv_down4"])
def test_wrappers_refuse_inputs_that_require_grad(dev, name):
    fn, x = _grad_case(name, dev)
    fn(x)                                   # launches without grad
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(x.clone().requires_grad_(True))
    assert kernels.LAUNCHES[name] == 0


def test_exchanges_on_gloo_with_cuda_tensors(dev, tmp_path):
    """The channel gather (float32 and bfloat16), the depth halo with its
    backward and the depth gather of tensor and spatial parallelism: the
    all-reduces of a zero-filled buffer, on two gloo ranks that share the
    card (as ``chip_smoke.py`` phase 7k runs them), equal to the same on
    two CPU ranks."""
    from semantic_segmentation_torch.parallel import harness
    from semantic_segmentation_torch.parallel.launch import RankPool
    got = {}
    for device in ("cuda", "cpu"):
        with RankPool(2, device, backend="gloo", timeout=300.0,
                      workdir=str(tmp_path)) as pool:
            got[device] = pool.run(harness.exchange_probe, device)
    for k, want in got["cpu"].items():
        assert torch.equal(got["cuda"][k], want), k
