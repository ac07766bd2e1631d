"""Check and time the port's image kernels on the card against their plain
versions, at the shapes of ``scripts/bench_pallas.py`` (whose port this is):
the equalize and the histogram on (4, 256, 256) random uint8 images, the
warp on (2, 256, 256, 1) binary masks under ``sample_affine_batch`` draws.
Times are device time per call (torch.profiler, inputs warm in L2); the
wrapper's call time (CUDA events, host work included) is beside them.

Then the two cluster kernels at the shapes that measure them
(``time_cases``): the equalize at the trainer's (2, 256, 256, 1) on a
full-width generator's image and on random bytes, and at the ISIC
family's three interleaved channels, (2, 256, 256, 3) and (2, 224, 224, 3),
on an RGB generator's image and on random bytes, warm and cold; the
histogram at
(4, 256, 256) on random and constant images, each warm, and both at
(64, 512, 512) cold (L2 flushed before each call), where a share of the
HBM bound means something. Each case gives the kernel's device time, the
call's device time (every kernel one wrapper call launches) and the bytes
bound.

    python -m semantic_segmentation_torch.bench.kernels

``time_cases`` uses only the wrappers' public functions, so
``scripts/ab_torch_image_kernels.py`` runs it against an older checkout's
package too.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from semantic_segmentation_torch.bench.timing import (bound_ms, card_line,
                                                      device_ms, time_ms)
from semantic_segmentation_torch.ops import augment, image

# device kernel names, to pick the kernel out of the profiler trace
SYMBOLS = {"equalize_uint8": "equalize_kernel",
           "histogram256": "histogram256_kernel",
           "warp_affine": "warp_affine_kernel"}


def _check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"bench.kernels: {msg}")


def inputs():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 256, 256),
                                         dtype=np.uint8)).cuda()
    masks = torch.from_numpy((rng.random((2, 256, 256, 1)) > 0.5)
                             .astype(np.float32)).cuda()
    mats = augment.sample_affine_batch(
        2, 256, 256, torch.Generator(device="cuda").manual_seed(3))
    return imgs, masks, mats


ITERS = 200                     # timed kernel calls; a quarter for plain


def generator_image(dev="cuda", size: int = 256, channels: int = 1):
    """(2, size, size, channels) uint8: the fake-image branch's input to the
    equalize, a full-width generator (random weights from seed 0; unet_256
    at 256^2, the ISIC224 preset's resnet_9blocks at other sizes) on two
    thresholded synthetic masks, min-max normalised and quantised as the
    trainer does."""
    from semantic_segmentation_torch.data.synthetic import SyntheticSegDataset
    from semantic_segmentation_torch.models.pix2pix.networks import define_G
    from semantic_segmentation_torch.ops.nas import init_arch_params
    init = torch.Generator().manual_seed(0)
    netG = "unet_256" if size == 256 else "resnet_9blocks"
    G = define_G(1, channels, netG, 64, True, init).to(dev).eval()
    arch = init_arch_params(init)["upconv"].to(dev)
    ds = SyntheticSegDataset(n=2, size=size, seed=3)
    masks = torch.from_numpy(np.stack([ds[i]["mask"] for i in range(2)]))
    mask = image.threshold_mask(masks.float().to(dev), 0.1)
    with torch.no_grad():
        out = G(mask.permute(0, 3, 1, 2), arch).permute(0, 2, 3, 1)
    return image.to_uint8(image.minmax_normalize(out)).contiguous()


def family(name: str, shape, dev="cuda", seed: int = 0):
    """uint8 images of ``shape``: "random" bytes, a "constant" plane, a
    "two_value" plane (10 or 200, 30% / 70%), or "generator_like", a
    min-max normalised smooth field."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if name == "random":
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)
    if name == "constant":
        return torch.full(shape, 77, device=dev, dtype=torch.uint8)
    if name == "two_value":
        u = torch.rand(shape, generator=g, device=dev)
        return torch.where(u < 0.3, 10, 200).to(torch.uint8)
    if name == "generator_like":
        f = torch.tanh(torch.randn(shape, generator=g, device=dev))
        return image.to_uint8(image.minmax_normalize(f))
    raise KeyError(name)


# (kernel, family, shape, cold): the shapes that measure the cluster
# kernels. Warm at the trainers' and the benchmark's shapes (the ISIC
# family's C = 3 also cold); cold at (64, 512, 512), whose 16.8 MB could
# otherwise be served from the 50 MB L2.
ISIC_CASES = [("equalize_uint8", fam, (2, hw, hw, 3), cold)
              for hw in (256, 224) for fam in ("generator_image", "random")
              for cold in (False, True)]
CASES = [("equalize_uint8", "generator_image", (2, 256, 256, 1), False),
         ("equalize_uint8", "random", (2, 256, 256, 1), False),
         *ISIC_CASES,
         ("equalize_uint8", "random", (64, 512, 512, 1), True),
         ("equalize_uint8", "generator_like", (64, 512, 512, 1), True),
         ("histogram256", "random", (4, 256, 256), False),
         ("histogram256", "constant", (4, 256, 256), False),
         ("histogram256", "random", (64, 512, 512), True),
         ("histogram256", "constant", (64, 512, 512), True)]


def case_bound(kernel: str, shape):
    """(bound ms, 'bytes' or 'operations'): the equalize reads and writes
    each byte once, with a histogram add and a LUT lookup per byte; the
    histogram reads each byte once and writes (N, 256) int32 counts, one
    add per byte. Integer work counted at the f32 rate (the data sheet
    gives no int32 rate outside the tensor cores)."""
    n = int(np.prod(shape))
    if kernel == "equalize_uint8":
        return bound_ms(2 * n, 2 * n)
    return bound_ms(n + shape[0] * 256 * 4, n)


def time_cases(gen_image=None, iters: int = ITERS):
    """One record per entry of ``CASES``, over ``iters`` calls (a quarter
    as many cold): the kernel's device time per call (``kernel_ms``), the
    call's (``call_ms``: every kernel the wrapper launches, a zeroing fill
    included), the bound and the share of it the kernel reaches.
    ``gen_image``: the (2, 256, 256, 1) generator image (made here if not
    given, as are the RGB ones)."""
    fns = {"equalize_uint8": image.equalize_uint8,
           "histogram256": image.histogram256}
    records = []
    made = {} if gen_image is None else {(256, 1): gen_image}
    for kernel, fam, shape, cold in CASES:
        if fam == "generator_image":
            key = (shape[1], shape[3])
            if key not in made:
                made[key] = generator_image(size=key[0], channels=key[1])
            x = made[key]
        else:
            x = family(fam, shape)
        fn = fns[kernel]
        b, why = case_bound(kernel, shape)
        n = iters // 4 if cold else iters
        k_ms = device_ms(lambda: fn(x), n, SYMBOLS[kernel], cold=cold)
        call_ms = device_ms(lambda: fn(x), n, cold=cold)
        records.append({"kernel": kernel, "family": fam, "shape": list(shape),
                        "cold": cold, "kernel_ms": k_ms, "call_ms": call_ms,
                        "bound_ms": b, "bound_by": why,
                        "share_of_bound": b / k_ms})
    return records


def run():
    """{kernel name: record}. Raises RuntimeError where a kernel and its
    plain version disagree: the equalize and the histogram must match bit
    for bit (the histogram also ``np.bincount``), the warp within 1e-4 with
    identical > 0.1 masks."""
    imgs, masks, mats = inputs()
    planes = imgs[..., None]                       # NHWC, C = 1
    calls = {
        "equalize_uint8": (planes, lambda: image.equalize_uint8(planes),
                           lambda: image.equalize_uint8_ref(planes)),
        "histogram256": (imgs, lambda: image.histogram256(imgs),
                         lambda: image.histogram256_ref(imgs)),
        "warp_affine": (masks, lambda: augment.warp_affine_batch(masks, mats),
                        lambda: augment.warp_affine_batch_ref(masks, mats)),
    }
    records = {}
    for name, (x, kernel_fn, plain_fn) in calls.items():
        out, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rec = {"shape": list(x.shape), "max_abs_err": err}
        if name == "warp_affine":
            _check(err < 1e-4 and torch.equal(out > 0.1, ref > 0.1),
                   f"warp: max |err| {err} or > 0.1 masks differ")
        else:
            _check(torch.equal(out, ref), f"{name}: not bit-exact ({err})")
        if name == "histogram256":
            counts = np.stack([np.bincount(p.ravel(), minlength=256)
                               for p in imgs.cpu().numpy()])
            _check(np.array_equal(out.cpu().numpy(), counts),
                   "histogram256: differs from np.bincount")
        rec.update(ms=device_ms(kernel_fn, ITERS, SYMBOLS[name]),
                   call_ms=device_ms(kernel_fn, ITERS),
                   wrapper_call_ms=time_ms(kernel_fn, ITERS),
                   plain_ms=device_ms(plain_fn, ITERS // 4))
        records[name] = rec
    return records


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench.kernels needs a CUDA card")
    print(json.dumps({"card": card_line(),
                      "device": torch.cuda.get_device_name(0),
                      "kernels": run(), "cases": time_cases()}))


if __name__ == "__main__":
    main()
