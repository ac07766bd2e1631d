"""Check and time the port's image kernels on the card against their plain
versions, at the shapes of ``scripts/bench_pallas.py`` (whose port this is):
the equalize and the histogram on (4, 256, 256) random uint8 images, the
warp on (2, 256, 256, 1) binary masks under ``sample_affine_batch`` draws.
Times are device time per call (torch.profiler, inputs warm in L2); the
wrapper's call time (CUDA events, host work included) is beside them.

    python -m semantic_segmentation_torch.bench.kernels
"""

from __future__ import annotations

import json

import numpy as np
import torch

from semantic_segmentation_torch.bench.timing import (card_line, device_ms,
                                                      time_ms)
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
                   wrapper_call_ms=time_ms(kernel_fn, ITERS),
                   plain_ms=device_ms(plain_fn, ITERS // 4))
        records[name] = rec
    return records


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench.kernels needs a CUDA card")
    print(json.dumps({"card": card_line(),
                      "device": torch.cuda.get_device_name(0),
                      "kernels": run()}))


if __name__ == "__main__":
    main()
