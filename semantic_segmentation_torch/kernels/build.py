"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all started
together) into ``build/kernels/lib<name>-<hash>.so`` at the repository root,
where ``<hash>`` covers the source, every header ``csrc/*.cuh`` (which any
source may include) and the flags: an edited source or header gets a fresh
library and an unchanged one is reused. The sources expose plain C
functions, so no PyTorch header is compiled (seconds, not minutes).

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each source's entry point: (argtypes, restype int =
# cudaGetLastError() after the launch).
SIGNATURES = {
    # warp_affine_f32(img, coef, out, n, h, w, c, cval, stream)
    "warp_affine": ("warp_affine_f32",
                    [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
    # equalize_uint8(in, out, n, hw, c, cluster, slice, keep, smem, stream)
    "equalize_uint8": ("equalize_uint8", [_P, _P] + [_I] * 7 + [_P]),
    # histogram256(in, out, n, hw, cluster, slice, smem, stream)
    "histogram256": ("histogram256", [_P, _P] + [_I] * 5 + [_P]),
    # conv_down4_bf16(x, w, y, ws, tickets, b, h, w, c, cout, rows, swap,
    #                 x_tma, split, k_per_split, stream)
    "conv_down4": ("conv_down4_bf16", [_P] * 5 + [_I] * 10 + [_P]),
}

_loaded: dict = {}                 # name -> its loaded ctypes function


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` each, all in parallel. Returns the wall seconds per built name.
    Raises with the compiler's output if any build fails."""
    import time
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # build to a private file, then rename: concurrent builders never see
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, errors = {}, []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}] {log.strip()}")
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def kernel(name: str):
    """The ctypes function of ``csrc/<name>.cu``, building it on first use."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return _loaded[name]


def launch(name: str, device, *args):
    """Launch ``csrc/<name>.cu``'s entry point with ``args`` on ``device``'s
    current stream (appended as the last argument), raise if the launch was
    refused, and count it in ``kernels.LAUNCHES[name]``."""
    import torch

    from semantic_segmentation_torch import kernels
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{'cudaError' if err > 0 else 'code'} {err}")
    kernels.LAUNCHES[name] += 1
