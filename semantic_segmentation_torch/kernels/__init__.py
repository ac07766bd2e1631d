"""Hand-written CUDA kernels of the port, and their launch counts.

Each kernel lives in ``csrc/<name>.cu`` behind a plain C entry point, is
built by ``build.py`` with ``nvcc`` into its own shared library at first use,
and is called through ``ctypes`` by its wrapper in the module that owns the
function (``ops/augment.py``, ``ops/image.py``, ``ops/conv.py``). A wrapper
adds one to ``LAUNCHES[name]`` where it launches its kernel and nowhere else,
so a run can show that the main path went through the kernels.

No kernel has a backward. A wrapper whose input can carry a gradient (a
float tensor) refuses one that requires grad, on the CPU as on the card,
rather than cut the gradient without a word (``refuse_grad``); a uint8
tensor cannot require grad.
"""

LAUNCHES = {"warp_affine": 0, "equalize_uint8": 0, "histogram256": 0,
            "conv_down4": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def refuse_grad(name: str, *tensors):
    """Raise if any of ``tensors``, inputs of ``name``'s wrapper, requires
    grad."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel "
                           "has no backward; detach it first")
