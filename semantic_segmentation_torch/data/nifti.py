"""Minimal native NIfTI-1 reader/writer (no nibabel) — the port's own copy
of ``semantic_segmentation_tpu/data/nifti.py``, pure numpy and identical,
so a file written by either package reads the same in the other.

Covers what the GenSeg-3D pipeline needs (``GenSeg-3D/data/nifti_dataset.py``,
``util/mri_viewer.py``): .nii / .nii.gz volumes, the common datatypes,
scl_slope/scl_inter scaling, and the sform affine. Little-endian NIfTI-1
only (the standard case).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_nifti(path: str):
    """Returns (data ndarray in file axis order (x, y, z, ...), affine 4x4)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"not a little-endian NIfTI-1 file: {path}")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    srow = np.array([
        struct.unpack_from("<4f", raw, 280),
        struct.unpack_from("<4f", raw, 296),
        struct.unpack_from("<4f", raw, 312),
        (0.0, 0.0, 0.0, 1.0),
    ], dtype=np.float64)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=_DTYPES[datatype], count=count,
                         offset=vox_offset)
    data = data.reshape(shape, order="F").copy()
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return data, srow


def write_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None):
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (data.ndim,) + data.shape + (1,) * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 0.0, *(1.0,) * 7)  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)             # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)               # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                 # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr_bytes = bytes(hdr) + b"n+1\x00"
    payload = hdr_bytes + data.tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
