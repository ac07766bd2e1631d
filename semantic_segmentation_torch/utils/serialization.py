"""The JAX package's single-file pytrees (``semantic_segmentation_tpu/utils/
serialization.py``: flax's ``to_bytes``/``from_bytes``), read and written
without flax or msgpack: the machine with the card has neither.

flax's format is msgpack of the state dict: maps with string keys, and
array leaves as msgpack extension types whose payload is itself msgpack of
``(shape, dtype name, C-order bytes)`` (ext 1, an ndarray; ext 3, a numpy
scalar). An array over ``MAX_CHUNK_SIZE`` bytes is written as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": flat chunk, ...}}``. This module decodes maps, arrays, strings,
bins, integers, floats, booleans and nil, and the two extension types;
array leaves come back as CPU tensors (``bfloat16`` through
``torch.frombuffer``, numpy has no such dtype), scalars as 0-d tensors.
``save_pytree`` writes nested dicts of tensors, numpy arrays and numbers
in the same format, byte for byte what ``to_bytes`` writes for them.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are chunked
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


# -- decoding ---------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, ext_hook=None):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                                0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H",
                                         0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack: extension type {code}")
        return self.ext_hook(code, data)


def unpackb(data: bytes, ext_hook=None):
    r = _Reader(data, ext_hook)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes")
    return out


def _array_from_bytes(data: bytes) -> torch.Tensor:
    shape, dtype, raw = unpackb(data)
    shape = tuple(shape)
    if dtype == "bfloat16":
        t = (torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
             if raw else torch.empty(0, dtype=torch.bfloat16))
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).copy())
    return t.reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data).reshape(())
    raise ValueError(f"msgpack: extension type {code} (not an array)")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes):
    """flax ``msgpack_restore``: the nested dict of ``to_bytes``' output,
    array leaves as CPU tensors."""
    return _unchunk(unpackb(data, _ext_hook))


def load_pytree(path: str):
    """The nested dict a ``.msgpack`` file of the JAX package holds."""
    with open(path, "rb") as f:
        return loads(f.read())


# -- encoding ---------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple):
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int):
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_bytes(out: bytearray, b: bytes):
    _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_bytes(shape, dtype: str, raw: bytes) -> bytes:
    """flax ``_ndarray_to_bytes``: msgpack of (shape, dtype, bytes)."""
    out = bytearray()
    _pack_len(out, 3, 0x90, 0x0F, (None, 0xDC, 0xDD))
    _pack_len(out, len(shape), 0x90, 0x0F, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(out, int(d))
    _pack(out, dtype)
    _pack_bytes(out, raw)
    return bytes(out)


def _leaf_parts(x):
    """(shape, dtype name, C-order bytes) of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = _TORCH_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        return tuple(t.shape), name, raw
    a = np.asarray(x)
    return a.shape, a.dtype.name, a.tobytes("C")


def _pack(out: bytearray, v):
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int) and not isinstance(v, np.generic):
        _pack_int(out, v)
    elif isinstance(v, float) and not isinstance(v, np.generic):
        out += struct.pack(">Bd", 0xCB, v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, bytes):
        _pack_bytes(out, v)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_bytes(*_leaf_parts(
            np.asarray(v))))
    elif isinstance(v, (torch.Tensor, np.ndarray)):
        _pack_ext(out, _EXT_NDARRAY, _array_bytes(*_leaf_parts(v)))
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def _chunk(tree):
    """flax ``_chunk_array_leaves_in_place``: array leaves over
    ``MAX_CHUNK_SIZE`` bytes as the chunked map."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        itemsize = (tree.element_size() if isinstance(tree, torch.Tensor)
                    else tree.dtype.itemsize)
        n = int(np.prod(tree.shape))
        if n * itemsize > MAX_CHUNK_SIZE:
            step = max(1, MAX_CHUNK_SIZE // itemsize)
            flat = tree.reshape(-1)
            chunks = [flat[i:i + step] for i in range(0, n, step)]
            return {_CHUNKED: True,
                    "shape": {str(i): int(d) for i, d in
                              enumerate(tree.shape)},
                    "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def dumps(tree) -> bytes:
    """flax ``msgpack_serialize`` of a nested dict."""
    out = bytearray()
    _pack(out, _chunk(tree))
    return bytes(out)


def save_pytree(tree, path: str):
    """Write ``tree`` (nested dicts of tensors, numpy arrays and numbers)
    as the JAX package's ``save_pytree`` writes a pytree."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(dumps(tree))


def to_numpy_tree(tree):
    """The tree with every tensor leaf as a float32 numpy array (the weight
    bridge's input)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree
