"""msgpack for the subset flax writes, on the standard library alone.

tpukit's consolidated checkpoint is `flax.serialization.to_bytes` of its
train state (`tpukit/checkpoint.py:379-409`): msgpack maps with str keys,
arrays as flax's ext type 1, a packed `(shape, dtype name, C-order
bytes)` (`flax/serialization.py` `_ndarray_to_bytes`), and arrays over
`MAX_CHUNK_SIZE` bytes split into a `{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}` map. This codec reads and writes that:

  - `unpackb` decodes every msgpack type (nil, bool, int and uint of every
    width, float32/64, str, bin, array, map, fixext and ext8/16/32); ext 1
    (ndarray) becomes a CPU tensor (`torch.frombuffer`, then one copy;
    "bfloat16" is `torch.bfloat16`), ext 3 (numpy scalar) a 0-dim tensor,
    ext 2 a complex, any other ext an `Ext`; chunked maps are joined back
    into one tensor;
  - `packb` encodes dicts (str keys), lists and tuples, str, bytes, None,
    bool, int, float (as float64), complex (ext 2), tensors and numpy
    arrays (ext 1; over `MAX_CHUNK_SIZE` bytes, chunked as flax does),
    numpy scalars (ext 3) and `Ext`.

It does not reproduce flax's bytes (flax keeps the tree's key order; this
codec keeps the dict's): flax reads what it writes and it reads flax.
"""

from __future__ import annotations

import dataclasses
import struct
import warnings

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3  # flax's `_MsgpackExtType`
MAX_CHUNK_SIZE = 2**30  # flax's: bytes above which an array is chunked
CHUNKED = "__msgpack_chunked_array__"

DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "bool": torch.bool, "complex64": torch.complex64, "complex128": torch.complex128,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


@dataclasses.dataclass(frozen=True)
class Ext:
    """An ext value of a type this codec does not interpret."""

    code: int
    data: bytes


# ------------------------------------------------------------------ decode --


class _Reader:
    def __init__(self, data):
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError(f"msgpack: truncated data at byte {self.pos} (wants {n} more)")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(_LEN[b - 0xC4]))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(_LEN[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(_LEN[b - 0xDB]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(_LEN[b - 0xDD]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(_LEN[b - 0xC7]))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[bytes(key) if isinstance(key, memoryview) else key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _tensor_from(data)
        if code == EXT_NPSCALAR:
            return _tensor_from(data).reshape(())
        if code == EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        return Ext(code, bytes(data))


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = (">B", ">H", ">I")


def _tensor_from(payload: memoryview) -> torch.Tensor:
    """flax's ndarray payload, a packed (shape, dtype name, bytes), as a
    CPU tensor that owns its memory."""
    shape, name, buf = _Reader(payload).value()
    name = str(name, "utf-8") if isinstance(name, memoryview) else name
    if name not in DTYPES:
        raise ValueError(f"msgpack: array dtype {name!r} has no torch dtype")
    dtype = DTYPES[name]
    if len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():  # a read-only buffer: the clone below owns the copy
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(buf, dtype=dtype)
    return flat.reshape(shape).clone()


def _unchunk(tree):
    """Chunked arrays (flax's `_unchunk_array_leaves_in_place`) joined back
    into one tensor each."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data):
    """The value msgpack-encoded in `data` (bytes, bytearray or memoryview).
    Bin values come back as memoryviews of `data`."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.view):
        raise ValueError(f"msgpack: {len(r.view) - r.pos} bytes after the value")
    return _unchunk(out)


# ------------------------------------------------------------------ encode --


def _int(n: int, out: list) -> None:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        out.append(struct.pack(">b" if n < 0 else ">B", n))
    elif n >= 0:
        for fmt, code in ((">B", 0xCC), (">H", 0xCD), (">I", 0xCE), (">Q", 0xCF)):
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(struct.pack(">B" + fmt[1:], code, n))
                return
        raise OverflowError(f"msgpack: int {n} needs more than 64 bits")
    else:
        for fmt, code in ((">b", 0xD0), (">h", 0xD1), (">i", 0xD2), (">q", 0xD3)):
            if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(struct.pack(">B" + fmt[1:], code, n))
                return
        raise OverflowError(f"msgpack: int {n} needs more than 64 bits")


def _header(n: int, fix_base: int | None, fix_max: int, codes, out: list) -> None:
    """A length-prefixed type's header: the fix form below `fix_max`, else
    the 8/16/32-bit length code of `codes` (None for a width it lacks)."""
    if fix_base is not None and n < fix_max:
        out.append(struct.pack(">B", fix_base | n))
        return
    for fmt, code in zip(_LEN, codes):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(struct.pack(">B" + fmt[1:], code, n))
            return
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _ext(code: int, data, out: list) -> None:
    n = len(data)
    if n in (1, 2, 4, 8, 16):
        out.append(struct.pack(">Bb", 0xD4 + n.bit_length() - 1, code))
    else:
        _header(n, None, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(struct.pack(">b", code))
    out.append(data)


def _ndarray_payload(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype not in DTYPE_NAMES:
        raise ValueError(f"msgpack: tensor dtype {t.dtype} has no flax name")
    raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else b""
    return packb([list(t.shape), DTYPE_NAMES[t.dtype], memoryview(raw)])


def _chunked(t: torch.Tensor) -> dict:
    """flax's `_chunk`: the flattened array in chunks of MAX_CHUNK_SIZE bytes."""
    per = max(1, int(MAX_CHUNK_SIZE / t.element_size()))
    flat = t.detach().cpu().contiguous().reshape(-1)
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(t.shape)},
            "chunks": {str(i): c for i, c in enumerate(torch.split(flat, per))}}


def _encode(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _header(memoryview(obj).nbytes, None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map keys must be str, got {k!r}")
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, complex):
        _ext(EXT_COMPLEX, packb([obj.real, obj.imag]), out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        t = torch.from_numpy(np.ascontiguousarray(obj)) if isinstance(obj, np.ndarray) else obj
        if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
            _encode(_chunked(t), out)
        else:
            _ext(EXT_NDARRAY, _ndarray_payload(t), out)
    elif isinstance(obj, np.generic):
        _ext(EXT_NPSCALAR, _ndarray_payload(torch.from_numpy(np.asarray(obj))), out)
    elif isinstance(obj, Ext):
        _ext(obj.code, obj.data, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """`obj` msgpack-encoded (see the module docstring for the types)."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)
