"""The port's native tokenizer: `tokenizer.cpp` behind ctypes (twin of
`tpukit/native/__init__.py`).

A multithreaded C++ batch encoder that gives `WordTokenizer`'s ids and
masks byte for byte (`padding="max_length"`, truncation). The port keeps
its own copy of the source. It builds with `g++` on first use into
`build/tpukit_torch/native-<source hash>/` at the repository root (git-
ignored), as `ops/_cuda.py` builds the kernels: nothing is written next to
the source, and a changed source builds a new library. A process that
races another's build publishes its own whole file (`os.replace`).
Without a compiler `is_available()` is False and `WordTokenizer` keeps its
Python encoder; `TPUKIT_NATIVE=0` forces the Python path. `encodes` counts
the batches the native encoder has encoded in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpukit_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_build_error: str | None = None
encodes = 0  # batches encoded natively, this process


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"native-{digest[:16]}" / "libtpukit_torch_native.so"


def build() -> Path:
    """Build the library unless it exists; its path. Raises
    `subprocess.CalledProcessError` (with g++'s output) or `OSError`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    if os.environ.get("TPUKIT_NATIVE") == "0":
        _build_error = "disabled via TPUKIT_NATIVE=0"
        return None
    try:
        lib = ctypes.CDLL(str(build()))
        lib.tpukit_tok_create.restype = ctypes.c_void_p
        lib.tpukit_tok_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                                          ctypes.c_int32]
        lib.tpukit_tok_destroy.argtypes = [ctypes.c_void_p]
        lib.tpukit_tok_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
        ]
        _lib = lib
    except Exception as exc:  # no compiler, or a toolchain that refused it
        detail = getattr(exc, "stderr", "") or ""
        _build_error = f"{type(exc).__name__}: {exc} {detail}".strip()
    return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the native path is unavailable, or None."""
    _load()
    return _build_error


class NativeEncoder:
    """Batch encoder over a `WordTokenizer` vocab, byte-identical to
    `WordTokenizer.__call__(padding="max_length", truncation=True)`."""

    def __init__(self, id_to_token: list[str], unk_id: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native tokenizer unavailable: {_build_error}")
        self._lib = lib
        blob = b"\0".join(t.encode("utf-8") for t in id_to_token) + b"\0"
        self._handle = lib.tpukit_tok_create(blob, len(blob), len(id_to_token), unk_id)
        if not self._handle:
            raise RuntimeError("tpukit_tok_create failed")

    def encode_batch(self, texts: list[str], max_length: int, pad_id: int,
                     n_threads: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), both `[N, max_length]` int32."""
        global encodes
        encoded = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        n = len(encoded)
        ids = np.empty((n, max_length), dtype=np.int32)
        mask = np.empty((n, max_length), dtype=np.int32)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 16)
        self._lib.tpukit_tok_encode_batch(self._handle, b"".join(encoded), offsets, n,
                                          max_length, pad_id, ids, mask, n_threads)
        encodes += 1
        return ids, mask

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and self._lib is not None:
            self._lib.tpukit_tok_destroy(handle)
