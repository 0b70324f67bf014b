"""Build and load the port's CUDA kernels: `nvcc` by hand into a shared
library with a plain C interface, loaded with `ctypes`.

Each `tpukit_torch/csrc/<name>.cu` builds into
`build/tpukit_torch/<hash>/lib<name>.so` at the repository root, keyed by a
hash of the source and the flags, on first use. `build/` is git-ignored, so
a fresh checkout builds from its own sources. Nothing here runs when a
module is imported: the first `load` call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpukit_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; filled by `load`
_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise KernelBuildError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the port's "
        "CUDA kernels are built from tpukit_torch/csrc on first use"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> dict:
    """Build `csrc/<name>.cu` unless its library exists. Returns
    `{"seconds", "log", "path", "cached"}`; raises `KernelBuildError` with
    nvcc's output if the build fails."""
    out = _target(name)
    if out.exists():
        return dict(seconds=0.0, log="", path=str(out), cached=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(f"kernel build failed: {name} (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return dict(seconds=seconds, log=proc.stdout, path=str(out), cached=False)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use, with
    `signatures` (`{function: (restype, [argtypes])}`) declared on it: an
    undeclared pointer argument would pass through ctypes as a 32-bit int."""
    if name not in _LOADED:
        lib = ctypes.CDLL(build(name)["path"])
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[name] = lib
    return _LOADED[name]
