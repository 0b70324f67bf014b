"""tpukit_torch: the PyTorch/CUDA port of tpukit, for one NVIDIA H100.

The JAX package `tpukit/` stays the reference; this package is its twin,
module for module (`model/gpt.py`, `ops/layers.py`, `serve/engine.py`,
...), and imports neither `jax` nor anything of `tpukit`. What it needs
from a tpukit module it keeps as its own copy.

Slice 1 ports the paged, fused-decode serving path
(`python -m tpukit_torch.serve --page_size P --fused_decode`); its TPU
kernel, the paged-attention decode, is `csrc/paged_attention.cu`. Slice 2
ports single-device training, recipe 1 (`python -m
tpukit_torch.recipes.single`); its TPU kernels, causal flash attention and
the fused LM head + cross-entropy, forward and backward, are
`csrc/flash_attention.cu` and `csrc/fused_head_ce.cu`. All are hand-written
CUDA for sm_90a.

Every entry point takes a `device` argument and runs on `cuda` unless the
caller passes `device="cpu"`. Without a GPU and without that request it
raises `CudaUnavailableError`; it never drops to the CPU silently.
"""

from __future__ import annotations

import torch


class CudaUnavailableError(RuntimeError):
    """An entry point was asked for (or defaulted to) `cuda` on a machine
    where `torch.cuda.is_available()` is false."""


class NotPortedError(NotImplementedError):
    """A tpukit feature this slice of the port does not carry yet. The
    message names the ROADMAP.md item that will."""


def configure_numerics() -> None:
    """True-f32 matmuls and convolutions: TF32 keeps ~3 decimal digits, so
    an f32 run with it on could not be held to the JAX package's f32
    results. bf16 products also reduce in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, `cpu` only
    when asked. Also applies `configure_numerics`, so every entry point
    starts from the same matmul precision."""
    configure_numerics()
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "tpukit_torch runs on cuda by default, and torch.cuda.is_available() "
            "is false here; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
