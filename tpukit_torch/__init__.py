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
`csrc/flash_attention.cu` and `csrc/fused_head_ce.cu`. Slice 3 ports MoE
training (recipe 8) and serving on one card through the grouped-expert FFN,
`csrc/moe_gemm.cu`. All are hand-written CUDA for sm_90a. Slice 8 ports
data-parallel and fully-sharded training, recipes 2 and 3 (`python -m
tpukit_torch.recipes.ddp` and `.fsdp`): DDP and FSDP2 over a c10d process
group (`mesh.py`), the same kernels under both. Slice 9 ports seeded
sampling (`random.py`, a copy of `jax.random`'s threefry; `sampling.py`),
the ring KV cache that is tpukit's default serving engine, speculative
decoding (`serve/spec.py`) and dropout, around the same kernels. Slice 10
ports pipeline parallelism, recipes 4 and 5 (`python -m
tpukit_torch.recipes.pipe` and `.pipe_ddp`): GPipe and 1F1B, flat and
interleaved, over c10d stage ranks (`pipeline.py`), the flash kernels
inside every stage. Slice 11 reads and writes tpukit's checkpoint formats
(`checkpoint.py`, with `msgpack.py`, a standard-library codec for what
flax writes) beside the port's own `.pt`, and serves a checkpoint of any
of them (`python -m tpukit_torch.serve --checkpoint latest`). Slice 16 is
tpukit's recovery plane in `train.fit` (`recovery.py`, `chaos.py`,
`retry.py`, `prefetch.py`, `reshard.py`, `obs/`): `--resume latest`,
preemption (exit 75), the loss sentinel (76), rollback (77 past its
budget), chaos injection, I/O retries, async saves and retention.

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
