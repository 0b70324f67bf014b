"""Causal multi-head attention core (twin of `tpukit/ops/attention.py:31`).

`causal_attention(q, k, v, *, scale, pad_mask, impl)` over `[B, H, S, D]`
tensors, with the `[B, S]` bool pad mask (True = padding) applied to keys:

  - "xla": the eager twin of tpukit's XLA path (:83-97): scores in the
    compute dtype, scaled in it, plus a -1e9 causal term, finfo.min on
    padded keys, softmax in f32, probabilities cast to v's dtype;
  - "flash": the flash-attention kernels (`ops/flash_attention.py`);
  - "auto": "flash" exactly when the tensors are on CUDA and
    S >= FLASH_MIN_SEQ.
"""

from __future__ import annotations

import torch

from tpukit_torch import NotPortedError
from tpukit_torch.ops.flash_attention import flash_causal_attention

NEG_INF = -1e9  # the causal additive term of the reference model
# The H100's crossover (80GB HBM3 at 700 W; chip_smoke.py's attention
# crossover, PERF.md): one forward + backward of 32768 tokens, bf16 with a
# pad mask, is faster by the flash kernels (bf16 on the tensor cores) at
# every S measured from 32 to 1024, in every run; at S = 16 both paths are
# host-bound and their order changes from run to run. tpukit switches at
# 512, its TPU's.
FLASH_MIN_SEQ = 32


def causal_attention(q, k, v, *, scale: float, pad_mask=None, impl: str = "xla"):
    """Scaled dot-product causal attention; returns `[B, H, S, D]` in v's
    dtype."""
    if impl == "auto":
        # tpukit's rule, with the accelerator in the TPU's place and the
        # H100's own threshold
        impl = "flash" if q.device.type == "cuda" and q.shape[2] >= FLASH_MIN_SEQ else "xla"
    if impl == "flash":
        return flash_causal_attention(q, k, v, scale=scale, pad_mask=pad_mask)
    if impl in ("ring", "ulysses"):
        raise NotPortedError(
            f"attention_impl={impl!r} is context-parallel attention, not in the port "
            f"yet (ROADMAP.md, queue A item 15 'Context parallel')"
        )
    if impl != "xla":
        raise ValueError(f"attention_impl must be auto, xla, flash, ring or ulysses, "
                         f"got {impl!r}")
    seq = q.shape[2]
    dt = q.dtype
    logits = torch.matmul(q, k.transpose(-1, -2)) * torch.tensor(scale, dtype=dt,
                                                                  device=q.device)
    causal = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
    logits = logits + torch.where(causal, 0.0, NEG_INF).to(dt)
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, None, :], torch.finfo(dt).min)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
