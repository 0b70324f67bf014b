"""The 256-element block quantizer (twin of `tpukit/ops/quant_comm.py:106,
130,143-173`), the int8 page layout of the paged KV cache.

Per-block max-abs scaling: `scale = amax / 127`, `q = round(x * (127 /
amax))` with round-half-to-even (`torch.round`, like `jnp.round`), clipped
to [-127, 127]. Leading axes are preserved. Only the round-to-nearest
mode is ported; stochastic rounding belongs to the quantized collectives.
"""

from __future__ import annotations

import torch

DEFAULT_BLOCK = 256  # elements per scale block (f32 sidecar: 4 B / block)


def packed_bytes(n: int, block: int = DEFAULT_BLOCK) -> int:
    """Bytes of one int8 payload covering `n` elements: `n` int8 values
    plus one f32 scale per started block."""
    n = max(n, 1)
    return n + 4 * (-(-n // block))


def quantize_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """`x [..., chunk]` (chunk % block == 0) to `(q int8 [..., chunk],
    scales f32 [..., chunk // block])`."""
    chunk = x.shape[-1]
    lead = x.shape[:-1]
    xb = x.float().reshape(*lead, chunk // block, block)
    amax = xb.abs().amax(-1)
    # true divisions by a tensor: with a Python scalar, torch may multiply
    # by a reciprocal instead (`127.0 / t` always, `t / 127.0` on cuda),
    # which can land an ulp away from `jnp`'s quotient
    c127 = torch.full_like(amax, 127.0)
    scales = amax / c127
    pos = amax > 0
    inv = torch.where(pos, c127 / torch.where(pos, amax, torch.ones_like(amax)),
                      torch.zeros_like(amax))
    v = torch.round(xb * inv[..., None])
    q = v.clamp(-127, 127).to(torch.int8).reshape(x.shape)
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of `quantize_blocks`: f32 `[..., chunk]`."""
    chunk = q.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], chunk // block, block)
    return (xb * scales[..., None]).reshape(q.shape)
