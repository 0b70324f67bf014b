"""Primitive layers (twin of `tpukit/ops/layers.py:22,31`).

Matmuls run in the compute dtype; LayerNorm runs in f32 and returns f32,
and callers cast back where the JAX model does.
"""

from __future__ import annotations

import torch


def linear(x: torch.Tensor, params: dict, compute_dtype=None) -> torch.Tensor:
    """y = x @ kernel + bias, kernel `[in, out]`. Both operands and the bias
    are cast to the compute dtype, and the bias is added in it."""
    dtype = compute_dtype or x.dtype
    y = torch.matmul(x.to(dtype), params["kernel"].to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def layer_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, spelled as `jnp.var` spells the
    population variance (mean of squared deviations). Returns f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return normed * params["scale"].float() + params["bias"].float()
