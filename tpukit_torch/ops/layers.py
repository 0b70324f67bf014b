"""Primitive layers and the loss (twin of `tpukit/ops/layers.py:19-122,234`).

Matmuls run in the compute dtype; LayerNorm runs in f32 and returns f32,
and callers cast back where the JAX model does. The cross-entropy and the
masked accuracy work on full logits: the unfused loss path
(`TPUKIT_FUSED_HEAD=0`) and the reference the fused head is held to.
"""

from __future__ import annotations

import math

import torch

from tpukit_torch import random as tk_random

IGNORE_INDEX = -100  # the F.cross_entropy ignore index every loss path uses


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


def dropout(x: torch.Tensor, rate: float, rng, row0: int = 0) -> torch.Tensor:
    """Inverted dropout (twin of `tpukit/ops/layers.py:44`): keep each
    element with probability `1 - rate`, drawn as `bernoulli(rng, keep)`
    over `x.shape`, and scale the kept ones by `1 / keep`. The identity
    when `rng` is None or `rate` is 0. `row0` is the first row of `x`
    within the batch the mask is drawn over: rows `[row0, row0 + B)` of
    that mask, bit for bit (a data-parallel rank's share)."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = tk_random.bernoulli(rng, keep, x.shape, offset=row0 * math.prod(x.shape[1:]))
    # divide by a tensor in x's dtype, as jnp converts the weak-typed
    # `keep`: a Python scalar divisor may run as a multiply by its
    # reciprocal on cuda, an ulp away from the quotient
    return torch.where(mask, x / torch.full_like(x, keep), torch.zeros_like(x))


class _CrossEntropySum(torch.autograd.Function):
    """(loss_sum, count) with the hand-written backward of tpukit's custom
    VJP: `(softmax - onehot) * g` on valid rows, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets):
        valid = targets != IGNORE_INDEX
        safe = torch.where(valid, targets, 0).long()
        lse = torch.logsumexp(logits.float(), -1)
        target_logit = logits.gather(-1, safe[..., None])[..., 0].float()
        loss_sum = torch.where(valid, lse - target_logit, 0.0).sum()
        count = valid.sum().float()
        ctx.save_for_backward(logits, targets, lse)
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        logits, targets, lse = ctx.saved_tensors
        valid = targets != IGNORE_INDEX
        probs = torch.exp(logits.float() - lse[..., None])
        col = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (col == torch.where(valid, targets, -1)[..., None]).float()
        scale = torch.where(valid, g_sum, 0.0)[..., None]
        return ((probs - onehot) * scale).to(logits.dtype), None


def cross_entropy_sum(logits: torch.Tensor, targets: torch.Tensor):
    """(loss_sum, valid_count) of token cross-entropies with IGNORE_INDEX
    masking, f32 accumulation."""
    return _CrossEntropySum.apply(logits, targets)


def masked_correct(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The count (f32) of non-ignored positions whose logits' argmax is the
    target. `argmax` returns the first index of a tied maximum, as
    `jnp.argmax` does."""
    valid = targets != IGNORE_INDEX
    return (valid & (logits.argmax(-1) == targets)).sum().float()
