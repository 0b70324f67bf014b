"""Primitive layers and the loss (twin of `tpukit/ops/layers.py:19-122,234`).

Matmuls run in the compute dtype; LayerNorm runs in f32 and returns f32,
and callers cast back where the JAX model does. The cross-entropy and the
masked accuracy work on full logits: the unfused loss path
(`TPUKIT_FUSED_HEAD=0`) and the reference the fused head is held to.
"""

from __future__ import annotations

import torch

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
