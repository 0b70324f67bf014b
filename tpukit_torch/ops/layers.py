"""Primitive layers and the loss (twin of `tpukit/ops/layers.py:19-234`).

Matmuls run in the compute dtype; LayerNorm runs in f32 and returns f32,
and callers cast back where the JAX model does. The cross-entropy and the
masked accuracy work on full logits: the unfused loss path
(`TPUKIT_FUSED_HEAD=0`) and the reference the fused head is held to. The
pipeline's vocab-parallel primitives (`psum_bcast`, `vocab_parallel_ce`)
work on a stage's slice of the vocab over a c10d group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

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


# --------------------------------------------------------------------------
# Vocab-parallel primitives of the pipeline's sharded embedding and head
# (twin of `tpukit/ops/layers.py:136-231`): each stage of a c10d `group`
# holds `[..., V / S]` columns of the token table and the LM head.
# --------------------------------------------------------------------------


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _PsumBcast(torch.autograd.Function):
    """An all-reduce (sum) whose backward is also an all-reduce of the
    cotangent: the sum is consumed divergently (one stage uses it), so the
    input's cotangent is the sum of every stage's output cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


def psum_bcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the ranks of `group`, with an all-reduce of the
    cotangent as its backward (twin of `psum_bcast`, tpukit
    `ops/layers.py:142`). The identity at a group of one."""
    if _group_size(group) == 1:
        return x
    return _PsumBcast.apply(x, group)


class _VocabParallelCE(torch.autograd.Function):
    """(loss_sum, count) of the cross-entropy over vocab-sharded logits;
    the backward is local, `(softmax - onehot) * g` from the saved global
    log-sum-exp, with `g` summed over the group first (tpukit's `_vp_bwd`):
    callers may hand each stage a share of the loss's cotangent."""

    @staticmethod
    def forward(ctx, local_logits, targets, offset, group):
        lf = local_logits.float()
        v_local = lf.shape[-1]
        valid = targets != IGNORE_INDEX
        rel = torch.where(valid, targets, 0).long() - offset
        own = valid & (rel >= 0) & (rel < v_local)
        safe = torch.where(own, rel, 0)
        gmax = lf.amax(-1)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        sumexp = torch.exp(lf - gmax[..., None]).sum(-1)
        dist.all_reduce(sumexp, group=group)
        lse = gmax + torch.log(sumexp)
        target_logit = torch.where(own, lf.gather(-1, safe[..., None])[..., 0], 0.0)
        dist.all_reduce(target_logit, group=group)
        loss_sum = torch.where(valid, lse - target_logit, 0.0).sum()
        count = valid.sum().float()
        ctx.save_for_backward(local_logits, lse, own, safe, valid)
        ctx.group = group
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        local_logits, lse, own, safe, valid = ctx.saved_tensors
        g = g_sum.detach().float().reshape(1).clone()
        dist.all_reduce(g, group=ctx.group)
        probs = torch.exp(local_logits.float() - lse[..., None])
        col = torch.arange(local_logits.shape[-1], device=local_logits.device)
        onehot = (col == torch.where(own, safe, -1)[..., None]).float()
        scale = torch.where(valid, g[0], 0.0)[..., None]
        return ((probs - onehot) * scale).to(local_logits.dtype), None, None, None


def vocab_parallel_ce(local_logits: torch.Tensor, targets: torch.Tensor, offset: int,
                      group=None):
    """(loss_sum, valid_count) of the global cross-entropy from this rank's
    `[..., V / S]` logit columns starting at `offset` (twin of tpukit
    `ops/layers.py:182`): all-reduces of the row max, then of the sum of
    exponentials, then of the target logit over `group`, so every rank of
    it returns the same values. At a group of one it is `cross_entropy_sum`."""
    if _group_size(group) == 1:
        return cross_entropy_sum(local_logits, targets)
    return _VocabParallelCE.apply(local_logits, targets, offset, group)
