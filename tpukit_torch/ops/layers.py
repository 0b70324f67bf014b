"""Primitive layers and the loss (twin of `tpukit/ops/layers.py:19-234`).

Matmuls run in the compute dtype; LayerNorm runs in f32 and returns f32,
and callers cast back where the JAX model does. The cross-entropy and the
masked accuracy work on full logits: the unfused loss path
(`TPUKIT_FUSED_HEAD=0`) and the reference the fused head is held to. The
vocab-parallel primitives (`psum_bcast`, `vocab_parallel_ce`,
`vocab_parallel_argmax`) work on a rank's slice of the vocab over a c10d
group: a pipeline stage's, or a tensor-parallel rank's. The Megatron
operators of tensor parallelism (`copy_to_model`, `reduce_from_model`,
`gather_from_model`, `vocab_parallel_embedding`) work over the `model`
group a `ModelGroup` names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from tpukit_torch import random as tk_random
from tpukit_torch.ops import deferred

IGNORE_INDEX = -100  # the F.cross_entropy ignore index every loss path uses


def linear(x: torch.Tensor, params: dict, compute_dtype=None) -> torch.Tensor:
    """y = x @ kernel + bias, kernel `[in, out]`. Both operands and the bias
    are cast to the compute dtype, and the bias is added in it. The weight
    gradients are deferred under an active `deferred.Deferral` that defers
    one of its leaves."""
    return deferred.run(_linear, x, params, compute_dtype)


def _linear(x: torch.Tensor, params: dict, compute_dtype=None) -> torch.Tensor:
    dtype = compute_dtype or x.dtype
    y = torch.matmul(x.to(dtype), params["kernel"].to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def layer_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, spelled as `jnp.var` spells the
    population variance (mean of squared deviations). Returns f32. The
    scale's and bias's gradients are deferred under an active
    `deferred.Deferral` that defers one of them (the affine alone: `x` has several uses in the
    normalization, whose gradients must add up in the step's graph, in its
    order)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return deferred.run(_affine, normed, params)


def _affine(normed: torch.Tensor, params: dict) -> torch.Tensor:
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
    log-sum-exp. `cotangent` says what each rank's `g` is:

      - "shared": a share of the loss's cotangent (the pipeline: stage 0
        hands 1 / count, the others 0), so `g` is summed over the group
        first (tpukit's `_vp_bwd`);
      - "replicated": every rank differentiates the same loss with the
        same cotangent (tensor parallelism), so `g` is used as it is;
        summing it would scale the head's gradient by the group size."""

    @staticmethod
    def forward(ctx, local_logits, targets, offset, group, cotangent):
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
        ctx.group, ctx.cotangent = group, cotangent
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        local_logits, lse, own, safe, valid = ctx.saved_tensors
        g = g_sum.detach().float().reshape(1).clone()
        if ctx.cotangent == "shared":
            dist.all_reduce(g, group=ctx.group)
        probs = torch.exp(local_logits.float() - lse[..., None])
        col = torch.arange(local_logits.shape[-1], device=local_logits.device)
        onehot = (col == torch.where(own, safe, -1)[..., None]).float()
        scale = torch.where(valid, g[0], 0.0)[..., None]
        return ((probs - onehot) * scale).to(local_logits.dtype), None, None, None, None


COTANGENTS = ("shared", "replicated")


def vocab_parallel_ce(local_logits: torch.Tensor, targets: torch.Tensor, offset: int,
                      group=None, *, cotangent: str):
    """(loss_sum, valid_count) of the global cross-entropy from this rank's
    `[..., V / S]` logit columns starting at `offset` (twin of tpukit
    `ops/layers.py:182`): all-reduces of the row max, then of the sum of
    exponentials, then of the target logit over `group`, so every rank of
    it returns the same values. `cotangent` ("shared" or "replicated",
    `_VocabParallelCE`) is the callers' contract for the backward. At a
    group of one it is `cross_entropy_sum`."""
    if cotangent not in COTANGENTS:
        raise ValueError(f"cotangent must be one of {COTANGENTS}, got {cotangent!r}")
    if _group_size(group) == 1:
        return cross_entropy_sum(local_logits, targets)
    return _VocabParallelCE.apply(local_logits, targets, offset, group, cotangent)


def vocab_parallel_argmax(local_logits: torch.Tensor, offset: int, vocab: int,
                          group=None) -> torch.Tensor:
    """The global argmax (int64) of logits sharded over `group` by vocab
    columns, this rank's starting at `offset`, `vocab` columns in all: the
    largest value's lowest global index, as `jnp.argmax` breaks ties (each
    rank's own first maximum, then the least index among the ranks that
    hold the global maximum)."""
    lmax, larg = local_logits.float().max(-1)
    if _group_size(group) == 1:
        return larg + offset
    gmax = lmax.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    preds = torch.where(lmax >= gmax, larg + offset, torch.full_like(larg, vocab))
    dist.all_reduce(preds, op=dist.ReduceOp.MIN, group=group)
    return preds


# --------------------------------------------------------------------------
# Tensor parallelism (twin of what GSPMD inserts for tpukit's
# `TensorParallel`, `tpukit/shardings.py:998`): the Megatron operators over
# a `model` group. Activations between the operators are replicated over
# the group; each rank's parameters are its shards. Every sum over the
# group runs in f32 and returns the input's dtype, as the all-reduces of
# tpukit's TP step do (bf16 partial products widened, summed, narrowed).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """A rank's place in a `(data, model)` grid: the c10d `model` group
    (None at a degree of one) and its size and this rank's index in it,
    and the `data` group, degree and index beside it. Carried in
    `GPTConfig.tp`, it tells the model's functions that their parameters
    are this rank's tensor-parallel shards."""

    group: Any = None
    size: int = 1
    rank: int = 0
    data_group: Any = None
    data_size: int = 1
    data_rank: int = 0

    @classmethod
    def of(cls, mesh) -> "ModelGroup":
        """This rank's place on a `(data, model)` `DeviceMesh`
        (`mesh.create_tp_mesh`)."""
        m, d = mesh.size(1), mesh.size(0)
        return cls(group=mesh.get_group("model") if m > 1 else None, size=m,
                   rank=mesh.get_local_rank("model"),
                   data_group=mesh.get_group("data") if d > 1 else None, data_size=d,
                   data_rank=mesh.get_local_rank("data"))


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    out.copy_(x)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce_f32(ct, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along `dim` forward; this rank's slice of the cotangent
    backward (the gathered tensor is used the same way on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.rank, ctx.width = dim, tp.rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x, group=tp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, ct):
        return ct.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


def copy_to_model(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel product. Each rank's
    cotangent of `x` is its shard's share; the backward sums them."""
    if tp is None or tp.size == 1:
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """Megatron's g: the partial sums of a row-parallel product (or of a
    vocab-parallel lookup) summed over the group. Its result is used the
    same way on every rank, so the backward passes the cotangent on."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, dim: int, tp: ModelGroup | None) -> torch.Tensor:
    """This rank's shard of a tensor split evenly along `dim`, whole: the
    attention's weights where the heads do not divide the group (tpukit
    shards the columns by `inner_dim`, and GSPMD regathers them), and the
    vocab-parallel logits a decode tick samples from."""
    if tp is None or tp.size == 1:
        return x
    return _GatherFromModel.apply(x, dim, tp)


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor,
                             tp: ModelGroup | None) -> torch.Tensor:
    """Rows `ids` of a token table split over the group by rows (this
    rank's `[V / m, dim]` block, the twin of GSPMD's sharded `jnp.take` at
    `tpukit/model/gpt.py:351`): ids outside the block look up row 0 and
    are zeroed, then the ranks' lookups are summed."""
    if tp is None or tp.size == 1:
        return table[ids.long()]
    v_local = table.shape[0]
    rel = ids.long() - tp.rank * v_local
    own = (rel >= 0) & (rel < v_local)
    part = torch.where(own[..., None], table[torch.where(own, rel, 0)], 0.0)
    return reduce_from_model(part, tp)
