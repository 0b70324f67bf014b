"""Mixture-of-experts routing, dispatch and combine (twin of
`tpukit/ops/moe_dispatch.py`).

Three dataflows sit behind `GPTConfig.moe_dispatch` and compute the same
math (routing, per-row capacity, the expert FFN, the gated combine, the
load-balance aux):

  - "xla": the global one-hot einsum formulation (`moe_ffn_xla`);
  - "a2a": the expert-parallel exchange block (`moe_ffn_a2a`): local rows
    packed into `[E, B, C, D]` capacity buffers, the expert FFN, the
    mirrored combine. The port carries it for an expert axis of size 1,
    where the exchange moves nothing; more ranks raise `NotPortedError`
    (multi-rank `all_to_all_single` comes with the process groups of
    ROADMAP.md item 5, 'DDP');
  - "pallas": the grouped-expert GEMM of `tpukit_torch/ops/moe_gemm.py`,
    which reuses `_route_topk`, `_kept_mask`, `_aux_stats` and
    `_moe_ffn_exchange` from here.

`ExpertGrid` stands in for tpukit's `moe_mesh`: the `(data, expert)` grid
sizes `ExpertParallel` injects into the config at loss time.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpukit_torch import NotPortedError


@dataclasses.dataclass(frozen=True)
class ExpertGrid:
    """The `(data, expert)` device grid of an expert-parallel run: the
    sizes of tpukit's `moe_mesh` axes, without devices."""

    data: int = 1
    expert: int = 1

    def __post_init__(self):
        if self.data < 1 or self.expert < 1:
            raise ValueError(f"grid sizes must be >= 1, got data={self.data}, "
                             f"expert={self.expert}")

    @property
    def size(self) -> int:
        return self.data * self.expert


def moe_capacity(cfg, seq_len: int) -> int:
    """Per-row expert capacity: `ceil(max_position * top_k * factor / E)`
    from the static position table (or `cfg.moe_capacity` when set),
    clamped to the call width `seq_len` (a row position never reaches it,
    so the clamp changes no output)."""
    if cfg.moe_capacity > 0:
        return min(cfg.moe_capacity, seq_len)
    capacity = max(1, int(-(-cfg.max_position_embeddings * cfg.router_top_k
                            * cfg.expert_capacity_factor // cfg.num_experts)))
    return min(capacity, seq_len)


def top_k_lower_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the `k` largest entries of the last axis, ties
    broken toward the lower index, as `jax.lax.top_k` breaks them.
    `torch.topk` promises no order among ties, so this sorts: a stable
    descending sort keeps equal entries in index order."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k].to(torch.int32)


def _route_topk(x, router_kernel, cfg):
    """Routing front half, shared by every dispatch: the router in f32 on
    `x` widened to f32 (also under bf16 compute), softmax, top-k.

    Returns (xc, top_idx, top_vals, probs, assign):
      xc       [B,S,D]  x in the compute dtype
      top_idx  [B,S,K]  int32 chosen expert ids
      top_vals [B,S,K]  f32 router probability of each chosen expert
      probs    [B,S,E]  f32 full softmax
      assign   [B,S,E]  f32 0/1 chosen-expert mask
    """
    xc = x.to(cfg.compute_dtype)
    logits = torch.matmul(x.float(), router_kernel.float())
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k_lower_index_first(probs, cfg.router_top_k)
    choice_oh = F.one_hot(top_idx.long(), cfg.num_experts).float()
    assign = choice_oh.sum(dim=2)
    return xc, top_idx, top_vals, probs, assign


def _slot_positions(assign):
    """[B,S,E] position of each token in its expert's per-row buffer (a
    causal cumsum along the sequence); -1 where unassigned."""
    return torch.cumsum(assign, dim=1) * assign - 1.0


def _kept_mask(assign, capacity: int):
    """[B,S,E] 0/1 mask of the assignments within the per-row capacity."""
    return assign * (_slot_positions(assign) < capacity).float()


def _route(x, router_kernel, cfg):
    """Routing plus the per-row fixed-capacity dispatch one-hot.

    Returns (xc, dispatch [B,S,E,C] in the compute dtype, gate_map [B,S,E]
    f32, probs, assign)."""
    capacity = moe_capacity(cfg, x.shape[1])
    xc, top_idx, top_vals, probs, assign = _route_topk(x, router_kernel, cfg)
    choice_oh = F.one_hot(top_idx.long(), cfg.num_experts).float()
    gate_map = (top_vals[..., None] * choice_oh).sum(dim=2)
    kept = _kept_mask(assign, capacity)
    slot = _slot_positions(assign).clamp(0, capacity - 1).long()
    dispatch = (kept[..., None] * F.one_hot(slot, capacity).float()).to(cfg.compute_dtype)
    return xc, dispatch, gate_map, probs, assign


def _expert_ffn(experts, expert_in, dtype):
    """up -> relu -> down -> relu (the reference's double ReLU) as batched
    matmuls over an expert-major buffer `[E, b, C, D]`, each product and
    its bias add in `dtype`."""
    e, b, c, d = expert_in.shape
    up, down = experts["up"], experts["down"]
    h = torch.matmul(expert_in.reshape(e, b * c, d), up["kernel"].to(dtype))
    h = torch.relu(h + up["bias"].to(dtype)[:, None, :])
    h = torch.matmul(h, down["kernel"].to(dtype)) + down["bias"].to(dtype)[:, None, :]
    return torch.relu(h).reshape(e, b, c, d)


def _aux_stats(probs, assign, pad_mask, cfg):
    """Switch load-balance statistics as (numerator, denominator) row
    sums; `aux = E * num / max(den, 1)`. With a pad mask and
    `cfg.moe_aux_mask_pads`: real tokens only, per-row normalisation by the
    real-token count, all-pad rows left out. Otherwise the average over
    every position."""
    top_k = cfg.router_top_k
    if pad_mask is not None and cfg.moe_aux_mask_pads:
        real = (~pad_mask).float()
        count = torch.clamp(real.sum(dim=1), min=1.0)
        frac_tokens = torch.einsum("bse,bs->be", assign, real) / count[:, None] / top_k
        mean_prob = torch.einsum("bse,bs->be", probs, real) / count[:, None]
        row_real = (real.sum(dim=1) > 0).float()
        num = ((frac_tokens * mean_prob).sum(dim=-1) * row_real).sum()
        return num, row_real.sum()
    frac_tokens = assign.mean(dim=1) / top_k
    mean_prob = probs.mean(dim=1)
    num = (frac_tokens * mean_prob).sum(dim=-1).sum()
    return num, probs.new_full((), float(assign.shape[0]))  # a fill: no host sync


def _aux(num, den, cfg):
    return cfg.num_experts * num / torch.clamp(den, min=1.0)


def _capacity_ffn(layer, cfg, x, pad_mask, expert_ffn):
    """Route, pack the rows into `[E, B, C, D]` capacity buffers by the
    one-hot einsum, `expert_ffn(experts, buffer, dtype)`, gated combine.
    Returns (out [B,S,D], aux scalar)."""
    xc, dispatch, gate_map, probs, assign = _route(x, layer["ffn"]["router"]["kernel"], cfg)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, xc)
    h = expert_ffn(layer["ffn"]["experts"], expert_in, cfg.compute_dtype)
    out = torch.einsum("ebcd,bsec->bsd", h,
                       dispatch * gate_map.to(cfg.compute_dtype)[..., None])
    return out, _aux(*_aux_stats(probs, assign, pad_mask, cfg), cfg)


def moe_ffn_xla(layer, cfg, x, pad_mask=None):
    """The einsum formulation. Returns (out [B,S,D], aux scalar)."""
    return _capacity_ffn(layer, cfg, x, pad_mask, _expert_ffn)


def moe_ffn_a2a(layer, cfg, x, pad_mask=None):
    """The expert-parallel exchange block with the batched expert FFN.
    Needs `cfg.moe_mesh` (an `ExpertGrid`, injected by `ExpertParallel`)."""
    return _moe_ffn_exchange(layer, cfg, x, pad_mask, _expert_ffn, "a2a")


def _moe_ffn_exchange(layer, cfg, x, pad_mask, expert_ffn, name):
    """The exchange block shared by "a2a" and "pallas": route, pack local
    rows into `[E, B, C, D]` capacity buffers, `expert_ffn(experts,
    buffer, dtype)`, combine. With one rank on the expert axis the
    exchange moves nothing and the block runs as is; an expert axis > 1
    raises `NotPortedError`."""
    grid = cfg.moe_mesh
    if grid is None:
        raise ValueError(f"moe_dispatch={name!r} under ExpertParallel needs cfg.moe_mesh "
                         f"(an ExpertGrid) - ExpertParallel injects it; set "
                         f"moe_dispatch='xla' for meshless buffer execution")
    if cfg.num_experts % grid.expert:
        raise ValueError(f"num_experts {cfg.num_experts} must divide over the "
                         f"{grid.expert}-way expert axis for {name} dispatch")
    if grid.expert > 1:
        raise NotPortedError(
            f"moe_dispatch={name!r} over a {grid.expert}-way expert axis needs "
            f"all_to_all_single between ranks, which is not in the port yet "
            f"(ROADMAP.md, queue A item 13 'EP over more than one rank', after item 5 'DDP')")
    return _capacity_ffn(layer, cfg, x, pad_mask, expert_ffn)
