"""Mixture-of-experts routing, dispatch and combine (twin of
`tpukit/ops/moe_dispatch.py`).

Three dataflows sit behind `GPTConfig.moe_dispatch` and compute the same
math (routing, per-row capacity, the expert FFN, the gated combine, the
load-balance aux):

  - "xla": the global one-hot einsum formulation (`moe_ffn_xla`);
  - "a2a": the expert-parallel exchange block (`moe_ffn_a2a`): local rows
    packed into `[E, B, C, D]` capacity buffers, sent by
    `all_to_all_single` over the expert group of `cfg.moe_mesh`, the
    expert FFN on this rank's `E / ep` experts over `[E / ep, ep B, C, D]`,
    the mirrored exchange back, the gated combine (tpukit's tiled
    `lax.all_to_all` pair, `tpukit/ops/quant_comm.py:487-509`:
    `quant_comm.exchange_all_to_all`, its payload `cfg.comm_dtype`). Each
    exchange is an autograd Function whose backward is the other
    exchange, so a training step runs 4 a layer;
  - "pallas": the grouped-expert GEMM of `tpukit_torch/ops/moe_gemm.py`,
    which reuses `_route_topk`, `_kept_mask`, `_aux_stats` and
    `_moe_ffn_exchange` from here.

`ExpertGrid` stands in for tpukit's `moe_mesh`: the `(data, expert)` grid
`ExpertParallel` injects into the config at loss time, with the c10d
expert group where the expert axis spans ranks. Routing, capacity and
drops are per row, so a rank's rows route alone; only the load-balance
aux crosses ranks: with `cfg.moe_rows` (a `RowGroup`, injected by
`ExpertParallel`, `DataParallel` and `FSDP`) every dispatch sums its
statistics over the ranks that hold the batch's rows, as tpukit's psum
over the row axes (and GSPMD over the global batch) does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpukit_torch.ops import quant_comm


@dataclasses.dataclass(frozen=True)
class ExpertGrid:
    """The `(data, expert)` device grid of an expert-parallel run: the
    sizes of tpukit's `moe_mesh` axes and, where the expert axis spans
    ranks, the c10d group of this rank's expert peers (in expert-index
    order) and this rank's index in it."""

    data: int = 1
    expert: int = 1
    group: Any = dataclasses.field(default=None, compare=False)
    rank: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.data < 1 or self.expert < 1:
            raise ValueError(f"grid sizes must be >= 1, got data={self.data}, "
                             f"expert={self.expert}")

    @property
    def size(self) -> int:
        return self.data * self.expert

    @classmethod
    def of(cls, mesh) -> "ExpertGrid":
        """This rank's place on a `(data, expert)` `DeviceMesh`
        (`mesh.create_ep_mesh`)."""
        d, e = mesh.size(0), mesh.size(1)
        return cls(data=d, expert=e, group=mesh.get_group("expert") if e > 1 else None,
                   rank=mesh.get_local_rank("expert"))


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The c10d group whose ranks hold the batch's rows between them (None
    at one rank) and its size: the load-balance statistics are summed over
    it."""

    group: Any = dataclasses.field(default=None, compare=False)
    size: int = 1


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


class _RowSum(torch.autograd.Function):
    """All-reduce (sum) over the row group forward; identity backward: each
    rank differentiates its own rows' terms, and the strategy's gradient
    reduction (a sum under `ExpertParallel`, the wrappers' mean of an
    objective scaled by the world under `DataParallel` and `FSDP`) adds
    them up."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def _aux(num, den, cfg):
    """`E * num / max(den, 1)`, with (num, den) summed over `cfg.moe_rows`
    first (one all-reduce: den has no gradient, routing being discrete):
    every rank gets the global aux of the batch."""
    rows = cfg.moe_rows
    if rows is not None and rows.size > 1:
        stats = _RowSum.apply(torch.stack([num.float(), den.detach().float()]), rows.group)
        num, den = stats[0], stats[1]
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
    """The exchange block shared by "a2a" and "pallas": route this rank's
    rows, pack them into `[E, B, C, D]` capacity buffers, send each expert
    block to its rank (`quant_comm.exchange_all_to_all`, "dispatch"),
    `expert_ffn(experts, buffer, dtype)` on this rank's experts (the
    layer's bank holds `E / ep` of them) over `[E / ep, ep B, C, D]`, send
    the results back ("combine"), the gated combine. Each hop is one
    `all_to_all_single` forward and its mirror backward, its payload
    `cfg.comm_dtype` (tpukit `moe_dispatch.py:277-293`: f32 as computed,
    bf16 cast around the exchange, int8 packed per destination). Routing
    runs before the exchange on exact values, so a quantized payload
    perturbs expert activations, never the routing. With one rank on the
    expert axis the exchanges are skipped and the block runs as is. The aux
    is `_aux` over `cfg.moe_rows`."""
    grid = cfg.moe_mesh
    if grid is None:
        raise ValueError(f"moe_dispatch={name!r} under ExpertParallel needs cfg.moe_mesh "
                         f"(an ExpertGrid) - ExpertParallel injects it; set "
                         f"moe_dispatch='xla' for meshless buffer execution")
    if cfg.num_experts % grid.expert:
        raise ValueError(f"num_experts {cfg.num_experts} must divide over the "
                         f"{grid.expert}-way expert axis for {name} dispatch")
    xc, dispatch, gate_map, probs, assign = _route(x, layer["ffn"]["router"]["kernel"], cfg)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, xc)
    if grid.expert > 1:
        expert_in = quant_comm.exchange_all_to_all(
            expert_in, grid.group, grid.expert, "dispatch", cfg.comm_dtype,
            stochastic=cfg.quant_stochastic)
    h = expert_ffn(layer["ffn"]["experts"], expert_in, cfg.compute_dtype)
    if grid.expert > 1:
        h = quant_comm.exchange_all_to_all(h, grid.group, grid.expert, "combine",
                                           cfg.comm_dtype, stochastic=cfg.quant_stochastic)
    out = torch.einsum("ebcd,bsec->bsd", h,
                       dispatch * gate_map.to(cfg.compute_dtype)[..., None])
    return out, _aux(*_aux_stats(probs, assign, pad_mask, cfg), cfg)


def expected_a2a(cfg, data_size: int, expert_size: int, global_batch: int,
                 seq: int) -> dict | None:
    """The `all_to_all_single` calls of the exchange in one step on one rank
    (twin of `tpukit/ops/moe_dispatch.py:315`): `{"buffer_bytes", "train":
    {count, bytes, wire}, "eval": {...}}`, or None for a dense config or a
    batch the grid does not divide.

    Per layer each rank sends its `[E, B_local, C, D]` buffer out and the
    results back: 2 calls forward, and, the exchange being its own
    transpose, 2 more backward (6 with `remat_layers`, whose backward
    re-runs the forward). Counts are calls of one step with every layer
    unrolled, which is tpukit's count at `scan_layers` off (its scanned
    stack emits each op once). A 1-way expert axis moves nothing. An int8
    wire moves the packed block-scaled rows (`quant_comm.packed_bytes` a
    destination), bf16 the cast buffer, f32 the compute-dtype buffer; eval
    runs forward only in bf16. c10d carries bf16 at 2 bytes on every
    backend, so the port needs none of tpukit's `backend` pricing; `wire`
    names the payload's type ("s8-packed" or the torch dtype)."""
    if cfg.num_experts <= 0:
        return None
    zero = {"count": 0, "bytes": 0}
    if expert_size <= 1:
        return {"buffer_bytes": 0, "train": dict(zero), "eval": dict(zero)}
    rows = data_size * expert_size
    if global_batch % rows:
        return None
    capacity = moe_capacity(cfg, seq)
    n_buf = cfg.num_experts * (global_batch // rows) * capacity * cfg.dim
    comm = getattr(cfg, "comm_dtype", "f32")

    def entry(dtype: torch.dtype, ops_per_layer: int) -> dict:
        if comm == "int8":
            op_bytes, wire = expert_size * quant_comm.packed_bytes(n_buf // expert_size), \
                "s8-packed"
        else:
            dtype = torch.bfloat16 if comm == "bf16" else dtype
            op_bytes = n_buf * torch.empty((), dtype=dtype).element_size()
            wire = str(dtype).replace("torch.", "")
        count = ops_per_layer * cfg.num_layers
        return {"count": count, "bytes": count * op_bytes, "wire": wire}

    return {"buffer_bytes": n_buf * torch.empty((), dtype=cfg.compute_dtype).element_size(),
            "train": entry(cfg.compute_dtype, 6 if cfg.remat_layers else 4),
            "eval": entry(torch.bfloat16, 2)}
