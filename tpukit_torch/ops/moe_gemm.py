"""The grouped-expert FFN, the "pallas" MoE dispatch: the CUDA kernels and
their plain PyTorch versions (twin of `tpukit/ops/moe_gemm.py`, kernels
`_grouped_ffn_fwd_call` :241 and `_grouped_ffn_bwd_call` :262).

Rows sorted by expert (`sort_plan`) form one contiguous segment per expert,
`offsets [E+1]` int32 its boundaries. `grouped_ffn(xs, wu, bu, wd, bd,
offsets)` applies expert e's FFN, `relu(round(relu(x Wu[e] + bu[e])) Wd[e] +
bd[e])` with f32 accumulation and h rounded to the compute dtype, to each
row of segment e, as a `torch.autograd.Function`:

  - on a CPU tensor both directions run the plain version
    (`grouped_ffn_reference`, `grouped_ffn_backward_reference`), a loop of
    torch products over the segments that rounds where tpukit rounds;
  - on a CUDA tensor the forward launches `csrc/moe_gemm.cu`'s up and down
    kernels (the rounded h is kept for the backward) and the backward its
    dh, dx, dWu and dWd kernels, or raises.

The backward returns dx in the compute dtype and dW/db cast to the bank's
dtype, as tpukit's `_grouped_ffn_bwd` casts them (:311-324): under bf16
the expert gradients pass through a bf16 rounding.

`moe_ffn_pallas` is the dispatch around it: meshless, the dropless sorted
dataflow (route, sort by expert, grouped FFN, unsort, gated combine);
under `ExpertParallel` the exchange block of `moe_dispatch` with the
grouped FFN over its equal, static segments.

`launches` counts kernel launches per kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpukit_torch.ops import _cuda
from tpukit_torch.ops.moe_dispatch import (
    _aux,
    _aux_stats,
    _kept_mask,
    _moe_ffn_exchange,
    _route_topk,
    moe_capacity,
)

BLOCK_ROWS = 512  # tpukit's sorted-row block edge (_BLOCK_ROWS), for sort_plan's padding
MAX_EXPERTS = 32  # tpukit's _MAX_VMEM_EXPERTS: both packages refuse the same configs
_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # kind, xs, wu, bu, wd, bd, offsets, h, y, M, D, F, E, stream
    "tk_moe_fwd": (_I, [_I] + [_P] * 8 + [_I] * 4 + [_P]),
    # kind, xs, g, y, h, wu, wd, offsets, dz1, part, dx, dwu, dbu, dwd, dbd,
    # M, D, F, E, stream
    "tk_moe_bwd": (_I, [_I] + [_P] * 14 + [_I] * 4 + [_P]),
    "tk_moe_row_tile": (_I, [_I]),
    "tk_moe_error_string": (ctypes.c_char_p, [_I]),
}

# kernel launches since import (or since a caller reset them)
launches = {"forward_up": 0, "forward_down": 0, "backward_dh": 0, "backward_dx": 0,
            "backward_dwu": 0, "backward_dwd": 0}


def plan_rows(n_rows: int) -> tuple[int, int]:
    """(block_rows, padded_rows): tpukit's `_plan_rows`, the 8-aligned block
    edge and the row count padded to a whole number of blocks."""
    bt = min(BLOCK_ROWS, -(-n_rows // 8) * 8)
    return bt, -(-n_rows // bt) * bt


def check_bank(num_experts: int) -> None:
    """tpukit's `_check_bank`: the pallas dispatch takes at most 32 experts."""
    if num_experts > MAX_EXPERTS:
        raise ValueError(
            f"moe_dispatch='pallas' keeps the whole expert bank VMEM-resident and "
            f"unrolls over it: num_experts={num_experts} exceeds the supported "
            f"{MAX_EXPERTS} (shard experts over an ExpertParallel mesh, or use the "
            f"buffer dispatches)")


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------


def _segments(offsets, num_experts):
    bounds = offsets.tolist()
    return [(e, bounds[e], bounds[e + 1]) for e in range(num_experts)
            if bounds[e + 1] > bounds[e]]


def grouped_ffn_reference(xs, wu, bu, wd, bd, offsets):
    """The plain forward: per segment e, h = relu(x Wu[e] + bu[e]) in f32,
    rounded to the compute dtype, y = relu(h Wd[e] + bd[e]) in f32, rounded
    once. Rows outside every segment are 0."""
    dt = xs.dtype
    ys = torch.zeros_like(xs)
    for e, s, t in _segments(offsets, wu.shape[0]):
        h = torch.relu(xs[s:t].float() @ wu[e].float() + bu[e].float())
        ys[s:t] = torch.relu(h.to(dt).float() @ wd[e].float() + bd[e].float()).to(dt)
    return ys


def grouped_ffn_backward_reference(xs, g, ys, wu, bu, wd, offsets, h=None):
    """The plain backward, tpukit's `_bwd_kernel` (:145-214) per segment:
    dz2 = g where y > 0 (f32); dWd = round(h)^T round(dz2); dbd = sum dz2;
    dh = round(dz2) Wd^T; dz1 = dh where h > 0; dWu = x^T round(dz1);
    dbu = sum dz1 (unrounded); dx = round(dz1) Wu^T, rounded to the compute
    dtype. Returns (dx, dwu, dbu, dwd, dbd), the weight terms in f32.

    h recomputes in f32, as tpukit does, unless the caller hands over the
    forward's rounded h `[M, F]` (the kernels' input): then the relu mask
    reads it, as the kernels do, and a holding of the kernels against this
    version runs on the same inputs (an f32 h within summation noise of 0
    would otherwise flip the mask on one side only)."""
    dt = xs.dtype
    e_all, d, f = wu.shape
    dx = torch.zeros_like(xs)
    f32 = dict(dtype=torch.float32, device=xs.device)
    dwu, dbu = torch.zeros((e_all, d, f), **f32), torch.zeros((e_all, f), **f32)
    dwd, dbd = torch.zeros((e_all, f, d), **f32), torch.zeros((e_all, d), **f32)
    for e, s, t in _segments(offsets, e_all):
        x = xs[s:t].float()
        if h is None:
            hs = torch.relu(x @ wu[e].float() + bu[e].float())
        else:
            hs = h[s:t].float()
        dz2 = torch.where(ys[s:t] > 0, g[s:t].float(), 0.0)
        dz2_c = dz2.to(dt).float()
        dwd[e] = hs.to(dt).float().t() @ dz2_c
        dbd[e] = dz2.sum(0)
        dz1 = torch.where(hs > 0, dz2_c @ wd[e].float().t(), 0.0)
        dz1_c = dz1.to(dt).float()
        dwu[e] = x.t() @ dz1_c
        dbu[e] = dz1.sum(0)
        dx[s:t] = (dz1_c @ wu[e].float().t()).to(dt)
    return dx, dwu, dbu, dwd, dbd


# ---------------------------------------------------------------------------
# The CUDA path.
# ---------------------------------------------------------------------------


def _check(xs, wu, bu, wd, bd, offsets):
    if xs.dim() != 2 or wu.dim() != 3:
        raise ValueError(f"grouped_ffn takes xs [M, D] and wu [E, D, F], got "
                         f"{list(xs.shape)} and {list(wu.shape)}")
    m, d = xs.shape
    e, _, f = wu.shape
    want = {"wu": (e, d, f), "bu": (e, f), "wd": (e, f, d), "bd": (e, d), "offsets": (e + 1,)}
    for name, t in (("wu", wu), ("bu", bu), ("wd", wd), ("bd", bd), ("offsets", offsets)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"grouped_ffn: {name} must be {list(want[name])}, got "
                             f"{list(t.shape)}")
        if t.device != xs.device:
            raise ValueError(f"grouped_ffn: {name} is on {t.device}, xs on {xs.device}")
    if xs.dtype not in _KIND or any(t.dtype != xs.dtype for t in (wu, bu, wd, bd)):
        raise TypeError(f"grouped_ffn runs xs and the bank in one dtype, f32 or bf16; got "
                        f"{xs.dtype} and {[t.dtype for t in (wu, bu, wd, bd)]}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"grouped_ffn takes int32 offsets, got {offsets.dtype}")
    check_bank(e)
    if plan_rows(m)[1] != m:
        raise ValueError(f"grouped_ffn: {m} rows is not a whole number of "
                         f"{plan_rows(m)[0]}-row blocks; the caller pads the sorted rows")


def _route(xs) -> bool:
    """True for the plain version: a CPU tensor."""
    if xs.device.type == "cpu":
        return True
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_ffn runs on cpu or cuda, got {xs.device}")
    return False


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(code: int, lib, what: str) -> None:
    if code == 0:
        return
    if code == -1:
        msg = "no instance for this dtype"
    elif code == -2:
        msg = f"more than {MAX_EXPERTS} experts"
    else:
        msg = lib.tk_moe_error_string(code).decode()
    raise RuntimeError(f"grouped_ffn {what} kernel launch failed: {msg} ({code})")


def row_tiles(lib, dtype, m: int, e: int) -> int:
    """Upper bound on the one-expert row tiles of M rows over E segments:
    ceil(M / BM) + E (each segment adds at most one partial tile)."""
    bm = lib.tk_moe_row_tile(_KIND[dtype])
    return -(-m // bm) + e


def launch_forward(lib, xs, wu, bu, wd, bd, offsets, h, ys, stream: int) -> None:
    """The up kernel (h, rounded) then the down kernel (y)."""
    m, d = xs.shape
    e, _, f = wu.shape
    code = lib.tk_moe_fwd(_KIND[xs.dtype], _ptr(xs), _ptr(wu), _ptr(bu), _ptr(wd), _ptr(bd),
                          _ptr(offsets), _ptr(h), _ptr(ys), m, d, f, e,
                          ctypes.c_void_p(stream))
    _raise_on(code, lib, "forward")


def launch_backward(lib, xs, g, ys, h, wu, wd, offsets, dz1, part, dx, dwu, dbu, dwd, dbd,
                    stream: int) -> None:
    """The dh, dx, dWu and dWd kernels; `dz1 [M, F]` (compute dtype) and
    `part [row_tiles, F]` (f32) are scratch."""
    m, d = xs.shape
    e, _, f = wu.shape
    ptrs = [_ptr(t) for t in (xs, g, ys, h, wu, wd, offsets, dz1, part, dx, dwu, dbu, dwd, dbd)]
    code = lib.tk_moe_bwd(_KIND[xs.dtype], *ptrs, m, d, f, e, ctypes.c_void_p(stream))
    _raise_on(code, lib, "backward")


def _contiguous(*ts):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("grouped_ffn kernels take contiguous tensors")


def _forward_cuda(xs, wu, bu, wd, bd, offsets):
    _contiguous(xs, wu, bu, wd, bd, offsets)
    m, f = xs.shape[0], wu.shape[2]
    h = torch.empty((m, f), dtype=xs.dtype, device=xs.device)
    ys = torch.zeros_like(xs)  # rows outside every segment stay 0
    lib = _cuda.load("moe_gemm", _SIGNATURES)
    with torch.cuda.device(xs.device):
        launch_forward(lib, xs, wu, bu, wd, bd, offsets, h, ys,
                       torch.cuda.current_stream().cuda_stream)
    launches["forward_up"] += 1
    launches["forward_down"] += 1
    return ys, h


def _backward_cuda(xs, g, ys, h, wu, wd, offsets):
    g = g.contiguous()
    _contiguous(xs, ys, h, wu, wd, offsets)
    m, d = xs.shape
    e, _, f = wu.shape
    lib = _cuda.load("moe_gemm", _SIGNATURES)
    f32 = dict(dtype=torch.float32, device=xs.device)
    dz1 = torch.empty((m, f), dtype=xs.dtype, device=xs.device)
    part = torch.empty((row_tiles(lib, xs.dtype, m, e), f), **f32)
    dx = torch.zeros_like(xs)
    dwu, dbu = torch.empty((e, d, f), **f32), torch.empty((e, f), **f32)
    dwd, dbd = torch.empty((e, f, d), **f32), torch.empty((e, d), **f32)
    with torch.cuda.device(xs.device):
        launch_backward(lib, xs, g, ys, h, wu, wd, offsets, dz1, part, dx, dwu, dbu, dwd, dbd,
                        torch.cuda.current_stream().cuda_stream)
    for k in ("backward_dh", "backward_dx", "backward_dwu", "backward_dwd"):
        launches[k] += 1
    return dx, dwu, dbu, dwd, dbd


class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, wu, bu, wd, bd, offsets):
        if _route(xs):
            ys = grouped_ffn_reference(xs, wu, bu, wd, bd, offsets)
            ctx.save_for_backward(xs, wu, bu, wd, offsets, ys)
        else:
            ys, h = _forward_cuda(xs, wu, bu, wd, bd, offsets)
            ctx.save_for_backward(xs, wu, bu, wd, offsets, ys, h)
        return ys

    @staticmethod
    def backward(ctx, g):
        xs, wu, bu, wd, offsets, ys, *h = ctx.saved_tensors
        if _route(xs):
            dx, dwu, dbu, dwd, dbd = grouped_ffn_backward_reference(xs, g, ys, wu, bu, wd,
                                                                    offsets)
        else:
            dx, dwu, dbu, dwd, dbd = _backward_cuda(xs, g, ys, h[0], wu, wd, offsets)
        return dx, dwu.to(wu.dtype), dbu.to(bu.dtype), dwd.to(wd.dtype), dbd.to(wu.dtype), None


def grouped_ffn(xs, wu, bu, wd, bd, offsets):
    """Segment FFN over expert-sorted rows `xs [M, D]` (M a whole number of
    `plan_rows` blocks) with the bank `wu [E, D, F]`, `bu [E, F]`, `wd [E,
    F, D]`, `bd [E, D]` in xs's dtype and `offsets [E+1]` int32 (offsets[0]
    = 0, offsets[E] = M; sort padding folds into the last segment). Returns
    `[M, D]` in xs's dtype. CUDA tensors go through the kernels, CPU
    tensors through the plain version."""
    _check(xs, wu, bu, wd, bd, offsets)
    return _GroupedFFN.apply(xs, wu, bu, wd, bd, offsets)


# ---------------------------------------------------------------------------
# The dataflows around it.
# ---------------------------------------------------------------------------


def sort_plan(cfg, top_idx):
    """(src, inv, offsets) of the flattened `[B*S*K]` assignments, all on
    the device and with no host sync (tpukit `sort_plan`, :334):
      src     [M]   int32 flat token feeding each sorted row (M = B*S*K
                    padded by `plan_rows`; padding rows read row 0 and fold
                    into the last expert's segment)
      inv     [NK]  int32 sorted position of each (token, k) pair
      offsets [E+1] int32 segment boundaries, offsets[E] = M
    The sort is stable: within an expert, rows keep (b, s, k) order."""
    b, s, k = top_idx.shape
    nk = b * s * k
    _, m = plan_rows(nk)
    ids = top_idx.reshape(nk).to(torch.int32)
    if m > nk:
        ids = torch.cat([ids, ids.new_full((m - nk,), cfg.num_experts - 1)])
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(cfg.num_experts + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(sorted_ids, bounds, out_int32=True)  # count of ids < e
    inv = torch.empty_like(order)
    inv[order] = torch.arange(m, dtype=order.dtype, device=ids.device)
    src = torch.where(order < nk, torch.div(order, k, rounding_mode="floor"), 0)
    return src.to(torch.int32), inv[:nk].to(torch.int32), offsets


def pallas_kept_mask(cfg, x, router_kernel):
    """[B,S,E] 0/1 mask of the assignments the pallas dispatch keeps: all
    of them when dropless, else the buffer paths' `_kept_mask`."""
    _, _, _, _, assign = _route_topk(x, router_kernel, cfg)
    if cfg.moe_capacity > 0:
        return _kept_mask(assign, moe_capacity(cfg, x.shape[1]))
    return assign


def _bank(experts, dtype):
    up, down = experts["up"], experts["down"]
    return (up["kernel"].to(dtype), up["bias"].to(dtype), down["kernel"].to(dtype),
            down["bias"].to(dtype))


def _grouped_expert_ffn(experts, expert_in, dtype):
    """`_expert_ffn` over the exchange's `[E, R, C, D]` buffer by the
    grouped kernels: the buffer is expert-contiguous, so the sorted layout
    with equal static segments of R*C rows (the block padding folds into
    the last segment and is cut off)."""
    e, r, c, d = expert_in.shape
    n = e * r * c
    rows = expert_in.reshape(n, d)
    _, m = plan_rows(n)
    if m > n:
        rows = F.pad(rows, (0, 0, 0, m - n))
    offsets = torch.arange(e + 1, dtype=torch.int32, device=rows.device) * (r * c)
    offsets[-1] = m
    ys = grouped_ffn(rows, *_bank(experts, dtype), offsets)
    return ys[:n].reshape(e, r, c, d)


def moe_ffn_pallas(layer, cfg, x, pad_mask=None):
    """The grouped-GEMM MoE FFN; returns (out [B,S,D], aux scalar).
    Meshless (`cfg.moe_mesh` None): route, sort by expert, grouped FFN,
    unsort, gated combine; dropless unless `cfg.moe_capacity > 0`, where
    the buffer paths' drop mask zeroes the dropped assignments' gates.
    Under ExpertParallel: the exchange block with the grouped FFN."""
    if cfg.moe_mesh is not None:
        return _moe_ffn_exchange(layer, cfg, x, pad_mask, _grouped_expert_ffn, "pallas")
    check_bank(cfg.num_experts)
    xc, top_idx, top_vals, probs, assign = _route_topk(x, layer["ffn"]["router"]["kernel"], cfg)
    b, s, d = x.shape
    k = cfg.router_top_k
    gates = top_vals
    if cfg.moe_capacity > 0:
        kept = _kept_mask(assign, moe_capacity(cfg, s))
        gates = gates * kept.gather(-1, top_idx.long())
    src, inv, offsets = sort_plan(cfg, top_idx)
    xs = xc.reshape(b * s, d).index_select(0, src)
    ys = grouped_ffn(xs, *_bank(layer["ffn"]["experts"], cfg.compute_dtype), offsets)
    y_pairs = ys.index_select(0, inv).reshape(b, s, k, d)
    out = torch.einsum("bskd,bsk->bsd", y_pairs, gates.to(cfg.compute_dtype))
    return out, _aux(*_aux_stats(probs, assign, pad_mask, cfg), cfg)
