"""Paged-attention decode: the CUDA kernels and their plain PyTorch version
(twin of `tpukit/ops/paged_attention.py:105,174`).

`paged_attend` takes one query token per slot (the decode tick) and attends
over the slot's window `[0, start]`, read through its block-table row from
the page pool, with this tick's fresh k/v standing at position `start`. It
returns the attention output before the output projection.

  - On a CPU tensor it runs `paged_attend_reference`: `gather_view`, insert
    the fresh k/v at the cursor, then the `_attend_over_cache` core.
  - On a CUDA tensor it launches `csrc/paged_attention.cu` (built with nvcc
    for sm_90a on first use) or raises. There is no path from a CUDA tensor
    to the plain version.

`fused_paged_attention` is its twin of tpukit's tensor-parallel wrapper:
each rank calls `paged_attend` on its own heads.

The kernels split each window into runs of pages (`plan`): a scores kernel
and a values kernel over (slot, head, split) units, and a combine kernel
that sums the splits' partial outputs. `launches` counts each kernel's
launches; nothing else changes it, so a run can show that its decode ticks
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpukit_torch.ops import _cuda, quant_comm
from tpukit_torch.serve.paged import gather_view

NEG_INF = -1e9  # the causal mask value of the JAX model
MAX_HEAD_DIM = 256  # the values kernel's lanes hold 16 f32 sums each (fits D <= 512)

_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_COMPUTE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    # (pool kind, N, H, P, D, MP, int[6] out)
    "tk_paged_plan": (ctypes.c_int, [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    # (pool kind, compute kind, 11 pointers, N, H, P, D, MP, nb, pps, scale, stream)
    "tk_paged_attend": (ctypes.c_int, [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]),
    "tk_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# kernel launches since import (or since a caller reset them), per kernel
launches = {"scores": 0, "values": 0, "combine": 0}


def attend_core(q, k, v, q_pos):
    """`_attend_over_cache` before the projection (tpukit/model/gpt.py:618):
    `q [B, H, T, D]` over `k`/`v [B, H, W, D]`, causal window
    `key_pos <= q_pos` (`q_pos [B, 1, T, 1]`). Scores in the compute dtype,
    scaled by 1/sqrt(D) in that dtype, masked with -1e9, softmax in f32
    (divide before the value dot), probabilities back in the compute dtype.
    Returns `[B, H, T, D]`."""
    cdt = q.dtype
    d = q.shape[-1]
    scale = torch.tensor(1.0 / d**0.5, dtype=cdt, device=q.device)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    key_pos = torch.arange(k.shape[2], device=q.device)
    scores = torch.where(key_pos <= q_pos, scores,
                         torch.tensor(NEG_INF, dtype=cdt, device=q.device))
    s32 = scores.float()
    p = torch.exp(s32 - s32.amax(-1, keepdim=True))
    probs = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.matmul(probs, v)


def paged_attend_reference(pool_k, pool_v, scale_k, scale_v, bt, start, q,
                           k_new, v_new):
    """The plain PyTorch version of the kernel: gather the window, insert
    the fresh k/v at `idx = min(start, W - 1)`, attend. Same arguments and
    result as `paged_attend`."""
    cdt = q.dtype
    view_k = gather_view(pool_k, scale_k, bt, cdt)
    view_v = gather_view(pool_v, scale_v, bt, cdt)
    n, w = view_k.shape[0], view_k.shape[2]
    rows = torch.arange(n, device=q.device)
    idx = start.long().clamp(0, w - 1)
    view_k[rows, :, idx] = k_new
    view_v[rows, :, idx] = v_new
    q_pos = start.long()[:, None, None, None]
    return attend_core(q[:, :, None, :], view_k, view_v, q_pos)[:, :, 0, :]


def _check(pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new):
    num_pages, heads, page, head_dim = pool_k.shape
    n, mp = bt.shape
    tensors = dict(pool_k=pool_k, pool_v=pool_v, bt=bt, start=start, q=q,
                   k_new=k_new, v_new=v_new)
    quant = scale_k is not None
    if quant:
        tensors.update(scale_k=scale_k, scale_v=scale_v)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_attend: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attend: {name} must be contiguous")
    if pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("paged_attend: pool_k and pool_v differ in shape or dtype")
    if pool_k.dtype not in _POOL_KIND or q.dtype not in _COMPUTE_KIND:
        raise TypeError(
            f"paged_attend: pools must be f32, bf16 or int8 and q f32 or bf16, "
            f"got {pool_k.dtype} / {q.dtype}"
        )
    if (pool_k.dtype == torch.int8) != quant:
        raise ValueError("paged_attend: int8 pools need scales; other pools take none")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.shape != (n, heads, head_dim) or t.dtype != q.dtype:
            raise ValueError(
                f"paged_attend: {name} must be [{n}, {heads}, {head_dim}] in "
                f"{q.dtype}, got {list(t.shape)} {t.dtype}"
            )
    if bt.dtype != torch.int32 or start.dtype != torch.int32 or start.shape != (n,):
        raise ValueError("paged_attend: bt [N, MP] and start [N] must be int32")
    if quant:
        if (page * head_dim) % quant_comm.DEFAULT_BLOCK:
            raise ValueError(
                f"int8 pages need page_size x head_dim ({page} x {head_dim}) "
                f"to tile into {quant_comm.DEFAULT_BLOCK}-element quant blocks "
                f"(paged.validate_kv_layout enforces this upstream)"
            )
        nb = (page * head_dim) // quant_comm.DEFAULT_BLOCK
        for name, t in (("scale_k", scale_k), ("scale_v", scale_v)):
            if t.shape != (num_pages, heads, nb) or t.dtype != torch.float32:
                raise ValueError(f"paged_attend: {name} must be [{num_pages}, "
                                 f"{heads}, {nb}] f32")
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"paged_attend: head_dim {head_dim} > {MAX_HEAD_DIM}")


def plan(lib, pool_dtype, n: int, heads: int, page: int, head_dim: int, mp: int) -> dict:
    """The kernels' plan at these static shapes on the current card
    (`tk_paged_plan`): pages a split, splits a window, ring stages, f32
    scratch elements, bulk copies for an aligned pool (else byte loads),
    and the larger block's shared memory."""
    out = (ctypes.c_int * 6)()
    if lib.tk_paged_plan(_POOL_KIND[pool_dtype], n, heads, page, head_dim, mp, out) != 0:
        raise ValueError(f"paged_attend: no kernel for {pool_dtype} pools")
    keys = ("pages_per_split", "splits", "stages", "scratch", "bulk", "smem")
    return dict(zip(keys, out))


@functools.lru_cache(maxsize=256)
def _card_plan(lib, pool_dtype, n, heads, page, head_dim, mp, device_index) -> dict:
    """`plan` once per shape and card: static shapes and the card's SM
    count fix it. Call with `device_index` current."""
    return plan(lib, pool_dtype, n, heads, page, head_dim, mp)


def launch(lib, pl, pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new, out,
           stream: int) -> None:
    """The kernels on checked operands, as `pl` (`plan` at their shapes)
    lays them out, writing `out`; the f32 scratch comes from `torch.empty`
    on q's device. Reads nothing back."""
    heads, page, head_dim = pool_k.shape[1:]
    n, mp = bt.shape
    nb = scale_k.shape[-1] if scale_k is not None else 0
    scratch = torch.empty((pl["scratch"],), dtype=torch.float32, device=q.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    code = lib.tk_paged_attend(
        _POOL_KIND[pool_k.dtype], _COMPUTE_KIND[q.dtype], ptr(pool_k), ptr(pool_v),
        ptr(scale_k), ptr(scale_v), ptr(bt), ptr(start), ptr(q), ptr(k_new), ptr(v_new),
        ptr(out), ptr(scratch), n, heads, page, head_dim, mp, nb, pl["pages_per_split"],
        1.0 / head_dim**0.5, ctypes.c_void_p(stream))
    if code != 0:
        msg = {-1: "unknown dtype kind or an empty split",
               -2: f"pages of {page} x {head_dim} need {pl['smem']} B of shared memory a "
                   f"block, over the limit"}.get(code)
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{msg or lib.tk_error_string(code).decode()} ({code})")


def paged_attend(pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new):
    """Fused paged decode attention over one layer's pools.

    pool_k/pool_v `[NP, H, P, D]` (f32/bf16, or int8 with `scale_k`/`scale_v`
    `[NP, H, P*D/256]` f32; None scales for other pools); bt `[N, MP]` int32;
    start `[N]` int32 cursors (>= 0); q/k_new/v_new `[N, H, D]` in the
    compute dtype. Returns `[N, H, D]` in the compute dtype."""
    if q.device.type == "cpu":
        return paged_attend_reference(pool_k, pool_v, scale_k, scale_v, bt,
                                      start, q, k_new, v_new)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attend runs on cpu or cuda, got {q.device}")
    _check(pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new)
    out = torch.empty_like(q)
    if bt.shape[0] == 0:
        return out
    lib = _cuda.load("paged_attention", _SIGNATURES)
    heads, page, head_dim = pool_k.shape[1:]
    with torch.cuda.device(q.device):
        pl = _card_plan(lib, pool_k.dtype, bt.shape[0], heads, page, head_dim, bt.shape[1],
                        q.device.index)
        launch(lib, pl, pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new, out,
               torch.cuda.current_stream(q.device).cuda_stream)
    for k in launches:
        launches[k] += 1
    return out


def fused_paged_attention(pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new,
                          tp=None, heads: int | None = None):
    """`paged_attend` on a rank's heads (twin of tpukit
    `ops/paged_attention.py:239`, whose `shard_map` gives each device of
    the `model` axis its heads). Here each rank already holds its heads'
    pools and scales and its heads of `q`, `k_new` and `v_new`, so it calls
    `paged_attend` on them; the block tables and cursors are the same on
    every rank, and nothing is exchanged. `tp` is the rank's
    `ops.layers.ModelGroup` (None: one device) and `heads` the model's
    head count, which the group's degree must divide."""
    m = 1 if tp is None else tp.size
    if m > 1:
        heads = q.shape[1] if heads is None else heads
        if heads % m:
            raise ValueError(
                f"fused paged attention shards heads over the model axis: heads={heads} "
                f"must divide model={m} (the paged serving grid picker guarantees this)")
    return paged_attend(pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new)
