"""Context-parallel attention over a c10d sequence group (twin of
`tpukit/ring_attention.py`): the ring, contiguous and zigzag, and Ulysses.

Every rank of a `SeqGroup` holds `[B, H, S / P, D]` of q, k and v, its
shard of the sequence, and the `[B, S / P]` pad mask beside it.

  - `ring_causal_attention`: each rank keeps its query shard and an f32
    online-softmax state `(m, l, acc)` while the K/V blocks and their pad
    masks travel the ring, one hop a step, rank r sending to r + 1. After i
    hops a rank holds the block of rank `(r - i) mod P`. The contiguous
    layout skips the hops whose block lies in every local query's causal
    future; the zigzag layout (`zigzag_order`: rank d holds chunks d and
    2P-1-d of 2P) attends half a block on every hop but its diagonal one.
    Masks are tpukit's: the -1e9 causal term on global positions, then
    finfo(f32).min on padded keys, so a fully padded query row attends as
    tpukit's does (its :34-38).
  - `ulysses_attention`: one stacked all-to-all of q, k and v from
    sequence shards to head shards (`[B, H / P, S, D]`), the port's
    `causal_attention(impl="auto")` on the rank's heads (the flash kernels
    on CUDA), and the inverse exchange.

tpukit gets the ring's backward from autodiff through `ppermute`, `scan`
and `cond`. c10d's point-to-point calls have no autograd, so the ring here
is a `torch.autograd.Function` with its own backward ring: it saves q, k,
v, the output and the row log-sum-exp, recomputes each hop's
probabilities from the log-sum-exp (as a flash backward does), adds dq
locally, and carries f32 dk/dv accumulators around the ring with the K/V
blocks, so that each block's gradient arrives back at the rank that owns
it. Both directions post a hop's sends and receives
(`dist.batch_isend_irecv`) before its compute, as tpukit puts the
`ppermute` before the math; the accumulators, which the compute writes,
travel after it.

The hop math is plain PyTorch, as it is jnp in tpukit: products of the
input dtype's values accumulated in f32 (both operands widened to f32,
whose products of bf16 values are exact), the softmax state in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from tpukit_torch.ops.attention import NEG_INF, causal_attention

F32_MIN = torch.finfo(torch.float32).min
LAYOUTS = ("contiguous", "zigzag")


def zigzag_order(seq_len: int, ring: int) -> np.ndarray:
    """Token permutation of the causally balanced zigzag layout (a copy of
    tpukit's): `seq_len` in 2 * ring chunks, ordered so that a contiguous
    shard over `ring` ranks gives rank d chunks d and 2 * ring - 1 - d.
    Apply as `x[:, zigzag_order(S, P)]` before sharding."""
    if seq_len % (2 * ring):
        raise ValueError(f"zigzag needs seq_len % (2*ring) == 0, got {seq_len} over {ring}")
    c = seq_len // (2 * ring)
    idx = []
    for d in range(ring):
        idx.append(np.arange(d * c, (d + 1) * c))
        idx.append(np.arange((2 * ring - 1 - d) * c, (2 * ring - d) * c))
    return np.concatenate(idx)


@dataclasses.dataclass(frozen=True, eq=False)
class SeqGroup:
    """A rank's place on the `seq` axis of a `(data, seq)` grid: the c10d
    group (None at a degree of one), its size, this rank's index in it and
    the group's global ranks in sequence order (the ring's peers). Carried
    in `GPTConfig.cp`, it tells the attention to run over the group."""

    group: Any = None
    size: int = 1
    rank: int = 0
    ranks: tuple = (0,)

    @classmethod
    def of(cls, mesh) -> "SeqGroup":
        """This rank's place on a `(data, seq)` `DeviceMesh`
        (`mesh.create_cp_mesh`)."""
        size, rank = mesh.size(1), mesh.get_local_rank("seq")
        if size == 1:
            return cls(rank=0, ranks=(dist.get_rank(),))
        group = mesh.get_group("seq")
        return cls(group=group, size=size, rank=rank,
                   ranks=tuple(dist.get_process_group_ranks(group)))

    @property
    def next(self) -> int:
        return self.ranks[(self.rank + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.ranks[(self.rank - 1) % self.size]


def _post_hop(tensors: list, seq: SeqGroup) -> tuple[list, list]:
    """Send `tensors` to the next rank and receive their likes from the
    previous one, posted together; returns (the works, the buffers)."""
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, seq.next, group=seq.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, seq.prev, group=seq.group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _wait(works: list) -> None:
    for work in works:
        work.wait()


def _pass_home(dkv: torch.Tensor, seq: SeqGroup) -> tuple[list, torch.Tensor]:
    """The backward's hop of a block's dk/dv accumulator, along with the
    block itself."""
    works, (got,) = _post_hop([dkv], seq)
    return works, got


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` accumulated in f32, from operands in their own dtype (tpukit's
    `preferred_element_type=jnp.float32`)."""
    return torch.matmul(a.float(), b.float())


def _hop_block(layout: str, ring: int, me: int, src: int, s_local: int):
    """What a hop computes when this rank (`me`) holds the block of ring
    source `src`: None (skipped), or (query rows, key columns, the global
    positions of those rows and columns where the hop needs the causal
    term, else None). The zigzag's three shapes are tpukit's `hop_lower`,
    `hop_diag` and `hop_upper`."""
    every = slice(None)
    if layout == "contiguous":
        if src > me:  # wholly in every local query's causal future
            return None
        if src < me:  # every key precedes every query: the causal term adds 0
            return every, every, None
        pos = torch.arange(s_local)
        return every, every, (me * s_local + pos, src * s_local + pos)
    c = s_local // 2
    if src < me:  # both local chunks attend the source's early chunk
        return every, slice(0, c), None
    if src > me:  # the local late chunk attends both source chunks
        return slice(c, None), every, None
    ar = torch.arange(c)
    rows = torch.cat([me * c + ar, (2 * ring - 1 - me) * c + ar])
    return every, every, (rows, rows)


def _scores(q, k, scale: float, mask, causal) -> torch.Tensor:
    """f32 `q kᵀ * scale`, plus the -1e9 causal term on global positions,
    then finfo.min where the key is padding (tpukit's order)."""
    s = _mm(q, k.transpose(-1, -2)).mul_(scale)
    if causal is not None:
        rows, cols = (t.to(s.device) for t in causal)
        s.add_(torch.where(cols[None, :] <= rows[:, None], 0.0, NEG_INF))
    return s.masked_fill_(mask[:, None, None, :], F32_MIN)


class _RingAttention(torch.autograd.Function):
    """The ring, forward and backward (see the module's docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, seq, layout):
        ring, me, s_local = seq.size, seq.rank, q.shape[2]
        m = torch.full(q.shape[:3], -torch.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv, mask_c = torch.stack([k, v]), mask
        for i in range(ring):
            works = []
            if i < ring - 1:  # the next hop's block, posted before this hop's math
                works, (kv_next, mask_next) = _post_hop([kv, mask_c], seq)
            block = _hop_block(layout, ring, me, (me - i) % ring, s_local)
            if block is not None:
                rows, cols, causal = block
                s = _scores(q[:, :, rows], kv[0][:, :, cols], scale, mask_c[:, cols], causal)
                m_b = m[:, :, rows]
                m_new = torch.maximum(m_b, s.amax(-1))
                corr = torch.exp(m_b - m_new)
                p = s.sub_(m_new[..., None]).exp_()
                l[:, :, rows] = l[:, :, rows] * corr + p.sum(-1)
                acc[:, :, rows] = (acc[:, :, rows] * corr[..., None]
                                   + _mm(p.to(v.dtype), kv[1][:, :, cols]))
                m[:, :, rows] = m_new
                del s, p
            _wait(works)
            if i < ring - 1:
                kv, mask_c = kv_next, mask_next
        out = (acc / l[..., None]).to(v.dtype)
        ctx.save_for_backward(q, k, v, mask, out, m + torch.log(l))
        ctx.scale, ctx.seq, ctx.layout = scale, seq, layout
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, mask, out, lse = ctx.saved_tensors
        scale, seq, layout = ctx.scale, ctx.seq, ctx.layout
        ring, me, s_local = seq.size, seq.rank, q.shape[2]
        d_out = d_out.float()
        delta = (d_out * out.float()).sum(-1)  # rowsum(dO * O)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((2, *k.shape), dtype=torch.float32, device=k.device)
        kv, mask_c = torch.stack([k, v]), mask
        for i in range(ring):
            works = []
            if i < ring - 1:
                works, (kv_next, mask_next) = _post_hop([kv, mask_c], seq)
            block = _hop_block(layout, ring, me, (me - i) % ring, s_local)
            if block is not None:
                rows, cols, causal = block
                k_c, v_c = kv[0][:, :, cols], kv[1][:, :, cols]
                p = _scores(q[:, :, rows], k_c, scale, mask_c[:, cols], causal)
                p.sub_(lse[:, :, rows, None]).exp_()
                do = d_out[:, :, rows]
                dkv[1][:, :, cols] += _mm(p.transpose(-1, -2), do)
                ds = _mm(do, v_c.transpose(-1, -2)).sub_(delta[:, :, rows, None]).mul_(p)
                ds.mul_(scale)
                dq[:, :, rows] += _mm(ds, k_c)
                dkv[0][:, :, cols] += _mm(ds.transpose(-1, -2), q[:, :, rows])
                del p, ds
            if ring > 1:  # this block's accumulator moves on with it
                grad_works, dkv_next = _pass_home(dkv, seq)
                works = works + grad_works
            _wait(works)
            if ring > 1:
                dkv = dkv_next
            if i < ring - 1:
                kv, mask_c = kv_next, mask_next
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None, None


def ring_causal_attention(q, k, v, *, scale: float, seq: SeqGroup | None = None,
                          pad_mask=None, layout: str = "contiguous") -> torch.Tensor:
    """Exact causal attention over the sequence shards of `seq` (a world of
    one when None). q, k, v: this rank's `[B, H, S / P, D]`; `pad_mask`:
    its `[B, S / P]` bool, True = padding; `layout`: "contiguous" (rank d
    holds global rows `[d S/P, (d+1) S/P)`) or "zigzag" (chunks d and
    2P-1-d of 2P: the caller permuted by `zigzag_order`). Returns
    `[B, H, S / P, D]` in v's dtype."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    seq = SeqGroup() if seq is None else seq
    batch, _, s_local, _ = q.shape
    if layout == "zigzag" and s_local % 2:
        raise ValueError(f"zigzag local sequence must be even, got {s_local}")
    if pad_mask is None:
        pad_mask = torch.zeros((batch, s_local), dtype=torch.bool, device=q.device)
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                pad_mask.contiguous(), float(scale), seq, layout)


def _seq_to_heads(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """`[n, B, H, S/P, D]` sequence shards -> `[n, B, H/P, S, D]` head
    shards: head block j goes to rank j, and the gathered sequence is the
    ranks' shards in order (jax's tiled `all_to_all`, split axis 2,
    concat axis 3)."""
    n, b, h, s, d = x.shape
    p = seq.size
    send = x.reshape(n, b, p, h // p, s, d).permute(2, 0, 1, 3, 4, 5).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=seq.group)
    return got.permute(1, 2, 3, 0, 4, 5).reshape(n, b, h // p, p * s, d)


def _heads_to_seq(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The inverse exchange: `[n, B, H/P, S, D]` -> `[n, B, H, S/P, D]`."""
    n, b, hp, s, d = x.shape
    p = seq.size
    send = x.reshape(n, b, hp, p, s // p, d).permute(3, 0, 1, 2, 4, 5).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=seq.group)
    return got.permute(1, 2, 0, 3, 4, 5).reshape(n, b, p * hp, s // p, d)


class _SeqToHeads(torch.autograd.Function):
    """`_seq_to_heads` forward, `_heads_to_seq` of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _seq_to_heads(x, seq)

    @staticmethod
    def backward(ctx, ct):
        return _heads_to_seq(ct, ctx.seq), None


class _HeadsToSeq(torch.autograd.Function):
    """`_heads_to_seq` forward, `_seq_to_heads` of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _heads_to_seq(x, seq)

    @staticmethod
    def backward(ctx, ct):
        return _seq_to_heads(ct, ctx.seq), None


def _gather_seq(mask: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The `[B, S]` pad mask from every rank's `[B, S/P]` (no gradient)."""
    local = mask.to(torch.uint8).contiguous()
    b, s = local.shape
    parts = torch.empty((seq.size * b, s), dtype=torch.uint8, device=mask.device)
    dist.all_gather_into_tensor(parts, local, group=seq.group)
    return parts.reshape(seq.size, b, s).permute(1, 0, 2).reshape(b, -1).bool()


def ulysses_attention(q, k, v, *, scale: float, seq: SeqGroup | None = None,
                      pad_mask=None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) context parallelism on the contiguous
    layout: q, k, v `[B, H, S/P, D]` and `pad_mask [B, S/P]` as for the
    ring; heads must divide over the group. Returns `[B, H, S/P, D]` in
    v's dtype."""
    seq = SeqGroup() if seq is None else seq
    heads = q.shape[1]
    if heads % seq.size:
        raise ValueError(
            f"ulysses attention needs heads ({heads}) divisible by the "
            f"'seq' axis size ({seq.size}); use the ring schedule"
        )
    if seq.size == 1:
        return causal_attention(q, k, v, scale=scale, pad_mask=pad_mask, impl="auto")
    qkv = _SeqToHeads.apply(torch.stack([q, k, v]), seq)
    if pad_mask is not None:
        pad_mask = _gather_seq(pad_mask, seq)
    out = causal_attention(qkv[0], qkv[1], qkv[2], scale=scale, pad_mask=pad_mask,
                           impl="auto")
    return _HeadsToSeq.apply(out[None], seq)[0]
