"""Block-scaled quantized collectives and the gradient bucket scheduler
(twin of `tpukit/ops/quant_comm.py`), over c10d process groups.

Quantization (the EQuARX block layout, tpukit :13-28): values flatten to
blocks of `DEFAULT_BLOCK` (256) elements; each block carries one f32 scale
`amax / 127` (on the wire `amax * f32(1 / 127)`, as XLA compiles it) and its values `round(x * (127 / amax))` clipped to [-127,
127] as int8 (round-half-to-even, `torch.round` like `jnp.round`); an
all-zero block has scale 0 and dequantizes to exact zeros. With a key,
rounding is stochastic, `floor(v + U[0, 1))`, `U` drawn by the port's
threefry (`tpukit_torch.random.uniform`, the bits of `jax.random.uniform`).
A packed wire row is the int8 values of `n` elements followed by the f32
scales viewed as bytes (`bitcast_convert_type`'s little-endian order), so
one collective moves values and scales: `packed_bytes(n)` bytes.

Collectives take a process group (None: the default group) and its size
where tpukit takes an axis name and a static size. `quantized_all_reduce`
is the two-shot all-reduce: every rank's `[world, chunk]` rows through one
`all_to_all_single` (the reduce-scatter phase), the received rows summed in
f32 in rank order (int8 rows as tpukit's compiled program sums them, each
dequantizing product fused into the accumulation: `_sum_packed`), the
reduced chunk re-quantized and moved by one
`all_gather_into_tensor`. Only the wire is bf16 or int8; accumulation is
f32. At a world of one the quantize numerics stay and the collectives are
skipped. `bucket_all_reduce` keeps that shape at f32 too, so every
element's sum runs in rank order whatever the partition into buckets.

The autograd Functions are tpukit's custom vjps: `all_gather_qgrad` (a
full-precision gather forward, the quantized reduce-scatter of the
cotangent backward), `psum_grad` (identity forward, f32 all-reduce
backward), `bucket_gather_qgrad` (per-leaf gathers forward, one packed
reduce-scatter `all_to_all_single` per bucket backward) and the MoE
exchange `exchange_all_to_all` (its backward the mirrored hop at the same
payload dtype).

Trees are nested dicts. tpukit flattens them in sorted-key order
(`jax.tree_util`); the payloads' per-destination chunks, their 256-element
blocks and `grad_bucket_plan`'s buckets depend on that order, so this
module flattens in it (`sorted_items`) wherever a payload or a plan is
built, whatever order the dict was built in.

c10d moves the bytes it is given: a bf16 payload is 2 bytes an element on
gloo as on NCCL, where XLA:CPU upcasts it to 4 (`wire_itemsize("bf16",
"cpu")`). The port's wire matches the closed forms at `backend=None`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from tpukit_torch import random as tk_random

DEFAULT_BLOCK = 256  # elements per scale block (f32 sidecar: 4 B / block)

COMM_DTYPES = ("f32", "bf16", "int8")


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def wire_itemsize(dtype: str, backend: str | None = None) -> int:
    """Bytes an element of a `dtype` payload takes on the wire of tpukit's
    compiled program (XLA:CPU upcasts bf16 to f32: 4 there, 2 elsewhere;
    int8 is 1 everywhere)."""
    if dtype in ("int8", "s8"):
        return 1
    if dtype in ("bf16", "bfloat16"):
        return 4 if backend == "cpu" else 2
    return 4


def packed_bytes(n: int, block: int = DEFAULT_BLOCK) -> int:
    """Bytes of one packed int8 row covering `n` f32 elements: `n` int8
    values and one f32 scale per started block."""
    n = max(n, 1)
    return n + 4 * (-(-n // block))


def _check_dtype(dtype: str) -> None:
    if dtype not in COMM_DTYPES:
        raise ValueError(f"comm dtype must be one of {COMM_DTYPES}, got {dtype!r}")


# -- block quantize / dequantize -------------------------------------------


_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK, rng=None,
                    compiled: bool = False):
    """`x [..., chunk]` (chunk % block == 0) to `(q int8 [..., chunk],
    scales f32 [..., chunk // block])`, leading axes preserved. `rng` (a
    threefry key) switches round-to-nearest to stochastic rounding.
    `compiled` takes the scales as tpukit's compiled programs do: XLA
    rewrites `amax / 127.0` as `amax * f32(1 / 127)`, an ulp off the
    quotient in about one block in nine; tpukit's collectives only ever
    run compiled (eagerly, `jnp` divides)."""
    chunk = x.shape[-1]
    lead = x.shape[:-1]
    xb = x.float().reshape(*lead, chunk // block, block)
    amax = xb.abs().amax(-1)
    # true divisions by a tensor: with a Python scalar, torch may multiply
    # by a reciprocal instead (`127.0 / t` always, `t / 127.0` on cuda),
    # which can land an ulp away from `jnp`'s quotient
    c127 = torch.full_like(amax, 127.0)
    scales = amax * _INV_127 if compiled else amax / c127
    pos = amax > 0
    inv = torch.where(pos, c127 / torch.where(pos, amax, torch.ones_like(amax)),
                      torch.zeros_like(amax))
    v = xb * inv[..., None]
    if rng is not None:
        v = torch.floor(v + tk_random.uniform(rng.to(v.device), v.shape))
    else:
        v = torch.round(v)
    q = v.clamp(-127, 127).to(torch.int8).reshape(x.shape)
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of `quantize_blocks`: f32 `[..., chunk]`."""
    chunk = q.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], chunk // block, block)
    return (xb * scales[..., None]).reshape(q.shape)


def quantize_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK, rng=None):
    """Any tensor to `(q int8 [n_pad], scales f32 [n_pad // block])`, zero
    padded to a block multiple."""
    n = x.numel()
    chunk = _ceil_to(max(n, 1), block)
    flat = torch.nn.functional.pad(x.reshape(-1).float(), (0, chunk - n))
    q, scales = quantize_blocks(flat[None], block, rng)
    return q[0], scales[0]


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, shape,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of `quantize_blockwise` at the original `shape`."""
    n = math.prod(shape)
    return dequantize_blocks(q[None], scales[None], block)[0, :n].reshape(shape)


def pack_quantized(parts: torch.Tensor, block: int = DEFAULT_BLOCK, rng=None) -> torch.Tensor:
    """`[rows, n_c]` f32 rows to packed int8 rows of `packed_bytes(n_c)`
    bytes: the `n_c` values (the block padding never travels), then the
    scales as bytes, taken as tpukit's compiled wire takes them."""
    rows, n_c = parts.shape
    chunk = _ceil_to(max(n_c, 1), block)
    padded = torch.nn.functional.pad(parts.float(), (0, chunk - n_c))
    q, scales = quantize_blocks(padded, block, rng, compiled=True)
    sb = scales.contiguous().view(torch.int8).reshape(rows, -1)
    return torch.cat([q[:, :n_c], sb], dim=1)


def unpack_dequantized(packed: torch.Tensor, n_c: int, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of `pack_quantized`: f32 `[rows, n_c]`."""
    chunk = _ceil_to(max(n_c, 1), block)
    q = torch.nn.functional.pad(packed[:, :n_c], (0, chunk - n_c))
    scales = packed[:, n_c:].contiguous().view(torch.float32)
    return dequantize_blocks(q, scales, block)[:, :n_c]


def fallback_key(rank: int | None, sample: torch.Tensor) -> torch.Tensor:
    """The stochastic-rounding key of a site with no step key (tpukit
    `_fallback_key` :219): `PRNGKey(0x51C0)` folded with the rank on the
    axis (None: no fold) and with the bits of the f32 sum of `sample`. The
    sum's rounding follows torch's summation order, not XLA's, so these
    keys (and their noise) are not tpukit's bit for bit."""
    key = tk_random.PRNGKey(0x51C0, device=sample.device)
    if rank is not None:
        key = tk_random.fold_in(key, rank)
    word = sample.float().sum().reshape(1).view(torch.int32)[0]
    return tk_random.fold_in(key, word)


def _group_rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


# -- the wire ---------------------------------------------------------------


def _a2a_rows(rows: torch.Tensor, group, async_op: bool = False):
    """Row j of `rows [world, n]` to rank j; row i of the result from rank
    i (tpukit's tiled all_to_all, split and concat axis 0). With
    `async_op`, (the result's buffer, the handle)."""
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    work = dist.all_to_all_single(out, rows, group=group, async_op=async_op)
    return (out, work) if async_op else out


def _gather_rows(row: torch.Tensor, group, world: int, async_op: bool = False):
    """`[world, *row.shape]`: every rank's `row` in rank order. With
    `async_op`, (the result's buffer, the handle)."""
    row = row.contiguous()
    out = row.new_empty(world * row.numel())  # gloo takes a flat output
    work = dist.all_gather_into_tensor(out, row.reshape(-1), group=group, async_op=async_op)
    out = out.view((world,) + tuple(row.shape))
    return (out, work) if async_op else out


def _wait(work) -> None:
    if work is not None:
        work.wait()


def _sum_rows(vals: torch.Tensor) -> torch.Tensor:
    """`vals [world, n]` summed over the ranks in f32, in rank order (the
    same bits for any partition of the elements into payloads)."""
    red = vals[0].float().clone()
    for i in range(1, vals.shape[0]):
        red += vals[i].float()
    return red


def _sum_packed(packed: torch.Tensor, n_c: int, block: int) -> torch.Tensor:
    """The packed rows `[world, packed_bytes(n_c)]` dequantized and summed
    in rank order: `[n_c]` f32, as tpukit's compiled wire sums them. XLA
    fuses the dequantizing product into the accumulation, so after the
    first row's product each row is added with one rounding (a fused
    multiply-add): `acc = fma(q_r, s_r, acc)`. The product of an int8 and
    an f32 scale is exact in f64, so the f64 sum rounded to f32 is that
    fused result (short of a double rounding at an exact f32 midpoint)."""
    world = packed.shape[0]
    chunk = _ceil_to(max(n_c, 1), block)
    q = torch.nn.functional.pad(packed[:, :n_c], (0, chunk - n_c)).reshape(world, -1, block)
    scales = packed[:, n_c:].contiguous().view(torch.float32)
    acc = q[0].float() * scales[0][:, None]
    for r in range(1, world):
        acc = (q[r].double() * scales[r].double()[:, None] + acc.double()).float()
    return acc.reshape(-1)[:n_c]


class _ScatterShot:
    """The reduce-scatter phase of `parts [world, n_c]` f32 (row j bound for
    rank j) in two steps: `start` packs the rows (f32 raw, bf16 cast, int8
    packed with the key `rng`) and issues one `all_to_all_single`,
    `reduced` waits on it and sums the received rows in f32 in rank order:
    this rank's `[n_c]`. With `async_op` the collective returns a handle,
    so work can run between the steps; back to back they are the same bits
    either way."""

    def __init__(self, parts: torch.Tensor, group, world: int, dtype: str, block: int,
                 rng=None, async_op: bool = False):
        self.parts, self.group, self.world = parts, group, world
        self.dtype, self.block, self.rng, self.async_op = dtype, block, rng, async_op
        self.chunk = parts.shape[1]
        self.recv = self.work = None

    def _move(self, fn, t, *args):
        if self.world == 1:
            return t[None] if fn is _gather_rows else t
        if not self.async_op:
            return fn(t, self.group, *args)
        out, self.work = fn(t, self.group, *args, async_op=True)
        return out

    def start(self) -> None:
        if self.dtype == "int8":
            payload = pack_quantized(self.parts, self.block, self.rng)
        else:
            payload = self.parts if self.dtype == "f32" else self.parts.to(torch.bfloat16)
        self.recv = self._move(_a2a_rows, payload)
        self.parts = None

    def reduced(self) -> torch.Tensor:
        _wait(self.work)
        self.work = None
        recv, self.recv = self.recv, None
        if self.dtype == "int8":
            return _sum_packed(recv, self.chunk, self.block)
        return _sum_rows(recv)


class _TwoShot(_ScatterShot):
    """The two-shot all-reduce of `parts [world, chunk]` f32: `_ScatterShot`
    (`start`), then `middle` re-packs the reduced chunk (the second key of
    `rng` split in two) and issues the all-gather, and `finish` waits on it
    and returns `[world * chunk]` f32, the whole sum on every rank."""

    def __init__(self, parts: torch.Tensor, group, world: int, dtype: str, block: int,
                 rng=None, async_op: bool = False):
        r1 = self.r2 = None
        if dtype == "int8" and rng is not None:
            r1, self.r2 = tk_random.split(rng, 2)
        super().__init__(parts, group, world, dtype, block, r1, async_op)
        self.gathered = None

    def middle(self) -> None:
        red = self.reduced()
        if self.dtype == "int8":
            row = pack_quantized(red[None], self.block, self.r2)[0]
        else:
            row = red if self.dtype == "f32" else red.to(torch.bfloat16)
        self.gathered = self._move(_gather_rows, row, self.world)

    def finish(self) -> torch.Tensor:
        _wait(self.work)
        if self.dtype == "int8":
            return unpack_dequantized(self.gathered, self.chunk, self.block).reshape(-1)
        return self.gathered.float().reshape(-1)


def _two_shot(parts: torch.Tensor, group, world: int, dtype: str, block: int,
              rng=None) -> torch.Tensor:
    """`_TwoShot`'s steps back to back, blocking."""
    shot = _TwoShot(parts, group, world, dtype, block, rng)
    shot.start()
    shot.middle()
    return shot.finish()


def _rows_of(x: torch.Tensor, world: int) -> torch.Tensor:
    """`x` flattened in f32, zero padded to `[world, chunk]`."""
    n = x.numel()
    chunk = _ceil_to(max(n, 1), world) // world
    flat = torch.nn.functional.pad(x.reshape(-1).float(), (0, world * chunk - n))
    return flat.reshape(world, chunk)


def quantized_all_reduce(x: torch.Tensor, group, world: int, dtype: str = "int8",
                         block: int = DEFAULT_BLOCK, rng=None) -> torch.Tensor:
    """`x` summed over `group` with a bf16 or int8 payload (tpukit :246):
    the two-shot exchange, f32 accumulation. "f32" is a plain all-reduce."""
    _check_dtype(dtype)
    if dtype == "f32":
        out = x.clone()
        if world > 1:
            dist.all_reduce(out, group=group)
        return out
    res = _two_shot(_rows_of(x, world), group, world, dtype, block, rng)
    return res[:x.numel()].reshape(x.shape).to(x.dtype)


def quantized_reduce_scatter(x: torch.Tensor, group, world: int, dim: int = 0,
                             dtype: str = "int8", block: int = DEFAULT_BLOCK,
                             rng=None) -> torch.Tensor:
    """`x` summed over `group`, this rank's piece of dimension `dim` kept
    (tpukit :307; the dimension must divide by `world`): one
    `all_to_all_single` of the per-destination rows, f32 accumulation.
    "f32" is a plain reduce-scatter."""
    _check_dtype(dtype)
    if x.shape[dim] % world:
        raise ValueError(f"reduce-scatter dim {dim} of shape {tuple(x.shape)} must divide by "
                         f"the {world}-way axis")
    moved = x.movedim(dim, 0)
    shard_shape = (moved.shape[0] // world,) + tuple(moved.shape[1:])
    if dtype == "f32":
        if world == 1:
            return x.clone()
        out = moved.new_empty(shard_shape)
        dist.reduce_scatter_tensor(out, moved.contiguous(), group=group)
        return out.movedim(0, dim)
    parts = moved.float().reshape(world, -1)
    red = _scatter_sum(parts, group, world, dtype, block, rng)
    return red.reshape(shard_shape).movedim(0, dim).to(x.dtype)


def _scatter_sum(parts: torch.Tensor, group, world: int, dtype: str, block: int,
                 rng=None) -> torch.Tensor:
    """The reduce-scatter phase alone (`_ScatterShot`, blocking): `parts
    [world, n_c]` (row j bound for rank j) moved by one `all_to_all_single`
    and summed in f32: this rank's `[n_c]`."""
    shot = _ScatterShot(parts, group, world, dtype, block, rng)
    shot.start()
    return shot.reduced()


def quantized_all_gather(x: torch.Tensor, group, world: int, dim: int = 0,
                         dtype: str = "int8", block: int = DEFAULT_BLOCK,
                         rng=None) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` with a compressed payload
    (tpukit :342; each source's scales ride its packed row). "f32" is a
    plain all-gather."""
    _check_dtype(dtype)
    moved = x.movedim(dim, 0)
    if dtype == "f32":
        vals = _gather_rows(moved, group, world) if world > 1 else moved[None]
    elif dtype == "bf16":
        payload = moved.to(torch.bfloat16)
        gathered = _gather_rows(payload, group, world) if world > 1 else payload[None]
        vals = gathered.float()
    else:
        row = pack_quantized(moved.reshape(1, -1), block, rng)[0]
        gathered = _gather_rows(row, group, world) if world > 1 else row[None]
        vals = unpack_dequantized(gathered, moved.numel(), block)
    full = vals.reshape((world * moved.shape[0],) + tuple(moved.shape[1:]))
    return full.movedim(0, dim).to(x.dtype)


def gather_dim(x: torch.Tensor, group, world: int, dim: int) -> torch.Tensor:
    """The full-precision tiled all-gather of `x` along `dim`."""
    parts = _gather_rows(x, group, world)  # [world, *x.shape]
    shape = list(x.shape)
    shape[dim] *= world
    return parts.movedim(0, dim).reshape(shape)


# -- trees ------------------------------------------------------------------


def sorted_items(tree: dict, prefix: tuple = ()) -> list:
    """`[(path, leaf)]` of a nested dict in `jax.tree_util`'s order (keys
    sorted at every level); `path` is the tuple of keys."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(sorted_items(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _rebuild(tree: dict, values: dict, prefix: tuple = ()) -> dict:
    """A dict shaped like `tree` (its own key order) holding `values[path]`."""
    return {k: _rebuild(v, values, prefix + (k,)) if isinstance(v, dict) else values[prefix + (k,)]
            for k, v in tree.items()}


def quantized_psum_tree(tree: dict, group, world: int, dtype: str = "int8",
                        block: int = DEFAULT_BLOCK, rng=None) -> dict:
    """`quantized_all_reduce` of a whole tree as one payload (tpukit :292;
    one `all_to_all_single` and one all-gather however many leaves), the
    leaves concatenated in tpukit's order; leaf dtypes and shapes
    restored."""
    items = sorted_items(tree)
    flat = torch.cat([leaf.reshape(-1).float() for _, leaf in items])
    red = quantized_all_reduce(flat, group, world, dtype, block, rng)
    out, off = {}, 0
    for path, leaf in items:
        out[path] = red[off:off + leaf.numel()].reshape(leaf.shape).to(leaf.dtype)
        off += leaf.numel()
    return _rebuild(tree, out)


# -- custom-vjp twins --------------------------------------------------------


class _AllGatherQGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, dim, dtype, block, stochastic):
        ctx.args = (group, world, dim, dtype, block, stochastic)
        return gather_dim(x, group, world, dim)

    @staticmethod
    def backward(ctx, g):
        group, world, dim, dtype, block, stochastic = ctx.args
        rng = fallback_key(_group_rank(group), g) if stochastic and dtype == "int8" else None
        return (quantized_reduce_scatter(g, group, world, dim, dtype, block, rng),
                None, None, None, None, None, None)


def all_gather_qgrad(x: torch.Tensor, group, world: int, dim: int, dtype: str,
                     block: int = DEFAULT_BLOCK, stochastic: bool = False) -> torch.Tensor:
    """FSDP gather-at-use with a quantized gradient wire (tpukit :377): a
    full-precision all-gather of the shard along `dim` forward, the
    quantized reduce-scatter of the cotangent backward. Identity at a world
    of one."""
    if world <= 1:
        return x
    return _AllGatherQGrad.apply(x, group, world, dim, dtype, block, stochastic)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.world > 1:
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


def psum_grad(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """Identity forward, f32 all-reduce of the cotangent backward (tpukit
    :407): a replicated leaf inside the hand-placed FSDP step."""
    return _PsumGrad.apply(x, group, world)


class BucketScatter:
    """One FSDP bucket's reduce-scatter (tpukit :666) in two steps: the
    bucket's cotangents `gs` (each the whole gathered shape) as one `[world,
    n_c]` payload, one `all_to_all_single` issued at construction (a handle
    with `async_op`); `finish()` waits, sums in f32 in rank order and
    splits each leaf's shard back out."""

    def __init__(self, gs, group, world: int, dims, dtype: str, block: int,
                 stochastic: bool, async_op: bool = False):
        parts, self.shapes = [], []
        for g, dim in zip(gs, dims):
            moved = g.movedim(dim, 0)
            self.shapes.append((moved.shape[0] // world,) + tuple(moved.shape[1:]))
            parts.append(moved.float().reshape(world, -1))
        row = torch.cat(parts, dim=1)
        rng = None
        if dtype == "int8" and stochastic:
            rng = fallback_key(_group_rank(group), row)
        self.dims, self.dtypes = tuple(dims), [g.dtype for g in gs]
        self.shot = _ScatterShot(row, group, world, dtype, block, rng, async_op)
        self.shot.start()

    def finish(self) -> list:
        red = self.shot.reduced()
        out, off = [], 0
        for shape, dim, dtype in zip(self.shapes, self.dims, self.dtypes):
            n = math.prod(shape)
            out.append(red[off:off + n].reshape(shape).movedim(0, dim).to(dtype))
            off += n
        return out


def _bucket_scatter_grads(gs, group, world: int, dims, dtype: str, block: int,
                          stochastic: bool) -> list:
    """`BucketScatter`, blocking: each leaf's reduced shard."""
    return BucketScatter(gs, group, world, dims, dtype, block, stochastic).finish()


class _BucketGatherQGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, args, *xs):
        group, world, dims, dtype, block, stochastic = args
        ctx.args = args
        return tuple(gather_dim(x, group, world, d) for x, d in zip(xs, dims))

    @staticmethod
    def backward(ctx, *gs):
        group, world, dims, dtype, block, stochastic = ctx.args
        return (None, *_bucket_scatter_grads(gs, group, world, dims, dtype, block, stochastic))


def bucket_gather_qgrad(xs, group, world: int, dims, dtype: str, block: int = DEFAULT_BLOCK,
                        stochastic: bool = False) -> tuple:
    """FSDP gather-at-use of one bucket of sharded leaves (tpukit :706):
    per-leaf full-precision all-gathers forward, one packed reduce-scatter
    `all_to_all_single` for the whole bucket backward, when the bucket's
    last cotangent lands. Identity at a world of one."""
    if world <= 1:
        return tuple(xs)
    return _BucketGatherQGrad.apply((group, world, tuple(dims), dtype, block, stochastic), *xs)


# -- MoE dispatch exchange ---------------------------------------------------


def _exchange_raw(x: torch.Tensor, group, world: int, mode: str) -> torch.Tensor:
    """The unquantized hop in `x`'s dtype. "dispatch": `[E, B, C, D]` ->
    `[E / w, w B, C, D]` (block j of the experts to rank j, the arrivals
    side by side on dim 1 in rank order: split axis 0, concat axis 1);
    "combine": the inverse (split axis 1, concat axis 0)."""
    if mode == "dispatch":
        e, b, c, d = x.shape
        x = x.contiguous()  # the einsum's layout: empty_like would keep its strides
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x, group=group)
        return got.reshape(world, e // world, b, c, d).transpose(0, 1).reshape(
            e // world, world * b, c, d)
    el, wb, c, d = x.shape
    send = x.reshape(el, world, wb // world, c, d).transpose(0, 1).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return got.reshape(el * world, wb // world, c, d)


def _exchange_int8(x: torch.Tensor, group, world: int, mode: str, block: int,
                   stochastic: bool) -> torch.Tensor:
    """One packed int8 hop (tpukit `_qa2a_impl` :428): each destination's
    elements quantized as one row (the combine's `[E_l, w, B, C, D]`
    transposed to destination-major first), one `all_to_all_single` of the
    packed rows."""
    if mode == "dispatch":
        e, b, c, d = x.shape
        el = e // world
        parts = x.float().reshape(world, el * b * c * d)
    else:
        el, wb, c, d = x.shape
        b = wb // world
        parts = x.float().reshape(el, world, b, c, d).transpose(0, 1).reshape(
            world, el * b * c * d)
    n_g = parts.shape[1]
    rng = fallback_key(_group_rank(group), parts) if stochastic else None
    vals = unpack_dequantized(_a2a_rows(pack_quantized(parts, block, rng), group), n_g, block)
    if mode == "dispatch":
        out = vals.reshape(world, el, b, c, d).transpose(0, 1).reshape(el, world * b, c, d)
    else:
        out = vals.reshape(world * el, b, c, d)
    return out.to(x.dtype)


def _exchange(x, group, world, mode, dtype, block, stochastic):
    if dtype == "int8":
        return _exchange_int8(x, group, world, mode, block, stochastic)
    if dtype == "bf16":
        return _exchange_raw(x.to(torch.bfloat16), group, world, mode).to(x.dtype)
    return _exchange_raw(x, group, world, mode)


class _Exchange(torch.autograd.Function):
    """A hop forward, the mirrored hop of the cotangent at the same payload
    dtype backward (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group, world, mode, dtype, block, stochastic):
        ctx.args = (group, world, mode, dtype, block, stochastic)
        return _exchange(x, group, world, mode, dtype, block, stochastic)

    @staticmethod
    def backward(ctx, g):
        group, world, mode, dtype, block, stochastic = ctx.args
        inverse = "combine" if mode == "dispatch" else "dispatch"
        return (_exchange(g, group, world, inverse, dtype, block, stochastic),
                None, None, None, None, None, None)


def exchange_all_to_all(x: torch.Tensor, group, world: int, mode: str, dtype: str = "f32",
                        block: int = DEFAULT_BLOCK, stochastic: bool = False) -> torch.Tensor:
    """The MoE token exchange (tpukit :487) with a selectable payload: "f32"
    moves the buffer as it is, "bf16" casts around the `all_to_all_single`
    in both directions, "int8" packs per destination. One
    `all_to_all_single` a hop either way."""
    _check_dtype(dtype)
    if mode not in ("dispatch", "combine"):
        raise ValueError(f"mode must be 'dispatch' or 'combine', got {mode!r}")
    return _Exchange.apply(x, group, world, mode, dtype, block, stochastic)


# -- bucket scheduler (--grad_buckets) ---------------------------------------


def _backward_rank(path) -> tuple[int, int]:
    """Backward-completion rank of a leaf path (tpukit :515): the head,
    then the final LayerNorm, then the layers, then the embeddings. The
    port's layer leaves are stacked (no per-layer index), one run."""
    names = list(path)
    if "lm_head" in names:
        return (0, 0)
    if "norm_out" in names:
        return (0, 1)
    if "layers" in names:
        return (1, 0)
    return (2, 0)


def _tree_leaf_size(leaf) -> int:
    """Bytes of a leaf (the partition's balance unit); a leaf without a
    dtype prices as f32."""
    n = math.prod(int(d) for d in leaf.shape)
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return n * dtype.itemsize
    try:
        return n * int(np.dtype(dtype).itemsize)
    except TypeError:
        return n * 4


def grad_bucket_plan(tree: dict, n_buckets: int, include=None) -> list[list[int]]:
    """`tree`'s leaves (indices in `sorted_items` order, tpukit's) in <=
    `n_buckets` contiguous buckets of about equal bytes, in backward
    completion order (tpukit :537). `include` restricts the partition to
    those indices (FSDP's sharded leaves)."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    items = [(i, _backward_rank(path), _tree_leaf_size(leaf))
             for i, (path, leaf) in enumerate(sorted_items(tree))
             if include is None or i in include]
    if not items:
        return []
    items.sort(key=lambda it: it[1])  # stable: ties keep tree order
    total = sum(size for _, _, size in items) or 1
    n_b = min(n_buckets, len(items))
    buckets: list[list[int]] = [[]]
    acc = 0
    for pos, (i, _, size) in enumerate(items):
        b = len(buckets) - 1
        if buckets[b] and b < n_b - 1 and (acc >= total * (b + 1) / n_b
                                           or len(items) - pos == n_b - 1 - b):
            buckets.append([])
        buckets[-1].append(i)
        acc += size
    return buckets


def bucket_all_reduce(x: torch.Tensor, group, world: int, dtype: str = "f32",
                      block: int = DEFAULT_BLOCK, rng=None) -> torch.Tensor:
    """One flat bucket summed over `group` by the two-shot exchange at every
    dtype, f32 included (tpukit :594): each element's sum runs in rank
    order, the same bits under any partition."""
    _check_dtype(dtype)
    res = _two_shot(_rows_of(x, world), group, world, dtype, block, rng)
    return res[:x.numel()].reshape(x.shape).to(x.dtype)


def bucketed_psum_tree(tree: dict, group, world: int, n_buckets: int, dtype: str = "f32",
                       block: int = DEFAULT_BLOCK, rng=None) -> dict:
    """The DDP bucket wire (tpukit :637): `grad_bucket_plan`'s buckets, one
    `bucket_all_reduce` each (`BucketAllReduce`, each waited on at once);
    bucket b's stochastic key is `fold_in(rng, b)`."""
    items = sorted_items(tree)
    out = {path: leaf for path, leaf in items}
    wire = BucketAllReduce(group, world, dtype, block, rng)
    for b, idxs in enumerate(grad_bucket_plan(tree, n_buckets)):
        wire.issue(b, [items[i][1] for i in idxs])
        for i, g in zip(idxs, wire.result(b)):
            out[items[i][0]] = g
    return _rebuild(tree, out)


class BucketAllReduce:
    """The DDP bucket wire issued bucket by bucket as the gradients come:
    `issue(b, leaves)` flattens bucket b's gradients (in `grad_bucket_plan`
    order) and issues its two-shot all-to-all, `advance()` takes every
    all-to-all issued so far on to its sum and all-gather, `result(b)`
    waits on bucket b's all-gather and returns its reduced gradients. Each
    collective is issued with `async_op`. The same bits as
    `bucketed_psum_tree` in any order of issue: bucket b's stochastic key
    is `fold_in(rng, b)` and each element's sum runs in rank order."""

    def __init__(self, group, world: int, dtype: str = "f32", block: int = DEFAULT_BLOCK,
                 rng=None):
        _check_dtype(dtype)
        self.group, self.world, self.dtype, self.block, self.rng = group, world, dtype, block, rng
        self._shots: dict = {}
        self._pending: list = []

    def issue(self, b: int, leaves: list) -> None:
        flat = torch.cat([g.reshape(-1).float() for g in leaves])
        b_rng = tk_random.fold_in(self.rng, b) if self.rng is not None else None
        shot = _TwoShot(_rows_of(flat, self.world), self.group, self.world, self.dtype,
                        self.block, b_rng, async_op=True)
        shot.start()
        self._shots[b] = (shot, [(g.shape, g.dtype) for g in leaves], flat.numel())
        self._pending.append(shot)

    def advance(self) -> None:
        for shot in self._pending:
            shot.middle()
        self._pending.clear()

    def result(self, b: int) -> list:
        self.advance()
        shot, meta, n = self._shots.pop(b)
        red = shot.finish()[:n]
        out, off = [], 0
        for shape, dtype in meta:
            k = math.prod(shape)
            out.append(red[off:off + k].reshape(shape).to(dtype))
            off += k
        return out


# -- closed-form expected bytes ----------------------------------------------


def expected_all_reduce(n: int, world: int, dtype: str, block: int = DEFAULT_BLOCK,
                        backend: str | None = None) -> dict | None:
    """`{op: {count, bytes}}` of one two-shot all-reduce over `n` f32
    elements (tpukit :745): one all-to-all and one all-gather of `[world,
    row]`; None for f32 or a world of one."""
    if dtype == "f32" or world <= 1:
        return None
    chunk = _ceil_to(max(n, 1), world) // world
    row = packed_bytes(chunk, block) if dtype == "int8" else chunk * wire_itemsize("bf16", backend)
    return {"all-to-all": {"count": 1, "bytes": world * row},
            "all-gather": {"count": 1, "bytes": world * row}}


def expected_reduce_scatter(n: int, world: int, dtype: str, block: int = DEFAULT_BLOCK,
                            backend: str | None = None) -> dict | None:
    """One quantized reduce-scatter of an `n`-element leaf (tpukit :766):
    one all-to-all of `[world, row]`."""
    if dtype == "f32" or world <= 1:
        return None
    n_c = -(-n // world)
    row = packed_bytes(n_c, block) if dtype == "int8" else n_c * wire_itemsize("bf16", backend)
    return {"all-to-all": {"count": 1, "bytes": world * row}}


def _bucket_row_bytes(n_c: int, dtype: str, block: int, backend: str | None) -> int:
    if dtype == "int8":
        return packed_bytes(n_c, block)
    if dtype == "bf16":
        return n_c * wire_itemsize("bf16", backend)
    return n_c * 4


def expected_bucketed_all_reduce(sizes, world: int, dtype: str, block: int = DEFAULT_BLOCK,
                                 backend: str | None = None) -> dict | None:
    """The DDP bucket wire (tpukit :793): one two-shot pair a bucket of
    `sizes` elements, f32 priced too."""
    sizes = [s for s in sizes if s > 0]
    if not sizes or world <= 1:
        return None
    total = 0
    for n in sizes:
        chunk = _ceil_to(max(n, 1), world) // world
        total += world * _bucket_row_bytes(chunk, dtype, block, backend)
    return {"all-to-all": {"count": len(sizes), "bytes": total},
            "all-gather": {"count": len(sizes), "bytes": total}}


def expected_bucketed_reduce_scatter(sizes, world: int, dtype: str,
                                     block: int = DEFAULT_BLOCK,
                                     backend: str | None = None) -> dict | None:
    """The FSDP bucket wire (tpukit :816): one packed reduce-scatter
    all-to-all a bucket of `sizes` elements."""
    sizes = [s for s in sizes if s > 0]
    if not sizes or world <= 1:
        return None
    total = sum(world * _bucket_row_bytes(n // world, dtype, block, backend) for n in sizes)
    return {"all-to-all": {"count": len(sizes), "bytes": total}}
