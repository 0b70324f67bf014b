"""Batched KV-cached decode for the serving engine and the samplers (twin
of `tpukit/serve/decode.py`), over the ring cache (`gpt.init_kv_cache`)
or the paged one.

  - `prefill_slots` (ring): write an admit batch of bucket-padded prompts
    into their slots' buffer rows and ring rows, one batched forward;
  - `prefill_chunk_paged` (paged): forward the next chunk of every
    prefilling lane in one batched call, writing whole pages; lanes on
    their last chunk arm their decode state;
  - `decode_step`: `steps` ticks for every slot; a slot that finishes
    mid-quantum stays frozen for the rest of it;
  - `decode_loop_window`: up to `max_ticks` ticks that stop early when
    every lane is done or finished lanes have freed `stop_when_freed`
    pages. tpukit runs the loop on the device; here the host checks the
    condition after each tick;
  - `adopt_slot` (paged): arm a lane whose pages another engine
    prefilled, the decode replica's half of the fleet's disaggregated
    prefill; no forward;
  - `decode_loop`: a whole batch known up front (`sampling.generate_batch`):
    one full-width prefill of the `[N, W]` buffer, then ticks until every
    row is done.

State lives in tensors on the engine's device: `buf [N, W]` int32 token
buffer, `cursors`/`limits [N]` int32, `active [N]` bool, `keys [N, 2]`
(each slot's request key, int64 words). The functions update them in
place and return them. Each tick samples through `sampling._sample_next`
with the slot's key folded with its cursor, so token streams depend on
neither the schedule nor the neighbouring slots; greedy ticks take the
argmax (first index on ties, as `jnp.argmax`).

Under a serving grid (`cfg.tp`, set by the engine's `mesh`) every rank
holds the whole host-side state and its heads of the cache; on a ring
with a data axis a rank's ring holds only its replica's slots
(`slot_rows`), each replica runs the forward on those rows, and
`forward_slots` all-gathers the replicas' logits, so every rank samples
the same tokens from the same rows.

Stale ring positions are never read: a slot writes its K/V at `cursor - 1`
before it attends, and attention reads only `key_pos <= q_pos`, so what a
longer evicted request (or a rejected speculative window) left above the
cursor is rewritten before anything attends to it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpukit_torch.model import gpt
from tpukit_torch.sampling import _sample_next


def slot_rows(cfg: gpt.GPTConfig, n: int) -> slice:
    """The slots of this rank's data replica among `n` (all of them
    without a data axis): the rows its ring holds."""
    d = 1 if cfg.tp is None else cfg.tp.data_size
    if d == 1:
        return slice(0, n)
    per = n // d
    return slice(cfg.tp.data_rank * per, (cfg.tp.data_rank + 1) * per)


def forward_slots(params, cfg: gpt.GPTConfig, ids, position_ids, cache, start,
                  write_mask=None):
    """`gpt.forward_cached`'s logits for every slot's row of `ids [N, T]`.
    Under a data axis the rank's replica forwards its own slots' rows
    against its ring rows and the replicas' logits are all-gathered over
    `data` (every row is independent of the others, a per-row MoE capacity
    included)."""
    rows = slot_rows(cfg, ids.shape[0])
    if rows.stop - rows.start == ids.shape[0]:
        return gpt.forward_cached(params, cfg, ids, position_ids, cache, start,
                                  write_mask=write_mask)[0]
    vec = isinstance(start, torch.Tensor) and start.dim() == 1
    local, _ = gpt.forward_cached(params, cfg, ids[rows], position_ids[rows], cache,
                                  start[rows] if vec else start)
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(cfg.tp.data_size)]
    dist.all_gather(parts, local, group=cfg.tp.data_group)
    return torch.cat(parts)


def _select_next(last, cursors, keys, temperature: float, top_k: int):
    """Next token per slot from f32 logits `last [N, V]` (twin of
    `tpukit/serve/decode.py:75`): `_sample_next` with each slot's key and
    cursor."""
    return _sample_next(last, cursors, keys, temperature, top_k)


def _advance(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits, keys,
             eos_id: int, temperature: float = 0.0, top_k: int = 0):
    """One decode tick for every slot (twin of `tpukit/serve/decode.py:91`).
    Inactive slots re-forward their last token: on the ring into the same
    position (a write of the same values), on the paged cache with
    `write_mask` False (their K/V go to the null page, since a freed lane's
    block-table row may alias re-issued pages). Inactive slots are masked
    out of every state update. Returns the new `active`; `buf`, `cursors`
    and the cache change in place."""
    n, total = buf.shape
    read = (cursors - 1).clamp(0, total - 1)
    tok = buf.gather(1, read[:, None].long())
    mask = active if "bt" in cache else None
    logits = forward_slots(params, cfg, tok, read[:, None], cache, read, write_mask=mask)
    last = logits[:, -1].float()
    next_token = _select_next(last, cursors, keys, temperature, top_k).to(buf.dtype)
    fits = cursors < limits
    live = fits & (next_token != eos_id)
    append = active & live  # stop BEFORE appending on EOS
    rows = torch.arange(n, device=buf.device)
    write = cursors.clamp(0, total - 1).long()
    buf[rows, write] = torch.where(append, next_token, buf[rows, write])
    cursors.add_(append.to(cursors.dtype))
    return active & live & (cursors < limits)


def decode_step(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits, keys,
                eos_id: int, temperature: float = 0.0, top_k: int = 0, steps: int = 1):
    """`steps` tokens for every slot (the decode quantum), with no host
    sync. Returns `(buf, cache, cursors, active)`."""
    for _ in range(steps):
        active = _advance(params, cfg, buf, cache, cursors, active, limits, keys, eos_id,
                          temperature, top_k)
    return buf, cache, cursors, active


def prefill_slots(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits, keys,
                  slots, rows, prompt_lens, new_limits, new_keys):
    """Admit `A` requests in one batched forward (twin of
    `tpukit/serve/decode.py:198`): their bucket-padded prompts `rows [A,
    bucket]` go into the buffer at `slots [A]`, and their K/V for positions
    `[0, bucket)` into the ring rows of those slots. The forward runs over
    exactly these A rows, repeats of the power-of-two padding included:
    under a capacity MoE dispatch the rows a forward sees set its capacity
    windows, so tpukit's tokens need tpukit's rows. A repeated entry
    rewrites the same slot with the same values. Pad positions write K/V
    the causal window never reads. Under a data axis each replica forwards
    only the entries of its own slots (none: no forward) into its ring
    rows; the lane state is written whole on every rank. Returns `(buf,
    cache, cursors, active, limits, keys)`."""
    dev = buf.device
    idx = slots.long()
    mine = slot_rows(cfg, buf.shape[0])
    f_rows, f_idx = rows, idx
    if mine.stop - mine.start < buf.shape[0]:
        own = (idx >= mine.start) & (idx < mine.stop)
        f_rows, f_idx = rows[own], idx[own]
    a, bucket = f_rows.shape
    if a:
        pos = torch.arange(bucket, dtype=torch.int32, device=dev).expand(a, bucket)
        scratch = gpt.init_kv_cache(cfg, a, bucket, device=dev)
        gpt.forward_cached(params, cfg, f_rows, pos, scratch, 0)
        for name, ring in cache.items():
            ring[:, f_idx - mine.start, :, :bucket] = scratch[name]
    buf[idx, :rows.shape[1]] = rows.to(buf.dtype)
    cursors[idx] = prompt_lens.to(cursors.dtype)
    active[idx] = True
    limits[idx] = new_limits.to(limits.dtype)
    keys[idx] = new_keys.to(keys.dtype)
    return buf, cache, cursors, active, limits, keys


def prefill_chunk_paged(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits,
                        keys, slots, rows, starts, is_last, prompt_lens, new_limits,
                        new_keys):
    """One chunked-prefill dispatch (twin of `tpukit/serve/decode.py:243`):
    forward `rows [A, C]`, each lane's next C prompt tokens at positions
    `[starts[i], starts[i] + C)`, through the lanes' block-table rows,
    writing whole pages (`starts` page-aligned, C a page multiple). The
    chunk attends to everything the lane's block table already holds,
    shared prefix pages included. Lanes with `is_last` arm cursor, limit,
    key and `active`. Repeated entries (the power-of-two padding) rewrite
    the same values, so they are harmless. Returns `(buf, cache, cursors,
    active, limits, keys)`."""
    a, c = rows.shape
    dev = buf.device
    sub = dict(cache, bt=cache["bt"][slots.long()])  # pools shared: writes land in cache
    pos = starts[:, None] + torch.arange(c, dtype=starts.dtype, device=dev)
    gpt.forward_cached(params, cfg, rows, pos, sub, starts)
    total = buf.shape[1]
    cols = starts.long().clamp(0, total - c)[:, None] + torch.arange(c, device=dev)
    buf[slots.long()[:, None], cols] = rows.to(buf.dtype)
    arm = slots.long()[is_last]
    cursors[arm] = prompt_lens[is_last].to(cursors.dtype)
    active[arm] = True
    limits[arm] = new_limits[is_last].to(limits.dtype)
    keys[arm] = new_keys[is_last].to(keys.dtype)
    return buf, cache, cursors, active, limits, keys


def adopt_slot(buf, cursors, active, limits, keys, slot: int, row, prompt_len: int,
               new_limit: int, new_key):
    """Arm one lane whose K/V another engine prefilled (twin of
    `tpukit/serve/decode.py:286`, the disaggregated handoff): write the
    prompt row `row [W]` into the buffer at `slot` and set the lane's
    cursor to `prompt_len`, its limit, its key and `active`. No forward:
    the pool already holds the handed-off pages. Returns `(buf, cursors,
    active, limits, keys)`."""
    buf[slot] = row.to(buf.dtype)
    cursors[slot] = prompt_len
    active[slot] = True
    limits[slot] = new_limit
    keys[slot] = new_key.to(keys.dtype)
    return buf, cursors, active, limits, keys


def decode_loop_window(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits,
                       keys, pages_held, max_ticks: int, stop_when_freed: int, eos_id: int,
                       temperature: float = 0.0, top_k: int = 0):
    """Run decode ticks until `max_ticks` have run, every lane is done, or
    lanes that finished in this window hold `>= stop_when_freed` pages
    (`pages_held [N]` int32, each lane's page count). The condition is
    read on the host after each tick: one small device-to-host copy per
    tick. Returns `(buf, cache, cursors, active, ticks, freed)`."""
    ticks = freed = 0
    more = bool(active.any())
    while more and ticks < max_ticks and freed < stop_when_freed:
        new_active = _advance(params, cfg, buf, cache, cursors, active, limits, keys, eos_id,
                              temperature, top_k)
        just_done = active & ~new_active
        freed_now = torch.where(just_done, pages_held, torch.zeros_like(pages_held)).sum()
        any_left, freed_now = torch.stack([new_active.any().to(freed_now.dtype),
                                           freed_now]).tolist()
        more, freed, active = bool(any_left), freed + freed_now, new_active
        ticks += 1
    return buf, cache, cursors, active, ticks, freed


@torch.no_grad()
def decode_loop(params, cfg: gpt.GPTConfig, buf, prompt_lens, max_new_tokens: int,
                eos_id: int, temperature: float = 0.0, top_k: int = 0, rng=None):
    """The whole batch at once (twin of `tpukit/serve/decode.py:311`):
    prefill the full `[N, W]` buffer into a ring of width W in one forward
    (per-row prompt lengths; the pad positions' K/V are never read), then
    tick until every row is done, with one host read of `active` a tick.
    Every row shares `rng` and folds its own cursor. Returns `(buf,
    lengths)`."""
    n, total = buf.shape
    dev = buf.device
    cache = gpt.init_kv_cache(cfg, n, total, device=dev)
    pos = torch.arange(total, dtype=torch.int32, device=dev).expand(n, total)
    gpt.forward_cached(params, cfg, buf, pos, cache, 0)
    cursors = prompt_lens.to(device=dev, dtype=torch.int32).clone()
    limits = torch.clamp(cursors + max_new_tokens, max=total)
    active = cursors < limits
    keys = (rng.expand(n, 2) if rng is not None
            else torch.zeros((n, 2), dtype=torch.int64, device=dev))
    while bool(active.any()):
        active = _advance(params, cfg, buf, cache, cursors, active, limits, keys, eos_id,
                          temperature, top_k)
    return buf, cursors


def decode_step_comm(cfg: gpt.GPTConfig, mesh, slots: int, top_k: int = 0,
                     paged: bool = False, verify_tokens: int = 1) -> dict:
    """The c10d calls of one decode tick (`decode_step` with `steps=1`) on
    one rank of a serving grid `mesh` (`{"data": d, "model": m}`, None for
    one device), `{op: {count, bytes}}`
    (twin of `tpukit/serve/decode.py:418`), exhaustive: the step issues
    these and nothing else.

      - `all-reduce` x (2 num_layers + 1) under model > 1: the Megatron
        pair a layer (the row-parallel attention-out and FFN-down partial
        sums) on `[N/d, t, dim]` in the compute dtype, and the vocab-
        parallel token embedding's f32 sum;
      - `all-gather` x 1 under model > 1: the vocab-parallel logits
        `[N/d, t, padded_vocab]` f32, gathered model-replicated before
        sampling;
      - under data > 1, one more `all-gather`: every replica's logits
        `[N, t, padded_vocab]`, so every rank samples every slot (the
        port's host-side sampler). tpukit keeps the slot axis sharded and
        pays a data-axis gather only for top-k sampling (`lax.top_k`'s
        sort); the port pays it on every tick, top-k or not.

    `verify_tokens = spec_k + 1` prices the speculative verify: the same
    calls, every byte term `t` positions wide. Bytes are result payloads
    (`comm_ir`). Raises where tpukit's form does: paged with a data axis,
    slots the data axis does not divide, heads the model axis does not."""
    if paged and verify_tokens > 1:
        raise ValueError("speculative verify (verify_tokens > 1) audits the ring cache only "
                         "— spec + paged is rejected at ServeConfig")
    d, m = (1, 1) if mesh is None else (int(mesh.get("data", 1)), int(mesh.get("model", 1)))
    if paged and d > 1:
        raise ValueError(f"paged KV serving requires a model-only grid (data axis 1, got "
                         f"data={d})")
    if slots % d:
        raise ValueError(f"slots={slots} must be a multiple of the data axis ({d}) — slots "
                         f"shard over it")
    if m > 1 and cfg.heads % m:
        raise ValueError(f"heads={cfg.heads} must divide the model axis ({m}) for the "
                         f"closed-form decode audit")
    n_local, t = slots // d, verify_tokens
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    act = n_local * t * cfg.dim * itemsize
    embed = n_local * t * cfg.dim * 4  # f32 parameters
    logits = n_local * t * cfg.padded_vocab_size * 4
    out: dict = {}
    if m > 1:
        out["all-reduce"] = {"count": 2 * cfg.num_layers + 1,
                             "bytes": 2 * cfg.num_layers * act + embed}
        out["all-gather"] = {"count": 1, "bytes": logits}
    if d > 1:
        rec = out.setdefault("all-gather", {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += d * logits
    return out
