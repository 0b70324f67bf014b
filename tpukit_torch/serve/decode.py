"""Batched decode over the paged KV cache (twin of `tpukit/serve/decode.py`,
its paged, greedy programs).

  - `prefill_chunk_paged`: forward the next chunk of every prefilling lane
    in one batched call, writing whole pages; lanes on their last chunk arm
    their decode state.
  - `decode_step`: `steps` greedy ticks for every slot; a slot that
    finishes mid-quantum stays frozen for the rest of it.
  - `decode_loop_window`: up to `max_ticks` ticks that stop early when
    every lane is done or finished lanes have freed `stop_when_freed`
    pages. tpukit runs the loop on the device; here the host checks the
    condition after each tick. Token streams do not depend on the schedule.

State lives in tensors on the engine's device: `buf [N, W]` int32 token
buffer, `cursors`/`limits [N]` int32, `active [N]` bool. The functions
update them in place and return them. Sampling is greedy (argmax, first
index on ties, as `jnp.argmax`); seeded sampling waits for a port of
`jax.random` (ROADMAP.md).
"""

from __future__ import annotations

import torch

from tpukit_torch.model import gpt


def _advance(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits,
             eos_id: int):
    """One greedy decode tick for every slot. Inactive slots re-forward
    their last token with `write_mask` False (their K/V go to the null
    page) and are masked out of every state update. Returns the new
    `active`; `buf`, `cursors` and the cache change in place."""
    n, total = buf.shape
    read = (cursors - 1).clamp(0, total - 1)
    tok = buf.gather(1, read[:, None].long())
    logits, _ = gpt.forward_cached(params, cfg, tok, read[:, None], cache, read,
                                   write_mask=active)
    last = logits[:, -1].float()
    next_token = torch.argmax(last, -1).to(buf.dtype)
    fits = cursors < limits
    live = fits & (next_token != eos_id)
    append = active & live  # stop BEFORE appending on EOS
    rows = torch.arange(n, device=buf.device)
    write = cursors.clamp(0, total - 1).long()
    buf[rows, write] = torch.where(append, next_token, buf[rows, write])
    cursors.add_(append.to(cursors.dtype))
    return active & live & (cursors < limits)


def decode_step(params, cfg: gpt.GPTConfig, buf, cache, cursors, active,
                limits, eos_id: int, steps: int = 1):
    """`steps` greedy tokens for every slot (the decode quantum), with no
    host sync. Returns `(buf, cache, cursors, active)`."""
    for _ in range(steps):
        active = _advance(params, cfg, buf, cache, cursors, active, limits, eos_id)
    return buf, cache, cursors, active


def prefill_chunk_paged(params, cfg: gpt.GPTConfig, buf, cache, cursors,
                        active, limits, slots, rows, starts, is_last,
                        prompt_lens, new_limits):
    """One chunked-prefill dispatch: forward `rows [A, C]`, each lane's next
    C prompt tokens at positions `[starts[i], starts[i] + C)`, through the
    lanes' block-table rows, writing whole pages (`starts` page-aligned, C
    a page multiple). The chunk attends to everything the lane's block
    table already holds, shared prefix pages included. Lanes with
    `is_last` arm cursor, limit and `active`. Repeated entries (the
    power-of-two padding) rewrite the same values, so they are harmless.
    Returns `(buf, cache, cursors, active, limits)`."""
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
    return buf, cache, cursors, active, limits


def decode_loop_window(params, cfg: gpt.GPTConfig, buf, cache, cursors,
                       active, limits, pages_held, max_ticks: int,
                       stop_when_freed: int, eos_id: int):
    """Run decode ticks until `max_ticks` have run, every lane is done, or
    lanes that finished in this window hold `>= stop_when_freed` pages
    (`pages_held [N]` int32, each lane's page count). The condition is
    read on the host after each tick: one small device-to-host copy per
    tick. Returns `(buf, cache, cursors, active, ticks, freed)`."""
    ticks = freed = 0
    more = bool(active.any())
    while more and ticks < max_ticks and freed < stop_when_freed:
        new_active = _advance(params, cfg, buf, cache, cursors, active, limits, eos_id)
        just_done = active & ~new_active
        freed_now = torch.where(just_done, pages_held, torch.zeros_like(pages_held)).sum()
        any_left, freed_now = torch.stack([new_active.any().to(freed_now.dtype),
                                           freed_now]).tolist()
        more, freed, active = bool(any_left), freed + freed_now, new_active
        ticks += 1
    return buf, cache, cursors, active, ticks, freed
