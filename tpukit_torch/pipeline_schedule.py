"""Static 1F1B tick tables, flat and interleaved: the port's copy of
`tpukit/pipeline_schedule.py`, arithmetic unchanged (the tests hold every
table equal to tpukit's over a grid of stage, virtual-stage and micro-batch
counts).

This module is the schedule AUTHORITY of the port's `Pipeline1F1B`
(`tpukit_torch/pipeline.py`): a pure-Python greedy list scheduler that emits
the per-tick, per-stage job tables every stage rank walks in lockstep, plus
tpukit's idle-work accounting. At one virtual stage the table is the flat
1F1B order (micro m forwards at stage s on tick m + s, the last stage
backwards it the same tick, the cotangent moves back one stage a tick);
interleaved virtual stages (Megatron-LM's interleaved 1F1B; *Scaling Deep
Learning Training with MPMD Pipeline Parallelism*, PAPERS.md) split each
stage's layer block into V non-contiguous chunks — stage d owns global
chunks d, d+S, d+2S, ... — so one hop of the pipeline is 1/V of a stage's
work and the warm-up/cool-down shrinks toward (S-1)/(M*V) of the useful
work at equal M.

Schedule model (tpukit's; its SPMD machine executes every phase on every
device and masks the work of devices without a job, which is what the
bubble accounting prices — the port's ranks skip that work, so the tables'
`bubble_frac` is an upper bound on their idle work):

- A tick has a forward PHASE and/or a backward PHASE, chosen statically:
  a tick costs `has_fwd * t_f + has_bwd * t_b`, and idle work is "phase
  executed, no job". Pure-F warm-up and pure-B cool-down ticks are how
  interleaving beats the flat machine, whose every tick pays both phases.
- fwd(g, m) on stage g % S needs fwd(g-1, m) shipped: executable from
  tick f(g-1, m) + 1. Chunk 0 ingests embeddings at its own tick.
- bwd(G-1, m) is self-triggered: the head+CE backward runs at fwd(G-1,
  m)'s tick on the last stage, so the deepest chunk's backward is ready the
  SAME tick. bwd(g, m) for g < G-1 needs the cotangent shipped:
  executable from b(g+1, m) + 1.
- One fwd job and one bwd job per stage per tick, at most.
- In-flight micro-chunks per stage settle at ~(G + S - d) in steady
  state (the fill depth before the first backward retires) — Megatron's
  documented memory cost of interleaving. The generator reports the
  exact buffer depth per (stage, chunk) in `depth`; a hard in-flight
  cap is available (`max_in_flight`) but defaults OFF, because capping
  below the fill depth stalls micro 0's wavefront — the very forwards
  the schedule needs to trigger the first backward.

BACKWARD_COST prices a backward chunk-step relative to a forward one for
the idle-WORK (not idle-tick) accounting: the backward phase replays the
chunk forward (remat) and then runs the transpose, ~2 forward
equivalents. The gate compares fractions of the same weighting, so the
1F1B baseline bubble (2S-2)/(M+2S-2) is weight-independent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

BACKWARD_COST = 2.0


@dataclass(frozen=True)
class Tick:
    """One row of the static tick program. Per-device entries are tuples
    indexed by device (stage) id; None = no job (masked execution)."""

    # (chunk_local, micro, slot) per device, or None
    fwd: tuple
    bwd: tuple
    # forward activation / backward cotangent arriving at the START of
    # this tick (shipped by the previous tick): (chunk_local, slot) per
    # device, or None
    recv_fwd: tuple
    recv_bwd: tuple
    # does this tick's end ship a forward / backward ring payload?
    ship_fwd: bool = False
    ship_bwd: bool = False
    # micro ingested by device 0 (chunk 0) this tick, -1 = none
    ingest: int = -1
    # micro whose head+CE runs on the last device this tick, -1 = none;
    # head_slot is that job's activation slot (static: the last device's
    # fwd slot this tick) — the head's cotangent stashes there
    head: int = -1
    head_slot: int = -1
    # micro whose embedding-transpose runs on device 0 this tick (its
    # chunk-0 backward), -1 = none
    emb: int = -1

    @property
    def has_fwd(self) -> bool:
        return any(j is not None for j in self.fwd)

    @property
    def has_bwd(self) -> bool:
        return any(j is not None for j in self.bwd)


@dataclass(frozen=True)
class InterleavedSchedule:
    num_stages: int
    virtual: int
    num_micro: int
    ticks: tuple  # tuple[Tick]
    depth: int  # activation-buffer slots per (device, chunk)
    stats: dict = field(default_factory=dict)


def flat_1f1b_bubble(num_stages: int, num_micro: int) -> float:
    """Idle-work fraction of the EXISTING flat 1F1B tick machine
    (tpukit's lax.scan over M + 2S - 2 ticks, both phases every
    tick): each device does M useful forward and M useful backward
    chunk-steps out of T executed each, independent of phase weights."""
    ticks = num_micro + 2 * num_stages - 2
    return 1.0 - num_micro / ticks


def _bubble_fraction(f_ticks: int, b_ticks: int, num_stages: int,
                     num_micro: int, virtual: int,
                     backward_cost: float = BACKWARD_COST) -> float:
    """Idle-work fraction of an interleaved program: per device, every
    forward-phase tick executes one chunk-forward (cost 1) and every
    backward-phase tick one chunk-backward (cost backward_cost); M*V of
    each are useful."""
    useful = num_micro * virtual * (1.0 + backward_cost)
    executed = f_ticks + backward_cost * b_ticks
    return 1.0 - useful / executed


def build_schedule(num_stages: int, virtual: int, num_micro: int,
                   include_backward: bool = True,
                   max_in_flight: int | None = None) -> InterleavedSchedule:
    """Greedy list scheduler for the interleaved-1F1B tick program.

    Priorities: backward jobs prefer the oldest micro, deepest chunk
    (the retire chain is the critical path); forward jobs prefer the
    DEEPEST ready chunk, oldest micro — which reproduces Megatron's
    grouped warm-up (chunk 0 micros 0..S-1, then chunk 1 micros 0..S-1,
    ...) and keeps micro 0's wavefront tight so the first backward fires
    at tick G-1. `include_backward=False` emits the forward-only program
    (the interleaved eval path). `max_in_flight` optionally caps forward-
    executed-but-not-retired chunk-steps per device (activation memory);
    None = uncapped (a cap below the fill depth stalls the wavefront
    that triggers the first backward and deadlocks the schedule).
    """
    S, V, M = num_stages, virtual, num_micro
    if S < 1 or V < 1 or M < 1:
        raise ValueError(f"need num_stages/virtual/num_micro >= 1, got "
                         f"{S}/{V}/{M}")
    G = S * V
    if max_in_flight is None:
        max_in_flight = G * M + 1  # uncapped
    f_tick: dict = {}  # (g, m) -> tick index
    b_tick: dict = {}
    # slot pools, per (device, chunk_local): slot ids alloc'd at the tick
    # the activation lands (arrival, or execution for ingest), freed the
    # tick after its backward consumes it
    free_slots: dict = {}
    next_slot: dict = {}
    slot_of: dict = {}  # (g, m) -> slot id

    def _alloc(d: int, c: int, g: int, m: int) -> int:
        pool = free_slots.setdefault((d, c), [])
        if pool:
            s = pool.pop()
        else:
            s = next_slot.get((d, c), 0)
            next_slot[(d, c)] = s + 1
        slot_of[(g, m)] = s
        return s

    total_jobs = G * M
    ticks: list = []
    in_flight = [0] * S  # fwd executed, bwd not yet, per device
    pending_recv_f: list = [None] * S  # stash targets for last ship_fwd
    pending_recv_b: list = [None] * S
    t = 0
    limit = 4 * (G + M) * (V + 2) + 64  # deadlock backstop
    while len(b_tick) < total_jobs if include_backward else len(f_tick) < total_jobs:
        if t > limit:
            raise RuntimeError(
                f"interleaved schedule failed to converge at S={S} V={V} "
                f"M={M} (scheduler bug)")
        recv_f = tuple(pending_recv_f)
        recv_b = tuple(pending_recv_b)
        pending_recv_f = [None] * S
        pending_recv_b = [None] * S

        # -- forward assignments -----------------------------------------
        fwd: list = [None] * S
        ingest = -1
        head = -1
        head_slot = -1
        for d in range(S):
            if include_backward and in_flight[d] >= max_in_flight:
                continue
            best = None
            for c in range(V - 1, -1, -1):  # deepest chunk first
                g = c * S + d
                for m in range(M):
                    if (g, m) in f_tick:
                        continue
                    if g > 0 and f_tick.get((g - 1, m), t + 1) + 1 > t:
                        continue
                    best = (c, g, m)
                    break  # oldest micro of this chunk
                if best is not None:
                    break
            if best is None:
                continue
            c, g, m = best
            f_tick[(g, m)] = t
            in_flight[d] += 1
            if g == 0:
                s = _alloc(d, c, g, m)  # ingest: stashed at execution
                ingest = m
            else:
                s = slot_of[(g, m)]  # alloc'd at arrival
            fwd[d] = (c, m, s)
            if g == G - 1:
                head = m
                head_slot = s
            if not include_backward:
                # forward-only (eval): the stash is dead once the chunk
                # forward consumed it — recycle immediately
                free_slots.setdefault((d, c), []).append(slot_of.pop((g, m)))
        ship_fwd = any(
            fwd[d] is not None and fwd[d][0] * S + d < G - 1 for d in range(S)
        )
        if ship_fwd:
            for d in range(S):
                if fwd[d] is None:
                    continue
                g = fwd[d][0] * S + d
                if g >= G - 1:
                    continue
                # consumer: chunk g+1 on device (d+1) % S — pre-alloc its
                # stash slot now; the payload lands at tick t+1
                nd, nc = (g + 1) % S, (g + 1) // S
                m = fwd[d][1]
                s = _alloc(nd, nc, g + 1, m)
                pending_recv_f[nd] = (nc, s)

        # -- backward assignments ----------------------------------------
        bwd: list = [None] * S
        emb = -1
        if include_backward:
            for d in range(S):
                best = None
                for m in range(M):  # oldest micro first
                    for c in range(V - 1, -1, -1):  # deepest chunk first
                        g = c * S + d
                        if (g, m) in b_tick or (g, m) not in f_tick:
                            continue
                        if g == G - 1:
                            if f_tick[(g, m)] > t:
                                continue
                        elif b_tick.get((g + 1, m), t + 1) + 1 > t:
                            continue
                        best = (c, g, m)
                        break
                    if best is not None:
                        break
                if best is None:
                    continue
                c, g, m = best
                b_tick[(g, m)] = t
                in_flight[d] -= 1
                s = slot_of.pop((g, m))
                free_slots.setdefault((d, c), []).append(s)
                bwd[d] = (c, m, s)
                if g == 0:
                    emb = m
            ship_bwd = any(
                bwd[d] is not None and bwd[d][0] * S + d > 0 for d in range(S)
            )
            if ship_bwd:
                for d in range(S):
                    if bwd[d] is None:
                        continue
                    g = bwd[d][0] * S + d
                    if g <= 0:
                        continue
                    # consumer: bwd(g-1, m) on device (d-1) % S; the
                    # cotangent shares the forward's activation slot
                    pd = (g - 1) % S
                    pending_recv_b[pd] = ((g - 1) // S, slot_of[(g - 1, bwd[d][1])])
        else:
            ship_bwd = False

        tick = Tick(fwd=tuple(fwd), bwd=tuple(bwd), recv_fwd=recv_f,
                    recv_bwd=recv_b, ship_fwd=ship_fwd, ship_bwd=ship_bwd,
                    ingest=ingest, head=head, head_slot=head_slot, emb=emb)
        if not (tick.has_fwd or tick.has_bwd):
            raise RuntimeError(
                f"interleaved schedule deadlocked at tick {t} "
                f"(S={S} V={V} M={M})")
        ticks.append(tick)
        t += 1

    depth = max(next_slot.values(), default=1)
    f_ticks = sum(1 for tk in ticks if tk.has_fwd)
    b_ticks = sum(1 for tk in ticks if tk.has_bwd)
    stats = {
        "ticks": len(ticks),
        "fwd_phase_ticks": f_ticks,
        "bwd_phase_ticks": b_ticks,
        "depth": depth,
        "ship_fwd_ticks": sum(1 for tk in ticks if tk.ship_fwd),
        "ship_bwd_ticks": sum(1 for tk in ticks if tk.ship_bwd),
        "bubble_frac": (
            _bubble_fraction(f_ticks, b_ticks, S, M, V)
            if include_backward else float("nan")
        ),
        "flat_1f1b_bubble_frac": flat_1f1b_bubble(S, M),
    }
    return InterleavedSchedule(
        num_stages=S, virtual=V, num_micro=M, ticks=tuple(ticks),
        depth=depth, stats=stats,
    )


@lru_cache(maxsize=64)
def cached_schedule(num_stages: int, virtual: int, num_micro: int,
                    include_backward: bool = True) -> InterleavedSchedule:
    """The machine traces one program per (S, V, M, phase) — cache the
    table so retracing (jit cache misses, eval + train in one run) does
    not regenerate it."""
    return build_schedule(num_stages, virtual, num_micro,
                          include_backward=include_backward)


def bubble_table(num_stages: int, virtuals=(1, 2, 4), micros=(4, 8, 16)):
    """tpukit's bubble-fraction table (its bench record's):
    one row per (V, M). V=1 rows price the EXISTING flat machine
    (tpukit's scan — what `--virtual_stages 1` runs there);
    V > 1 rows come from the generated tick tables."""
    rows = []
    for m in micros:
        for v in virtuals:
            if v == 1:
                rows.append({
                    "virtual_stages": 1, "micro": m,
                    "ticks": m + 2 * num_stages - 2,
                    "bubble_frac": round(flat_1f1b_bubble(num_stages, m), 4),
                })
            else:
                sched = build_schedule(num_stages, v, m)
                rows.append({
                    "virtual_stages": v, "micro": m,
                    "ticks": sched.stats["ticks"],
                    "fwd_phase_ticks": sched.stats["fwd_phase_ticks"],
                    "bwd_phase_ticks": sched.stats["bwd_phase_ticks"],
                    "depth": sched.depth,
                    "bubble_frac": round(sched.stats["bubble_frac"], 4),
                })
    return rows
