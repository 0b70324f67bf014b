"""Request-scoped tracing for the serving engine (a copy of
`tpukit/obs/trace.py`).

The serving JSONL is window-aggregate: it answers "how did the run go",
not "where did request 17's 900ms go". This module adds the per-request
substrate: every `serve.Request` carries a trace id (defaulting to its
rid), the engine's step primitives emit small SPAN EVENTS into a bounded
per-replica ring (`TraceRecorder`, the FlightRecorder discipline: locked
deque, O(1) append, memory bounded by construction), and `build_trees`
merges the events into one span tree per request:

    enqueue -> [route] -> admit -> prefill chunk k -> prefill_done
            -> [handoff claim/copy -> adopt] -> quantum participations
            -> finish            (requeue after a replica_kill links the
                                  old and new attempts under ONE trace id)

Event vocabulary (each record is `{"ev", "trace", "rid", "replica", ...}`
with `t` for points and `t0`/`t1` for spans, seconds on the run clock —
`set_epoch` pins the perf_counter origin so every emitter shares it):

    enqueue      t=arrival_s          request visible to the scheduler
    route        t, dst               router assignment (fleet only)
    admit        t, slot              lane created on `replica`
    prefill      t0, t1, chunk        one (batched) prefill dispatch wall
    prefill_done t                    lane armed for decode
    handoff      t0, t1, claim_s, copy_s, dst   disagg page handoff
    adopt        t                    decode-side lane armed (disagg)
    quantum      t0, t1, s0, s1, steps, lanes   ONE event per decode
                 dispatch+sync pair; `lanes` lists the participating
                 trace ids, [t0,t1] the dispatch wall, [s0,s1] the
                 wall-to-sync wall
    finish       t, reason, generated  exactly-once completion
    requeue      t, from_replica       kill victim back to the queue

The port's engine emits enqueue, admit, prefill, prefill_done, quantum and
finish; route, handoff, adopt and requeue belong to the fleet (ROADMAP.md
item 19), and `build_trees` keeps tpukit's accounting of them.

Phase accounting (`build_trees`): a request's lifetime [enqueue, finish]
partitions into queue_wait (enqueue/requeue -> admit), prefill (admit ->
prefill_done, per attempt), handoff (prefill_done -> adopt, when a
disagg adopt exists), decode (sum of participating quanta's dispatch
walls), sync_stall (sum of their sync walls) and `other` (the residual).
Each named interval is a disjoint sub-interval of the request's own
lifetime, so named phases can never exceed e2e on a correct trace — the
COMPLETENESS INVARIANT: a tree is `closed` when it has an enqueue, at
least one admit and exactly one finish, and `complete` when additionally
the named phase walls sum to <= e2e + 1e-3 s. `tools/report.py
--min_trace_complete` gates on the fraction of complete trees and
`tools/traceview.py` renders/exports them (Chrome-trace JSON via
`to_chrome`).

Standard library only (no torch, no numpy), as tpukit's copy is, so that
the rows it writes are the ones `tools/report.py` and `tools/traceview.py`
read.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# The per-request phase vocabulary, in lifetime order. `other` is the
# residual that makes the walls sum exactly to e2e.
PHASES = ("queue_wait", "prefill", "handoff", "decode", "sync_stall", "other")

# Tolerance on the completeness invariant: named phase walls may exceed
# e2e by at most this much (float accumulation across many quanta).
SUM_TOL_S = 1e-3


def request_trace_id(rid: int, trace: int = -1) -> int:
    """Effective trace id of a request: an explicit `trace` field wins,
    else the rid — requeued attempts reuse the SAME Request object, so
    both attempts land under one id either way."""
    return trace if trace >= 0 else rid


def _ev_time(ev: dict) -> float:
    return ev.get("t", ev.get("t0", 0.0))


class TraceRecorder:
    """Bounded per-replica rings of span events — FlightRecorder
    discipline: one dict allocation + a deque append under a lock per
    event, memory bounded by `capacity` events PER RING (a ring per
    emitting replica, so one hot replica cannot evict another's
    history). `snapshot()` merges all rings time-sorted."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rings: dict = {}  # replica label -> deque
        self._ring_totals: dict = {}  # replica label -> events ever emitted
        self._lock = threading.Lock()
        self._total = 0
        self._epoch: float | None = None

    def set_epoch(self, t0: float) -> None:
        """Pin the run clock: `now()` returns perf_counter seconds since
        `t0`. The run loop calls this at its own t0 so event times are
        directly comparable with arrival_s / admit_s / done_s."""
        with self._lock:
            self._epoch = t0

    @property
    def epoch(self) -> float | None:
        """The perf_counter origin of `now()`, None until one is set. The
        fleet hands it to a grid replica's first rank, whose events then
        share this clock (perf_counter is the host's monotonic clock, one
        across processes)."""
        return self._epoch

    def now(self) -> float:
        """Run-relative seconds (lazily 0-based when no epoch was set —
        tests driving step primitives directly still get a coherent
        clock)."""
        if self._epoch is None:
            with self._lock:
                if self._epoch is None:
                    self._epoch = time.perf_counter()
        return time.perf_counter() - self._epoch

    def emit(self, ev: str, trace: int, **fields) -> None:
        """Append one event to the emitting replica's ring (`replica`
        key in `fields`, None for a standalone engine). Values must be
        JSON-serializable — they flush to the metrics JSONL as
        `kind="trace_event"` rows."""
        rec = {"ev": ev, "trace": trace, **fields}
        key = fields.get("replica")
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = deque(maxlen=self.capacity)
            ring.append(rec)
            self._total += 1
            self._ring_totals[key] = self._ring_totals.get(key, 0) + 1

    def snapshot(self) -> list[dict]:
        """Consistent merged copy of every ring, time-sorted. Safe from
        any thread while emitters keep appending."""
        with self._lock:
            evs = [e for ring in self._rings.values() for e in ring]
        return sorted(evs, key=_ev_time)

    @property
    def total_emitted(self) -> int:
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        """Events evicted by ring bounds — nonzero means long traces are
        incomplete and `--trace_capacity` should grow."""
        with self._lock:
            return self._total - sum(len(r) for r in self._rings.values())

    @property
    def dropped_by_replica(self) -> dict:
        """Per-ring eviction counts, keyed by the emitting replica label
        (None for a standalone engine), only nonzero entries — the
        summary/report surface that stops a saturated ring from silently
        reading as a complete history (a dropped event poisons every
        phase aggregate built from the ring)."""
        with self._lock:
            return {
                key: self._ring_totals.get(key, 0) - len(ring)
                for key, ring in self._rings.items()
                if self._ring_totals.get(key, 0) > len(ring)
            }

    def __len__(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._rings.values())


# ---- span-tree merge -----------------------------------------------------


def build_trees(events: list[dict]) -> list[dict]:
    """Merge raw events into one span tree per trace id. Quantum events
    are per-ENGINE (their `lanes` field lists the participating trace
    ids), everything else is per-request; the tree's phase walls follow
    the module-docstring partition. Returns trees sorted by trace id."""
    by_trace: dict = {}
    member: dict = {}  # trace id -> participating quantum events
    for ev in events:
        if ev.get("ev") == "quantum":
            for t in ev.get("lanes") or ():
                member.setdefault(t, []).append(ev)
        else:
            by_trace.setdefault(ev.get("trace"), []).append(ev)
    return [
        _build_tree(trace, evs, member.get(trace, []))
        for trace, evs in sorted(by_trace.items())
    ]


def _build_tree(trace, evs: list[dict], quanta: list[dict]) -> dict:
    evs = sorted(evs, key=_ev_time)
    of = lambda name: [e for e in evs if e.get("ev") == name]  # noqa: E731
    enq = of("enqueue")
    admits = of("admit")
    dones = of("prefill_done")
    adopts = of("adopt")
    fins = of("finish")
    requeues = of("requeue")
    rid = next((e["rid"] for e in evs if e.get("rid") is not None), trace)
    arrival = enq[0]["t"] if enq else (admits[0]["t"] if admits else 0.0)
    closed = bool(enq) and bool(admits) and len(fins) == 1

    # queue_wait: per attempt, (re)queue entry -> that attempt's admit
    starts = [arrival] + sorted(r["t"] for r in requeues)
    queue_wait = sum(
        max(a["t"] - starts[min(k, len(starts) - 1)], 0.0)
        for k, a in enumerate(admits)
    )
    # prefill: per attempt, admit -> the prefill_done landing before the
    # next attempt's admit
    bounds = [a["t"] for a in admits[1:]] + [float("inf")]
    prefill = 0.0
    for a, b in zip(admits, bounds):
        pd = next((d for d in dones if a["t"] - 1e-9 <= d["t"] <= b), None)
        if pd is not None:
            prefill += max(pd["t"] - a["t"], 0.0)
    # handoff: prefill_done (on the worker) -> adopt (on the decode
    # replica) — includes wait-for-capacity, claim and the page copy
    handoff = 0.0
    for ad in adopts:
        pd = next((d for d in reversed(dones) if d["t"] <= ad["t"]), None)
        if pd is not None:
            handoff += max(ad["t"] - pd["t"], 0.0)
    decode = sum(q["t1"] - q["t0"] for q in quanta)
    sync_stall = sum(q["s1"] - q["s0"] for q in quanta if "s1" in q)

    end = fins[0]["t"] if fins else max((_ev_time(e) for e in evs), default=arrival)
    e2e = max(end - arrival, 0.0)
    named = queue_wait + prefill + handoff + decode + sync_stall
    residual = named - e2e  # > 0 means named walls overran the lifetime
    complete = closed and residual <= SUM_TOL_S
    replicas = sorted(
        {str(e["replica"]) for e in admits + adopts + fins
         if e.get("replica") is not None}
    )
    return {
        "trace": trace,
        "rid": rid,
        "closed": closed,
        "complete": complete,
        "e2e_s": e2e,
        "phases": {
            "queue_wait": queue_wait,
            "prefill": prefill,
            "handoff": handoff,
            "decode": decode,
            "sync_stall": sync_stall,
            "other": max(e2e - named, 0.0),
        },
        "residual_s": max(residual, 0.0),
        "attempts": len(admits),
        "quanta": len(quanta),
        "replicas": replicas,
        "reason": fins[0].get("reason") if fins else None,
        "generated": fins[0].get("generated") if fins else None,
    }


# ---- derived views -------------------------------------------------------


def percentile(vals: list[float], q: float) -> float | None:
    """np.percentile's linear interpolation, stdlib-only (the exporter
    and report path must not import numpy)."""
    if not vals:
        return None
    v = sorted(vals)
    if len(v) == 1:
        return float(v[0])
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] * (1.0 - frac) + v[hi] * frac)


def phase_stats(trees: list[dict]) -> tuple[dict, dict]:
    """(p50, p99) per phase over `trees` — the serve_summary /
    fleet_summary per-phase latency rows."""
    p50: dict = {}
    p99: dict = {}
    for ph in PHASES:
        vals = [t["phases"][ph] for t in trees]
        p50[ph] = percentile(vals, 50)
        p99[ph] = percentile(vals, 99)
    return p50, p99


def completeness(trees: list[dict]) -> float | None:
    """Fraction of trees satisfying the completeness invariant."""
    if not trees:
        return None
    return sum(1 for t in trees if t["complete"]) / len(trees)


def flush_to_logger(tracer: TraceRecorder, logger, trees=()) -> None:
    """Persist the ring into the metrics JSONL: one `kind="trace_event"`
    row per raw event plus one `kind="trace"` row per span tree — the
    rows report.py's `--min_trace_complete` gate and traceview read."""
    if tracer is None or logger is None:
        return
    for ev in tracer.snapshot():
        logger.log(kind="trace_event", **ev)
    for t in trees:
        logger.log(kind="trace", **t)


# ---- Chrome-trace / Perfetto export --------------------------------------


def to_chrome(events: list[dict]) -> dict:
    """Export events as Chrome-trace JSON (chrome://tracing / Perfetto
    `traceEvents` array, microsecond timestamps). Layout: one pid per
    emitting replica (tid 0 carries that engine's quantum dispatch/sync
    bars, tid trace+1 the per-request milestones and prefill/handoff
    spans) plus a synthetic "phases" pid with one contiguous bar set per
    request derived from its span tree."""
    pids: dict = {}

    def pid_for(rep) -> int:
        key = "engine" if rep is None else str(rep)
        if key not in pids:
            pids[key] = len(pids) + 1
        return pids[key]

    us = lambda s: round(s * 1e6, 3)  # noqa: E731
    out = []
    for ev in events:
        name = ev.get("ev", "?")
        pid = pid_for(ev.get("replica"))
        if name == "quantum":
            out.append({
                "name": f"dispatch x{ev.get('steps', 1)}", "ph": "X",
                "cat": "quantum", "pid": pid, "tid": 0,
                "ts": us(ev["t0"]), "dur": max(us(ev["t1"] - ev["t0"]), 1),
                "args": {"lanes": ev.get("lanes", [])},
            })
            if "s1" in ev:
                out.append({
                    "name": "sync", "ph": "X", "cat": "quantum",
                    "pid": pid, "tid": 0, "ts": us(ev["s0"]),
                    "dur": max(us(ev["s1"] - ev["s0"]), 1),
                    "args": {"lanes": ev.get("lanes", [])},
                })
        elif "t0" in ev:  # prefill / handoff spans
            label = name
            if ev.get("chunk") is not None:
                label = f"{name}[{ev['chunk']}]"
            out.append({
                "name": label, "ph": "X", "cat": name, "pid": pid,
                "tid": int(ev.get("trace", 0)) + 1, "ts": us(ev["t0"]),
                "dur": max(us(ev["t1"] - ev["t0"]), 1),
                "args": {"rid": ev.get("rid")},
            })
        else:  # point milestones
            args = {k: v for k, v in ev.items()
                    if k not in ("ev", "t", "replica")}
            out.append({
                "name": name, "ph": "i", "s": "t", "cat": "milestone",
                "pid": pid, "tid": int(ev.get("trace", 0)) + 1,
                "ts": us(ev.get("t", 0.0)), "args": args,
            })
    # contiguous per-request phase bars (tree-derived approximation:
    # decode+sync render as one "decode" residency bar)
    phase_pid = len(pids) + 1
    for tree in build_trees(events):
        if not tree["closed"]:
            continue
        tid = int(tree["trace"]) + 1
        # reconstruct boundaries from the cumulative walls; `other` is
        # folded into the decode residency tail
        ph = tree["phases"]
        arrival = None
        for ev in events:
            if ev.get("ev") == "enqueue" and ev.get("trace") == tree["trace"]:
                arrival = ev["t"]
                break
        if arrival is None:
            continue
        t = arrival
        segs = [("queue_wait", ph["queue_wait"]), ("prefill", ph["prefill"]),
                ("handoff", ph["handoff"]),
                ("decode", ph["decode"] + ph["sync_stall"] + ph["other"])]
        for label, dur in segs:
            if dur <= 0:
                continue
            out.append({
                "name": label, "ph": "X", "cat": "phase",
                "pid": phase_pid, "tid": tid, "ts": us(t),
                "dur": max(us(dur), 1), "args": {"rid": tree["rid"]},
            })
            t += dur
    for key, pid in pids.items():
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": f"replica {key}"}})
        out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": "engine quanta"}})
    out.append({"name": "process_name", "ph": "M", "pid": phase_pid,
                "args": {"name": "request phases"}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
