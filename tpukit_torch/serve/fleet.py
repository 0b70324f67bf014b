"""Fleet serving: a request router over N `ServeEngine` replicas (twin of
`tpukit/serve/fleet.py`).

  - **Least-loaded admission.** The router holds the one FIFO queue and
    gives each arrived request to the replica with the most free slots
    (then the most free pages, then the lowest id). Per-request seeds
    travel with the request and every replica is the proven engine, so
    the fleet's tokens are a single engine's on the same stream.
  - **Disaggregated prefill** (`FleetConfig.disagg_prefill`, paged only).
    A prefill worker runs the chunked prefill into its own pool; a
    finished prefix hands off to a decode replica as pages: the replica
    first claims the prefix pages its own registry already holds, then the
    remaining written pages are copied (`paged.extract_pages`, a move to
    the replica's device, `paged.insert_pages`) into fresh pages, and
    `ServeEngine.adopt_prefilled` arms the lane. Decode replicas run no
    prefill.
  - **Autoscale and failures.** Between fleet windows the router compares
    the mean slot occupancy with the thresholds: it builds a replica on a
    free device, or drains the highest live one (no new admissions, its
    lanes finish, then it retires); it never evicts work. A replica killed
    by the chaos plan (`replica_kill@R[:idx]`, `chaos.ServingChaos`) or
    declared dead by the heartbeat check is dropped mid-flight: its
    in-flight requests requeue onto survivors, rebuilt from the Request
    with the same seed, within the `request_retries` budget, so each
    request completes once with the tokens of the run without the kill.
    With `fleet_dir` the request lifecycle is durable (`serve/ledger.py`):
    write-ahead leases, exactly-once completion records, and replay of the
    stream that resumes at the completed frontier.
  - **Deadlines and backpressure.** Engines evict lanes past their
    `Request.deadline_ms`; with `max_queue_depth` the router sheds the
    arrived excess, lowest priority first, then latest.

Devices. `devices_per_replica` 0 puts every replica, an engine in the
router's process, on the router's device (the card, or the CPU when
asked); 1 puts replica i on `devices[i]` (`cuda:i`). Every call into such a
replica runs under its card (`torch.cuda.device`), since the ctypes
kernels launch on the current device, and a cross-card handoff moves the
page block with `.to`. Above 1, replica i serves on a `(data, model)` grid
over the subset `devices[i*D:(i+1)*D]`, `pick_serve_grid(D, heads, slots,
paged)`, as tpukit's subset meshes: the port serves a grid as one process
a device over c10d, so the replica is a world of D rank processes of its
own, driven through a `replica_world.GridReplica` (that module's docstring
has the protocol). The devices default to `mesh.device_list` (every card;
on the CPU, `TPUKIT_CPU_DEVICES` entries). A subset beyond the replica
budget hosts the prefill worker as a world of its own; otherwise it runs
meshless on the router's device.

The router adds no collective and no kernel. It dispatches every
replica's quantum before it syncs any, as tpukit's. The port's fused
window reads its flags on the host after every tick (ROADMAP.md A11), so
in-process replicas on one card run one after the other; grid replicas
are processes of their own and overlap.

Telemetry: replicas write their `kind="serve"` windows tagged
`replica=<id>`; the router adds `kind="fleet"` windows, `fleet_event`
rows (scale, kill, requeue, shed) and one `fleet_summary`, which
`tools/report.py` renders ("== fleet ==", `--min_fleet_tps`). With a
shared `tracer` the router emits `route`, `handoff` and `requeue` span
events and flushes the one tracer at the end; with a shared `metrics`
registry it accounts the `slo` targets fleet-wide and owns the snapshot
files of `metrics_dir`, one per replica and their merge.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from tpukit_torch import mesh as mesh_lib
from tpukit_torch import resolve_device
from tpukit_torch import chaos as chaos_lib
from tpukit_torch import recovery as recovery_lib
from tpukit_torch import retry as retry_lib
from tpukit_torch.obs import metrics as metrics_lib
from tpukit_torch.obs import trace as trace_lib
from tpukit_torch.serve import ledger as ledger_lib
from tpukit_torch.serve import paged as paged_lib
from tpukit_torch.serve.engine import Completion, Request, ServeConfig, ServeEngine, trace_id
from tpukit_torch.serve.replica_world import GridReplica, HostParams, adopt_block


def pick_serve_grid(n_devices: int, heads: int, slots: int, paged: bool = False,
                    announce: bool = True) -> dict:
    """(data x model) serving grid (twin of `tpukit/serve/fleet.py:91`):
    the largest model degree <= 4 dividing both the device count and the
    head count (the KV ring shards heads over `model`; main-tp.py's rule),
    remaining devices data-parallel, shrunk to the largest divisor of the
    slot count, since slots shard over `data`. Paged serving requires a
    model-only grid (the page pool and block tables are the same on every
    data replica) and therefore drops the <= 4 cap: `model` grows to the
    largest head-dividing degree, and `announce` prints when devices stay
    idle."""
    if paged:
        for model in range(min(n_devices, heads), 0, -1):
            if heads % model == 0:
                if model < n_devices and announce:
                    print(f"paged serving uses a model-only grid: "
                          f"model={model} of {n_devices} devices "
                          f"(model degree is capped by heads={heads})")
                return {"data": 1, "model": model}
    for model in (4, 2, 1):
        if n_devices % model == 0 and heads % model == 0:
            data = n_devices // model
            while data > 1 and slots % data:
                data -= 1
            return {"data": data, "model": model}
    return {"data": 1, "model": 1}


def place_replica_params(host_params, device):
    """ONE copy of the parameters (nested dicts of tensors) placed on a
    replica's device (twin of `tpukit/serve/fleet.py:127`): the checkpoint
    is read once, and every placement is a copy of the same tree. A leaf
    already on `device` is shared, not copied."""
    if isinstance(host_params, dict):
        return {k: place_replica_params(v, device) for k, v in host_params.items()}
    return host_params.to(device)


def _on(eng):
    """The context of a call into `eng`: an in-process engine's card the
    current device (where the ctypes kernels launch; their wrappers enter
    it too), or nothing on the CPU and for a grid replica, whose ranks set
    their own cards."""
    return (torch.cuda.device(eng.device)
            if isinstance(eng, ServeEngine) and eng.device.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The router's shape (twin of `tpukit/serve/fleet.py:152-277`, the same
    fields, defaults and named errors). Replicas share one `ServeConfig`;
    the fleet adds the topology and the control loops.

    `replicas` engines to start; `devices_per_replica` 0 (every replica on
    the router's device), 1 (replica i on devices[i]) or D (replica i on a
    grid over its D devices, a world of its own); autoscale between
    `min_replicas` and `max_replicas` (0: `replicas`) on the window's mean
    slot occupancy against `scale_up_occupancy` / `scale_down_occupancy`
    (0 disables each); a `kind="fleet"` window every `window_steps`
    dispatch rounds; `disagg_prefill` with the worker's `prefill_slots`
    and `prefill_pages` (0: the ServeConfig's); `kill_spec`, the fleet
    chaos plan (`chaos.validate_fleet_spec`); `fleet_dir`, the durable
    ledger and the heartbeat files; `replica_timeout` seconds of heartbeat
    silence that make a replica dead (0 disables; needs `fleet_dir`);
    `request_retries` reassignments a request survives; `max_queue_depth`
    arrived requests past which the router sheds (0: unbounded)."""

    replicas: int = 2
    devices_per_replica: int = 0
    min_replicas: int = 1
    max_replicas: int = 0
    scale_up_occupancy: float = 0.0
    scale_down_occupancy: float = 0.0
    window_steps: int = 16
    disagg_prefill: bool = False
    prefill_slots: int = 0
    prefill_pages: int = 0
    kill_spec: str = ""
    fleet_dir: str = ""
    replica_timeout: float = 0.0
    request_retries: int = 3
    max_queue_depth: int = 0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas={self.replicas} must be >= 1")
        if self.min_replicas < 1 or self.min_replicas > self.replicas:
            raise ValueError(
                f"min_replicas={self.min_replicas} must be in "
                f"[1, replicas={self.replicas}]")
        if self.max_replicas and self.max_replicas < self.replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas} must be 0 (= replicas) "
                f"or >= replicas={self.replicas}")
        if self.devices_per_replica < 0:
            raise ValueError(f"devices_per_replica={self.devices_per_replica} must be >= 0")
        for name in ("scale_up_occupancy", "scale_down_occupancy"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must be in [0, 1]")
        if (self.scale_up_occupancy and self.scale_down_occupancy
                and self.scale_down_occupancy >= self.scale_up_occupancy):
            raise ValueError(
                f"scale_down_occupancy={self.scale_down_occupancy} must be "
                f"< scale_up_occupancy={self.scale_up_occupancy} — equal or "
                f"inverted thresholds would oscillate every window")
        if self.window_steps < 1:
            raise ValueError(f"window_steps={self.window_steps} must be >= 1")
        for name in ("prefill_slots", "prefill_pages"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 0")
        if (self.prefill_slots or self.prefill_pages) and not self.disagg_prefill:
            raise ValueError(
                "prefill_slots/prefill_pages configure the dedicated "
                "prefill worker — set disagg_prefill=True to run one")
        chaos_lib.validate_fleet_spec(self.kill_spec)
        if self.replica_timeout < 0:
            raise ValueError(f"replica_timeout={self.replica_timeout} must be >= 0")
        if self.replica_timeout > 0 and not self.fleet_dir:
            raise ValueError(
                "replica_timeout needs fleet_dir: liveness is declared "
                "from the heartbeat FILES replicas publish there")
        if self.request_retries < 0:
            raise ValueError(f"request_retries={self.request_retries} must be >= 0")
        if self.max_queue_depth < 0:
            raise ValueError(f"max_queue_depth={self.max_queue_depth} must be >= 0")

    @property
    def max_count(self) -> int:
        return self.max_replicas or self.replicas


class FleetRouter:
    """The fleet: N `ServeEngine` replicas behind one request queue (twin of
    `tpukit/serve/fleet.py:279`).

    `params_host` is ONE host copy of the model parameters; the router
    places it once per device (`place_replica_params`), and replicas on
    one device share the placement; grid replicas map one shared host copy
    (`replica_world.HostParams`), and each subset counts one placement.
    `serve` is each replica's engine shape, `fleet` the topology and
    control. `device` is the device of meshless replicas (cuda unless the
    caller asks for the CPU); `devices` the list `devices_per_replica`
    carves (default: `mesh.device_list`). `logger`/`recorder` flow into
    every replica and carry the router's own records; `tracer`, `metrics`,
    `slo` and `metrics_dir` are the router's, shared with the replicas.
    `close` ends the grid replicas' worlds; `run` closes them when it
    ends."""

    def __init__(self, params_host, cfg, serve: ServeConfig, fleet: FleetConfig,
                 eos_id: int, *, device=None, devices=None, logger=None, recorder=None,
                 tracer=None, metrics=None, slo=None, metrics_dir=None):
        if serve.draft and fleet.disagg_prefill:
            raise ValueError("disagg_prefill and speculative decoding are "
                             "mutually exclusive (ServeConfig enforces "
                             "draft => ring cache)")
        if fleet.disagg_prefill and not serve.paged:
            raise ValueError(
                "disagg_prefill requires the paged cache (page_size > 0): "
                "the prefill->decode handoff rides page granularity — "
                "refcounted read-only pages are the transferable unit")
        if fleet.devices_per_replica and cfg.num_experts > 0:
            raise ValueError(
                "fleet MoE serving uses meshless replicas this round "
                "(devices_per_replica=0): the Megatron grid rules don't "
                "cover expert banks (main-serve.py serves MoE replicated)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve = serve
        self.fleet = fleet
        self.eos_id = int(eos_id)
        self.logger = logger
        self.recorder = recorder
        # one tracer and one registry for the router, every replica and
        # the prefill worker: the span trees need one clock and rings that
        # outlive a killed replica, and the router flushes them once
        self.tracer = tracer
        self.metrics = metrics
        self.slo_accountant = (metrics_lib.SloAccountant(slo)
                               if (metrics is not None and slo) else None)
        self.metrics_dir = metrics_dir
        self._slo_seen_rids: set = set()
        self._metrics_replicas: set = set()  # every replica id ever built
        self._params_host = params_host
        self._host_block: HostParams | None = None  # the grid worlds' shared host copy
        self.placements = 0
        self._placed: dict = {}  # device, or ("subset", idx) -> placed params

        dpr = fleet.devices_per_replica
        devices = [torch.device(d) for d in (mesh_lib.device_list(self.device)
                                             if devices is None else devices)]
        # replica i's devices: a subset of `dpr`, or the router's device
        self._subsets = [[self.device]] * fleet.max_count
        self._worker_devices = [self.device]  # the prefill worker's
        if dpr:
            need = fleet.max_count * dpr
            if need > len(devices):
                raise ValueError(
                    f"max_replicas={fleet.max_count} x devices_per_replica="
                    f"{dpr} needs {need} devices, have {len(devices)}")
            self._subsets = [devices[i * dpr: (i + 1) * dpr] for i in range(fleet.max_count)]
            # a spare subset beyond the replica budget hosts the prefill
            # worker; otherwise it runs meshless on the router's device
            if len(devices) >= need + dpr:
                self._worker_devices = devices[need: need + dpr]

        self.requeued = 0
        self.kills = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.handoffs = 0
        self.replicas_peak = 0
        self.rejected = 0
        self.request_failures = 0
        self.replicas_dead = 0
        self.leases_revoked = 0
        self._attempts: dict[int, int] = {}  # rid -> assignments so far
        self._not_before: dict[int, float] = {}  # rid -> backoff gate
        self._stalled_until: dict[int, float] = {}  # replica -> wall time
        self._ledger_marks: dict[int, int] = {}  # id(engine) -> completions published
        self._replayed = 0
        self._last_beat_t = 0.0
        self._last_live_t = 0.0
        self._pending: deque[Request] = deque()
        self.last_summary: dict | None = None

        self._chaos = chaos_lib.ServingChaos(fleet.kill_spec)
        self.ledger = ledger_lib.RequestLedger(fleet.fleet_dir) if fleet.fleet_dir else None
        self._hb_dir = Path(fleet.fleet_dir) / "heartbeats" if fleet.fleet_dir else None
        self._done: list[Completion] = []  # retired and killed replicas' completions
        self._gen_removed = 0  # and their generated tokens
        self._replica_stats: dict = {}  # id -> final per-replica row
        self._window_idx = 0
        self._win = dict(rounds=0, occ=0.0, tok0=0, t0=0.0, req0=0)

        self._replicas: dict[int, ServeEngine | GridReplica] = {}
        self._draining: set[int] = set()
        self.prefill: ServeEngine | GridReplica | None = None
        try:
            for idx in range(fleet.replicas):
                self._build_replica(idx, log=False)
            if fleet.disagg_prefill:
                wcfg = dataclasses.replace(serve, slots=fleet.prefill_slots or serve.slots,
                                           num_pages=fleet.prefill_pages or serve.num_pages)
                self.prefill = self._engine("prefill", self._worker_devices, wcfg,
                                            dict(tracer=self.tracer))
        except BaseException:
            self.close()
            raise

        # round -> target ids (None: the highest live). The in-process router
        # fires replica_sigkill as replica_kill (there is no process to
        # kill) and says so; a real SIGKILL is ledger.ProcessFleet's
        self._kill_plan = self._chaos.kills
        self._sigkill_plan = self._chaos.sigkills
        self._stall_plan = self._chaos.stalls

    # ---- replica lifecycle ----------------------------------------------

    def _place_for(self, device: torch.device):
        """The parameters on `device`, placed once: replicas on one device
        share them (they are read-only); `placements` counts the copies."""
        key = str(device)
        if key not in self._placed:
            self._placed[key] = place_replica_params(self._params_host, device)
            self.placements += 1
        return self._placed[key]

    def _place_for_subset(self, subset_key) -> HostParams:
        """The shared host copy a grid world maps (written once); each
        subset counts one placement, as tpukit's `_place_for` counts one
        device_put a subset mesh."""
        if self._host_block is None:
            self._host_block = HostParams(self._params_host)
        if subset_key not in self._placed:
            self._placed[subset_key] = self._host_block
            self.placements += 1
        return self._host_block

    def _engine(self, replica, devices: list, serve: ServeConfig, planes: dict):
        """A replica (or the prefill worker): an engine in this process on
        its one device, or a grid world over its subset."""
        if len(devices) == 1:
            return ServeEngine(self._place_for(devices[0]), self.cfg, serve,
                               eos_id=self.eos_id, device=devices[0], replica=replica,
                               **planes)
        grid = pick_serve_grid(len(devices), self.cfg.heads, serve.slots, paged=serve.paged)
        return GridReplica(replica, devices, self._place_for_subset(("subset", replica)),
                           self.cfg, serve, self.eos_id, grid, **planes)

    def _build_replica(self, idx: int, log: bool = True) -> ServeEngine | GridReplica:
        eng = self._engine(idx, self._subsets[idx], self.serve,
                           dict(logger=self.logger, recorder=self.recorder,
                                tracer=self.tracer, metrics=self.metrics))
        eng.stuck_rids = self._chaos.stuck
        self._replicas[idx] = eng
        self._metrics_replicas.add(idx)
        self.replicas_peak = max(self.replicas_peak, len(self._replicas))
        if log:
            self._event("scale_up", replica=idx,
                        devices=self.fleet.devices_per_replica)
        return eng

    def _free_ids(self) -> list[int]:
        return [i for i in range(self.fleet.max_count) if i not in self._replicas]

    def _live(self) -> list[ServeEngine | GridReplica]:
        """Admission targets: live, non-draining replicas in id order (so
        ties go to the lowest id)."""
        return [e for i, e in sorted(self._replicas.items()) if i not in self._draining]

    def _event(self, event: str, **kw) -> None:
        if self.logger is not None:
            self.logger.log(kind="fleet_event", event=event, **kw)
        if self.recorder is not None:
            self.recorder.record("fleet_event", event=event, **kw)

    # ---- admission -------------------------------------------------------

    def _admit(self, pending: deque, now: float) -> None:
        """Move arrived requests (past their requeue backoff) onto the
        least-loaded targets: most free slots, then most free pages, then
        the lowest id. Each engine admits its batch in one call; what its
        pool cannot cover returns to the head of the queue in arrival
        order. With a ledger every assignment is written ahead of the
        engine seeing the request (a crash between lease and dispatch
        replays as a requeue); a leftover's attempt is taken back."""
        targets = [self.prefill] if self.prefill is not None else self._live()
        if not targets:
            return
        total_free = sum(e.free_slots for e in targets)
        arrived: list[Request] = []
        while pending and len(arrived) < total_free and self._ready_at(pending[0]) <= now:
            arrived.append(pending.popleft())
        if not arrived:
            return
        free = {id(e): e.free_slots for e in targets}
        assign: dict[int, list[Request]] = {id(e): [] for e in targets}
        for req in arrived:
            best = max(targets, key=lambda e: (free[id(e)], e.free_pages))
            assign[id(best)].append(req)
            free[id(best)] -= 1
            if self.tracer is not None:
                self.tracer.emit("route", trace_id(req), rid=req.rid, t=now,
                                 dst=best.replica, replica="router")
        leftovers: list[Request] = []
        for e in targets:
            batch = assign[id(e)]
            if not batch:
                continue
            for req in batch:
                att = self._attempts.get(req.rid, 0) + 1
                self._attempts[req.rid] = att
                if self.ledger is not None:
                    self.ledger.assign(req.rid, e.replica, att, now)
            with _on(e):
                left = e.admit(batch, now)
            for req in left:
                self._attempts[req.rid] -= 1
            leftovers.extend(left)
        for req in sorted(leftovers, key=lambda r: r.rid, reverse=True):
            pending.appendleft(req)

    def _ready_at(self, req: Request) -> float:
        """When a queued request may admit: its arrival, or its requeue
        backoff gate, whichever is later."""
        return max(req.arrival_s, self._not_before.get(req.rid, 0.0))

    def _shed(self, pending: deque, now: float) -> None:
        """Backpressure: with more than `max_queue_depth` arrived requests
        queued, shed the excess, lowest priority first, then the latest
        arrival (highest rid), each as a `request_rejected` event and a
        terminal ledger record (a replayed stream does not bring it back)."""
        depth = self.fleet.max_queue_depth
        if not depth or len(pending) <= depth:
            return
        arrived = [r for r in pending if r.arrival_s <= now]
        if len(arrived) <= depth:
            return
        shed = sorted(arrived, key=lambda r: (r.priority, -r.rid))[: len(arrived) - depth]
        drop = {r.rid for r in shed}
        kept = [r for r in pending if r.rid not in drop]
        pending.clear()
        pending.extend(kept)
        for req in sorted(shed, key=lambda r: r.rid):
            self.rejected += 1
            if self.metrics is not None:
                self.metrics.inc("fleet_rejected")
            if self.ledger is not None:
                self.ledger.record_failure(req.rid, "backpressure",
                                           self._attempts.get(req.rid, 0))
            self._event("request_rejected", rid=req.rid, priority=req.priority,
                        reason="backpressure", queue_depth=len(arrived))

    # ---- disaggregated prefill handoff ----------------------------------

    def _handoffs(self, now: float) -> None:
        """Hand every prefill-complete worker lane, in rid order, to the
        least-loaded decode replica with a free slot. A lane with no
        destination waits on the worker with its pages: prefill work is
        never dropped."""
        worker = self.prefill
        ready = sorted(((slot, lane) for slot, lane in worker._lanes.items()
                        if lane.phase == "decode"), key=lambda sl: sl[1].req.rid)
        for slot, lane in ready:
            cands = [e for e in self._live() if e.free_slots > 0]
            if not cands:
                break
            dst = max(cands, key=lambda e: (e.free_slots, e.free_pages))
            if self._adopt(worker, slot, lane, dst, now):
                self.handoffs += 1

    def _adopt(self, worker, slot: int, lane, dst, now: float) -> bool:
        """One handoff: read the worker's written pages, then claim the
        destination's registered prefix pages, allocate the rest, write the
        remaining pages and arm the decode lane (`adopt_block`; into a grid
        replica one command of its world, `GridReplica.adopt_handoff`, on
        every rank). Returns False, changing nothing, when the destination's
        pool cannot cover the request's footprint."""
        req, plen = lane.req, lane.prompt_len
        tr = self.tracer
        h0 = tr.now() if tr is not None else 0.0
        written = -(-lane.prefill_end // self.serve.page_size)  # pages holding K/V
        block = _read_pages(worker, lane.pages[:written])
        if isinstance(dst, GridReplica):
            adopted = dst.adopt_handoff(req, plen, {k: v.cpu() for k, v in block.items()},
                                        lane.admit_s, now, lane.key)
        else:
            with _on(dst):
                adopted = adopt_block(dst, req, plen, block, lane.admit_s, now, lane.key)
        if adopted is None:
            return False
        copied, claim_s, copy_s = adopted
        worker.release_lane(slot)
        if tr is not None:
            tr.emit("handoff", trace_id(req), rid=req.rid, t0=h0, t1=tr.now(),
                    claim_s=claim_s, copy_s=copy_s, pages=copied, dst=dst.replica,
                    replica="router")
        return True

    # ---- failure + autoscale --------------------------------------------

    def _maybe_kill(self, rounds: int, now: float) -> None:
        for plan, extra in (
            (self._kill_plan, {}),
            # in one process a sigkill entry is the simulated kill, and says so
            (self._sigkill_plan, {"signal": "SIGKILL", "simulated": True}),
        ):
            for target in plan.pop(rounds, ()):
                live = sorted(self._replicas)
                if len(live) <= 1:
                    self._event("kill_skipped", round=rounds, reason="last live replica")
                    continue
                idx = target if target in self._replicas else live[-1]
                self._kill(idx, rounds, now, **extra)

    def _fire_stalls(self, rounds: int) -> None:
        """slow_replica@R:ms: the highest live replica's heartbeat stalls for
        ms of wall clock, the engine untouched: the straggler the liveness
        check must not take for dead (unless the stall outlives
        `replica_timeout`)."""
        for stall_s in self._stall_plan.pop(rounds, ()):
            live = sorted(self._replicas)
            if not live:
                continue
            idx = live[-1]
            self._stalled_until[idx] = max(self._stalled_until.get(idx, 0.0),
                                           time.time() + stall_s)
            self._chaos.record(dict(fault="slow_replica", round=rounds, replica=idx,
                                    stall_s=stall_s))
            self._event("replica_slow", replica=idx, round=rounds, stall_s=stall_s)

    def _beat(self, rounds: int) -> None:
        """Publish each live replica's heartbeat file, at most every 10 ms;
        a stalled replica skips its beat (that is the fault)."""
        if self._hb_dir is None:
            return
        wall = time.time()
        if wall - self._last_beat_t < 0.01:
            return
        self._last_beat_t = wall
        for idx, eng in sorted(self._replicas.items()):
            if self._stalled_until.get(idx, 0.0) > wall:
                continue
            retry_lib.retry_io(
                recovery_lib.publish_heartbeat, self._hb_dir, f"replica-{idx:05d}",
                dict(replica=idx, t=wall, round=rounds, generated=eng.generated_tokens,
                     lanes=eng.live_lanes),
                label="heartbeat")

    def _check_liveness(self, rounds: int, now: float) -> None:
        """Replicas whose heartbeat is older than `replica_timeout` are dead:
        the kill path, driven by the heartbeat files."""
        f = self.fleet
        if f.replica_timeout <= 0 or self._hb_dir is None:
            return
        wall = time.time()
        if wall - self._last_live_t < min(f.replica_timeout / 4.0, 0.01):
            return
        self._last_live_t = wall
        beats = recovery_lib.read_heartbeat_dir(self._hb_dir, "replica-")
        for idx in sorted(self._replicas):
            rec = beats.get(f"replica-{idx:05d}")
            if rec is None:
                continue  # not published yet: born this round
            age = wall - float(rec["t"])
            if age <= f.replica_timeout:
                continue
            if len(self._replicas) <= 1:
                self._event("kill_skipped", round=rounds, reason="last live replica")
                continue
            self.replicas_dead += 1
            if self.metrics is not None:
                self.metrics.inc("fleet_replica_dead")
            self._kill(idx, rounds, now, event="replica_dead", reason="heartbeat_timeout",
                       age_s=round(age, 3))

    def _kill(self, idx: int, rounds: int, now: float, event: str = "replica_kill",
              **extra) -> None:
        """Drop replica `idx` mid-flight: the engine is discarded (a grid
        replica's world ended and reaped once its live requests are taken
        back), its completed requests keep their tokens (published to the
        ledger first), and its in-flight requests requeue at the head of
        the queue within the retry budget."""
        eng = self._replicas.pop(idx)
        self._draining.discard(idx)
        self._ledger_collect(eng)
        victims = eng.requeue_live()
        _close(eng)
        self._done.extend(eng.completions)
        # the victim's whole generated count (its in-flight partial tokens
        # too) joins the removed tally, so the window counter stays
        # monotone; the survivors' redone work counts again
        self._gen_removed += eng.generated_tokens
        self._replica_stats[idx] = dict(
            completions=len(eng.completions),
            tokens=sum(c.generated for c in eng.completions),
            occupancy=None, fate="killed" if event == "replica_kill" else "dead")
        self.kills += 1
        self.leases_revoked += len(victims)
        kept = self._requeue(victims, idx, now)
        if self.tracer is not None:
            # the same Request requeues, so the retry lands on the same tree
            for req in kept:
                self.tracer.emit("requeue", trace_id(req), rid=req.rid, t=now,
                                 from_replica=idx, replica="router")
        self._event(event, replica=idx, round=rounds, requeued=len(kept),
                    requeued_rids=[r.rid for r in kept], **extra)
        if self.logger is not None and self.ledger is not None and kept:
            self.logger.log(kind="lease_requeue", from_replica=idx,
                            rids=[r.rid for r in kept],
                            attempts={str(r.rid): self._attempts.get(r.rid, 1) for r in kept})

    def _requeue(self, victims: list[Request], idx: int, now: float) -> list[Request]:
        """Requeue a dead replica's in-flight requests at the queue head,
        each behind a jittered backoff (`retry.backoff_delay`), within the
        `request_retries` budget: past it a request is a named terminal
        `request_failed`."""
        kept: list[Request] = []
        for req in victims:
            n = self._attempts.get(req.rid, 1)
            if n > self.fleet.request_retries:
                self.request_failures += 1
                self._event("request_failed", rid=req.rid, attempts=n, reason="retry_budget")
                if self.metrics is not None:
                    self.metrics.inc("fleet_request_failed")
                if self.ledger is not None:
                    self.ledger.record_failure(req.rid, "retry_budget", n)
                continue
            self._not_before[req.rid] = now + retry_lib.backoff_delay(n)
            kept.append(req)
        self.requeued += len(kept)
        if self.metrics is not None and kept:
            self.metrics.inc("fleet_requeued", len(kept))
        for req in reversed(kept):
            self._pending.appendleft(req)
        return kept

    def _autoscale(self, mean_occ: float, queue_depth: int) -> None:
        f = self.fleet
        live = [i for i in self._replicas if i not in self._draining]
        if (f.scale_up_occupancy and mean_occ >= f.scale_up_occupancy
                and len(live) < f.max_count and self._free_ids()):
            self._build_replica(min(self._free_ids()))
            self.scale_ups += 1
        elif (f.scale_down_occupancy and mean_occ <= f.scale_down_occupancy
                and len(live) > f.min_replicas and queue_depth == 0):
            victim = max(live)
            self._draining.add(victim)
            self.scale_downs += 1
            self._event("scale_down", replica=victim,
                        draining_lanes=self._replicas[victim].live_lanes)

    def _retire_drained(self, now: float) -> None:
        for idx in sorted(self._draining):
            eng = self._replicas[idx]
            if eng.live_lanes:
                continue
            self._retire(idx, eng, now, fate="drained")
            self._event("scale_down_complete", replica=idx)

    def _retire(self, idx: int, eng: ServeEngine, wall: float, fate: str) -> None:
        comps = eng.finish(wall)
        self._ledger_collect(eng)
        self._done.extend(comps)
        self._gen_removed += sum(c.generated for c in comps)
        s = eng.last_summary or {}
        self._replica_stats[idx] = dict(
            completions=len(comps), tokens=sum(c.generated for c in comps),
            occupancy=s.get("mean_occupancy"), fate=fate)
        del self._replicas[idx]
        self._draining.discard(idx)
        _close(eng)

    # ---- telemetry -------------------------------------------------------

    def _ledger_collect(self, eng: ServeEngine) -> None:
        """Publish an engine's new completions to the durable ledger, after
        every sync and before an engine is dropped, so a crash loses no
        finished request; the ledger's check-then-publish keeps a request
        that completes twice (a slow, not dead, replica) to one record."""
        if self.ledger is None:
            return
        key = id(eng)
        mark = self._ledger_marks.get(key, 0)
        comps = eng.completions
        for c in comps[mark:]:
            self.ledger.complete(c, replica=eng.replica, attempt=self._attempts.get(c.rid, 1))
        self._ledger_marks[key] = len(comps)

    def _fleet_gen(self) -> int:
        return self._gen_removed + sum(e.generated_tokens for e in self._replicas.values())

    def _emit_window(self, now: float, queue_depth: int) -> float:
        """The `kind="fleet"` window; returns its mean occupancy (the
        autoscale signal)."""
        w = self._win
        occ = w["occ"] / max(w["rounds"], 1)
        tok = self._fleet_gen() - w["tok0"]
        wall = now - w["t0"]
        rec = dict(
            kind="fleet", window=self._window_idx, rounds=w["rounds"],
            replicas=sorted(self._replicas), draining=sorted(self._draining),
            new_tokens=tok, tokens_per_sec=(tok / wall) if wall > 0 else None,
            occupancy=occ, queue_depth=queue_depth, requeued=self.requeued - w["req0"],
            per_replica_tokens={str(i): e.generated_tokens
                                for i, e in sorted(self._replicas.items())},
            window_s=wall,
        )
        if self.prefill is not None:
            rec["prefill_lanes"] = self.prefill.live_lanes
            rec["handoffs"] = self.handoffs
        if self.logger is not None:
            self.logger.log(**rec)
        if self.recorder is not None:
            self.recorder.record("fleet", window=self._window_idx, new_tokens=tok,
                                 occupancy=occ, replicas=len(self._replicas))
        if self.metrics is not None:
            self._metrics_window(rec)
        self._window_idx += 1
        self._win = dict(rounds=0, occ=0.0, tok0=self._fleet_gen(), t0=now,
                         req0=self.requeued)
        return occ

    def _metrics_window(self, rec: dict) -> None:
        """The fleet's gauges and its fleet-wide SLO accounting for one
        window (the replicas observe their own histograms, replica-labeled,
        into the same registry)."""
        m = self.metrics
        if rec.get("tokens_per_sec") is not None:
            m.gauge("fleet_tokens_per_sec", rec["tokens_per_sec"])
        m.gauge("fleet_occupancy", rec["occupancy"])
        m.gauge("fleet_queue_depth", rec["queue_depth"])
        m.gauge("fleet_replicas", len(self._replicas))
        if self.slo_accountant is not None:
            # every completion not yet accounted, live replicas' and retired
            # ones' alike, each rid once
            fresh: list[Completion] = []
            pools = [e.completions for e in self._replicas.values()]
            pools.append(self._done)
            for pool in pools:
                for c in pool:
                    if c.rid not in self._slo_seen_rids:
                        self._slo_seen_rids.add(c.rid)
                        fresh.append(c)
            samples = {
                "e2e": [c.e2e_s for c in fresh],
                "ttft": [max(c.active_s - c.arrival_s, 0.0) for c in fresh],
                "queue_wait": [max(c.admit_s - c.arrival_s, 0.0) for c in fresh],
                "tpot": [c.per_token_s for c in fresh],
            }
            slo_rec = dict(kind="slo", window=self._window_idx,
                           **self.slo_accountant.evaluate(samples))
            if self.logger is not None:
                self.logger.log(**slo_rec)
            if self.recorder is not None:
                self.recorder.record("slo", window=self._window_idx,
                                     overall_compliance=slo_rec["overall_compliance"])
        if self.metrics_dir:
            self._publish_metrics()

    def _publish_metrics(self) -> None:
        """One snapshot file a replica, split from the shared registry by its
        label, and the merge beside them; every file operation rides
        `retry_io`."""
        wall = time.time()
        count = self.fleet.max_count
        for idx in sorted(self._metrics_replicas):
            retry_lib.retry_io(metrics_lib.publish_snapshot, self.metrics_dir, idx,
                               self.metrics.filter(replica=idx), process_count=count,
                               time_s=wall, label="metrics_snapshot")
        merged, meta = retry_lib.retry_io(metrics_lib.merge_snapshot_dir, self.metrics_dir,
                                          process_count=count, label="metrics_merge")
        retry_lib.retry_io(metrics_lib.write_merged, self.metrics_dir, merged, meta=meta,
                           label="metrics_merge")

    def summary(self, wall_s: float) -> dict:
        """The `kind="fleet_summary"` record (tpukit's keys)."""
        comps = self._done
        rids = [c.rid for c in comps]
        e2e = sorted(c.e2e_s for c in comps)
        pct = lambda q: float(np.percentile(np.asarray(e2e), q)) if e2e else None  # noqa: E731
        occs = [r["occupancy"] for r in self._replica_stats.values()
                if r.get("occupancy") is not None]
        gen = sum(c.generated for c in comps)
        rec = dict(
            kind="fleet_summary", requests=len(comps), generated_tokens=gen,
            wall_s=wall_s, tokens_per_sec=(gen / wall_s) if wall_s else None,
            replicas_final=len(self._replicas) or sum(
                1 for r in self._replica_stats.values() if r["fate"] == "final"),
            replicas_peak=self.replicas_peak,
            scale_ups=self.scale_ups, scale_downs=self.scale_downs,
            kills=self.kills, requeued=self.requeued, rejected=self.rejected,
            request_failures=self.request_failures, replicas_dead=self.replicas_dead,
            leases_revoked=self.leases_revoked,
            deadline_misses=sum(1 for c in comps if c.reason == "deadline"),
            # the exactly-once invariant as data
            duplicate_completions=len(rids) - len(set(rids)),
            p50_e2e_s=pct(50), p99_e2e_s=pct(99),
            per_replica=self._replica_stats,
            occupancy_spread=(max(occs) - min(occs)) if len(occs) > 1 else 0.0,
            params_placements=self.placements,
        )
        if self.fleet.disagg_prefill:
            st = self.prefill.allocator.stats
            rec["disagg_prefill"] = dict(
                handoffs=self.handoffs, worker_admitted=self.prefill.admitted,
                worker_prefix_hits=st.prefix_hits,
                worker_pages_reused=st.prefix_pages_reused)
        if self.tracer is not None:
            # the fleet-wide per-phase view over every completed request's
            # tree, killed replicas' work included
            done_rids = {c.rid for c in comps}
            trees = [t for t in trace_lib.build_trees(self.tracer.snapshot())
                     if t["rid"] in done_rids]
            rec["phase_p50"], rec["phase_p99"] = trace_lib.phase_stats(trees)
            rec["trace_complete"] = trace_lib.completeness(trees)
            by_rep = self.tracer.dropped_by_replica
            rec["trace_dropped"] = sum(by_rep.values())
            rec["trace_dropped_by_replica"] = {str(k): v for k, v in
                                               sorted(by_rep.items(), key=str)}
        if self.slo_accountant is not None:
            rec["slo_overall_compliance"] = self.slo_accountant.overall_compliance()
        if self.ledger is not None:
            rec["ledger"] = dict(completed=len(self.ledger.completions()),
                                 replayed=self._replayed,
                                 duplicates=self.ledger.duplicates())
        return rec

    # ---- the loop --------------------------------------------------------

    @torch.no_grad()
    def run(self, requests, max_wall_s: float | None = None) -> list[Completion]:
        """Serve `requests` across the fleet to completion; returns every
        completion in finish order. Each iteration fires the scheduled
        kills and stalls, checks liveness, publishes heartbeats, sheds
        over-depth queue, admits least-loaded, advances prefill (the
        worker's chunks and handoffs, or each replica's), dispatches every
        replica's decode quantum, then syncs each and publishes its new
        completions. A fleet window and the autoscale check close every
        `window_steps` rounds. With `fleet_dir` the stream is durable: a
        router restarted on the same stream serves only what is not yet
        completed."""
        if self.ledger is not None:
            requests, done_recs = self.ledger.open_stream(requests)
            self._replayed = len(done_recs)
            if self._replayed:
                self._event("ledger_replay", completed=self._replayed,
                            remaining=len(requests))
        self._pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        # the ledger's file helpers reach the plan's I/O faults through
        # chaos.maybe_io_fault, as the checkpoint sites do
        prev_chaos = chaos_lib.install(self._chaos)
        try:
            return self._run_loop(self._pending, max_wall_s)
        finally:
            chaos_lib.install(prev_chaos)
            self.close()

    def ready(self) -> None:
        """Wait until every grid world this router holds has started (its
        ranks' start-up replies); an in-process engine is ready when built.
        `run` waits for them too, before its clock starts."""
        for eng in [*self._replicas.values(), self.prefill]:
            if isinstance(eng, GridReplica):
                eng.ready()

    def close(self) -> None:
        """End every grid world this router still holds (its replicas' and
        the prefill worker's) and release the shared host copy; in-process
        engines need nothing. `run` calls it when it ends."""
        for eng in [*self._replicas.values(), self.prefill]:
            _close(eng)
        if self._host_block is not None:
            self._host_block.close()

    def _run_loop(self, pending: deque, max_wall_s: float | None) -> list[Completion]:
        for eng in self._replicas.values():
            eng.spans.epoch()
        if self.prefill is not None:
            self.prefill.spans.epoch()
        t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.set_epoch(t0)
            for r in pending:
                self.tracer.emit("enqueue", trace_id(r), rid=r.rid, t=r.arrival_s,
                                 replica="router")
        self._win["t0"] = 0.0
        rounds = 0
        while pending or self._any_lanes():
            now = time.perf_counter() - t0
            if max_wall_s is not None and now > max_wall_s:
                raise TimeoutError(
                    f"fleet run exceeded max_wall_s={max_wall_s} with "
                    f"{len(pending)} pending and "
                    f"{sum(e.live_lanes for e in self._replicas.values())} live lanes")
            self._maybe_kill(rounds, now)
            self._fire_stalls(rounds)
            self._check_liveness(rounds, now)
            self._beat(rounds)
            self._shed(pending, now)
            self._admit(pending, now)
            if self.prefill is not None:
                with _on(self.prefill):
                    self.prefill.poll_prefill(time.perf_counter() - t0)
                self._handoffs(time.perf_counter() - t0)
            else:
                for eng in list(self._replicas.values()):
                    with _on(eng):
                        eng.poll_prefill(time.perf_counter() - t0)
            dispatched = []
            for eng in self._replicas.values():
                with _on(eng):
                    if eng.dispatch_decode():
                        dispatched.append(eng)
            if not dispatched:
                if not self._any_lanes() and pending:
                    wait = self._ready_at(pending[0]) - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            rounds += 1
            # occupancy at dispatch: the lanes the quanta just issued held
            slots = sum(e.serve.slots for e in self._replicas.values())
            decoding = sum(e.decoding_lanes for e in self._replicas.values())
            snow = time.perf_counter() - t0
            for eng in dispatched:
                with _on(eng):
                    eng.sync(snow)
                self._ledger_collect(eng)
            self._win["rounds"] += 1
            self._win["occ"] += decoding / max(slots, 1)
            if self._win["rounds"] >= self.fleet.window_steps:
                occ = self._emit_window(snow, len(pending))
                self._autoscale(occ, len(pending))
            self._retire_drained(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        if self._win["rounds"]:
            self._emit_window(wall, 0)
        for idx, eng in sorted(self._replicas.items()):
            self._retire(idx, eng, wall, fate="final")
        if self.logger is not None:
            for ev in self._chaos.drain_fired():
                self.logger.log(kind="chaos", **ev)
        rec = self.last_summary = self.summary(wall)
        if self.logger is not None:
            self.logger.log(**rec)
        if self.recorder is not None:
            self.recorder.record("fleet_summary", requests=rec["requests"],
                                 tokens_per_sec=rec["tokens_per_sec"],
                                 requeued=rec["requeued"], kills=rec["kills"])
        if self.tracer is not None:
            # one flush for the whole fleet: the replicas share this tracer
            trace_lib.flush_to_logger(self.tracer, self.logger,
                                      trace_lib.build_trees(self.tracer.snapshot()))
        if self.metrics is not None:
            rec_m = dict(kind="metrics", source="fleet", **self.metrics.summary())
            if self.logger is not None:
                self.logger.log(**rec_m)
            if self.recorder is not None:
                self.recorder.record("metrics", source="fleet", hists=len(rec_m["hists"]),
                                     tokens=self.metrics.sum_counter("serve_tokens"))
            if self.metrics_dir:
                self._publish_metrics()
        self._done.sort(key=lambda c: c.done_s)
        return self._done

    def _any_lanes(self) -> bool:
        if any(e.live_lanes for e in self._replicas.values()):
            return True
        return self.prefill is not None and self.prefill.live_lanes > 0


def _close(eng) -> None:
    """End a grid replica's world; an in-process engine (or None) needs
    nothing."""
    if isinstance(eng, GridReplica):
        eng.close()


def _read_pages(src, ids) -> dict:
    """The handoff's source half (twin of `tpukit/serve/fleet.py:1200`):
    the rows of pages `ids` of each of the source's pools (K/V and the int8
    scale sidecars, `paged.extract_pages`), on its device, or, from a grid
    worker, every head gathered on the CPU."""
    if isinstance(src, GridReplica):
        return src.read_pages(ids)
    s = torch.tensor(list(ids), dtype=torch.long, device=src.device)
    with _on(src):
        return {key: paged_lib.extract_pages(src.cache[key], s)
                for key in ("k", "v", "ks", "vs") if key in src.cache}
