"""The durable request lifecycle and the fleet of worker processes (twin of
`tpukit/serve/ledger.py`).

  - **RequestLedger**, the lifecycle store under one directory, one atomic
    JSON file a record (every read and write through `retry.retry_io`,
    under the `ledger` chaos site):

        stream.json            the whole request stream, written once ahead
                               of serving (the replay source)
        assign/r<rid>.json     the request's current lease {replica,
                               attempt, t}, written before dispatch
                               (write-ahead), overwritten on requeue
        done/r<rid>.json       the completion {ids, reason, timings},
                               written after the tokens exist
        failed/r<rid>.json     a terminal non-completion (retry budget
                               spent, shed by backpressure)
        dup/r<rid>-a<n>.json   a second completion of one rid, detected
                               (the exactly-once invariant as data)
        heartbeats/replica-<i>.json   the liveness plane
        ctl/stop.json, ctl/stall-<i>.json   shutdown and slow_replica chaos

    Completion is exactly once by construction: one done file a rid, and
    `complete` checks before it publishes, so a second finisher (a slow,
    not dead, replica whose lease was revoked) is recorded under dup/ and
    never overwrites the first. `open_stream` on a directory that holds a
    stream replays it without the completed and failed rids, so a
    restarted router resumes at the frontier; open leases serve again
    (at-least-once assignment, exactly-once output).
  - **serve_from_ledger**, the worker loop: a process that owns one
    `ServeEngine` claims the leases naming its replica, serves them, and
    publishes completions and heartbeats. The directory is the workers'
    only channel, which is what makes a SIGKILL recoverable.
  - **ProcessFleet**, the supervisor: spawns N workers (through a
    caller's `spawn`), assigns leases least-loaded, declares a worker dead
    when its process exits or its heartbeat is older than
    `replica_timeout`, revokes its leases and requeues them with a
    jittered backoff within `request_retries`, and fires `replica_sigkill`
    chaos as a real `os.kill`.

All of it is host-side control: no decode program changes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import time
from collections import deque
from pathlib import Path

import torch

from tpukit_torch import chaos as chaos_lib
from tpukit_torch import recovery as recovery_lib
from tpukit_torch import retry as retry_lib
from tpukit_torch.checkpoint import atomic_write_text
from tpukit_torch.serve.engine import Completion, Request

# The raw record I/O: chaos-injectable, and called only through retry_io,
# so that every record rides the transient-fault budget `ledger_io_fail`
# drills.


def _write_rec(path: Path, obj: dict) -> None:
    chaos_lib.maybe_io_fault("ledger")
    atomic_write_text(Path(path), json.dumps(obj, sort_keys=True))


def _read_rec(path: Path) -> dict:
    chaos_lib.maybe_io_fault("ledger")
    return json.loads(Path(path).read_text())


def request_to_rec(req: Request) -> dict:
    return dict(rid=req.rid, ids=[int(i) for i in req.ids],
                max_new_tokens=req.max_new_tokens, seed=req.seed, arrival_s=req.arrival_s,
                trace=req.trace, deadline_ms=req.deadline_ms, priority=req.priority)


def request_from_rec(rec: dict) -> Request:
    return Request(rid=int(rec["rid"]), ids=tuple(int(i) for i in rec["ids"]),
                   max_new_tokens=int(rec["max_new_tokens"]), seed=int(rec["seed"]),
                   arrival_s=float(rec["arrival_s"]), trace=int(rec.get("trace", -1)),
                   deadline_ms=float(rec.get("deadline_ms", 0.0)),
                   priority=int(rec.get("priority", 0)))


class RequestLedger:
    """The durable request lifecycle under one directory (the module
    docstring has the layout). Safe from the router or supervisor and from
    worker processes: records are single atomic files, readers tolerate
    files appearing between list and read, and the one path with several
    writers (done/) checks before it publishes."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        for sub in ("assign", "done", "failed", "dup", "heartbeats", "ctl"):
            (self.dir / sub).mkdir(parents=True, exist_ok=True)
        self._stream_path = self.dir / "stream.json"

    # -- request stream (write-ahead + replay) -----------------------------

    def open_stream(self, requests: list[Request]) -> tuple[list[Request], dict]:
        """Write the stream ahead of serving (first open) or replay it
        (restart: the completed and failed rids drop out). Returns (the
        requests still to serve, the completion records by rid)."""
        if not self._stream_path.exists():
            retry_lib.retry_io(_write_rec, self._stream_path,
                               {"requests": [request_to_rec(r) for r in requests]},
                               label="ledger_write")
        done = self.completions()
        failed = self.failures()
        return [r for r in requests if r.rid not in done and r.rid not in failed], done

    def read_stream(self) -> list[Request]:
        rec = retry_lib.retry_io(_read_rec, self._stream_path, label="ledger_read")
        return [request_from_rec(r) for r in rec["requests"]]

    def has_stream(self) -> bool:
        return self._stream_path.exists()

    # -- leases ------------------------------------------------------------

    def assign(self, rid: int, replica: int, attempt: int, t: float) -> None:
        """Publish the request's lease, ahead of the replica seeing it."""
        retry_lib.retry_io(_write_rec, self.dir / "assign" / f"r{rid:06d}.json",
                           dict(rid=rid, replica=replica, attempt=attempt, t=t),
                           label="ledger_write")

    def assignments(self) -> dict[int, dict]:
        return self._scan("assign")

    # -- completions (exactly-once publish) --------------------------------

    def complete(self, comp: Completion, replica, attempt: int) -> bool:
        """Publish a completion; returns False (and records the attempt under
        dup/) when the rid already has one."""
        path = self.dir / "done" / f"r{comp.rid:06d}.json"
        if path.exists():
            retry_lib.retry_io(_write_rec, self.dir / "dup" / f"r{comp.rid:06d}-a{attempt}.json",
                               dict(rid=comp.rid, replica=replica, attempt=attempt),
                               label="ledger_write")
            return False
        retry_lib.retry_io(
            _write_rec, path,
            dict(rid=comp.rid, replica=replica, attempt=attempt,
                 ids=[int(i) for i in comp.ids], prompt_len=comp.prompt_len,
                 generated=comp.generated, reason=comp.reason, arrival_s=comp.arrival_s,
                 admit_s=comp.admit_s, done_s=comp.done_s, e2e_s=comp.e2e_s),
            label="ledger_write")
        return True

    def completions(self) -> dict[int, dict]:
        return self._scan("done")

    def duplicates(self) -> int:
        return len(list((self.dir / "dup").glob("*.json")))

    # -- terminal failures -------------------------------------------------

    def record_failure(self, rid: int, reason: str, attempts: int) -> None:
        retry_lib.retry_io(_write_rec, self.dir / "failed" / f"r{rid:06d}.json",
                           dict(rid=rid, reason=reason, attempts=attempts),
                           label="ledger_write")

    def failures(self) -> dict[int, dict]:
        return self._scan("failed")

    # -- liveness + control ------------------------------------------------

    def beat(self, replica: int, **fields) -> None:
        """A worker's heartbeat, stamped with wall-clock time (the one clock
        processes share)."""
        retry_lib.retry_io(recovery_lib.publish_heartbeat, self.dir / "heartbeats",
                           f"replica-{replica:05d}",
                           dict(replica=replica, t=time.time(), **fields), label="heartbeat")

    def heartbeats(self) -> dict[int, dict]:
        return {int(rec["replica"]): rec for rec in recovery_lib.read_heartbeat_dir(
            self.dir / "heartbeats", "replica-").values()}

    def request_stop(self) -> None:
        retry_lib.retry_io(_write_rec, self.dir / "ctl" / "stop.json", dict(t=time.time()),
                           label="ledger_write")

    def stop_requested(self) -> bool:
        return (self.dir / "ctl" / "stop.json").exists()

    def set_stall(self, replica: int, stall_s: float, token: int) -> None:
        """slow_replica chaos: the worker sleeps `stall_s` without beating,
        once per unseen `token`: a straggler, not a corpse."""
        retry_lib.retry_io(_write_rec, self.dir / "ctl" / f"stall-{replica:05d}.json",
                           dict(replica=replica, stall_s=stall_s, token=token),
                           label="ledger_write")

    def read_stall(self, replica: int) -> dict | None:
        path = self.dir / "ctl" / f"stall-{replica:05d}.json"
        if not path.exists():
            return None
        return retry_lib.retry_io(_read_rec, path, label="ledger_read")

    # -- internals ---------------------------------------------------------

    def _scan(self, sub: str) -> dict[int, dict]:
        """Every r<rid>.json record of a subdirectory, by rid (records are
        never deleted, so a vanished file is real filesystem trouble)."""
        out: dict[int, dict] = {}
        for path in sorted((self.dir / sub).glob("r*.json")):
            rec = retry_lib.retry_io(_read_rec, path, label="ledger_read")
            out[int(rec["rid"])] = rec
        return out


# ---------------------------------------------------------------------------
# The replica worker loop (one OS process, one engine)
# ---------------------------------------------------------------------------


def serve_from_ledger(engine, directory: str | Path, replica: int, *,
                      poll_s: float = 0.005, max_wall_s: float = 600.0,
                      stream_wait_s: float = 60.0) -> list[Completion]:
    """Serve the leases addressed to `replica` until the supervisor
    publishes stop (or `max_wall_s` ends a worker whose supervisor died).
    Each tick: honour a stall record (sleep without beating), beat, claim
    newly assigned requests, run one quantum of the engine, publish new
    completions. A claimed request's `arrival_s` becomes the claim time on
    the worker's clock, so its deadline and latencies count from when this
    attempt could first run; its tokens depend only on prompt and seed."""
    led = RequestLedger(directory)
    t0 = time.time()
    while not led.has_stream():
        if time.time() - t0 > stream_wait_s:
            raise TimeoutError(f"replica {replica}: no stream.json after {stream_wait_s}s")
        time.sleep(poll_s)
    by_rid = {r.rid: r for r in led.read_stream()}
    queue: deque[Request] = deque()
    claimed: dict[int, int] = {}  # rid -> the lease attempt served or serving
    published = 0
    beats = 0
    stall_seen = -1
    with torch.no_grad():
        while True:
            now = time.time() - t0
            if now > max_wall_s:
                break
            stall = led.read_stall(replica)
            if stall is not None and int(stall.get("token", 0)) > stall_seen:
                stall_seen = int(stall["token"])
                time.sleep(float(stall["stall_s"]))
                continue
            beats += 1
            led.beat(replica, pid=os.getpid(), beats=beats, generated=engine.generated_tokens,
                     lanes=engine.live_lanes)
            done = led.completions()
            for rid, lease in sorted(led.assignments().items()):
                if (lease["replica"] == replica and rid in by_rid and rid not in done
                        and claimed.get(rid) != lease["attempt"]):
                    claimed[rid] = int(lease["attempt"])
                    queue.append(dataclasses.replace(by_rid[rid], arrival_s=now))
            if queue:
                batch = []
                while queue and len(batch) < engine.free_slots:
                    batch.append(queue.popleft())
                for req in reversed(engine.admit(batch, now)):
                    queue.appendleft(req)
            engine.poll_prefill(time.time() - t0)
            progressed = engine.dispatch_decode()
            if progressed:
                engine.sync(time.time() - t0)
            comps = engine.completions
            for c in comps[published:]:
                led.complete(c, replica=replica, attempt=claimed.get(c.rid, 1))
            published = len(comps)
            if led.stop_requested() and not queue and engine.live_lanes == 0:
                break
            if not progressed and not queue:
                time.sleep(poll_s)
    return engine.finish(time.time() - t0)


# ---------------------------------------------------------------------------
# The supervisor (a fleet of processes)
# ---------------------------------------------------------------------------


class ProcessFleet:
    """A crash-tolerant fleet of worker processes over one ledger directory.

    `spawn(idx)` launches worker `idx` and returns its `subprocess.Popen`
    (the entry point re-execs itself with `--fleet_worker idx`; tests start
    a worker script). The supervisor owns assignment (fewest open leases,
    then the lowest id), liveness (the process exited, or its heartbeat is
    older than `replica_timeout`), revocation with budgeted, jittered
    requeue, and the chaos plan (`replica_sigkill` as a real `os.kill`;
    its rounds count the supervisor's polls with work in flight, so a
    scheduled fault always has leases to disrupt). A dead worker is
    respawned only when it was the last: otherwise the survivors take its
    work."""

    def __init__(self, directory: str | Path, *, spawn, replicas: int,
                 replica_timeout: float = 5.0, request_retries: int = 3,
                 chaos: chaos_lib.ServingChaos | None = None, logger=None, recorder=None,
                 poll_s: float = 0.01, grace_s: float = 20.0):
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        self.ledger = RequestLedger(directory)
        self.spawn = spawn
        self.replicas = replicas
        self.replica_timeout = replica_timeout
        self.request_retries = request_retries
        self.chaos = chaos
        self.logger = logger
        self.recorder = recorder
        self.poll_s = poll_s
        self.grace_s = grace_s
        self.kills = 0
        self.requeued = 0
        self.replicas_dead = 0
        self.leases_revoked = 0
        self.respawns = 0
        self._deaths: list[dict] = []

    def _event(self, event: str, **kw) -> None:
        if self.logger is not None:
            self.logger.log(kind="fleet_event", event=event, **kw)
        if self.recorder is not None:
            self.recorder.record("fleet_event", event=event, **kw)

    def _pick_target(self, target: int | None, procs: dict) -> int | None:
        live = sorted(procs)
        if len(live) <= 1:
            return None
        return target if target in procs else live[-1]

    def run(self, requests: list[Request], max_wall_s: float = 300.0) -> dict:
        """Serve `requests` until every rid is completed or terminally
        failed; returns the `kind="fleet_summary"` record. Raises
        TimeoutError past `max_wall_s`: a fleet that cannot converge fails
        loudly. Every worker is stopped and reaped on the way out."""
        led = self.ledger
        todo, replayed = led.open_stream(requests)
        all_rids = {r.rid for r in requests}
        prev_chaos = chaos_lib.install(self.chaos)
        rlog = retry_lib.RetryLog()
        retry_lib.set_observer(rlog)
        procs: dict[int, object] = {}
        spawn_t: dict[int, float] = {}
        attempts: dict[int, int] = {}
        failed: set[int] = set(led.failures())
        try:
            for i in range(self.replicas):
                procs[i] = self.spawn(i)
                spawn_t[i] = time.time()
            not_before: dict[int, float] = {}
            unassigned = {r.rid for r in todo}
            rounds = 0
            t0 = time.time()
            while True:
                now = time.time() - t0
                if now > max_wall_s:
                    raise TimeoutError(f"process fleet exceeded max_wall_s={max_wall_s} "
                                       f"with {len(unassigned)} unassigned")
                done = led.completions()
                if all_rids <= (set(done) | failed):
                    break
                leases = led.assignments()
                open_leases = {rid: l for rid, l in leases.items()
                               if rid not in done and rid not in failed
                               and rid not in unassigned}
                if open_leases:
                    rounds += 1
                    self._fire_chaos(rounds, procs)
                self._check_liveness(procs, spawn_t, open_leases, attempts, not_before,
                                     unassigned, failed, now)
                if not procs:
                    # every worker died with work outstanding: respawn
                    # replica 0, which serves the ledger's frontier
                    procs[0] = self.spawn(0)
                    spawn_t[0] = time.time()
                    self.respawns += 1
                    self._event("replica_respawn", replica=0)
                loads = {i: 0 for i in procs}
                for lease in open_leases.values():
                    if lease["replica"] in loads:
                        loads[lease["replica"]] += 1
                for rid in sorted(unassigned):
                    if not_before.get(rid, 0.0) > now:
                        continue
                    target = min(procs, key=lambda i: (loads[i], i))
                    att = attempts.get(rid, 0) + 1
                    attempts[rid] = att
                    led.assign(rid, target, att, now)
                    loads[target] += 1
                    unassigned.discard(rid)
                time.sleep(self.poll_s)
            wall = time.time() - t0
        finally:
            led.request_stop()
            exit_codes = self._reap(procs)
            chaos_lib.install(prev_chaos)
            retry_lib.set_observer(None)
        return self._summary(replayed, failed, wall, exit_codes, rlog, attempts)

    def _fire_chaos(self, rounds: int, procs: dict) -> None:
        ch = self.chaos
        if ch is None:
            return
        # here replica_kill means replica_sigkill: a worker's death IS its
        # process dying
        for target in ch.sigkills.pop(rounds, []) + ch.kills.pop(rounds, []):
            idx = self._pick_target(target, procs)
            if idx is None:
                self._event("kill_skipped", round=rounds, reason="last live replica")
                continue
            os.kill(procs[idx].pid, signal.SIGKILL)
            self.kills += 1
            ch.record(dict(fault="replica_sigkill", round=rounds, replica=idx,
                           pid=procs[idx].pid))
            self._event("replica_sigkill", replica=idx, round=rounds, pid=procs[idx].pid)
        for stall_s in ch.stalls.pop(rounds, []):
            idx = sorted(procs)[-1]
            self.ledger.set_stall(idx, stall_s, token=rounds)
            ch.record(dict(fault="slow_replica", round=rounds, replica=idx, stall_s=stall_s))
            self._event("replica_slow", replica=idx, round=rounds, stall_s=stall_s)

    def _check_liveness(self, procs, spawn_t, open_leases, attempts, not_before, unassigned,
                        failed, now) -> None:
        beats = self.ledger.heartbeats()
        wall = time.time()
        for idx in sorted(procs):
            code = procs[idx].poll()
            reason = None
            if code is not None:
                reason = dict(reason="exit", code=code)
            elif self.replica_timeout > 0:
                rec = beats.get(idx)
                age = wall - (rec["t"] if rec else spawn_t[idx])
                if age > self.replica_timeout:
                    reason = dict(reason="heartbeat_timeout", age_s=round(age, 3))
            if reason is None:
                continue
            proc = procs.pop(idx)
            if code is None:
                # heartbeat-dead but alive: fence it, so it never races a
                # survivor for its revoked leases
                try:
                    proc.kill()
                except OSError:
                    pass
            self.replicas_dead += 1
            self._deaths.append(dict(replica=idx, **reason))
            victims = sorted(rid for rid, l in open_leases.items() if l["replica"] == idx)
            self.leases_revoked += len(victims)
            requeue_rids = []
            for rid in victims:
                open_leases.pop(rid, None)
                n = attempts.get(rid, 1)
                if n > self.request_retries:
                    failed.add(rid)
                    self.ledger.record_failure(rid, "retry_budget", n)
                    self._event("request_failed", rid=rid, attempts=n, reason="retry_budget")
                else:
                    not_before[rid] = now + retry_lib.backoff_delay(n)
                    unassigned.add(rid)
                    requeue_rids.append(rid)
            self.requeued += len(requeue_rids)
            self._event("replica_dead", replica=idx, **reason, requeued=len(requeue_rids),
                        requeued_rids=requeue_rids)
            if self.logger is not None and requeue_rids:
                self.logger.log(kind="lease_requeue", from_replica=idx, rids=requeue_rids,
                                attempts={str(r): attempts.get(r, 1) for r in requeue_rids})

    def _reap(self, procs: dict) -> dict[int, int | None]:
        codes: dict[int, int | None] = {}
        deadline = time.time() + self.grace_s
        for idx, p in sorted(procs.items()):
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            codes[idx] = p.poll()
        return codes

    def _summary(self, replayed, failed, wall, exit_codes, rlog, attempts) -> dict:
        done = self.ledger.completions()
        e2e = sorted(float(r.get("e2e_s", 0.0)) for r in done.values())
        gen = sum(int(r["generated"]) for r in done.values())
        pct = lambda q: (  # noqa: E731
            e2e[min(int(q / 100 * len(e2e)), len(e2e) - 1)] if e2e else None)
        rec = dict(
            kind="fleet_summary", mode="procs", requests=len(done), generated_tokens=gen,
            wall_s=wall, tokens_per_sec=(gen / wall) if wall else None,
            replicas_final=self.replicas - self.replicas_dead + self.respawns,
            replicas_peak=self.replicas, scale_ups=0, scale_downs=0,
            kills=self.kills, requeued=self.requeued,
            duplicate_completions=self.ledger.duplicates(),
            p50_e2e_s=pct(50), p99_e2e_s=pct(99), per_replica={}, occupancy_spread=0.0,
            params_placements=self.replicas, replicas_dead=self.replicas_dead,
            leases_revoked=self.leases_revoked,
            deadline_misses=sum(1 for r in done.values() if r["reason"] == "deadline"),
            request_failures=len(failed), rejected=0, respawns=self.respawns,
            deaths=self._deaths,
            worker_exit_codes={str(k): v for k, v in exit_codes.items()},
            retry_total=rlog.total,
            ledger=dict(completed=len(done), replayed=len(replayed),
                        duplicates=self.ledger.duplicates(),
                        max_attempts=max(attempts.values()) if attempts else 0),
        )
        if self.chaos is not None:
            for ev in self.chaos.drain_fired():
                if self.logger is not None:
                    self.logger.log(kind="chaos", **ev)
        if self.logger is not None:
            self.logger.log(**rec)
        if self.recorder is not None:
            self.recorder.record("fleet_summary", requests=rec["requests"],
                                 tokens_per_sec=rec["tokens_per_sec"],
                                 requeued=rec["requeued"], kills=rec["kills"])
        return rec
