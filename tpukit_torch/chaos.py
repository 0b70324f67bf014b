"""Deterministic fault injection behind `--chaos_spec` and `--fleet_kill`
(a copy of `tpukit/chaos.py`: `parse_spec` :120, `ChaosEngine` :201,
`validate_fleet_spec` :407, `ServingChaos` :427 and the module hooks
:515-535).

    --chaos_spec "nan_loss@120,sigterm@300,ckpt_io_fail@2,hang@450:2.5"

    spec   := entry ("," entry)*
    entry  := kind "@" int (":" float)?

Step kinds (`@N`: fires when training step N completes):
    nan_loss@N        the observed loss becomes NaN (the state is untouched)
    spike_loss@N[:m]  the observed loss times m (default 1e3)
    sigterm@N         SIGTERM raised in this process (the preemption path)
    sigint@N          SIGINT raised in this process
    hang@N[:s]        sleep s seconds (default 1.0)
    bitflip@N[:p]     flip the lowest mantissa bit of the first element of
                      the first parameter (jax's flatten order) on rank p
                      (default: the last rank), in place; on a DTensor,
                      rank p's local shard
    resize@N:M        a preempt-save at step N (SIGTERM) whose resume
                      metadata records the world M the relaunch must have
    skip@N            drop the first N batches of the first trained epoch
                      (the stream position a rollback leaves, for a control
                      run)

Occurrence kinds (`@K`: the K-th operation of that site fails; `:c`: its
first c attempts, default 1, so c <= --io_retries is absorbed by
`retry_io`):
    ckpt_io_fail@K[:c]     checkpoint writes (sync and async writers)
    ckpt_read_fail@K[:c]   checkpoint reads
    loader_io_fail@K[:c]   the DataLoader's batch fetch

Fleet kinds (`--fleet_kill`, `FleetConfig.kill_spec`; `validate_fleet_spec`
takes only these, and the training engine refuses them with tpukit's
message). Round-indexed ones fire at the router's dispatch round (the
process fleet's supervisor poll with leases open):
    replica_kill@R[:idx]     drop replica idx (default: the highest live)
    replica_sigkill@R[:idx]  a real SIGKILL of the worker process under
                             `--fleet_procs`; the in-process router drops
                             the replica and says the kill was simulated
    slow_replica@R:ms        the highest live replica's heartbeat stalls
                             for ms (a straggler, unless the stall outlives
                             `--replica_timeout`)
    stuck_request@RID        request RID is never retired by EOS or length
                             (pair with `--deadline_ms`)
    ledger_io_fail@K[:c]     the K-th ledger I/O operation fails c times
`ServingChaos` is the plan of one serving run; the router and the process
fleet read its round plans and install it for the run, so that the
ledger's file helpers reach `io_fault("ledger")` through `maybe_io_fault`.

The I/O sites call `maybe_io_fault(site)`, one `is None` test when no
engine is installed. All injection is host-side: the training step and the
decode programs are the same code with the flag on or off.
"""

from __future__ import annotations

import re
import signal
import threading
import time

import torch
from torch.distributed.tensor import DTensor

STEP_KINDS = ("nan_loss", "spike_loss", "sigterm", "sigint", "hang", "bitflip", "resize")
IO_KINDS = ("ckpt_io_fail", "ckpt_read_fail", "loader_io_fail")
FLEET_KINDS = ("replica_kill", "replica_sigkill", "slow_replica", "stuck_request",
               "ledger_io_fail")
_REPLICA_TARGET_KINDS = ("replica_kill", "replica_sigkill")
_IO_SITE = {"ckpt_io_fail": "ckpt_write", "ckpt_read_fail": "ckpt_read",
            "loader_io_fail": "loader_fetch"}

_ENTRY_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<at>\d+)(?::(?P<param>[0-9.eE+-]+))?$")


class ChaosSpecError(ValueError):
    pass


def parse_spec(spec: str) -> list[dict]:
    """The `--chaos_spec` grammar as a list of {kind, at, param} dicts.
    Raises `ChaosSpecError` naming the entry: a plan with a typo, or one
    that would crash mid-run or never fire, fails at startup."""
    entries = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        m = _ENTRY_RE.match(raw)
        if not m:
            raise ChaosSpecError(f"chaos spec entry {raw!r} does not match kind@step[:param]")
        kind = m.group("kind")
        known = STEP_KINDS + IO_KINDS + FLEET_KINDS + ("skip",)
        if kind not in known:
            raise ChaosSpecError(f"chaos spec entry {raw!r}: unknown kind {kind!r} "
                                 f"(known: {', '.join(known)})")
        param = m.group("param")
        entry = {"kind": kind, "at": int(m.group("at")),
                 "param": float(param) if param is not None else None}
        p = entry["param"]
        if kind == "hang" and p is not None and p < 0:
            raise ChaosSpecError(f"chaos spec entry {raw!r}: hang duration must be >= 0")
        if kind == "spike_loss" and p is not None and p <= 0:
            raise ChaosSpecError(f"chaos spec entry {raw!r}: spike multiplier must be > 0")
        if kind == "resize" and (p is None or p != int(p) or int(p) < 1):
            raise ChaosSpecError(f"chaos spec entry {raw!r}: resize needs an integer "
                                 f"target world size >= 1 (resize@N:M)")
        if kind in _REPLICA_TARGET_KINDS and p is not None and (p != int(p) or int(p) < 0):
            raise ChaosSpecError(f"chaos spec entry {raw!r}: {kind}'s optional "
                                 f"target must be an integer replica id >= 0")
        if kind == "slow_replica" and (p is None or p <= 0):
            raise ChaosSpecError(f"chaos spec entry {raw!r}: slow_replica needs a stall "
                                 f"duration in ms > 0 (slow_replica@R:ms)")
        if kind == "stuck_request" and p is not None:
            raise ChaosSpecError(f"chaos spec entry {raw!r}: stuck_request takes no param "
                                 f"(stuck_request@RID pins request RID past EOS)")
        if kind in IO_KINDS or kind == "ledger_io_fail":
            if entry["at"] < 1:
                raise ChaosSpecError(f"chaos spec entry {raw!r}: I/O occurrences are 1-based "
                                     f"(@0 would never fire)")
            if p is not None and int(p) < 1:
                raise ChaosSpecError(f"chaos spec entry {raw!r}: failure count must be >= 1 "
                                     f"(0 would never fire)")
        entries.append(entry)
    return entries


class ChaosEngine:
    """One run's fault plan, the same faults at the same steps and
    occurrences on every run. `fit` calls `on_step` after each training
    step; the I/O sites call `io_fault(site)` from inside their retried
    operation. Fired faults collect in `fired`."""

    def __init__(self, spec: str, seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.spec = spec
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self._lock = threading.Lock()
        self.fired: list[dict] = []
        self._step_faults: dict[int, list[dict]] = {}
        self._io_plan: dict[str, dict[int, int]] = {s: {} for s in _IO_SITE.values()}
        self._io_seen: dict[str, int] = {s: 0 for s in _IO_SITE.values()}
        self.skip_batches = 0
        self.resize_target: int | None = None  # set when resize@N:M fires
        for e in parse_spec(spec):
            if e["kind"] in FLEET_KINDS:
                raise ChaosSpecError(
                    f"chaos spec {e['kind']}@{e['at']}: fleet-scoped faults "
                    f"belong to the serving router — pass them via "
                    f"--fleet_kill / FleetConfig.kill_spec, not --chaos_spec")
            if e["kind"] == "bitflip" and e["param"] is not None and not (
                    0 <= int(e["param"]) < process_count):
                raise ChaosSpecError(
                    f"chaos spec bitflip@{e['at']}:{int(e['param'])}: target "
                    f"process out of range for world size {process_count}")
            if e["kind"] == "skip":
                self.skip_batches = max(self.skip_batches, e["at"])
            elif e["kind"] in IO_KINDS:
                count = int(e["param"]) if e["param"] is not None else 1
                self._io_plan[_IO_SITE[e["kind"]]][e["at"]] = count
            else:
                self._step_faults.setdefault(e["at"], []).append(e)

    # -- step faults (training thread) --------------------------------------

    def mutates_state_at(self, step: int) -> bool:
        """True when a fault at `step` writes into the state (bitflip)."""
        return any(f["kind"] == "bitflip" for f in self._step_faults.get(step, ()))

    def on_step(self, step: int, state, loss):
        """Apply the faults scheduled for `step`, once: returns (state,
        loss, fired events); state and loss are unchanged unless a fault
        targets them. A bitflip changes the state's parameter in place."""
        faults = self._step_faults.pop(step, None)
        if not faults:
            return state, loss, []
        events = []
        for f in faults:
            kind, param = f["kind"], f["param"]
            ev = {"fault": kind, "step": step}
            if kind == "nan_loss":
                loss = torch.full_like(loss, float("nan"))
            elif kind == "spike_loss":
                loss = loss * torch.tensor(param or 1e3, dtype=loss.dtype, device=loss.device)
                ev["mult"] = param or 1e3
            elif kind == "sigterm":
                signal.raise_signal(signal.SIGTERM)
            elif kind == "resize":
                self.resize_target = int(param)
                ev["to"] = int(param)
                signal.raise_signal(signal.SIGTERM)
            elif kind == "sigint":
                signal.raise_signal(signal.SIGINT)
            elif kind == "hang":
                dur = param if param is not None else 1.0
                ev["sleep_s"] = dur
                time.sleep(dur)
            elif kind == "bitflip":
                target = int(param) if param is not None else self.process_count - 1
                ev["process"] = target
                if target == self.process_index:
                    flip_bit(getattr(state, "params", state))
                    ev["flipped"] = True
            events.append(ev)
        with self._lock:
            self.fired.extend(events)
        return state, loss, events

    # -- occurrence faults (any thread) -------------------------------------

    def io_fault(self, site: str) -> None:
        """Raise `IOError` when this occurrence (1-based, per site) is
        scheduled to fail. A count of c fails the first c attempts of that
        occurrence: retries re-enter here without advancing it."""
        with self._lock:
            plan = self._io_plan.get(site)
            if plan is None:
                return
            seen = self._io_seen[site] + 1
            remaining = plan.get(seen)
            if remaining is not None and remaining > 0:
                plan[seen] = remaining - 1
                self.fired.append({"fault": f"{site}_io", "occurrence": seen,
                                   "remaining": remaining - 1})
                raise IOError(f"chaos: injected transient {site} failure (occurrence {seen})")
            self._io_seen[site] = seen

    def drain_fired(self) -> list[dict]:
        """Events fired since the last drain."""
        with self._lock:
            out, self.fired = self.fired, []
        return out


def flip_bit(params: dict) -> None:
    """Flip the lowest bit of the first element of the first floating
    parameter, in jax's flatten order (dict keys sorted), in place: the
    minimal divergence. On a DTensor the rank's local shard is flipped."""
    from tpukit_torch.shardings import leaves, paths

    for _, p in sorted(zip(paths(params), leaves(params)), key=lambda kv: kv[0].split("/")):
        t = p.to_local() if isinstance(p, DTensor) else p
        if not t.is_floating_point() or t.numel() == 0:
            continue
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        with torch.no_grad():
            t.detach().view(-1)[:1].view(bits).bitwise_xor_(1)
        return


def validate_fleet_spec(spec: str) -> list[dict]:
    """A `--fleet_kill` plan: `parse_spec`, then any non-fleet kind is
    refused (the mirror of `ChaosEngine` refusing fleet kinds)."""
    entries = parse_spec(spec)
    for e in entries:
        if e["kind"] not in FLEET_KINDS:
            raise ChaosSpecError(
                f"fleet kill spec {e['kind']}@{e['at']}: only fleet-scoped "
                f"faults ({', '.join(FLEET_KINDS)}, e.g. replica_kill@R) "
                f"are legal in FleetConfig.kill_spec / --fleet_kill — "
                f"training faults go via --chaos_spec")
    return entries


class ServingChaos:
    """One serving run's fleet fault plan, the serving twin of
    `ChaosEngine`, read by `serve.fleet.FleetRouter` (in one process) and
    `serve.ledger.ProcessFleet` (worker processes). Round-indexed faults
    fire once, at their round; occurrence-indexed ledger I/O faults fail
    the scheduled attempts of their occurrence and never fire again.
    `kills`/`sigkills` map a round to target replica ids (None: the
    highest live), `stalls` a round to stall seconds, `stuck` holds the
    pinned rids."""

    def __init__(self, spec: str):
        self.spec = spec
        self._lock = threading.Lock()
        self.fired: list[dict] = []
        self.kills: dict[int, list[int | None]] = {}
        self.sigkills: dict[int, list[int | None]] = {}
        self.stalls: dict[int, list[float]] = {}
        self.stuck: set[int] = set()
        self._io_plan: dict[str, dict[int, int]] = {"ledger": {}}
        self._io_seen: dict[str, int] = {"ledger": 0}
        for e in validate_fleet_spec(spec):
            kind, at, param = e["kind"], e["at"], e["param"]
            if kind == "replica_kill":
                self.kills.setdefault(at, []).append(int(param) if param is not None else None)
            elif kind == "replica_sigkill":
                self.sigkills.setdefault(at, []).append(int(param) if param is not None
                                                        else None)
            elif kind == "slow_replica":
                self.stalls.setdefault(at, []).append(float(param) / 1e3)
            elif kind == "stuck_request":
                self.stuck.add(at)
            elif kind == "ledger_io_fail":
                self._io_plan["ledger"][at] = int(param) if param is not None else 1

    def io_fault(self, site: str) -> None:
        """`ChaosEngine.io_fault`'s semantics for the "ledger" site; other
        sites are not this plan's and pass."""
        with self._lock:
            plan = self._io_plan.get(site)
            if plan is None:
                return
            seen = self._io_seen[site] + 1
            remaining = plan.get(seen)
            if remaining is not None and remaining > 0:
                plan[seen] = remaining - 1
                self.fired.append({"fault": f"{site}_io", "occurrence": seen,
                                   "remaining": remaining - 1})
                raise IOError(f"chaos: injected transient {site} failure (occurrence {seen})")
            self._io_seen[site] = seen

    def record(self, event: dict) -> None:
        """A kill or stall the router or supervisor fired joins the same
        trail as the I/O faults."""
        with self._lock:
            self.fired.append(dict(event))

    def drain_fired(self) -> list[dict]:
        with self._lock:
            out, self.fired = self.fired, []
        return out


# The I/O sites (checkpoint.py, loader.py, serve/ledger.py) call
# `maybe_io_fault(site)`; `fit` installs its engine for the run, the fleet
# router and the process fleet their `ServingChaos`, and each restores the
# previous one on exit.
_ENGINE: ChaosEngine | ServingChaos | None = None


def install(engine: ChaosEngine | ServingChaos | None) -> ChaosEngine | ServingChaos | None:
    """Install (or clear, with None) the process-wide engine; returns the
    previous one."""
    global _ENGINE
    prev, _ENGINE = _ENGINE, engine
    return prev


def installed() -> ChaosEngine | ServingChaos | None:
    return _ENGINE


def maybe_io_fault(site: str) -> None:
    eng = _ENGINE
    if eng is not None:
        eng.io_fault(site)
