"""The recovery engine: the exit-code contract, preemption and in-process
rollback (a twin of `tpukit/recovery.py`).

**Exit codes.** A recipe's process exits

    0   (EXIT_CLEAN)               the schedule completed, the final
                                   checkpoint is durable
    75  (EXIT_PREEMPTED)           SIGTERM/SIGINT: a checkpoint was written,
                                   `--resume latest` continues bit-exact
    76  (EXIT_ANOMALY_ABORT)       sentinel abort (--spike_action abort): the
                                   blown-up state is checkpointed
    77  (EXIT_ROLLBACK_EXHAUSTED)  --on_anomaly rollback ran out of budget, or
                                   found no checkpoint to restore

**Preemption** (`PreemptionGuard`): the signal handler only sets a flag;
`fit` polls it at iteration boundaries and writes a durable checkpoint with
resume metadata (epoch, batches consumed), then raises `Preempted`.

**Rollback** (`RecoveryEngine`): when the loss sentinel fires, `fit`
restores, in place, the newest integrity-verified checkpoint strictly older
than the anomaly's window, and goes on with the input stream moving
forward; the checkpoints of the abandoned timeline are renamed aside
(quarantined). `--max_rollbacks` bounds it; past it the run aborts (77).

**Collective decisions.** A world of several ranks must roll back to the
same step and save a preemption checkpoint at the same step. Every rank
sees the same window loss, so each plans the same rollback; rank 0 also
publishes it as `rollback-<seq>.json` in the heartbeat directory and the
others confirm theirs against it. A preemption signal becomes
`preempt-request-p<rank>.json`; rank 0 turns the first request into
`preempt-decision.json`, naming a window boundary at least one full window
ahead, where every rank saves and exits. The files are tpukit's, so either
package reads the other's. The port runs one process per card, so a
"process" is a c10d rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable

from tpukit_torch import checkpoint as ckpt_lib

EXIT_CLEAN = 0
EXIT_PREEMPTED = 75  # EX_TEMPFAIL: checkpointed, relaunch with --resume latest
EXIT_ANOMALY_ABORT = 76
EXIT_ROLLBACK_EXHAUSTED = 77


def _atomic_write_json(path: Path, obj: dict) -> None:
    ckpt_lib.atomic_write_text(path, json.dumps(obj))


def publish_heartbeat(directory: str | Path, name: str, record: dict) -> None:
    """Atomically publish one heartbeat record as `<directory>/<name>.json`
    (tpukit `recovery.py:113`), the file a liveness reader polls. The
    caller stamps its own clock into the record (`t`)."""
    path = Path(directory) / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    _atomic_write_json(path, record)


def read_heartbeat_dir(directory: str | Path, prefix: str = "") -> dict[str, dict]:
    """Every heartbeat record in `directory` whose name starts with
    `prefix`, as {stem: record}; unparseable or vanished files are
    skipped (tpukit `recovery.py:121`)."""
    out: dict[str, dict] = {}
    d = Path(directory)
    if not d.is_dir():
        return out
    for path in sorted(d.glob(f"{prefix}*.json")):
        try:
            rec = json.loads(path.read_text())
        except (ValueError, OSError):
            continue
        if isinstance(rec, dict):
            out[path.stem] = rec
    return out


class TrainingAborted(RuntimeError):
    """Base of every deliberate abnormal end of training; `exit_code` is
    the status the recipe's process exits with."""

    exit_code = 1


class AnomalyAbort(TrainingAborted):
    """Sentinel abort (--spike_action abort): the state was checkpointed."""

    exit_code = EXIT_ANOMALY_ABORT


class RollbackBudgetExhausted(AnomalyAbort):
    """--on_anomaly rollback escalated: the budget is spent, or no
    integrity-verified checkpoint exists to restore."""

    exit_code = EXIT_ROLLBACK_EXHAUSTED


class Preempted(TrainingAborted):
    """SIGTERM/SIGINT handled: a checkpoint was written; `--resume latest`
    continues the run."""

    exit_code = EXIT_PREEMPTED

    def __init__(self, message: str, checkpoint: Any = None, step: int = 0):
        super().__init__(message)
        self.checkpoint = checkpoint
        self.step = step


def run_recipe(main_fn: Callable, argv=None) -> int:
    """A recipe's `__main__`: `sys.exit(run_recipe(main))`. Maps the
    exceptions above to their exit codes; anything else propagates with
    its traceback."""
    try:
        main_fn(argv)
        return EXIT_CLEAN
    except TrainingAborted as exc:
        print(f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return exc.exit_code


class PreemptionGuard:
    """SIGTERM/SIGINT set a flag that the training loop polls (`pending`).
    A context manager: the previous handlers come back on exit. Off the
    main thread it is an inert flag. A second signal while the graceful
    exit runs restores the previous handler and re-raises the signal."""

    SIGNALS = ("SIGTERM", "SIGINT")

    def __init__(self):
        self._pending: str | None = None
        self._prev: dict[int, Any] = {}
        self._installed = False

    @property
    def pending(self) -> str | None:
        return self._pending

    def _handler(self, signum, frame):
        name = signal.Signals(signum).name
        if self._pending is not None:
            self._restore()
            signal.raise_signal(signum)
            return
        self._pending = name

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for name in self.SIGNALS:
                sig = getattr(signal, name)
                self._prev[sig] = signal.signal(sig, self._handler)
            self._installed = True
        return self

    def _restore(self):
        if self._installed:
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._installed = False

    def __exit__(self, *exc):
        self._restore()
        return False


@dataclasses.dataclass
class RollbackPlan:
    seq: int  # 1-based rollback counter within the run
    reason: str
    anomaly_step: int  # the step at detection (the window boundary)
    target_step: int  # the restored checkpoint's step
    target_path: str
    steps_lost: int  # anomaly_step - target_step

    def record(self) -> dict:
        return dataclasses.asdict(self)


class RollbackCoordinator:
    """Decision files in the shared heartbeat directory: rank 0 writes
    `rollback-<seq>.json`, every rank acks with
    `rollback-<seq>-ack-p<rank>.json`. A world of one never touches the
    filesystem. Rank 0 clears the previous incarnation's files at
    construction (a relaunch restarts `seq` at 1). The deferred rollback
    that a divergence drives (only rank 0 sees it) publishes its decision
    with `execute_after`, one window ahead, or a collective abort
    (`publish_abort`); the final-drain marker closes the decision channel
    at the end of training (tpukit `recovery.py:310-400`)."""

    def __init__(self, directory: str | os.PathLike | None, process_index: int = 0,
                 process_count: int = 1, timeout_s: float = 120.0):
        self.directory = Path(directory) if directory else None
        self.process_index = process_index
        self.process_count = process_count
        self.timeout_s = timeout_s
        if self.directory is not None and process_count > 1:
            self.directory.mkdir(parents=True, exist_ok=True)
            if self.process_index == 0:
                for stale in self.directory.glob("rollback-*.json"):
                    stale.unlink(missing_ok=True)

    def _path(self, seq: int) -> Path:
        return self.directory / f"rollback-{seq:04d}.json"

    def publish(self, plan: RollbackPlan, execute_after: int | None = None) -> None:
        """Rank 0 publishes the decision."""
        if self.directory is None or self.process_count == 1:
            return
        rec = plan.record()
        if execute_after is not None:
            rec["execute_after"] = execute_after
        _atomic_write_json(self._path(plan.seq), rec)

    def publish_abort(self, seq: int, reason: str, anomaly_step: int,
                      execute_after: int) -> None:
        """Rank 0 publishes a collective abort (the budget is spent, or
        nothing restorable, on an anomaly only it sees): every rank reaches
        the abort path at the same boundary, so the autopsy checkpoint's
        collective completes on all of them."""
        if self.directory is None or self.process_count == 1:
            return
        _atomic_write_json(self._path(seq), {
            "seq": seq, "action": "abort", "reason": reason,
            "anomaly_step": anomaly_step, "execute_after": execute_after})

    def read(self, seq: int) -> dict | None:
        if self.directory is None:
            return None
        try:
            return json.loads(self._path(seq).read_text())
        except (OSError, ValueError):
            return None

    def confirm(self, plan: RollbackPlan) -> None:
        """Ranks other than 0: wait (bounded) for rank 0's decision and
        check that the local plan matches it. Raises on timeout or
        mismatch."""
        if self.directory is None or self.process_count == 1 or self.process_index == 0:
            return
        deadline = time.monotonic() + self.timeout_s
        while True:
            rec = self.read(plan.seq)
            if rec is not None:
                if int(rec["target_step"]) != plan.target_step:
                    raise TrainingAborted(
                        f"rollback {plan.seq}: process {self.process_index} "
                        f"planned target step {plan.target_step} but process "
                        f"0 decided {rec['target_step']} — refusing a "
                        f"split-brain rollback")
                return
            if time.monotonic() > deadline:
                raise TrainingAborted(
                    f"rollback {plan.seq}: timed out after {self.timeout_s}s "
                    f"waiting for process 0's decision file in {self.directory}")
            time.sleep(0.05)

    def ack(self, seq: int, step: int) -> None:
        if self.directory is None or self.process_count == 1:
            return
        _atomic_write_json(
            self.directory / f"rollback-{seq:04d}-ack-p{self.process_index:05d}.json",
            {"process": self.process_index, "step": step})

    # the final-drain rendezvous: rank 0 writes the marker only after
    # everything it will ever publish is on disk, and the other ranks do not
    # trust a missing decision before the marker exists (rank 0 may still
    # be detecting a divergence in its last boundary block). It lives in
    # the rollback-*.json namespace, so construction clears a previous
    # incarnation's marker.

    @property
    def _final_drain_path(self) -> Path:
        return self.directory / "rollback-final-drain.json"

    def publish_final_drain(self, step: int) -> None:
        """Rank 0, entering the final drain: the decision channel is
        complete."""
        if self.directory is None or self.process_count == 1 or self.process_index != 0:
            return
        _atomic_write_json(self._final_drain_path, {"step": int(step)})

    def wait_final_drain(self) -> None:
        """Other ranks, entering the final drain: a bounded wait for rank
        0's marker. Raises on timeout (rank 0 died mid-window; going on
        could evaluate and save a diverged state)."""
        if self.directory is None or self.process_count == 1 or self.process_index == 0:
            return
        deadline = time.monotonic() + self.timeout_s
        while not self._final_drain_path.exists():
            if time.monotonic() > deadline:
                raise TrainingAborted(
                    f"final rollback drain: timed out after {self.timeout_s}s waiting for "
                    f"process 0's final-drain marker in {self.directory}")
            time.sleep(0.05)


class PreemptCoordinator:
    """Decision files that make a preemption checkpoint collective: a rank
    whose signal lands publishes `preempt-request-p<rank>.json`; rank 0, at
    a window boundary, turns the first request into
    `preempt-decision.json` naming a boundary at least one full window
    ahead, which every rank's step counter passes exactly once. Records
    carry `run_start` (the incarnation's first step), so a previous
    incarnation's leftovers never match."""

    def __init__(self, directory: str | os.PathLike | None, process_index: int = 0,
                 process_count: int = 1):
        self.directory = Path(directory) if directory else None
        self.process_index = process_index
        self.process_count = process_count
        self._requested = False
        self.run_start = 0
        if self.directory is not None and process_count > 1:
            self.directory.mkdir(parents=True, exist_ok=True)
            (self.directory / f"preempt-request-p{self.process_index:05d}.json").unlink(
                missing_ok=True)
            if self.process_index == 0:
                self._decision_path.unlink(missing_ok=True)

    @property
    def _decision_path(self) -> Path:
        return self.directory / "preempt-decision.json"

    def request(self, signal_name: str) -> None:
        """Publish this rank's pending signal (once)."""
        if self.directory is None or self._requested:
            return
        _atomic_write_json(self.directory / f"preempt-request-p{self.process_index:05d}.json",
                           {"process": self.process_index, "signal": signal_name,
                            "run_start": self.run_start})
        self._requested = True

    def any_request(self) -> str | None:
        """Rank 0: the signal of any request of this incarnation."""
        if self.directory is None:
            return None
        for path in sorted(self.directory.glob("preempt-request-p*.json")):
            try:
                rec = json.loads(path.read_text())
                if rec.get("run_start") != self.run_start:
                    continue
                return rec["signal"]
            except (OSError, ValueError, KeyError):
                continue
        return None

    def publish(self, signal_name: str, execute_after: int) -> dict:
        """Rank 0 publishes the decision (the first one wins)."""
        existing = self.read()
        if existing is not None:
            return existing
        rec = {"signal": signal_name, "execute_after": int(execute_after),
               "run_start": self.run_start}
        _atomic_write_json(self._decision_path, rec)
        return rec

    def read(self) -> dict | None:
        if self.directory is None:
            return None
        try:
            rec = json.loads(self._decision_path.read_text())
        except (OSError, ValueError):
            return None
        if rec.get("run_start") != self.run_start:
            return None
        return rec


class RecoveryEngine:
    """Budgeted in-process rollback over the run's checkpoint directory.
    `plan(reason, anomaly_step, window)` picks the newest integrity-verified
    checkpoint with step <= anomaly_step - window and charges nothing until
    `committed`; None means escalate. `quarantine(plan)` renames the newer
    checkpoints (and their sidecars) aside as `<name>.quarantined-<seq>`."""

    def __init__(self, directory: str | os.PathLike = "checkpoints", max_rollbacks: int = 3,
                 coordinator: RollbackCoordinator | None = None):
        if max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, got {max_rollbacks}")
        self.directory = Path(directory)
        self.max_rollbacks = max_rollbacks
        self.coordinator = coordinator or RollbackCoordinator(None)
        self.count = 0
        self.steps_lost = 0
        self.exhausted = False
        self.history: list[RollbackPlan] = []

    def plan(self, reason: str, anomaly_step: int, window: int = 0) -> RollbackPlan | None:
        if self.count >= self.max_rollbacks:
            self.exhausted = True
            return None
        target = ckpt_lib.latest_good(self.directory, max_step=anomaly_step - window)
        if target is None:
            self.exhausted = True
            return None
        step = ckpt_lib._step_of(target)
        return RollbackPlan(seq=self.count + 1, reason=reason, anomaly_step=anomaly_step,
                            target_step=step, target_path=str(target),
                            steps_lost=anomaly_step - step)

    def committed(self, plan: RollbackPlan) -> None:
        self.count = plan.seq
        self.steps_lost += plan.steps_lost
        self.history.append(plan)

    def quarantine(self, plan: RollbackPlan, process_zero: bool = True) -> list[str]:
        """Rank 0 renames every checkpoint newer than the target aside;
        returns the new names."""
        if not process_zero:
            return []
        out = []
        tag = f".quarantined-{plan.seq:04d}"
        for path in ckpt_lib.all_checkpoints(self.directory):
            if ckpt_lib._step_of(path) <= plan.target_step or str(path) == plan.target_path:
                continue
            dest = path.with_name(path.name + tag)
            try:
                os.replace(path, dest)
                for side in ckpt_lib.sidecars(path):
                    if side.exists():
                        os.replace(side, side.with_name(side.name + tag))
            except OSError:
                continue  # a missed rename is not fatal
            out.append(dest.name)
        return out
