"""Hang watchdog, diagnostics bundles and trace-on-anomaly (twin of
`tpukit/obs/watchdog.py`).

  - `HangWatchdog`: a daemon monitor thread armed and disarmed around each
    iteration of the training loop. When an armed iteration overruns its
    deadline (`--hang_timeout`), or when a sentinel asks for it
    (`trigger()`: a loss spike, NaN, a straggler, a divergence), it dumps a
    **diagnostics bundle**: one JSON file with every Python thread's stack
    (the training thread's frame shows which call is blocked), the flight
    recorder's ring (`obs/recorder.py`), the card's memory gauges
    (`obs/memory.py`), the heartbeat snapshot across ranks, the in-flight
    async-checkpoint and prefetcher state, and the run's flags. The dump is
    host work only: a stack walk, the allocator's host-side counters and
    the driver's device name, then a file write. Nothing in it waits on the
    device's queue (no synchronize, no `.item()`), so it succeeds while a
    stream is wedged, which is the point.
  - `AnomalyTracer`: the first anomaly of a run arms a `torch.profiler`
    capture of the next K steps (CPU and, on a CUDA device, CUDA activity;
    a Chrome trace in the directory), so the trace exists for the steps
    that matter. It arms once a run.

Bundle writes are atomic (`checkpoint.atomic_write_text`) and the dump
count is bounded (`max_dumps`). `python tools/flightview.py <bundle.json>`
renders a bundle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

from tpukit_torch import mesh as mesh_lib
from tpukit_torch.checkpoint import atomic_write_text
from tpukit_torch.obs.memory import live_memory_stats
from tpukit_torch.obs.meter import device_kind, export_trace, profiler_activities


def all_thread_stacks() -> dict[str, list[str]]:
    """The formatted stack of every live Python thread, keyed by
    `"{thread name}-{ident}"`. A thread blocked in C (a wedged collective,
    a queue get) shows its last Python line, which is the diagnosis."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        out[label] = [line.rstrip("\n") for line in traceback.format_stack(frame)]
    return out


def _jsonable(obj):
    """A value as JSON takes it, or its repr: a bundle written during a
    failure must not fail on an exotic value."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)


def write_bundle(directory: str | os.PathLike, reason: str, step: int | None = None,
                 recorder=None, heartbeat=None,
                 probes: dict[str, Callable[[], Any]] | None = None, config=None,
                 extra: dict | None = None, device=None) -> Path:
    """Assemble and atomically write one diagnostics bundle; returns its
    path. Every section is best-effort: a probe that raises lands as its
    error string and never stops the dump."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    bundle: dict[str, Any] = {"reason": reason, "step": step, "time": time.time(),
                              "stacks": all_thread_stacks()}
    try:
        bundle["process"] = {"index": mesh_lib.rank(), "count": mesh_lib.world_size(),
                             "device_kind": device_kind(device) or str(device or "cpu"),
                             "torch": torch.__version__}
    except Exception as exc:  # a torn-down group: still dump
        bundle["process"] = {"error": repr(exc)}
    if recorder is not None:
        bundle["ring"] = [{k: _jsonable(v) for k, v in r.items()} for r in recorder.snapshot()]
        bundle["ring_total_recorded"] = recorder.total_recorded
    if heartbeat is not None:
        try:
            bundle["heartbeats"] = {str(k): v for k, v in heartbeat.read_all().items()}
        except Exception as exc:
            bundle["heartbeats"] = {"error": repr(exc)}
    try:
        bundle["memory"] = live_memory_stats(device)
    except Exception as exc:
        bundle["memory"] = {"error": repr(exc)}
    if probes:
        inflight = {}
        for name, fn in probes.items():
            try:
                inflight[name] = _jsonable(fn())
            except Exception as exc:
                inflight[name] = repr(exc)
        bundle["inflight"] = inflight
    if config is not None:
        if dataclasses.is_dataclass(config) and not isinstance(config, type):
            config = dataclasses.asdict(config)
        bundle["config"] = {str(k): _jsonable(v) for k, v in dict(config).items()}
    if extra:
        bundle.update({k: _jsonable(v) for k, v in extra.items()})
    # the rank is part of the name: a world-wide hang has every rank dump
    # the same step in the same millisecond into the same --debug_dir
    proc = bundle.get("process", {}).get("index", 0) or 0
    stamp = f"{int(time.time() * 1000):013d}"
    path = directory / (f"bundle-step{step if step is not None else 0:08d}-{reason}"
                        f"-p{proc:05d}-{stamp}.json")
    atomic_write_text(path, json.dumps(bundle, indent=1, default=repr))
    return path


class HangWatchdog:
    """Deadline monitor around the training loop's iterations.

    `arm(step)` (re)sets a deadline `timeout_s` from now; `disarm()` clears
    it. A daemon thread polls; an armed deadline that passes dumps a
    `reason="hang"` bundle and clears itself (one bundle an overrun; the
    next `arm` starts a fresh deadline). `trigger(reason)` dumps from the
    calling thread (the sentinels' path). Both share the `max_dumps`
    budget. The watchdog records; it kills nothing.
    """

    def __init__(self, debug_dir: str | os.PathLike, timeout_s: float = 0.0, recorder=None,
                 heartbeat=None, probes: dict[str, Callable[[], Any]] | None = None,
                 config=None, max_dumps: int = 8, poll_s: float | None = None, device=None):
        if timeout_s < 0:
            raise ValueError(f"hang timeout must be >= 0, got {timeout_s}")
        self.debug_dir = Path(debug_dir)
        self.timeout_s = timeout_s
        self.recorder = recorder
        self.heartbeat = heartbeat
        self.probes = probes or {}
        self.config = config
        self.device = device
        self.max_dumps = max_dumps
        self.dumps: list[Path] = []
        # one entry per hang overrun, in order, with the bundle it produced
        # (None once the budget is spent)
        self.hang_events: list[dict] = []
        self.hang_count = 0
        self._deadline: float | None = None
        self._armed_step: int | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if timeout_s > 0:
            # poll a fraction of the timeout: a hang is seen within ~1.25x
            self._poll = poll_s if poll_s else max(0.02, min(timeout_s / 4.0, 1.0))
            self._thread = threading.Thread(target=self._monitor, daemon=True,
                                            name="tpukit-watchdog")
            self._thread.start()

    def arm(self, step: int) -> None:
        """Start (or reset) the deadline of the iteration that takes `step`."""
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._armed_step = step

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None
            self._armed_step = None

    def trigger(self, reason: str, step: int | None = None, **extra) -> Path | None:
        """A bundle now (the sentinels' path); None once the budget is spent."""
        return self._dump(reason, step=step, extra=extra)

    def close(self) -> None:
        self.disarm()
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _monitor(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                deadline, step = self._deadline, self._armed_step
            if deadline is None or time.monotonic() < deadline:
                continue
            overdue = time.monotonic() - (deadline - self.timeout_s)
            self.hang_count += 1
            path = self._dump("hang", step=step, extra={"stuck_for_s": round(overdue, 3)})
            self.hang_events.append({"step": step, "bundle": str(path) if path else None})
            with self._lock:  # one bundle an overrun
                if self._deadline == deadline:
                    self._deadline = None

    def _dump(self, reason: str, step: int | None, extra: dict | None) -> Path | None:
        with self._lock:
            if len(self.dumps) >= self.max_dumps:
                return None
        try:
            path = write_bundle(self.debug_dir, reason, step=step, recorder=self.recorder,
                                heartbeat=self.heartbeat, probes=self.probes,
                                config=self.config, extra=extra, device=self.device)
        except Exception as exc:  # the watchdog must never kill the run
            print(f"watchdog: bundle dump failed: {exc!r}", file=sys.stderr)
            return None
        with self._lock:
            self.dumps.append(path)
        print(f"watchdog: {reason} at step {step}; bundle {path}", file=sys.stderr)
        return path


class AnomalyTracer:
    """A `torch.profiler` capture of the next K steps, armed by the first
    anomaly.

    idle -> (trigger) armed -> (maybe_start, training thread) tracing ->
    (step x K) done. `trigger()` after the first call does nothing: one
    trace a run. `maybe_start`, `step` and `stop` run on the training
    thread; `trigger` may run anywhere (it sets a flag). On a CUDA device a
    capture that recorded no CUDA kernel raises at `stop`.
    """

    def __init__(self, trace_dir: str | os.PathLike, steps: int = 8, device="cpu",
                 rank: int = 0):
        if steps < 1:
            raise ValueError(f"trace step count must be >= 1, got {steps}")
        self.trace_dir = str(trace_dir)
        self.steps = steps
        self.device = device
        self.rank = rank
        self.reason: str | None = None
        self.path: Path | None = None
        self._armed = threading.Event()
        self._prof = None
        self._done = False
        self._remaining = 0

    @property
    def done(self) -> bool:
        return self._done

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def trigger(self, reason: str = "anomaly") -> bool:
        """The first call arms the capture; True when this call armed it."""
        if self._done or self.tracing or self._armed.is_set():
            return False
        self.reason = reason
        self._armed.set()
        return True

    def maybe_start(self) -> bool:
        """At the top of each iteration: start the profiler when armed.
        True when the trace started."""
        if not self._armed.is_set() or self.tracing or self._done:
            return False
        self._prof = torch.profiler.profile(activities=profiler_activities(self.device))
        self._prof.start()
        self._remaining = self.steps
        return True

    def step(self) -> bool:
        """Once per completed step while tracing; stops after K. True when
        this call stopped the trace."""
        if not self.tracing:
            return False
        self._remaining -= 1
        if self._remaining > 0:
            return False
        return self.stop()

    def stop(self) -> bool:
        """Stop an active capture and write its trace (`fit` also calls it
        on the way out, so a crashed run keeps its partial trace)."""
        if not self.tracing:
            return False
        prof, self._prof = self._prof, None
        self._done = True
        prof.stop()
        self.path = export_trace(prof, self.trace_dir, self.device,
                                 f"trace-p{self.rank:05d}.json")
        return True
