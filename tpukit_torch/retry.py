"""Jittered exponential retry for transient host I/O (a copy of
`tpukit/retry.py`).

  - `retry_io(fn, *args, label=...)` runs one I/O operation; on a retryable
    exception it sleeps a jittered exponential backoff and tries again, up
    to the policy's budget, then re-raises the last error.
  - Retryable means `OSError` (`IOError` and `TimeoutError` are
    subclasses). Anything else, a CUDA error or a kernel build failure
    among them, is never retried: retrying a bug repeats it slower.
  - Every failed attempt goes to the observer `fit` installs (a
    `RetryLog`), so the run can say how many transient errors it absorbed.

Wired sites: the checkpoint writers and readers of every format (the sync
writers and `AsyncCheckpointer`'s background half), the `DataLoader`
batch fetch, and the serving fleet's ledger records, heartbeats and
metric snapshots (`serve/ledger.py`, `serve/fleet.py`). `backoff_delay`
spaces the fleet's re-admissions of a dead replica's requests. The chaos harness (`tpukit_torch/chaos.py`) injects
`IOError`s inside exactly these sites. `retry_io` runs on the training
thread, the async checkpoint writer and the prefetch worker; the observer
hook and the jitter stream are lock-protected.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Any, Callable

RETRYABLE = (OSError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded jittered-exponential backoff. `retries` is the number of
    re-tries after the first attempt (3: up to 4 attempts; 0: one attempt).
    The delay before retry k (1-based) is `min(base_delay * 2**(k-1),
    max_delay)` scaled by a uniform jitter in `[1 - jitter, 1 + jitter]`."""

    retries: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5

    def __post_init__(self):
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry `attempt` (1-based)."""
        base = min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)
        if self.jitter:
            base *= rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)
        return base


_lock = threading.Lock()
_default_policy = RetryPolicy()
_observer: Callable[[dict], None] | None = None
# a jitter stream per process (seeded with the pid), so that the ranks of a
# world do not retry in lockstep
_rng = random.Random(0x7E72 ^ os.getpid())


def set_default_policy(policy: RetryPolicy | None) -> RetryPolicy:
    """Install the process-wide default policy (`fit` sets it from
    `--io_retries`); returns the previous one."""
    global _default_policy
    with _lock:
        prev = _default_policy
        _default_policy = policy if policy is not None else RetryPolicy()
    return prev


def set_observer(fn: Callable[[dict], None] | None) -> None:
    """Install (or clear) the retry-event observer, called with one dict
    per failed attempt: {label, attempt, retries, delay_s, error}."""
    global _observer
    with _lock:
        _observer = fn


def backoff_delay(attempt: int, policy: RetryPolicy | None = None) -> float:
    """One jittered-exponential delay for retry `attempt` (1-based), from
    the process's jitter stream under `policy` (default: the process-wide
    one). The fleet router spaces the re-admissions of a dead replica's
    requests with it: they retry a dispatch, not an I/O call, so they
    cannot ride `retry_io`, and the survivors must not take them all in
    one round."""
    with _lock:
        pol = policy if policy is not None else _default_policy
        return pol.delay(attempt, _rng)


def retry_io(fn: Callable[..., Any], *args, label: str = "io",
             policy: RetryPolicy | None = None, retryable: tuple = RETRYABLE,
             sleep: Callable[[float], None] = time.sleep, **kwargs):
    """Run `fn(*args, **kwargs)`, retrying transient failures per `policy`
    (default: the process-wide one). Re-raises the last error once the
    budget is spent."""
    with _lock:
        pol = policy if policy is not None else _default_policy
        obs = _observer
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retryable as exc:
            attempt += 1
            if attempt > pol.retries:
                raise
            with _lock:
                delay = pol.delay(attempt, _rng)
            if obs is not None:
                try:
                    obs({"label": label, "attempt": attempt, "retries": pol.retries,
                         "delay_s": round(delay, 4), "error": f"{type(exc).__name__}: {exc}"})
                except Exception:
                    pass  # observing must never break the I/O path
            if delay > 0:
                sleep(delay)


class RetryLog:
    """Thread-safe collector of retry events, the observer `fit` installs;
    `total` survives `drain`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.total = 0

    def __call__(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
            self.total += 1

    def drain(self) -> list[dict]:
        with self._lock:
            out, self._events = self._events, []
        return out
