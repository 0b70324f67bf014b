"""Flight recorder: a bounded in-memory ring of the trainer's recent history
(a copy of `tpukit/obs/recorder.py`).

The JSONL metrics log answers "how did the run go"; the flight recorder
answers "what was the run doing RIGHT BEFORE it died". It is a fixed-size
ring buffer (collections.deque with maxlen) of small host-side records —
step dispatches, window metrics, sentinel events, checkpoint saves,
divergence checksums — that is ALWAYS on: a record is one dict allocation
plus a deque append under a lock (sub-microsecond next to any real train
step), and memory
is bounded by construction — the ring evicts the oldest record at
capacity, so a month-long run holds exactly `capacity` records.

Nothing reads the ring on the happy path. Its one consumer is the
diagnostics bundle (`obs/watchdog.py`): when the hang watchdog or a
sentinel fires, `snapshot()` serializes the last-N history into the bundle
so the post-mortem shows what the trainer was doing when it stopped.

Thread-safety: `record()` runs on the training thread in the hot loop;
`snapshot()` runs on the watchdog's monitor thread at dump time. A plain
lock covers both — deque.append is itself atomic, but iterating a deque
while another thread appends raises RuntimeError, and a torn snapshot in
the one artifact written specifically for post-mortems is not acceptable.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class FlightRecorder:
    """Bounded ring of `{"t", "kind", ...}` records, oldest evicted first."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"recorder capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0  # lifetime count, so a bundle shows how much history
        # the ring evicted ("records 3017..3272 of 3272")

    def record(self, kind: str, **fields) -> None:
        """Append one record. Values must be JSON-serializable (the bundle
        writer stringifies anything that is not, but keep it plain)."""
        rec = {"t": time.time(), "kind": kind, **fields}
        with self._lock:
            self._ring.append(rec)
            self._total += 1

    def snapshot(self) -> list[dict]:
        """Consistent copy of the ring, oldest first. Safe to call from any
        thread while the training thread keeps recording."""
        with self._lock:
            return list(self._ring)

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
