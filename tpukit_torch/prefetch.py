"""A depth-N background prefetcher of host batches (a copy of
`tpukit/prefetch.py:45-200`).

`HostPrefetcher` runs the host side of the input pipeline on a worker
thread, `depth` batches ahead of the training loop: the loader's fetch,
`prepare_batch`, the strategy's host transform and, on a card, pinning the
batch's host memory. The copy to the device stays on the training thread
(`.to(device, non_blocking=True)` on the training stream), and no
collective ever runs on the worker, so the device sees the same work in
the same order with or without it.

Contract (tests/test_torch_prefetch.py):
  - the items and their order are exactly the wrapped iterable's, through
    the same `process`: the losses are bit-identical to the synchronous
    path (`--prefetch 0`), and the depth only changes timing;
  - an exception in the iterable or in `process` reaches the consumer at
    the `next()` where the failed item would have been, after the good
    items before it;
  - one prefetcher an epoch: it stops after the epoch's last item, and
    `close()` releases the worker mid-epoch.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Iterable

_ITEM, _DONE, _ERROR = "item", "done", "error"


class HostPrefetcher:
    """An iterator pulling (and host-processing) up to `depth` items ahead.
    `skip` drops the first items before `process` runs (the mid-epoch
    resume's fast-forward). `close()` releases the worker (idempotent; also
    called at exhaustion and on error)."""

    def __init__(self, iterable: Iterable, process: Callable[[Any], Any] | None = None,
                 depth: int = 2, name: str = "tpukit-torch-prefetch", skip: int = 0):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if skip < 0:
            raise ValueError(f"prefetch skip must be >= 0, got {skip}")
        self.depth = depth
        self._skip = skip
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._host_lock = threading.Lock()
        self._exhausted = False
        self._producer_done = False
        self._occ_sum = 0
        self._occ_n = 0
        self._thread = threading.Thread(target=self._worker, args=(iter(iterable), process),
                                        daemon=True, name=name)
        self._thread.start()

    def _put(self, item) -> bool:
        """A put that stays responsive to `close()`; False once closed."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it, process):
        end = object()
        try:
            for _ in range(self._skip):
                if self._stop.is_set():
                    return
                if next(it, end) is end:
                    break
            for raw in it:
                if self._stop.is_set():
                    return
                if process is None:
                    item = raw
                else:
                    with self._host_lock:  # paused by quiesce()
                        item = process(raw)
                if not self._put((_ITEM, item)):
                    return
            self._producer_done = True
            self._put((_DONE, None))
        except BaseException as exc:  # noqa: BLE001 — delivered to the consumer
            self._producer_done = True
            self._put((_ERROR, exc))

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        kind, val = self._queue.get()
        if kind is _ITEM:
            q = self._queue.qsize()
            if self._producer_done and q > 0:
                q -= 1  # the terminal sentinel is not a batch
            self._occ_sum += q
            self._occ_n += 1
            return val
        self._exhausted = True
        self.close()
        if kind is _ERROR:
            raise val
        raise StopIteration

    @property
    def buffered(self) -> int:
        """Batches ready in the buffer now (the diagnostics bundle's probe)."""
        return self._queue.qsize()

    @contextlib.contextmanager
    def quiesce(self):
        """Hold the worker between items while the body runs (an item in
        flight completes first); the buffer keeps serving."""
        with self._host_lock:
            yield

    def window_stats(self) -> dict:
        """Mean buffer occupancy since the last call, then reset."""
        out = {"occupancy": self._occ_sum / self._occ_n if self._occ_n else 0.0}
        self._occ_sum = 0
        self._occ_n = 0
        return out

    def close(self):
        """Release the worker: drain the buffer so a worker blocked on a
        full queue sees the stop flag; a closed prefetcher iterates as
        exhausted."""
        self._exhausted = True
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
