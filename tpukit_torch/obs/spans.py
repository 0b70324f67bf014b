"""Host-side span timeline: where does the step-loop wall clock go? (A
copy of `tpukit/obs/spans.py`.)

The trainer's hot loop has a handful of host-visible phases per step window
(PRINT_FREQ steps): waiting on the data loader, host-side batch transforms,
the host-to-device copy, enqueueing the step, and the one device-to-host
read that closes the window. `SpanTimeline` accumulates wall clock into
named phases and emits per-window and per-epoch breakdowns whose seconds
sum exactly to the elapsed wall clock (anything not inside a span lands in
"other").

The port's split is tpukit's: PyTorch enqueues CUDA work asynchronously,
so the "step" span (the host's enqueue of forward, backward and AdamW) is
small and the device's compute surfaces as the host blocking in the "sync"
span, the window's one read of the loss. Goodput is step + sync over the
wall: the share of host time spent feeding the device or waiting for it;
everything else (data wait, host-to-device copies, checkpoint I/O, eval)
is time the device may sit idle. On the CPU the step runs synchronously and
lands in "step" instead.

With the input prefetcher on (`--prefetch N`), "data" moves to a worker
thread and the loop's only input cost is the "prefetch_stall" span: the
wait on the buffer and the batch's host-to-device enqueue.
"""

from __future__ import annotations

import contextlib
import time

# Phases whose time counts as "inside the compiled step" for goodput: the
# dispatch call itself plus the device-wait sync at the window boundary.
GOODPUT_SPANS = ("step", "sync")


def _breakdown(acc: dict[str, float], total: float) -> dict:
    """Seconds + fractions for one window/epoch; `other` absorbs wall clock
    outside any span so the seconds always sum to `total`."""
    seconds = dict(acc)
    other = total - sum(seconds.values())
    # float error can push `other` epsilon-negative; clamp for sane output
    seconds["other"] = max(other, 0.0)
    denom = total if total > 0 else 1.0
    fractions = {k: v / denom for k, v in seconds.items()}
    goodput = sum(fractions.get(k, 0.0) for k in GOODPUT_SPANS)
    return {
        "total_s": total,
        "seconds": seconds,
        "fractions": fractions,
        "goodput": goodput,
    }


class SpanTimeline:
    """Accumulate wall clock into named phases; report per window and epoch.

    `span(name)` is a context manager. Nested spans attribute their time to
    the OUTERMOST span only (no double counting), so helpers wrapped in
    their own spans can be called from inside a larger phase safely.
    """

    def __init__(self):
        now = time.perf_counter()
        self._window_start = now
        self._epoch_start = now
        self._window_acc: dict[str, float] = {}
        self._epoch_acc: dict[str, float] = {}
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        if self._depth:
            yield  # nested: time already attributed to the outer span
            return
        self._depth += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._depth -= 1
            self._window_acc[name] = self._window_acc.get(name, 0.0) + dt
            self._epoch_acc[name] = self._epoch_acc.get(name, 0.0) + dt

    def window(self) -> dict:
        """Close the current window: breakdown since the last `window()` (or
        construction/epoch reset), then reset the window accumulators."""
        now = time.perf_counter()
        out = _breakdown(self._window_acc, now - self._window_start)
        self._window_acc = {}
        self._window_start = now
        return out

    def epoch(self) -> dict:
        """Close the current epoch: breakdown since the last `epoch()` call
        (or construction). Also resets the window accumulators so a stale
        partial window does not leak into the next epoch."""
        now = time.perf_counter()
        out = _breakdown(self._epoch_acc, now - self._epoch_start)
        self._epoch_acc = {}
        self._epoch_start = now
        self._window_acc = {}
        self._window_start = now
        return out


def format_breakdown(b: dict) -> str:
    """One-line human rendering: `goodput 83% (step 2% + sync 81%) | data 9% ...`"""
    frac = b["fractions"]
    inside = " + ".join(
        f"{k} {frac.get(k, 0.0) * 100:.0f}%" for k in GOODPUT_SPANS if k in frac
    )
    rest = " | ".join(
        f"{k} {v * 100:.0f}%"
        for k, v in sorted(frac.items(), key=lambda kv: -kv[1])
        if k not in GOODPUT_SPANS and v >= 0.005
    )
    head = f"goodput {b['goodput'] * 100:.0f}%"
    if inside:
        head += f" ({inside})"
    return head + (f" | {rest}" if rest else "")
