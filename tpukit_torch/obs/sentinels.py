"""The host half of tpukit's training-health sentinels (a copy of
`SpikeSentinel` and `SpikeEvent`, `tpukit/obs/sentinels.py:54-112`).

`SpikeSentinel` watches the window-averaged loss `fit` already reads once a
window: it fires on NaN/Inf at once, and on a loss above the running mean
by `threshold * max(std, rel_floor * |mean|)` once enough history exists.
What it does then is `fit`'s (`--spike_action warn|abort`, or a rollback
under `--on_anomaly rollback`). The traced half, `global_norms`
(`--log_grad_norms`), is ROADMAP item 18.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque


@dataclasses.dataclass
class SpikeEvent:
    kind: str  # "nan" | "spike"
    step: int
    loss: float
    mean: float | None = None
    std: float | None = None

    def record(self) -> dict:
        """A JSON-ready dict (a non-finite loss as its string)."""
        loss = self.loss if math.isfinite(self.loss) else str(self.loss)
        return {"event": self.kind, "step": self.step, "loss": loss,
                "mean": self.mean, "std": self.std}


class SpikeSentinel:
    """Rolling-window loss-spike and NaN detector. `observe(loss, step)`
    returns a `SpikeEvent` when it fires, else None. Spiking values stay out
    of the history, so the baseline tracks healthy training."""

    def __init__(self, threshold: float, window: int = 32, min_history: int = 4,
                 rel_floor: float = 0.05):
        if threshold <= 0:
            raise ValueError(f"spike threshold must be > 0, got {threshold}")
        self.threshold = threshold
        self.min_history = min_history
        self.rel_floor = rel_floor
        self._hist: deque[float] = deque(maxlen=window)

    def reset(self) -> None:
        """Drop the history (after a rollback the loss returns to an older
        point of the curve, which the old baseline would flag)."""
        self._hist.clear()

    def observe(self, loss: float, step: int) -> SpikeEvent | None:
        loss = float(loss)
        if not math.isfinite(loss):
            return SpikeEvent(kind="nan", step=step, loss=loss)
        if len(self._hist) >= self.min_history:
            n = len(self._hist)
            mean = sum(self._hist) / n
            var = sum((x - mean) ** 2 for x in self._hist) / n
            band = max(math.sqrt(var), self.rel_floor * abs(mean), 1e-12)
            if loss > mean + self.threshold * band:
                return SpikeEvent(kind="spike", step=step, loss=loss, mean=mean,
                                  std=math.sqrt(var))
        self._hist.append(loss)
        return None
