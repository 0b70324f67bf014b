"""Training-health sentinels (twin of `tpukit/obs/sentinels.py`): the global
norms of `--log_grad_norms` on the device, and a copy of `SpikeSentinel`
and `SpikeEvent` (:54-112) on the host.

`global_norms(grads, updates, params, strategy)` returns the global L2
norms as f32 device scalars, read at the window's one sync as tpukit reads
its in-jit norms. Under FSDP, TP, EP and the pipeline they are the norms of
the logical arrays: each rank sums the squares of the pieces it counts
(`shardings.distinct_piece`: every element once, a DTensor's replicated
placements once, a pipeline's stages over the stage ranks), one all-reduce
adds them, and the leaves every rank holds whole are summed locally. The
port's AdamW updates in place, so `updates` is the parameters' change over
the step, taken from a copy made before it (only while the flag is on).

`SpikeSentinel` watches the window-averaged loss `fit` already reads once a
window: it fires on NaN/Inf at once, and on a loss above the running mean
by `threshold * max(std, rel_floor * |mean|)` once enough history exists.
What it does then is `fit`'s (`--spike_action warn|abort`, or a rollback
under `--on_anomaly rollback`).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import torch
import torch.distributed as dist

from tpukit_torch.shardings import distinct_piece, leaves, paths


def comm_device(default: torch.device) -> torch.device:
    """Where a tensor must sit for a collective of the default group: the
    current CUDA device under NCCL, `default` otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return default


def world_collective() -> bool:
    """Whether a reduction over the ranks needs a collective."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _square_sums(tree: dict, strategy, device) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(this rank's sum of squares over the leaves held whole, over the
    pieces it counts of split leaves, whether any leaf is split)."""
    whole = torch.zeros((), dtype=torch.float32, device=device)
    split = torch.zeros((), dtype=torch.float32, device=device)
    any_split = False
    for n, t in zip(paths(tree), leaves(tree)):
        sharded, piece = distinct_piece(strategy, n, t)
        any_split |= sharded
        if piece is None:
            continue
        sq = piece.detach().to(torch.float32).square().sum().to(device)
        if sharded:
            split = split + sq
        else:
            whole = whole + sq
    return whole, split, any_split


def global_norms(grads: dict, updates: dict | None = None, params: dict | None = None,
                 strategy=None) -> dict:
    """`{grad_norm[, update_norm][, param_norm]}` as f32 device scalars.
    Every rank calls it (a collective where a leaf is split)."""
    names = ["grad_norm"] + (["update_norm"] if updates is not None else []) + (
        ["param_norm"] if params is not None else [])
    trees = [grads] + [t for t in (updates, params) if t is not None]
    device = comm_device(leaves(grads)[0].device)
    sums = [_square_sums(tree, strategy, device) for tree in trees]
    whole = torch.stack([w for w, _, _ in sums])
    split = torch.stack([s for _, s, _ in sums])
    if any(a for _, _, a in sums) and world_collective():
        dist.all_reduce(split)
    return dict(zip(names, torch.sqrt(whole + split).unbind()))


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
