"""Host-side batch loading (a copy of `tpukit/loader.py:32-284`).

- `DataLoader`: mini-batch iterator over an `ArrayDataset`, reshuffled each
  epoch with `np.random.RandomState(seed + epoch)` (call `set_epoch`);
  `pad_to_batch` fills the last batch by wrapping ("wrap") or with rows of
  `pad_fill` tokens and a zero mask ("empty", all-ignore rows for eval).
- `distributed_indices`: torch `DistributedSampler`'s index math (pad to an
  even split by wrapping, then rank-strided), for per-rank loading.

Each batch's fetch is one `retry_io` unit with the chaos hook inside it
(`loader_io_fail@K`), as tpukit's (`loader.py:257-273`).
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from tpukit_torch import chaos
from tpukit_torch.data import ArrayDataset
from tpukit_torch.retry import retry_io


def distributed_indices(
    dataset_len: int,
    num_replicas: int,
    rank: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = False,
    with_real: bool = False,
) -> np.ndarray:
    """`DistributedSampler.__iter__`: optionally shuffle with `seed + epoch`,
    pad by wrapping so the list divides evenly (unless drop_last), then take
    rank-strided indices. `with_real=True` also returns a bool mask of the
    entries that are original samples (False = wrap duplicates)."""
    if shuffle:
        g = np.random.RandomState(seed + epoch)
        indices = g.permutation(dataset_len)
    else:
        indices = np.arange(dataset_len)
    real = np.ones(dataset_len, dtype=bool)

    if drop_last and dataset_len % num_replicas != 0:
        num_samples = dataset_len // num_replicas
        total_size = num_samples * num_replicas
        indices = indices[:total_size]
        real = real[:total_size]
    else:
        num_samples = math.ceil(dataset_len / num_replicas)
        total_size = num_samples * num_replicas
        if total_size > dataset_len:
            pad = total_size - dataset_len
            indices = np.concatenate([indices, indices[:pad]])
            real = np.concatenate([real, np.zeros(pad, dtype=bool)])

    sl = slice(rank, total_size, num_replicas)
    if with_real:
        return indices[sl], real[sl]
    return indices[sl]


class DataLoader:
    """Mini-batch iterator over an ArrayDataset, yielding dict batches of
    numpy arrays `{input_ids, attention_mask, real_rows}`. Incomplete final
    batches are yielded unless `drop_last` (or filled, with
    `pad_to_batch`)."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_replicas: int = 1,
        rank: int = 0,
        drop_last: bool = False,
        pad_to_batch: bool = False,
        pad_mode: str = "wrap",
        pad_fill: int = 0,
    ):
        if pad_mode not in ("wrap", "empty"):
            raise ValueError(f"pad_mode must be 'wrap' or 'empty', got {pad_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.drop_last = drop_last
        self.pad_to_batch = pad_to_batch
        self.pad_mode = pad_mode
        self.pad_fill = pad_fill
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _permutation(self) -> np.ndarray:
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(len(self.dataset))
        return np.arange(len(self.dataset))

    def _indices(self) -> tuple[np.ndarray, np.ndarray]:
        """(indices, real): `real[i]` is False for padding entries (wrap
        duplicates or -1 sentinels, which become all-ignore rows)."""
        empty_pad = self.pad_to_batch and self.pad_mode == "empty"
        if self.num_replicas > 1:
            if empty_pad and not self.drop_last:
                base = self._permutation()
                total = math.ceil(len(base) / self.num_replicas) * self.num_replicas
                base = np.concatenate([base, np.full(total - len(base), -1, base.dtype)])
                indices = base[self.rank: total: self.num_replicas]
                real = indices >= 0
            else:
                indices, real = distributed_indices(
                    len(self.dataset), self.num_replicas, self.rank, shuffle=self.shuffle,
                    seed=self.seed, epoch=self.epoch, drop_last=self.drop_last,
                    with_real=True,
                )
        else:
            indices = self._permutation()
            real = np.ones(len(indices), dtype=bool)
        if self.pad_to_batch and len(indices) % self.batch_size:
            pad = self.batch_size - len(indices) % self.batch_size
            if self.pad_mode == "wrap":
                indices = np.concatenate([indices, np.resize(indices, pad)])
            else:
                indices = np.concatenate([indices, np.full(pad, -1, indices.dtype)])
            real = np.concatenate([real, np.zeros(pad, dtype=bool)])
        return indices, real

    def __len__(self) -> int:
        n = len(self._indices()[0])
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def global_real_row_counts(self) -> np.ndarray:
        """Each batch's dataset rows summed over the replicas (tpukit
        `loader.py:180`'s closed form): padding positions depend only on the
        dataset's length, the replicas and the batch size, never on the
        shuffle, so the meter counts a step's global tokens exactly with no
        collective. Row j of a rank's split holds an original row iff
        `j * R + rank < N`; summed over the ranks that is `clip(N - j R, 0,
        R)`, and the batch-padding tail holds none."""
        n, reps = len(self.dataset), self.num_replicas
        samples = n // reps if self.drop_last and n % reps else math.ceil(n / reps)
        per_rank = samples
        if self.pad_to_batch and per_rank % self.batch_size:
            per_rank += self.batch_size - per_rank % self.batch_size
        stop = (per_rank // self.batch_size) * self.batch_size if self.drop_last else per_rank
        if stop == 0:
            return np.zeros(0, dtype=np.int64)
        j = np.arange(stop, dtype=np.int64)
        real = np.clip(n - j * reps, 0, reps)
        real[j >= samples] = 0
        return np.add.reduceat(real, np.arange(0, stop, self.batch_size))

    def _fetch_rows(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One batch's fetch, the retried unit (the chaos hook inside)."""
        chaos.maybe_io_fault("loader_fetch")
        safe = np.maximum(idx, 0)
        return self.dataset.input_ids[safe], self.dataset.attention_mask[safe]

    def __iter__(self) -> Iterator[dict]:
        indices, real = self._indices()
        n = len(indices)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = indices[start: start + self.batch_size]
            ids, mask = retry_io(self._fetch_rows, idx, label="loader_fetch")
            pad_rows = idx < 0
            if pad_rows.any():
                ids = np.where(pad_rows[:, None], self.pad_fill, ids)
                mask = np.where(pad_rows[:, None], 0, mask)
            yield {
                "input_ids": ids,
                "attention_mask": mask,
                "real_rows": int(real[start: start + self.batch_size].sum()),
            }
