"""Host-side batch loading (a copy of `tpukit/loader.py:32-284` without the
chaos and retry hooks, which come with ROADMAP item 17).

- `DataLoader`: mini-batch iterator over an `ArrayDataset`, reshuffled each
  epoch with `np.random.RandomState(seed + epoch)` (call `set_epoch`);
  `pad_to_batch` fills the last batch by wrapping ("wrap") or with rows of
  `pad_fill` tokens and a zero mask ("empty", all-ignore rows for eval).
- `distributed_indices`: torch `DistributedSampler`'s index math (pad to an
  even split by wrapping, then rank-strided), for per-rank loading.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from tpukit_torch.data import ArrayDataset


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

    def __iter__(self) -> Iterator[dict]:
        indices, real = self._indices()
        n = len(indices)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = indices[start: start + self.batch_size]
            safe = np.maximum(idx, 0)
            ids = self.dataset.input_ids[safe]
            mask = self.dataset.attention_mask[safe]
            pad_rows = idx < 0
            if pad_rows.any():
                ids = np.where(pad_rows[:, None], self.pad_fill, ids)
                mask = np.where(pad_rows[:, None], 0, mask)
            yield {
                "input_ids": ids,
                "attention_mask": mask,
                "real_rows": int(real[start: start + self.batch_size].sum()),
            }
