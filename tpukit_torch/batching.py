"""Batch preparation: raw tokenized batch -> model inputs + LM targets (a
copy of `tpukit/batching.py:25-49`, numpy in and numpy out).

  - targets are input_ids shifted by one: inputs `[:, :-1]`, targets `[:, 1:]`;
  - target positions equal to the pad id become -100, the ignore index;
  - position_ids are `arange(S-1)` broadcast over the batch;
  - the attention mask is inverted (True = padding) and its last column
    dropped.
"""

from __future__ import annotations

import numpy as np

IGNORE_INDEX = -100


def prepare_batch(batch: dict, pad_id: int) -> tuple[dict, np.ndarray]:
    """`batch` with `input_ids` and `attention_mask`, both `[B, S]` integer
    arrays. Returns `(model_batch, targets)`: `model_batch` has `input_ids`,
    `position_ids` (int32) and `mask` (bool, True = padding), all `[B, S-1]`;
    `targets` is `[B, S-1]` int32 with pad positions set to -100."""
    input_ids = np.asarray(batch["input_ids"])
    attention_mask = np.asarray(batch["attention_mask"])[:, :-1]

    inputs = input_ids[:, :-1].astype(np.int32)
    targets = input_ids[:, 1:].astype(np.int32).copy()
    targets[targets == pad_id] = IGNORE_INDEX

    seq_len = inputs.shape[1]
    position_ids = np.broadcast_to(np.arange(seq_len, dtype=np.int32), inputs.shape)

    model_batch = dict(
        input_ids=inputs,
        position_ids=np.ascontiguousarray(position_ids),
        mask=~attention_mask.astype(bool),
    )
    return model_batch, targets
