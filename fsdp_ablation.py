#!/usr/bin/env python3
"""A one-off ablation of FSDP2's resharding after the forward, kept because
PERF.md's figures for it come from it: `python3 fsdp_ablation.py
[--rounds N]` from the repository root on one CUDA card.

Runs `chip_smoke.train_full_width` (phase 16's steps: the gpt-small-dim768
rung, batch 64, S 512, bf16, 8 steps) under `FSDP` in a world of one over
NCCL, two ways, in turns (root, reshard, reshard, root in every round):

  - `root`: as `tpukit_torch.shardings.FSDP` wraps the tree, FSDP2's
    default for the root group, which keeps the gathered parameters from
    the forward to the backward;
  - `reshard`: `fully_shard(..., reshard_after_forward=True)`, which frees
    them after the forward and gathers them again as the backward begins.

Prints each run's mean step wall, tokens/s and peak device memory, and, for
one profiled step, the device time (ms) under each of FSDP2's annotated
hooks. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import gc
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import BATCH, FULL_ORDER, SEQ, train_full_width
from tpukit_torch import mesh as mesh_lib
from tpukit_torch import shardings
from tpukit_torch.model import GPTConfig
from tpukit_torch.recipes.profile import GPT2_SMALL_TRAIN, synthetic_batch
from tpukit_torch.train import to_device, train_step

VARIANTS = {
    "root": shardings.fully_shard,
    "reshard": functools.partial(shardings.fully_shard, reshard_after_forward=True),
}


def run(dev, variant: str) -> dict:
    """Phase 16's FSDP steps with `variant`'s `fully_shard`; then one more
    step under the profiler."""
    shardings.fully_shard = VARIANTS[variant]
    try:
        strategy = shardings.FSDP()
        res = train_full_width(dev, strategy)
    finally:
        shardings.fully_shard = VARIANTS["root"]
    state = res.pop("state")
    cfg = GPTConfig(compute_dtype=torch.bfloat16, attention_impl="auto", **GPT2_SMALL_TRAIN)
    batch = to_device(*synthetic_batch(np.random.RandomState(0), cfg.vocab_size, BATCH, SEQ), dev)
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        float(train_step(state, cfg, strategy, *batch))
    # the device time of the kernels under each of FSDP2's annotated hooks
    # (the gathers in pre_forward and pre_backward; a world of one copies
    # where a larger world runs NCCL)
    res["hooks"] = {r.key: round(r.device_time_total / 1e3, 3) for r in prof.key_averages()
                    if r.device_type == torch.autograd.DeviceType.CUDA
                    and r.key.startswith("FSDP::")}
    del state, strategy
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fsdp_ablation needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    results = {name: [] for name in VARIANTS}
    with mesh_lib.scoped_runtime():
        mesh_lib.initialize_runtime(dev)
        for _ in range(args.rounds):
            for name in ("root", "reshard", "reshard", "root"):
                results[name].append(run(dev, name))
    print(f"FSDP, world of one, gpt-small-dim768 B{BATCH} S{SEQ} bf16, {len(FULL_ORDER)} "
          f"steps a run; each run in turn:")
    for name, runs in results.items():
        print(f"  {name:8s} step wall (s) {[round(r['wall'], 4) for r in runs]}, tokens/s "
              f"{[round(BATCH * SEQ / r['wall'], 1) for r in runs]}, peak (B) "
              f"{[r['peak'] for r in runs]}")
        print(f"  {name:8s} device ms under FSDP2's hooks, one profiled step: "
              f"{[r['hooks'] for r in runs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
