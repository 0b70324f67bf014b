#!/usr/bin/env python3
"""The quantized collectives and gradient buckets on several cards, kept
because PERF.md's figures for them come from it:

    torchrun --standalone --nproc_per_node 4 quant_ablation.py [--rounds N] [--recipes]

from the repository root, one rank a card over NCCL. In each round,
`python -m tpukit_torch.recipes.profile`'s `main` for each strategy's
configs in turn, its f32 run again at the end (the spread of unchanged
code beside the changes):

  - `--strategy ddp` and `--strategy fsdp` (the gpt-small-dim768 rung,
    batch 64 a rank, bf16): f32 (DDP's reducer and FSDP2's own
    collectives), `--comm_dtype int8`, `--comm_dtype bf16`, f32 with
    `--grad_buckets 4` and int8 with `--grad_buckets 4` (the hand-placed
    wire of `shardings.DataParallel` / `FSDP`);
  - `--strategy ep` (the e8 rung, batch 32 a rank, the pallas dispatch) on
    recipe 8's grid of the world and on `--expert 2`: the exchange at f32,
    int8 and bf16, and f32 with `--grad_buckets 4` (which changes no
    dataflow under EP).

Each prints its step wall, tokens/s, peak memory, the NCCL kernels' calls
and device time a profiled step and the c10d collectives of one step with
their bytes, beside the strategy's closed form. With `--recipes`, then
recipes 2, 3 and 8 end to end at f32 and at `--comm_dtype int8` (the
fixture corpus's whole train split, `--dataset_slice 4096`: 16 steps of
recipes 2 and 3, 15 of them timed; GPT-2-small width, one epoch; the
checkpoints under build/quant_ablation/). `--rounds 0 --recipes` runs the
recipes alone. Rank 0 prints a header before
each run. Needs one CUDA card a rank.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
from pathlib import Path

import torch

from tpukit_torch import mesh
from tpukit_torch.recipes import ddp, fsdp, moe, profile

COMMS = [[], ["--comm_dtype", "int8"], ["--comm_dtype", "bf16"], ["--grad_buckets", "4"]]
GROUPS = [("ddp", [], COMMS + [["--comm_dtype", "int8", "--grad_buckets", "4"]]),
          ("fsdp", [], COMMS), ("ep", [], COMMS), ("ep", ["--expert", "2"], COMMS[:3])]
RECIPE_ARGS = ["--dim", "768", "--head_dim", "64", "--heads", "12", "--num_layers", "12",
               "--sequence_length", "512", "--epochs", "1", "--dataset_slice", "4096"]
RECIPES = [("recipe 2", ddp, ["--batch_size", "64"]), ("recipe 3", fsdp, ["--batch_size", "64"]),
           ("recipe 8", moe, ["--batch_size", "32", "--num_experts", "8",
                              "--moe_dispatch", "pallas"])]


def header(text: str) -> None:
    if mesh.rank() == 0:
        print(f"=== {text}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--recipes", action="store_true")
    flags = ap.parse_args(argv)
    mesh.initialize_runtime("cuda")  # kept up: every run below reuses it
    try:
        nvsmi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
        header(f"{mesh.world_size()} ranks; {nvsmi.strip().splitlines()[0]}; torch "
               f"{torch.__version__}, CUDA {torch.version.cuda}")
        for rnd in range(flags.rounds):
            for strategy, grid, comms in GROUPS:
                for comm in comms + comms[:1]:
                    header(f"round {rnd}: --strategy {strategy} {' '.join(grid + comm) or 'f32'}")
                    profile.main(["--strategy", strategy, "--steps", "6", *grid, *comm])
                    gc.collect()
                    torch.cuda.empty_cache()
        if flags.recipes:
            work = Path("build/quant_ablation")
            work.mkdir(parents=True, exist_ok=True)
            cwd = os.getcwd()
            os.chdir(work)
            try:
                for label, recipe, extra in RECIPES:
                    for comm in ([], ["--comm_dtype", "int8"]):
                        header(f"{label} {' '.join(comm) or 'f32'}")
                        recipe.main(RECIPE_ARGS + extra + comm)
                        gc.collect()
                        torch.cuda.empty_cache()
            finally:
                os.chdir(cwd)
    finally:
        mesh.shutdown_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
