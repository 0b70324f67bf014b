"""Recipe 8: mixture-of-experts training (twin of `main-moe.py`).

    python -m tpukit_torch.recipes.moe [main-moe.py's flags] [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpukit_torch.recipes.moe [flags]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpukit_torch.recipes.moe [flags] --device cpu

`--num_experts N` (default 8) replaces every layer's FFN with a routed
expert bank (top `--moe_top_k`, default 1) and trains it with
`ExpertParallel` and `--moe_dispatch` ("a2a" by default, "pallas" for the
grouped-expert kernels, "xla" for the one-hot einsums) through
`tpukit_torch.train.fit`. The world is split into a `(data, expert)` grid
by tpukit's `pick_grid` (the expert degree the gcd of the world and the
experts, `expert` innermost): each rank holds its experts and its piece of
the trunk, and "a2a" and "pallas" exchange tokens with the expert group by
`all_to_all_single`, forward and backward, its payload `--comm_dtype`
(f32, bf16 or block-scaled int8; the xla dispatch refuses anything but
f32). `--batch_size` is rows a data
replica (tpukit's per-data-shard batch), split over the replica's expert
ranks. Run as a plain module it is a world of one (a 1 x 1 grid: the
exchange moves nothing); under a launcher, one rank per process (NCCL on
`cuda:{LOCAL_RANK}`, gloo with `--device cpu`); rank 0 prints. Without a
card it raises `CudaUnavailableError` unless `--device cpu` is given.
"""

from __future__ import annotations

import math
import sys

from tpukit_torch import mesh
from tpukit_torch.flags import check_carried, parse_flags
from tpukit_torch.ops.moe_dispatch import ExpertGrid
from tpukit_torch.recovery import run_recipe
from tpukit_torch.shardings import ExpertParallel
from tpukit_torch.train import fit


def pick_grid(n_devices: int, num_experts: int) -> dict:
    """tpukit's `pick_grid` (`main-moe.py:42-46`): the largest expert degree
    dividing both counts (their gcd), the other devices data-parallel."""
    expert = math.gcd(n_devices, num_experts)
    return {"data": n_devices // expert, "expert": expert}


def main(argv=None):
    flags = parse_flags(argv, num_experts=True)
    check_carried(flags)  # before a world comes up
    with mesh.scoped_runtime():  # a world brought up here ends here
        mesh.initialize_runtime(flags.device)
        grid = ExpertGrid(**pick_grid(mesh.world_size(), flags.num_experts))
        return fit(flags, ExpertParallel(grid, dispatch=flags.moe_dispatch))


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
