"""Recipe 5: pipeline x data-parallel training (twin of `main-pipe-ddp.py`).

    python -m tpukit_torch.recipes.pipe_ddp [recipe 4's flags] [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpukit_torch.recipes.pipe_ddp [flags]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpukit_torch.recipes.pipe_ddp [flags] --device cpu

Data-parallel replicas of recipe 4's pipeline: the world is split into a
`(data, stage)` grid by `pick_grid` (the largest stage count <= 4 that
divides the world and `--num_layers`; stages innermost), each replica
loads its own `--batch_size` rows, and the layer blocks' and vocab slices'
gradients are summed over the replicas, the replicated leaves' over every
rank. Otherwise as recipe 4 (`--schedule`, `--virtual_stages`,
`--microbatches`, MoE through `--moe_dispatch pallas`).
"""

from __future__ import annotations

import sys

from tpukit_torch import mesh
from tpukit_torch.recipes.pipe import make_strategy, pipeline_flags
from tpukit_torch.recovery import run_recipe
from tpukit_torch.train import fit


def pick_grid(n_devices: int, num_layers: int) -> dict:
    """Largest stage count <= 4 that divides both the device count and the
    layer count; remaining devices become data-parallel replicas (a copy
    of `main-pipe-ddp.py`'s)."""
    for stage in (4, 2, 1):
        if n_devices % stage == 0 and num_layers % stage == 0:
            return {"data": n_devices // stage, "stage": stage}
    return {"data": n_devices, "stage": 1}


def main(argv=None):
    flags = pipeline_flags(argv)
    with mesh.scoped_runtime():  # a world brought up here ends here
        mesh.initialize_runtime(flags.device)
        grid = pick_grid(mesh.world_size(), flags.num_layers)
        return fit(flags, make_strategy(flags, data=grid["data"], stages=grid["stage"]))


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
