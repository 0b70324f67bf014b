"""Recipe 6: tensor-parallel training (twin of `main-tp.py`).

    python -m tpukit_torch.recipes.tp [main-tp.py's flags] [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpukit_torch.recipes.tp [flags]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpukit_torch.recipes.tp [flags] --device cpu

Megatron tensor parallelism (`TensorParallel`): q/k/v and the FFN's
up-projection split their output columns over the `model` ranks, the
attention's out-projection and the FFN's down-projection their input rows,
so each layer sums over the model group once after the attention and once
after the FFN; the LM head and the token table split their vocab. The
world is split into a `(data, model)` grid by `pick_grid` (the largest
model degree <= 4 that divides the world and `--heads`, `model`
innermost); the remaining ranks are data-parallel replicas, each loading
its own `--batch_size` rows. Run as a plain module it is a world of one;
under a launcher, one rank per process (NCCL on `cuda:{LOCAL_RANK}`, gloo
with `--device cpu`). Without a card it raises `CudaUnavailableError`
unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

from tpukit_torch import mesh
from tpukit_torch.flags import parse_flags
from tpukit_torch.recovery import run_recipe
from tpukit_torch.shardings import TensorParallel
from tpukit_torch.train import fit


def pick_grid(n_devices: int, heads: int) -> dict:
    """Largest model-parallel degree <= 4 that divides the device count and
    the head count (column-parallel q/k/v shard the head dimension);
    remaining devices become data-parallel replicas (a copy of
    `main-tp.py`'s)."""
    for model in (4, 2, 1):
        if n_devices % model == 0 and heads % model == 0:
            return {"data": n_devices // model, "model": model}
    return {"data": n_devices, "model": 1}


def main(argv=None):
    flags = parse_flags(argv)
    with mesh.scoped_runtime():  # a world brought up here ends here
        mesh.initialize_runtime(flags.device)
        grid = pick_grid(mesh.world_size(), flags.heads)
        return fit(flags, TensorParallel(data=grid["data"], model=grid["model"]))


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
