"""Recipe 2: data-parallel training (twin of `main-ddp.py`).

    python -m tpukit_torch.recipes.ddp [main-ddp.py's flags] [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpukit_torch.recipes.ddp [flags]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpukit_torch.recipes.ddp [flags] --device cpu

Trains the GPT through `tpukit_torch.train.fit` with `DataParallel`: each
rank holds every parameter and `--batch_size` rows of the global batch,
and `DistributedDataParallel` averages the gradients; with `--comm_dtype
bf16|int8` or `--grad_buckets N` tpukit's hand-placed wire sums them
instead (`ops/quant_comm.py`: the two-shot all-reduce, f32 accumulation). Run as a plain
module it is a world of one; under a launcher, one rank per process (NCCL
on `cuda:{LOCAL_RANK}`, gloo with `--device cpu`). Without a card it
raises `CudaUnavailableError` unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

from tpukit_torch.flags import parse_flags
from tpukit_torch.mesh import scoped_runtime
from tpukit_torch.recovery import run_recipe
from tpukit_torch.shardings import DataParallel
from tpukit_torch.train import fit


def main(argv=None):
    flags = parse_flags(argv)
    strategy = DataParallel()
    with scoped_runtime():  # a world brought up here ends here
        try:
            return fit(flags, strategy)
        finally:
            strategy.release()  # DDP's reducer lets go of the group before it goes


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
