"""Recipe 3: fully-sharded training (twin of `main-fsdp.py`).

    python -m tpukit_torch.recipes.fsdp [main-fsdp.py's flags] [--cpu_offload]
        [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpukit_torch.recipes.fsdp [flags]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpukit_torch.recipes.fsdp [flags] --device cpu

Trains the GPT through `tpukit_torch.train.fit` with `FSDP`: FSDP2
`fully_shard` shards the parameters, gradients and AdamW state of every
leaf of 100 elements or more along its largest dimension divisible by the
world, as tpukit places them. `--cpu_offload` keeps the shards and the
optimizer step in host memory on `cuda` (on the CPU it warns and runs plain
FSDP). With `--comm_dtype bf16|int8` or `--grad_buckets N` each sharded
leaf is gathered at use and its gradient reduce-scattered through a
compressed (or bucketed) wire of `ops/quant_comm.py` instead of FSDP2's
own collectives. The checkpoint is whole, written by rank 0. Launches as
recipe 2 does. Without a card it raises `CudaUnavailableError` unless `--device
cpu` is given.
"""

from __future__ import annotations

import sys

from tpukit_torch.flags import parse_flags
from tpukit_torch.mesh import scoped_runtime
from tpukit_torch.recovery import run_recipe
from tpukit_torch.shardings import FSDP
from tpukit_torch.train import fit


def main(argv=None):
    flags = parse_flags(argv, cpu_offload=True)
    with scoped_runtime():  # a world brought up here ends here
        return fit(flags, FSDP(cpu_offload=flags.cpu_offload))


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
