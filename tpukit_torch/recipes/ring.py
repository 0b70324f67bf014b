"""Recipe 7: long-context training with context parallelism (twin of
`main-ring.py`).

    python -m tpukit_torch.recipes.ring [main-ring.py's flags] [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpukit_torch.recipes.ring [flags]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpukit_torch.recipes.ring [flags] --device cpu

The sequence splits over every rank of the world (`ContextParallel` on a
`seq` axis of world size, as tpukit's default `create_mesh({"seq": -1})`
has it): each rank holds `(--sequence_length - 1) / N` positions of every
row, which must divide, and attention runs over the ranks. By default it
is the zigzag ring (`tpukit_torch/ring_attention.py`): K/V blocks hop from
rank to rank while each rank keeps its queries' online-softmax state, the
sequence permuted on the host so that every rank holds one early and one
late chunk. `--cp_attention ulysses` re-partitions heads over the ranks
with two all-to-alls a layer instead, and each rank runs full-sequence
flash attention on its heads (`--heads` must divide by N). Each rank's
tokens go through the fused head + CE kernels. Run as a plain module it
is a world of one; under a launcher, one rank per process (NCCL on
`cuda:{LOCAL_RANK}`, gloo with `--device cpu`). Without a card it raises
`CudaUnavailableError` unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

from tpukit_torch import mesh
from tpukit_torch.flags import parse_flags
from tpukit_torch.recovery import run_recipe
from tpukit_torch.shardings import ContextParallel
from tpukit_torch.train import fit


def main(argv=None):
    flags = parse_flags(argv, cp_attention=True)
    with mesh.scoped_runtime():  # a world brought up here ends here
        mesh.initialize_runtime(flags.device)
        # host_permute: fit applies the zigzag permutation to the host batch
        return fit(flags, ContextParallel(attention=flags.cp_attention, host_permute=True))


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
