"""Recipe 4: pipeline-parallel training (twin of `main-pipe.py`).

    python -m tpukit_torch.recipes.pipe [main-pipe.py's flags]
        [--schedule gpipe|1f1b] [--virtual_stages V] [--microbatches M]
        [--num_experts N --moe_dispatch pallas] [--device cuda|cpu]
    torchrun --nproc_per_node S -m tpukit_torch.recipes.pipe [flags]
    python -m torch.distributed.run --standalone --nproc_per_node S \\
        -m tpukit_torch.recipes.pipe [flags] --device cpu

Trains the GPT through `tpukit_torch.train.fit` with `Pipeline` (GPipe) or
`Pipeline1F1B` (`--schedule 1f1b`, also spelled `--pipeline_schedule`;
interleaved with `--virtual_stages V > 1`), one rank a stage: S = the world
(the reference's `num_stages = torch.cuda.device_count()`), M =
`--microbatches` or 4 x S (tpukit's "4x", which shrinks the GPipe bubble;
`--microbatches S` restores the reference's `chunks=num_stages`). Every
rank loads the same global batch of `--batch_size` rows, which M must
divide. The layer stack is identity-padded to a multiple of S (x V) and the
token table and the LM head are split over the stages by vocab rows and
columns when the padded vocab divides S. MoE configs run only with the
meshless dropless `--moe_dispatch pallas`. Run as a plain module it is a
world of one (NCCL on `cuda`, gloo with `--device cpu`). Without a card it
raises `CudaUnavailableError` unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

from tpukit_torch.flags import parse_flags
from tpukit_torch.mesh import scoped_runtime
from tpukit_torch.pipeline import Pipeline, Pipeline1F1B
from tpukit_torch.recovery import run_recipe
from tpukit_torch.train import fit


def pipeline_flags(argv):
    return parse_flags(argv, pipeline_schedule=True, num_experts=True, default_experts=0)


def make_strategy(flags, **grid):
    """`Pipeline` or `Pipeline1F1B` from the flags, on `grid` (data, stages)."""
    cls = Pipeline1F1B if flags.pipeline_schedule == "1f1b" else Pipeline
    return cls(num_microbatches=flags.microbatches or "4x",
               moe_dispatch=flags.moe_dispatch if flags.num_experts else None, **grid)


def main(argv=None):
    flags = pipeline_flags(argv)
    with scoped_runtime():  # a world brought up here ends here
        return fit(flags, make_strategy(flags))


if __name__ == "__main__":
    # exit codes: 0 clean, 75 preempted and checkpointed, 76 sentinel abort,
    # 77 rollback budget exhausted (recovery.py)
    sys.exit(run_recipe(main))
