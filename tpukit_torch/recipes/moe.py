"""Recipe 8: mixture-of-experts training (twin of `main-moe.py`).

    python -m tpukit_torch.recipes.moe [main-moe.py's flags] [--device cuda|cpu]

`--num_experts N` (default 8) replaces every layer's FFN with a routed
expert bank (top `--moe_top_k`, default 1) and trains it with
`ExpertParallel` and `--moe_dispatch` ("a2a" by default, "pallas" for the
grouped-expert kernels, "xla" for the one-hot einsums) through
`tpukit_torch.train.fit`. The device grid is tpukit's `pick_grid` over the
devices this run uses. The port trains in one process on one device, so the
grid is (data 1, expert 1): the exchange moves nothing, and "pallas" runs
the grouped kernels over its equal capacity segments. Without a card it
raises `CudaUnavailableError` unless `--device cpu` is given.
"""

from __future__ import annotations

import math
import sys

from tpukit_torch import resolve_device
from tpukit_torch.flags import parse_flags
from tpukit_torch.ops.moe_dispatch import ExpertGrid
from tpukit_torch.shardings import ExpertParallel
from tpukit_torch.train import fit

# devices one run of the port trains on; expert parallelism over more ranks
# is ROADMAP.md item 13, on tpukit_torch/mesh.py's process groups
DEVICES = 1


def pick_grid(n_devices: int, num_experts: int) -> dict:
    """tpukit's `pick_grid` (`main-moe.py:42-46`): the largest expert degree
    dividing both counts (their gcd), the other devices data-parallel."""
    expert = math.gcd(n_devices, num_experts)
    return {"data": n_devices // expert, "expert": expert}


def main(argv=None):
    flags = parse_flags(argv, num_experts=True)
    resolve_device(flags.device)  # without a card: CudaUnavailableError, before the grid
    grid = ExpertGrid(**pick_grid(DEVICES, flags.num_experts))
    return fit(flags, ExpertParallel(grid, dispatch=flags.moe_dispatch))


if __name__ == "__main__":
    main(sys.argv[1:])
