"""Recipe 1: single-device training (twin of `main-single.py`).

    python -m tpukit_torch.recipes.single [main-single.py's flags] [--device cuda|cpu]

Trains the GPT on the offline fixture corpus on one device through
`tpukit_torch.train.fit` with `SingleDevice`: on a CUDA card the attention
runs the flash-attention kernels (S >= 256) and the loss the fused head +
cross-entropy kernels. Without a card it raises `CudaUnavailableError`
unless `--device cpu` is given.
"""

from __future__ import annotations

import sys

from tpukit_torch.flags import parse_flags
from tpukit_torch.shardings import SingleDevice
from tpukit_torch.train import fit


def main(argv=None):
    return fit(parse_flags(argv), SingleDevice())


if __name__ == "__main__":
    main(sys.argv[1:])
