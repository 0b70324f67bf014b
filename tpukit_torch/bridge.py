"""Parameters between tpukit and the port.

The port keeps tpukit's parameter tree (stacked `layers` leaves, `[in,
out]` kernels), so the bridge is a plain copy each way. The caller turns
the JAX pytree into numpy first, `jax.tree.map(np.asarray, params)`, which
keeps this module free of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukit_torch import resolve_device


def params_from_numpy(tree, device=None):
    """Nested dicts of numpy arrays -> the same nested dicts of tensors on
    `device`, values and dtypes unchanged (copies: the tensors share no
    memory with the arrays)."""
    device = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, copy=True)).to(device)

    return walk(tree)


def params_to_numpy(tree):
    """The port's nested dicts of tensors -> the same nested dicts of numpy
    arrays on the host (copies, detached from autograd)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()
