"""Cross-replica divergence detection: state checksums (twin of
`tpukit/obs/divergence.py`).

A periodic checksum of the parameters and the optimizer state
(`--divergence_check_freq N` steps), published through each rank's
heartbeat file and compared across ranks by rank 0. Replicas that should
be bit-identical (DDP keeps the state replicated) must give the same
checksum at the same step; one flipped bit anywhere in the parameters or
the Adam moments changes it.

The value is tpukit's, bit for bit, on the same state:

  - each leaf is folded by XOR over its bit patterns (floats through f32,
    viewed as int32; integers and bools widened), order-independent and
    exact. torch has no XOR reduction, so the fold halves the array until
    one element is left;
  - the folds are combined by FNV's multiply-xor in tpukit's leaf order
    (dict keys sorted at every level), in int64 masked to 32 bits: torch
    has no uint32 multiply on the CPU;
  - the optimizer state is optax's tree, `count`, then `mu` and `nu`
    (AdamW's `exp_avg` and `exp_avg_sq`), through the mapping that
    `checkpoint.py` writes tpukit's consolidated format with.

Sharded state (FSDP, TP, EP, the pipeline): tpukit's value is the fold of
the logical array, the same on every process. Each rank folds the pieces
it counts (`shardings.distinct_piece`: a replicated piece folded twice
would cancel under XOR), the per-leaf folds of the split leaves are
all-gathered (NCCL has no XOR reduction) and combined; leaves every rank
holds whole are folded locally, so a replica that diverged there still
shows its own checksum. The folds stay on the device until
`format_checksum` reads them, at the window's sync.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch.obs.sentinels import comm_device, world_collective
from tpukit_torch.shardings import distinct_piece, leaves, paths

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


def _leaf_fold(t: torch.Tensor) -> torch.Tensor:
    """The u32 XOR-fold of one tensor's bit patterns, as an int64 scalar."""
    x = t.detach()
    if isinstance(x, DTensor):
        x = x.to_local()
    if x.is_floating_point():
        x = x.to(torch.float32).contiguous().view(torch.int32)
    else:
        x = x.to(torch.int64).bitwise_and(_U32).to(torch.int32)
    x = x.reshape(-1)
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    while x.numel() > 1:
        half = x.numel() // 2
        folded = torch.bitwise_xor(x[:half], x[half:2 * half])
        x = torch.cat([folded, x[2 * half:]]) if x.numel() % 2 else folded
    return x[0].to(torch.int64).bitwise_and(_U32)


def _fnv(folds: torch.Tensor) -> torch.Tensor:
    acc = torch.full((), _FNV_OFFSET, dtype=torch.int64, device=folds.device)
    for f in folds.unbind():
        acc = (acc * _FNV_PRIME).bitwise_and(_U32).bitwise_xor(f)
    return acc


def _checksum(named: list, strategy) -> torch.Tensor:
    """The u32 checksum (int64 device scalar) of `(name or None, tensor)`
    leaves in tpukit's order; a name of None marks a scalar every rank
    holds (AdamW's count)."""
    device = comm_device(named[0][1].device)
    folds, split, any_split = [], [], False
    for name, t in named:
        sharded, piece = (False, t) if name is None else distinct_piece(strategy, name, t)
        any_split |= sharded
        split.append(sharded)
        folds.append(torch.zeros((), dtype=torch.int64, device=device) if piece is None
                     else _leaf_fold(piece).to(device))
    folds = torch.stack(folds)
    if any_split and world_collective():
        gathered = [torch.empty_like(folds) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, folds)
        mask = torch.tensor(split, device=device)
        combined = torch.zeros_like(folds)
        for g in gathered:
            combined = combined.bitwise_xor(g)
        folds = torch.where(mask, combined, folds)
    return _fnv(folds)


def _sorted(tree: dict) -> list:
    return sorted(zip(paths(tree), leaves(tree)), key=lambda kv: kv[0].split("/"))


def tree_checksum(tree: dict, strategy=None) -> torch.Tensor:
    """The u32 checksum of a nested dict of tensors (tpukit's
    `tree_checksum` of the same tree), as an int64 device scalar."""
    return _checksum(_sorted(tree), strategy)


def make_state_checksum():
    """`state -> {"params", "opt_state"}` u32 checksums (int64 device
    scalars), tpukit's `make_state_checksum()` of the same train state.
    Every rank calls it (a collective where a leaf is split)."""

    def checksum(state) -> dict:
        entries = ckpt_lib._state_entries(state)
        named = {"params": [], "opt_state": []}
        for key, name, t in entries:
            for part in named:
                if key.startswith(f".{part}/"):
                    named[part].append((name, t))
        return {part: _checksum(leaves_, state.strategy) for part, leaves_ in named.items()}

    return checksum


def format_checksum(ck: dict) -> str:
    """`params:opt_state` as hex, the string heartbeats and JSONL records
    carry (the one read from the device)."""
    return f"{int(ck['params']):08x}:{int(ck['opt_state']):08x}"
