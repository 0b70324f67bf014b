"""World bookkeeping for elastic resume (a twin of `tpukit/reshard.py:66-160`:
`current_world`, `saved_world`, `describe_mismatch`, `sweep_stale_world`).

Every save's meta sidecar records the saving world, so a relaunch can tell
a topology change from a plain resume. The restore itself is
`checkpoint.restore_any`, which puts any world's checkpoint in place for
this rank (every format holds whole tensors or blocks at their global
offsets), so the port has no counterpart of tpukit's block reassembly.

The port runs one process per card: a world of N cards is N ranks, so its
`nprocs` is N, where tpukit's world of N devices driven by one process
records 1. `nprocs` therefore differs between the packages' records of the
same device count by construction (ROADMAP.md §C).
"""

from __future__ import annotations

import json
from pathlib import Path

from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch import mesh as mesh_lib

# The keys that decide a mismatch; a global-batch change alone reshapes the
# stream, not the state (fit warns about the mid-epoch position then).
_COMPARED = ("nprocs", "device_count", "strategy", "mesh_axes")


def current_world(strategy, global_batch: int | None = None) -> dict:
    """The world a save records: ranks, cards (one a rank), the strategy's
    name and its mesh axes (`{"data": 1}` for a strategy without a mesh,
    tpukit's single-device mesh)."""
    mesh = getattr(strategy, "mesh", None)
    if mesh is None:
        axes = {"data": 1}
    else:
        axes = {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}
    world = {"nprocs": int(mesh_lib.world_size()), "device_count": int(mesh_lib.world_size()),
             "strategy": str(strategy.name), "mesh_axes": axes}
    if global_batch is not None:
        world["global_batch"] = int(global_batch)
    return world


def saved_world(path) -> dict | None:
    """The world a checkpoint was saved by: its meta sidecar's `world`, else
    a sharded manifest's `nprocs`, else None."""
    meta = ckpt_lib.read_meta(path)
    if meta and isinstance(meta.get("world"), dict):
        return meta["world"]
    path = Path(path)
    if path.is_dir():
        try:
            return {"nprocs": int(json.loads((path / "manifest.json").read_text())["nprocs"])}
        except (OSError, ValueError, KeyError):
            return None
    return None


def describe_mismatch(saved: dict | None, current: dict) -> str | None:
    """How the saving world differs from the current one, or None (also
    for a record without any compared key)."""
    if not saved:
        return None
    diffs = [f"{key} {saved[key]} -> {current.get(key)}" for key in _COMPARED
             if key in saved and saved[key] != current.get(key)]
    return "; ".join(diffs) or None


_STALE_PATTERNS = ("heartbeat-p*.json", "rollback-*.json", "preempt-request-p*.json",
                   "preempt-decision.json")


def sweep_stale_world(directory) -> list[str]:
    """Remove the previous incarnation's heartbeat, rollback and preemption
    files from the coordination directory (rank 0, when a resume sees a
    topology change, before this world's readers exist). Returns the
    removed names."""
    directory = Path(directory)
    removed = []
    if not directory.is_dir():
        return removed
    for pattern in _STALE_PATTERNS:
        for path in sorted(directory.glob(pattern)):
            try:
                path.unlink()
            except OSError:
                continue
            removed.append(path.name)
    return removed
