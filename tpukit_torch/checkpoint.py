"""Checkpoints in the port's own format (tpukit's consolidated checkpoint is
flax msgpack, `tpukit/checkpoint.py:379-448`; reading and writing it waits
for ROADMAP.md item 10).

`save` writes `checkpoints/checkpoint-<step>.pt`, a `torch.save` of
`{"params": tree of CPU tensors, "opt_state": the optimizer's state keyed by
parameter path ("layers/attn/q/kernel"), "step": int}`, and the run's flags
as JSON beside it (`checkpoint-<step>.json`). Both files are written to a
temporary name and renamed, so a reader sees all or nothing. `restore`
loads one into a live train state, in place, matching parameters by path,
so a tree whose dicts hold the same keys in another order (tpukit's,
bridged, has them sorted) restores too.

Under FSDP the file is still whole (tpukit's consolidated default,
`main-fsdp.py`): `save` gathers the full parameters and AdamW state on
every rank and rank 0 writes them; `restore` reads the full tensors on
every rank and puts each rank's shard in place. So a checkpoint moves
between `SingleDevice`, `DataParallel` and `FSDP` at any world, either way.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

from tpukit_torch import mesh as mesh_lib
from tpukit_torch.shardings import gather_full, leaves, local_shard, unflatten


CHECKPOINT_DIR = "checkpoints"


def _write_atomic(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def paths(tree: dict, prefix: str = "") -> list[str]:
    """The "/"-joined key path of every leaf, in `leaves` order."""
    out = []
    for k, v in tree.items():
        out.extend(paths(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])
    return out


def _full_cpu(t):
    """A whole tensor on the host (a collective for a sharded DTensor)."""
    return gather_full(t).detach().cpu() if isinstance(t, torch.Tensor) else t


def save(state, flags=None, directory=CHECKPOINT_DIR) -> Path:
    """Write `state` (a `train.TrainState`) and `flags`; returns the `.pt`
    path. Every rank calls it; rank 0 writes, and every rank returns once
    the file is there."""
    out = Path(directory)
    path = out / f"checkpoint-{state.step}.pt"
    opt = state.optimizer.state_dict()
    names = paths(state.params)
    opt_state = {"state": {names[i]: {k: _full_cpu(v) for k, v in st.items()}
                           for i, st in opt["state"].items()},
                 "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                                  for g in opt["param_groups"]]}
    params = unflatten(state.params, [_full_cpu(p) for p in leaves(state.params)])
    if mesh_lib.is_process_zero():
        out.mkdir(parents=True, exist_ok=True)
        payload = {"params": params, "opt_state": opt_state, "step": int(state.step)}
        _write_atomic(path, lambda p: torch.save(payload, p))
        if flags is not None:
            text = json.dumps(dataclasses.asdict(flags), indent=1, sort_keys=True)
            _write_atomic(path.with_suffix(".json"), lambda p: p.write_text(text))
    mesh_lib.sync_global_devices()
    return path


def _like(full, live):
    """`full` as `live` holds it: this rank's shard, as a DTensor, where
    `live` is one; `full` otherwise."""
    if not isinstance(live, DTensor):
        return full
    shard = local_shard(full, live).to(live.to_local().device)
    return DTensor.from_local(shard, live.device_mesh, live.placements, shape=live.shape,
                              stride=live.stride())


def load(path) -> dict:
    """The checkpoint's payload, tensors on the CPU."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def restore(path, state) -> None:
    """Load the checkpoint at `path` into `state`: parameters copied into
    the live tensors, the optimizer's state loaded (moved to the
    parameters' device), the step set. The trees must have the same
    shape."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"--resume {path}: no checkpoint found")
    payload = load(path)
    saved = dict(zip(paths(payload["params"]), leaves(payload["params"])))
    names, live = paths(state.params), leaves(state.params)
    if set(saved) != set(names) or any(saved[n].shape != p.shape for n, p in zip(names, live)):
        raise ValueError(f"checkpoint {path} holds another parameter tree than this model")
    with torch.no_grad():
        for n, dst in zip(names, live):
            if isinstance(dst, DTensor):
                dst.to_local().copy_(local_shard(saved[n], dst))
            else:
                dst.copy_(saved[n])
    # torch pairs a group's saved ids with its live parameters by position,
    # so each group lists its live indices in live order
    index = {n: i for i, n in enumerate(names)}
    opt = payload["opt_state"]
    state.optimizer.load_state_dict({
        "state": {index[n]: {k: _like(v, live[index[n]]) if k != "step" else v
                             for k, v in st.items()}
                  for n, st in opt["state"].items()},
        "param_groups": [{**g, "params": sorted(index[n] for n in g["params"])}
                         for g in opt["param_groups"]],
    })
    state.step = int(payload["step"])
