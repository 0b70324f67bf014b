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

Under FSDP and the pipeline the file is still whole (tpukit's consolidated
default, `main-fsdp.py`): `save` gathers the full parameters and AdamW state
on every rank (through the train state's strategy, `Strategy.gather_leaf`)
and rank 0 writes them; `restore` reads the full tensors on every rank and
puts each rank's piece in place (`Strategy.local_leaf`). So a checkpoint
moves between `SingleDevice`, `DataParallel` and `FSDP` at any world, either
way. A pipeline's is in tpukit's layout: the layer stack identity-padded
and, at V > 1, chunk-permuted; an evenly split V = 1 one restores into any
of the others.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

from tpukit_torch import mesh as mesh_lib
from tpukit_torch.shardings import Strategy, leaves, paths, unflatten


CHECKPOINT_DIR = "checkpoints"


def _write_atomic(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def _full_cpu(strategy: Strategy, name: str, t):
    """A whole tensor on the host (a collective for a sharded leaf)."""
    return strategy.gather_leaf(name, t).detach().cpu() if isinstance(t, torch.Tensor) else t


def save(state, flags=None, directory=CHECKPOINT_DIR) -> Path:
    """Write `state` (a `train.TrainState`) and `flags`; returns the `.pt`
    path. Every rank calls it; rank 0 writes, and every rank returns once
    the file is there."""
    out = Path(directory)
    path = out / f"checkpoint-{state.step}.pt"
    strategy = state.strategy or Strategy()
    opt = state.optimizer.state_dict()
    names = paths(state.params)
    opt_state = {"state": {names[i]: {k: _full_cpu(strategy, names[i], v) for k, v in st.items()}
                           for i, st in opt["state"].items()},
                 "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                                  for g in opt["param_groups"]]}
    params = unflatten(state.params, [_full_cpu(strategy, n, p)
                                      for n, p in zip(names, leaves(state.params))])
    if mesh_lib.is_process_zero():
        out.mkdir(parents=True, exist_ok=True)
        payload = {"params": params, "opt_state": opt_state, "step": int(state.step)}
        _write_atomic(path, lambda p: torch.save(payload, p))
        if flags is not None:
            text = json.dumps(dataclasses.asdict(flags), indent=1, sort_keys=True)
            _write_atomic(path.with_suffix(".json"), lambda p: p.write_text(text))
    mesh_lib.sync_global_devices()
    return path


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
    strategy = state.strategy or Strategy()
    saved = dict(zip(paths(payload["params"]), leaves(payload["params"])))
    names, live = paths(state.params), leaves(state.params)
    local = {n: strategy.local_leaf(n, saved[n], p) for n, p in zip(names, live) if n in saved}
    if set(saved) != set(names) or any(local[n].shape != p.shape for n, p in zip(names, live)):
        raise ValueError(f"checkpoint {path} holds another parameter tree than this model")
    with torch.no_grad():
        for n, dst in zip(names, live):
            if isinstance(dst, DTensor):
                dst.to_local().copy_(local[n].to_local())
            else:
                dst.copy_(local[n])
    # torch pairs a group's saved ids with its live parameters by position,
    # so each group lists its live indices in live order
    index = {n: i for i, n in enumerate(names)}
    opt = payload["opt_state"]
    state.optimizer.load_state_dict({
        "state": {index[n]: {k: strategy.local_leaf(n, v, live[index[n]]) if k != "step" else v
                             for k, v in st.items()}
                  for n, st in opt["state"].items()},
        "param_groups": [{**g, "params": sorted(index[n] for n in g["params"])}
                         for g in opt["param_groups"]],
    })
    state.step = int(payload["step"])
