"""Checkpoints: the port's own `.pt`, and tpukit's two formats (twins of
`tpukit/checkpoint.py`), read and written without flax or msgpack.

**The port's `.pt`.** `save` writes `checkpoints/checkpoint-<step>.pt`, a
`torch.save` of `{"params": tree of CPU tensors, "opt_state": the
optimizer's state keyed by parameter path ("layers/attn/q/kernel"), "step":
int}`, and the run's flags as JSON beside it (`checkpoint-<step>.json`).
`restore` loads one into a live train state, in place, matching parameters
by path, so a tree whose dicts hold the same keys in another order
(tpukit's, bridged, has them sorted) restores too.

**tpukit's consolidated format** (`save` :379, `restore` :439):
`checkpoint-step%09d.msgpack`, the train state as flax serializes it,
`{"params": ..., "opt_state": {"0": {"count", "mu", "nu"}, "1": {}, "2":
{}}, "step"}` (optax's adamw chain: scale_by_adam, then two stateless
transforms), encoded by `tpukit_torch.msgpack`, with a sha256 sidecar of
the bytes. From torch: `count` and `step` are int32 scalars, `mu` is
AdamW's `exp_avg`, `nu` its `exp_avg_sq`. `save_consolidated` and
`restore_consolidated` write and read it.

**tpukit's sharded format** (`save_sharded` :921, `restore_sharded`
:1089): a `checkpoint-step%09d.sharded/` directory holding `manifest.json`
(`nprocs`, `paths`, `leaves`, `checksums`), one `shard-<rank:05d>.npz` a
rank, keyed `"<leaf index>|<starts>"`, and each shard's `.sha256`, published
by renaming a `.tmp` directory. Leaves follow jax's flatten order of the
train state, dict keys sorted: `.params/...`, `.opt_state/[0]/.count`,
`.opt_state/[0]/.mu/...`, `.opt_state/[0]/.nu/...`, `.step`. Each block is
written once: under FSDP each rank writes its DTensor's local block at its
global start, the pipeline's stage ranks of data replica 0 their pieces of
the stack and vocab, and rank 0 every replicated leaf
(`Strategy.leaf_block`). A rank with no block writes an empty shard.

Every format holds whole tensors in tpukit's layout, so a checkpoint moves
between `SingleDevice`, `DataParallel`, `FSDP` and the pipeline at any
world, either way, and between the port and tpukit: each restore puts its
rank's piece in place through `Strategy.local_leaf`. An identity-padded
pipeline stack restores into an unpadded tree and back
(`_adapt_layer_axis`). `restore_any` takes any of the three, `restore_params`
reads the parameters alone (for serving), `verify_checkpoint` checks a
sidecar or a manifest, and `latest_any` picks the newest good checkpoint of
any format by step.

**Resilience** (twins of tpukit's `_publish_sidecars` :137,
`_finalize_manifest` :889, `all_checkpoints` :558, `latest_good` :572,
`prune_checkpoints` :589 and `AsyncCheckpointer` :1265). Every writer takes
`meta`, the resume-metadata sidecar: `<file>.meta.json` beside a `.pt` or a
msgpack, `resume.json` inside a sharded directory (`fit` records the saving
world in every save, and a preemption's epoch and batch position).
`all_checkpoints` lists the published checkpoints of the three formats,
`latest_good` picks the newest that verifies under a step limit (the
rollback target), and `prune_checkpoints` keeps the newest K and never
touches a quarantined timeline or the newest good checkpoint.
`AsyncCheckpointer` takes the snapshot (device-to-host copies) on the
calling thread, since AdamW updates the parameters in place, and writes on
a background thread with no collective: one write in flight at most,
`wait()` re-raises its failure. The sync and async writers of a format run
the same write code on the same snapshot, so their bytes are equal (the
shard archives carry fixed zip timestamps). Every write and read is a
`retry_io` unit with its chaos hook (`ckpt_io_fail`, `ckpt_read_fail`)
inside.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
from pathlib import Path

import numpy as np
import torch
from numpy.lib import format as npformat
from torch.distributed.tensor import DTensor

from tpukit_torch import chaos
from tpukit_torch import mesh as mesh_lib
from tpukit_torch import msgpack
from tpukit_torch.retry import retry_io
from tpukit_torch.shardings import Strategy, leaves, paths, unflatten


CHECKPOINT_DIR = "checkpoints"


def _write_atomic(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def atomic_write_text(path, text: str) -> None:
    """Publish `text` at `path` whole or not at all (a hidden temporary,
    then a rename): the sidecars, heartbeats and decision files."""
    _write_atomic(Path(path), lambda p: p.write_text(text))


def _full_cpu(strategy: Strategy, name: str, t, copy: bool = False):
    """A whole tensor on the host (a collective for a sharded leaf); with
    `copy`, never a view of live storage (an async save's snapshot)."""
    if not isinstance(t, torch.Tensor):
        return t
    t = strategy.gather_leaf(name, t).detach()
    return t.to("cpu", copy=True) if copy else t.cpu()


def _publish_meta(path: Path, meta: dict | None) -> None:
    if meta is not None:
        atomic_write_text(meta_path(path), json.dumps(meta))


# ---------------------------------------------------------------- the .pt --


def _torch_save(payload: dict, path: Path) -> None:
    # through a file object, so that the archive's inner name is torch's
    # fixed "archive", not the (pid-keyed) temporary file's: equal states
    # give equal bytes
    with open(path, "wb") as f:
        torch.save(payload, f)


def _write_pt_file(path: Path, payload: dict) -> None:
    chaos.maybe_io_fault("ckpt_write")
    _write_atomic(path, lambda p: _torch_save(payload, p))


def _pt_plan(state, flags, directory, meta, copy: bool):
    """The `.pt` save split at its snapshot: (path, the write for rank 0 or
    None). The snapshot (a gather on every rank) happens here."""
    out = Path(directory)
    path = out / f"checkpoint-{state.step}.pt"
    strategy = state.strategy or Strategy()
    opt = state.optimizer.state_dict()
    names = paths(state.params)
    opt_state = {"state": {names[i]: {k: _full_cpu(strategy, names[i], v, copy)
                                      for k, v in st.items()}
                           for i, st in opt["state"].items()},
                 "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                                  for g in opt["param_groups"]]}
    params = unflatten(state.params, [_full_cpu(strategy, n, p, copy)
                                      for n, p in zip(names, leaves(state.params))])
    if not mesh_lib.is_process_zero():
        return path, None
    payload = {"params": params, "opt_state": opt_state, "step": int(state.step)}
    text = (json.dumps(dataclasses.asdict(flags), indent=1, sort_keys=True)
            if flags is not None else None)

    def work():
        out.mkdir(parents=True, exist_ok=True)
        retry_io(_write_pt_file, path, payload, label="ckpt_write")
        if text is not None:
            atomic_write_text(path.with_suffix(".json"), text)
        _publish_meta(path, meta)
    return path, work


def save(state, flags=None, directory=CHECKPOINT_DIR, meta: dict | None = None) -> Path:
    """Write `state` (a `train.TrainState`) and `flags` as the port's
    `.pt`, with `meta` as its sidecar; returns its path. Every rank calls
    it; rank 0 writes, and every rank returns once the file is there."""
    path, work = _pt_plan(state, flags, directory, meta, copy=False)
    if work is not None:
        work()
    mesh_lib.sync_global_devices()
    return path


def _load_pt(path: Path) -> dict:
    chaos.maybe_io_fault("ckpt_read")
    return torch.load(path, map_location="cpu", weights_only=True)


def load(path) -> dict:
    """The checkpoint's payload, tensors on the CPU."""
    return retry_io(_load_pt, Path(path), label="ckpt_read")


def restore(path, state) -> None:
    """Load the `.pt` checkpoint at `path` into `state`: parameters copied
    into the live tensors, the optimizer's state loaded (moved to the
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


# ------------------------------------------------- names and sidecars --------


def step_name(step: int) -> str:
    """tpukit's step-keyed stem (`checkpoint.py:69-76`)."""
    return f"checkpoint-step{int(step):09d}"


_STEP_RE = re.compile(r"checkpoint-step(\d+)")
_PT_RE = re.compile(r"checkpoint-(\d+)\.pt$")


def _step_of(path) -> int:
    """The step in a checkpoint's name: tpukit's `checkpoint-step<N>`, or
    the port's `checkpoint-<N>.pt`; -1 for any other name."""
    name = Path(path).name
    m = _STEP_RE.search(name) or _PT_RE.search(name)
    return int(m.group(1)) if m else -1


def checksum_sidecar(path) -> Path:
    """The sha256 sidecar next to a consolidated checkpoint file."""
    path = Path(path)
    return path.with_name(path.name + ".sha256")


def meta_path(path) -> Path:
    """The resume-metadata sidecar: `<file>.meta.json`, or `resume.json`
    inside a sharded directory."""
    path = Path(path)
    if path.suffix == ".sharded" or path.is_dir():
        return path / "resume.json"
    return path.with_name(path.name + ".meta.json")


def read_meta(path) -> dict | None:
    """The save-time metadata, or None for checkpoints without it."""
    try:
        return json.loads(meta_path(path).read_text())
    except (OSError, ValueError):
        return None


def sidecars(path) -> list[Path]:
    """The files that travel with a checkpoint file when it is renamed or
    deleted: its sha256 and meta sidecars, and a `.pt`'s flags JSON (a
    sharded directory holds its own)."""
    path = Path(path)
    if path.suffix == ".sharded":
        return []
    out = [checksum_sidecar(path), meta_path(path)]
    if path.suffix == ".pt":
        out.append(path.with_suffix(".json"))
    return out


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _read_file(path: Path) -> bytearray:
    """A file's bytes in one writable buffer (the codec's tensors are
    copied out of it); the retried unit of a consolidated read."""
    chaos.maybe_io_fault("ckpt_read")
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    return buf


_VOCAB_PAD_HINT = (
    "If the mismatched dimension is the vocab axis (e.g. 50257 vs 50304), "
    "the checkpoint was written under a different GPTConfig.vocab_pad_multiple "
    "— recreate the model with the checkpoint's padding (vocab_pad_multiple=1 "
    "for an unpadded checkpoint, 128 for the default-padded one)."
)


def _adapt_layer_axis(name: str, t: torch.Tensor, want: tuple):
    """tpukit's `_adapt_layer_axis` (:412-436): an identity-padded pipeline
    stack restored into an unpadded tree loses its all-zero padding layers;
    an unpadded one restored into a padded tree gains zero layers. None
    when the mismatch is not such a pad."""
    if "layers" not in name or t.dim() == 0 or len(want) != t.dim() \
            or tuple(t.shape[1:]) != tuple(want[1:]):
        return None
    saved, target = t.shape[0], want[0]
    if saved > target:
        if bool((t[target:] != 0).any()):
            return None  # not identity padding: never drop trained layers
        return t[:target].contiguous()
    return torch.cat([t, t.new_zeros((target - saved, *t.shape[1:]))])


def _fit_shape(source, name: str, t: torch.Tensor, want: tuple) -> torch.Tensor:
    if tuple(t.shape) == tuple(want):
        return t
    adapted = _adapt_layer_axis(name, t, want)
    if adapted is None:
        raise ValueError(f"checkpoint {source}: leaf {name} was saved with shape "
                         f"{tuple(t.shape)} but the target expects {tuple(want)}. "
                         f"{_VOCAB_PAD_HINT}")
    return adapted


# ---------------------------------------- the train state in tpukit's tree --

_PARAMS_PREFIX = ".params"  # the TrainState's params subtree, in jax's key-path form
_COUNT, _STEP = ".opt_state/[0]/.count", ".step"
_SCHEDULE_COUNT = ".opt_state/[2]/.count"  # optax's scale_by_schedule, with a schedule
_MOMENTS = (("mu", "exp_avg"), ("nu", "exp_avg_sq"))  # optax's name, torch AdamW's


def _key_path(prefix: str, name: str) -> str:
    """jax's key path of a dict leaf: "layers/attn/q/kernel" under `prefix`
    is "<prefix>/['layers']/['attn']/['q']/['kernel']"."""
    return prefix + "".join(f"/[{k!r}]" for k in name.split("/"))


def _moment_prefix(field: str) -> str:
    return f".opt_state/[0]/.{field}"


def _adam_state(state) -> tuple[int, dict]:
    """AdamW's update count and, per parameter name, its (exp_avg,
    exp_avg_sq): zeros, as optax's init, before the first step."""
    counts, moments = set(), {}
    for n, p in zip(paths(state.params), leaves(state.params)):
        st = state.optimizer.state.get(p, {})
        counts.add(int(st["step"]) if "step" in st else 0)
        moments[n] = [st.get(k, torch.zeros_like(p.detach())) for _, k in _MOMENTS]
    if len(counts) > 1:
        raise ValueError(f"AdamW's per-parameter step counts differ ({sorted(counts)}); "
                         f"tpukit's optimizer state has one count")
    return counts.pop() if counts else 0, moments


def _state_entries(state) -> list[tuple[str, str | None, torch.Tensor]]:
    """The train state's leaves in jax's flatten order (dict keys sorted at
    every level): (key path, the port's parameter name or None for a
    scalar, tensor)."""
    count, moments = _adam_state(state)
    live = dict(zip(paths(state.params), leaves(state.params)))
    order = sorted(live, key=lambda n: n.split("/"))
    out = [(_key_path(_PARAMS_PREFIX, n), n, live[n]) for n in order]
    out.append((_COUNT, None, torch.tensor(count, dtype=torch.int32)))
    for i, (field, _) in enumerate(_MOMENTS):
        out += [(_key_path(_moment_prefix(field), n), n, moments[n][i]) for n in order]
    if state.lr_schedule is not None:
        out.append((_SCHEDULE_COUNT, None, torch.tensor(count, dtype=torch.int32)))
    out.append((_STEP, None, torch.tensor(int(state.step), dtype=torch.int32)))
    return out


def _flat_state(source, raw: dict) -> dict:
    """A decoded consolidated train state's leaves by jax key path."""
    try:
        adam = raw["opt_state"]["0"]
        trees = [(_PARAMS_PREFIX, raw["params"])] + [(_moment_prefix(f), adam[f])
                                                     for f, _ in _MOMENTS]
        flat = {_COUNT: adam["count"], _STEP: raw["step"]}
    except (KeyError, TypeError) as exc:
        raise ValueError(f"checkpoint {source} is not a train state in tpukit's tree "
                         f"(params, AdamW's count/mu/nu, step): no {exc}") from exc
    for prefix, tree in trees:
        flat.update({_key_path(prefix, n): t for n, t in zip(paths(tree), leaves(tree))})
    return flat


def _load_state(state, get, source) -> None:
    """Load whole tensors from `get(key path)` into `state`: parameters,
    AdamW's moments and count, the step; each leaf adapted to the live
    tree's global shape and put in place as this rank holds it."""
    strategy = state.strategy or Strategy()
    names, live = paths(state.params), leaves(state.params)

    def local(prefix, n, p):
        want = strategy.leaf_block(n, p)[0]
        full = _fit_shape(source, n, get(_key_path(prefix, n)), want)
        return strategy.local_leaf(n, full, p)

    with torch.no_grad():
        for n, p in zip(names, live):
            piece = local(_PARAMS_PREFIX, n, p)
            if isinstance(p, DTensor):
                p.to_local().copy_(piece.to_local())
            else:
                p.copy_(piece)
    count = torch.tensor(float(get(_COUNT)), dtype=torch.float32)
    state.optimizer.load_state_dict({
        "state": {i: {"step": count.clone(),
                      **{k: local(_moment_prefix(f), n, p) for f, k in _MOMENTS}}
                  for i, (n, p) in enumerate(zip(names, live))},
        "param_groups": state.optimizer.state_dict()["param_groups"],
    })
    state.step = int(get(_STEP))


def _no_leaf(source, key: str) -> ValueError:
    return ValueError(f"checkpoint {source} has no leaf {key} — the model flags "
                      f"(--dim/--heads/--num_layers/--num_experts...) must equal the "
                      f"training run's")


def _lookup(source, flat: dict):
    def get(key):
        if key not in flat:
            raise _no_leaf(source, key)
        return flat[key]
    return get


# ------------------------------------------------------- consolidated --------


def _write_blob(path: Path, blob) -> None:
    chaos.maybe_io_fault("ckpt_write")
    _write_atomic(path, lambda p: p.write_bytes(blob))


def _publish_sidecars(path: Path, digest: str, meta: dict | None) -> None:
    """The sha256 and meta sidecars, after the blob: a crash in between
    leaves a blob without a sidecar, which verifies as legacy, never as
    corrupt."""
    atomic_write_text(checksum_sidecar(path), digest)
    _publish_meta(path, meta)


def _consolidated_plan(state, directory, meta, copy: bool):
    """The consolidated save split at its snapshot: (path, the encode and
    write for rank 0 or None). Every rank gathers here."""
    strategy = state.strategy or Strategy()
    out = Path(directory).resolve()
    path = out / f"{step_name(state.step)}.msgpack"
    full = {k: _full_cpu(strategy, n, t, copy) if n else t for k, n, t in _state_entries(state)}
    if not mesh_lib.is_process_zero():
        return path, None
    names = paths(state.params)
    skeleton = state.params

    def work():
        def tree(prefix):
            return unflatten(skeleton, [full[_key_path(prefix, n)] for n in names])

        adam = {"count": full[_COUNT], **{f: tree(_moment_prefix(f)) for f, _ in _MOMENTS}}
        blob = msgpack.packb({"params": tree(_PARAMS_PREFIX),
                              "opt_state": {"0": adam, "1": {},
                                            "2": ({"count": full[_SCHEDULE_COUNT]}
                                                  if _SCHEDULE_COUNT in full else {})},
                              "step": full[_STEP]})
        out.mkdir(parents=True, exist_ok=True)
        retry_io(_write_blob, path, blob, label="ckpt_write")
        _publish_sidecars(path, hashlib.sha256(blob).hexdigest(), meta)
    return path, work


def save_consolidated(state, directory=CHECKPOINT_DIR, meta: dict | None = None) -> Path:
    """tpukit's consolidated checkpoint of `state`: the msgpack, then its
    sha256 and `meta` sidecars. Every rank gathers; rank 0 writes; every
    rank returns the path once it is published."""
    path, work = _consolidated_plan(state, directory, meta, copy=False)
    if work is not None:
        work()
    mesh_lib.sync_global_devices()
    return path


def _read_consolidated(path: Path) -> tuple[dict, int]:
    blob = retry_io(_read_file, path, label="ckpt_read")
    raw = msgpack.unpackb(blob)
    if not isinstance(raw, dict) or "params" not in raw:
        keys = sorted(raw)[:8] if isinstance(raw, dict) else type(raw).__name__
        raise ValueError(f"checkpoint {path} has no 'params' subtree — not a TrainState "
                         f"checkpoint (top-level keys: {keys})")
    return raw, len(blob)


def restore_consolidated(path, state) -> None:
    """tpukit's consolidated checkpoint at `path` into the live `state`."""
    path = Path(path)
    raw, _ = _read_consolidated(path)
    _load_state(state, _lookup(path, _flat_state(path, raw)), path)


# ------------------------------------------------------------ sharded --------


def _parse_block_key(key: str) -> tuple[int, list[int]]:
    """A shard block key `"<leaf-idx>|<start,start,...>"` (empty starts: a
    scalar leaf); ValueError when malformed."""
    idx_s, _, starts_s = key.partition("|")
    starts = [int(s) for s in starts_s.split(",")] if starts_s else []
    return int(idx_s), starts


def _npz_block_headers(path: Path):
    """(key, shape, dtype) of every array in an npz, from the npy headers
    alone: no array data is read."""
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            key = name[:-4] if name.endswith(".npy") else name
            with zf.open(name) as fp:
                version = npformat.read_magic(fp)
                read = (npformat.read_array_header_1_0 if version == (1, 0)
                        else npformat.read_array_header_2_0)
                shape, _, dtype = read(fp)
            yield key, tuple(shape), dtype


def _check_shard_geometry(shard_files: list[Path], manifest: dict) -> str | None:
    """tpukit's geometry check (:209-296): the shards' blocks must tile the
    manifest's global shapes exactly (no duplicate block, every block
    inside its leaf, dtypes equal, every element covered). A detail string
    on mismatch, None when it fits."""
    leaves_meta = manifest.get("leaves")
    if leaves_meta is None:
        return None
    names = manifest.get("paths") or [str(i) for i in range(len(leaves_meta))]
    covered = [0] * len(leaves_meta)
    seen: set = set()
    for f in shard_files:
        try:
            headers = list(_npz_block_headers(f))
        except Exception as exc:  # zip/npy damage: verify as unreadable
            return f"unreadable shard {f.name} ({exc})"
        for key, bshape, bdtype in headers:
            try:
                i, starts = _parse_block_key(key)
            except ValueError:
                return f"{f.name}: malformed block key {key!r}"
            if not 0 <= i < len(leaves_meta):
                return (f"world mismatch: {f.name} block {key!r} references leaf {i} but the "
                        f"manifest records {len(leaves_meta)} leaves — shards from a different "
                        f"world?")
            if (i, tuple(starts)) in seen:
                return (f"world mismatch: duplicate block {key!r} across shard files "
                        f"({f.name}) — shards from a different world mixed in?")
            seen.add((i, tuple(starts)))
            shape = tuple(leaves_meta[i]["shape"])
            if len(bshape) != len(shape) or len(starts) != len(shape) or any(
                    st + bs > dim for st, bs, dim in zip(starts, bshape, shape)):
                return (f"world mismatch: {f.name} block {key!r} shape {bshape} at offset "
                        f"{tuple(starts)} does not fit the manifest's global shape {shape} for "
                        f"leaf {names[i]} — shards from a different world?")
            if np.dtype(bdtype) != np.dtype(leaves_meta[i]["dtype"]):
                return (f"world mismatch: {f.name} block {key!r} dtype {np.dtype(bdtype)} != "
                        f"manifest dtype {leaves_meta[i]['dtype']} for leaf {names[i]}")
            covered[i] += int(np.prod(bshape, dtype=np.int64))
    for i, got in enumerate(covered):
        want = int(np.prod(leaves_meta[i]["shape"], dtype=np.int64))
        if got != want:
            return (f"world mismatch: leaf {names[i]} has {got}/{want} elements across the "
                    f"manifest's {manifest.get('nprocs')} shard files — shards from a "
                    f"different world?")
    return None


def _shard_files(base: Path, nprocs: int) -> list[Path]:
    return [base / f"shard-{pid:05d}.npz" for pid in range(nprocs)]


def _savez(path: Path, blocks: dict) -> None:
    """`np.savez`'s archive (stored, zip64 entries `<key>.npy`) with fixed
    entry timestamps, so equal blocks give equal bytes."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in blocks.items():
            info = zipfile.ZipInfo(f"{key}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                npformat.write_array(f, np.asanyarray(arr), allow_pickle=False)


def _write_shard(shard: Path, blocks: dict) -> None:
    chaos.maybe_io_fault("ckpt_write")
    _write_atomic(shard, lambda p: _savez(p, blocks))


def _write_shard_digest(shard: Path) -> None:
    chaos.maybe_io_fault("ckpt_write")
    digest = _sha256_file(shard)
    atomic_write_text(shard.with_name(shard.name + ".sha256"), digest)


def _shard_snapshot(state, copy: bool) -> tuple[dict, dict]:
    """This rank's blocks (`Strategy.leaf_block`; copies with `copy`) and
    the manifest without its checksums."""
    strategy = state.strategy or Strategy()
    rank = mesh_lib.rank()
    blocks, meta, keys = {}, [], []
    for i, (key, name, t) in enumerate(_state_entries(state)):
        if name is None:  # the scalars: rank 0's
            shape, block, starts = (), (t if rank == 0 else None), []
        else:
            shape, block, starts = strategy.leaf_block(name, t)
        keys.append(key)
        meta.append({"shape": list(shape), "dtype": msgpack.DTYPE_NAMES[t.dtype]})
        if block is not None and block.numel():
            arr = block.detach().cpu().numpy()
            blocks[f"{i}|{','.join(map(str, starts))}"] = arr.copy() if copy else arr
    return blocks, {"nprocs": mesh_lib.world_size(), "paths": keys, "leaves": meta}


def _finalize_manifest(tmp: Path, manifest: dict, meta: dict | None) -> None:
    """Rank 0, once every shard and its digest exist: the manifest with the
    shards' digests, then the meta sidecar."""
    def digest(f: Path) -> str:
        def read() -> str:
            chaos.maybe_io_fault("ckpt_read")
            return f.with_name(f.name + ".sha256").read_text().strip()
        return retry_io(read, label="ckpt_read")

    manifest = {**manifest, "checksums": {f.name: digest(f)
                                          for f in _shard_files(tmp, manifest["nprocs"])}}
    text = json.dumps(manifest)

    def write() -> None:
        chaos.maybe_io_fault("ckpt_write")
        atomic_write_text(tmp / "manifest.json", text)
    retry_io(write, label="ckpt_write")
    _publish_meta(tmp, meta)


def _keep_published(base: Path, meta: dict | None) -> None:
    """A same-step re-save keeps the published directory (it holds the same
    state), with a warning; the caller's meta still lands in it."""
    warnings.warn(f"sharded checkpoint {base} already exists; keeping the published "
                  f"directory (same-step re-save)", stacklevel=3)
    _publish_meta(base, meta)


def save_sharded(state, directory=CHECKPOINT_DIR, meta: dict | None = None) -> Path:
    """tpukit's sharded checkpoint of `state`: every rank writes its blocks
    (`Strategy.leaf_block`) to its shard file and that file's sha256;
    rank 0 folds the digests into the manifest, writes `meta` as
    `resume.json` and publishes the `.tmp` directory by renaming it. Every
    rank calls it and gets the path. A directory already published at this
    step is kept, with a warning, as tpukit keeps it (a same-step re-save
    holds the same state)."""
    rank = mesh_lib.rank()
    base = Path(directory).resolve() / f"{step_name(state.step)}.sharded"
    tmp = base.with_name(base.name + ".tmp")
    if rank == 0 and tmp.exists():
        shutil.rmtree(tmp)  # a crashed save's leftovers
    mesh_lib.sync_global_devices()
    tmp.mkdir(parents=True, exist_ok=True)
    mesh_lib.sync_global_devices()

    blocks, manifest = _shard_snapshot(state, copy=False)
    shard = tmp / f"shard-{rank:05d}.npz"
    retry_io(_write_shard, shard, blocks, label="ckpt_write")
    retry_io(_write_shard_digest, shard, label="ckpt_write")
    mesh_lib.sync_global_devices()
    if rank == 0:
        if base.exists():
            shutil.rmtree(tmp)
            _keep_published(base, meta)
        else:
            _finalize_manifest(tmp, manifest, meta)
            tmp.rename(base)
    mesh_lib.sync_global_devices()
    return base


def _publish_sharded_snapshot(blocks: dict, manifest: dict, base: Path, timeout: float,
                              meta: dict | None) -> None:
    """The background half of an async sharded save, with no collective:
    this rank's shard and digest into the staging directory, then rank 0
    waits for every rank's files, finalizes and publishes, and the other
    ranks wait for the published directory."""
    rank = mesh_lib.rank()
    if base.exists():
        if rank == 0:
            _keep_published(base, meta)
        return
    tmp = base.with_name(base.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    shard = tmp / f"shard-{rank:05d}.npz"
    retry_io(_write_shard, shard, blocks, label="ckpt_write")
    retry_io(_write_shard_digest, shard, label="ckpt_write")
    deadline = time.monotonic() + timeout
    if rank != 0:
        while not base.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"async sharded checkpoint {base}: timed out after "
                                   f"{timeout}s waiting for rank 0 to publish")
            time.sleep(0.05)
        return
    expected = [tmp / f"shard-{p:05d}.npz{ext}" for p in range(manifest["nprocs"])
                for ext in ("", ".sha256")]
    while True:
        missing = [p.name for p in expected if not p.exists()]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"async sharded checkpoint {base}: timed out after {timeout}s "
                               f"waiting for shard files {missing}")
        time.sleep(0.05)
    _finalize_manifest(tmp, manifest, meta)
    if not base.exists():
        tmp.rename(base)


def _read_shard_manifest(base: Path) -> tuple[dict, list[Path]]:
    """manifest.json and exactly the shard files of its world, each of
    which must exist."""
    def read() -> str:
        chaos.maybe_io_fault("ckpt_read")
        return (base / "manifest.json").read_text()

    manifest = json.loads(retry_io(read, label="ckpt_read"))
    files = _shard_files(base, manifest["nprocs"])
    missing = [str(f) for f in files if not f.exists()]
    if missing:
        raise FileNotFoundError(
            f"checkpoint {base}: missing shard files {missing} (saved from "
            f"{manifest['nprocs']} processes; are all shard files on this filesystem?)")
    return manifest, files


class _Shards:
    """The blocks of a sharded checkpoint, by leaf, planned from the npy
    headers; each block read (lazily, through one `np.load` a file) only
    when its leaf is assembled."""

    def __init__(self, base: Path):
        self.base = base
        self.manifest, files = _read_shard_manifest(base)
        self.files = files
        self.npz = [retry_io(self._open, f, label="ckpt_read") for f in files]
        self.blocks: dict[int, list] = {}  # leaf index -> [(file index, key, nbytes)]
        for fi, f in enumerate(files):
            for key, shape, dtype in _npz_block_headers(f):
                idx, _ = _parse_block_key(key)
                nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
                self.blocks.setdefault(idx, []).append((fi, key, nbytes))
        self.index = {k: i for i, k in enumerate(self.manifest["paths"])}

    @staticmethod
    def _open(f: Path):
        chaos.maybe_io_fault("ckpt_read")
        return np.load(f)

    def _block(self, fi: int, key: str) -> np.ndarray:
        """One block, retried: a failed read reopens its file."""
        def read():
            try:
                return self.npz[fi][key]
            except OSError:
                self.npz[fi].close()
                self.npz[fi] = self._open(self.files[fi])
                raise
        return retry_io(read, label="ckpt_read")

    def nbytes(self, idx: int) -> int:
        return sum(b[2] for b in self.blocks.get(idx, ()))

    def leaf(self, idx: int) -> torch.Tensor:
        """Leaf `idx` whole, as a CPU tensor."""
        meta, name = self.manifest["leaves"][idx], self.manifest["paths"][idx]
        full = np.empty(meta["shape"], np.dtype(meta["dtype"]))
        covered = 0
        for fi, key, _ in self.blocks.get(idx, ()):
            block = self._block(fi, key)
            _, starts = _parse_block_key(key)
            full[tuple(slice(s, s + n) for s, n in zip(starts, block.shape))] = block
            covered += block.size
        if covered != full.size:
            raise ValueError(
                f"checkpoint {self.base}: leaf {idx} ({name}) has {covered}/{full.size} "
                f"elements — a shard-*.npz file is missing (saved from "
                f"{self.manifest['nprocs']} processes; are all shard files on this "
                f"filesystem?)")
        return torch.from_numpy(full)

    def get(self, key: str) -> torch.Tensor:
        if key not in self.index:
            raise _no_leaf(self.base, key)
        return self.leaf(self.index[key])

    def close(self) -> None:
        for f in self.npz:
            f.close()


def restore_sharded(path, state) -> None:
    """tpukit's sharded checkpoint at `path` into the live `state`: each
    leaf assembled whole from its blocks, then this rank's piece put in
    place, whatever world or strategy wrote it."""
    shards = _Shards(Path(path))
    try:
        want = len(_state_entries(state))
        if want != len(shards.manifest["paths"]):
            raise ValueError(f"template has {want} leaves, checkpoint has "
                             f"{len(shards.manifest['paths'])} ({path})")
        _load_state(state, shards.get, path)
    finally:
        shards.close()


# ---------------------------------------------------------- any format ------


def save_auto(state, format: str = "auto", flags=None, directory=CHECKPOINT_DIR,
              meta: dict | None = None) -> Path:
    """`--checkpoint_format`: "auto" writes the port's `.pt` (with the
    flags beside it), "consolidated" tpukit's msgpack, "sharded" tpukit's
    sharded directory; each with `meta` as its resume-metadata sidecar."""
    if format == "auto":
        return save(state, flags, directory, meta)
    if format == "consolidated":
        return save_consolidated(state, directory, meta)
    if format == "sharded":
        return save_sharded(state, directory, meta)
    raise ValueError(f"format must be auto|consolidated|sharded, got {format!r}")


class AsyncCheckpointer:
    """A checkpoint writer that does not block the training loop (twin of
    tpukit's `AsyncCheckpointer`, `checkpoint.py:1265`). `save_auto` takes
    the snapshot on the calling thread (every rank's gather, copied off the
    live tensors: the next step updates them in place), then writes on a
    background thread and returns the path the write will publish. At most
    one write is in flight: the next `save_auto` and `wait()` join it, and
    `wait()` re-raises its failure. The background half runs no
    collective; a sharded save's ranks meet through the filesystem."""

    def __init__(self, shard_timeout: float = 600.0):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._shard_timeout = shard_timeout

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Block until the write in flight (if any) has published, then
        re-raise its failure (if any)."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save_auto(self, state, format: str = "auto", flags=None, directory=CHECKPOINT_DIR,
                  meta: dict | None = None) -> Path:
        self.wait()
        if format == "auto":
            path, work = _pt_plan(state, flags, directory, meta, copy=True)
        elif format == "consolidated":
            path, work = _consolidated_plan(state, directory, meta, copy=True)
        elif format == "sharded":
            blocks, manifest = _shard_snapshot(state, copy=True)
            path = Path(directory).resolve() / f"{step_name(state.step)}.sharded"
            work = lambda: _publish_sharded_snapshot(blocks, manifest, path,  # noqa: E731
                                                     self._shard_timeout, meta)
        else:
            raise ValueError(f"format must be auto|consolidated|sharded, got {format!r}")
        if work is None:
            return path

        def run():
            try:
                work()
            except BaseException as exc:  # noqa: BLE001 — re-raised at wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tpukit-torch-async-ckpt")
        self._thread.start()
        return path


def restore_any(path, state) -> None:
    """Any of the three formats into the live `state`: a directory is
    sharded, a `.pt` the port's, any other file consolidated."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"--resume {path}: no checkpoint found")
    if path.is_dir():
        restore_sharded(path, state)
    elif path.suffix == ".pt":
        restore(path, state)
    else:
        restore_consolidated(path, state)


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 0 if tree is None else 1


def restore_params(path, template: dict, device=None) -> tuple[dict, dict]:
    """The parameters alone, for serving (twin of `restore_params`
    :667-824): a tree shaped like `template` (its leaves' shapes only are
    read: meta tensors will do) of the checkpoint's parameters, on
    `device`, and tpukit's I/O ledger `{"format", "bytes_read",
    "bytes_skipped", "leaves_read", "leaves_skipped"}`. A sharded
    checkpoint's optimizer blocks are never read; a consolidated file is
    read once and its parameters alone kept."""
    path = Path(path)
    names = paths(template)
    want = dict(zip(names, (tuple(t.shape) for t in leaves(template))))
    if path.is_dir():
        shards = _Shards(path)
        try:
            saved = [i for i, k in enumerate(shards.manifest["paths"])
                     if k.startswith(_PARAMS_PREFIX)]
            if not saved:
                raise ValueError(f"checkpoint {path} has no '{_PARAMS_PREFIX}' leaves — not a "
                                 f"TrainState checkpoint")
            if len(saved) != len(names):
                raise ValueError(
                    f"checkpoint {path}: {len(saved)} saved params leaves don't match the "
                    f"template's {len(names)} — the model flags (--dim/--heads/--num_layers/"
                    f"--num_experts...) must equal the training run's")
            flat = {n: shards.get(_key_path(_PARAMS_PREFIX, n)) for n in names}
            read = sum(shards.nbytes(i) for i in saved)
            info = {"format": "sharded", "bytes_read": read,
                    "bytes_skipped": sum(shards.nbytes(i) for i in shards.blocks) - read,
                    "leaves_read": len(saved),
                    "leaves_skipped": len(shards.manifest["paths"]) - len(saved)}
        finally:
            shards.close()
    elif path.suffix == ".pt":
        payload = load(path)
        flat = dict(zip(paths(payload["params"]), leaves(payload["params"])))
        info = {"format": "pt", "bytes_read": path.stat().st_size, "bytes_skipped": 0,
                "leaves_read": len(flat),
                "leaves_skipped": _count_leaves(payload["opt_state"]["state"]) + 1}
    else:
        raw, nbytes = _read_consolidated(path)
        flat = dict(zip(paths(raw["params"]), leaves(raw["params"])))
        info = {"format": "consolidated", "bytes_read": nbytes, "bytes_skipped": 0,
                "leaves_read": len(names),
                "leaves_skipped": _count_leaves(raw) - len(names)}
    if set(flat) != set(names):
        raise ValueError(
            f"checkpoint {path}: its parameter tree differs from the model's (missing "
            f"{sorted(set(names) - set(flat))[:4]}, extra {sorted(set(flat) - set(names))[:4]})"
            f" — the model flags (--dim/--heads/--num_layers/--num_experts...) must equal the "
            f"training run's")
    out = [_fit_shape(path, n, flat[n], want[n]).to(device) for n in names]
    return unflatten(template, out), info


# ------------------------------------------------- verify and latest --------


def verify_checkpoint(path) -> tuple[bool, str]:
    """tpukit's integrity check (:299-355), (ok, detail). A file: its sha256
    against its sidecar; no sidecar is accepted as unverified legacy (so is
    the port's `.pt`, which has none). A directory: the manifest, every
    shard file of its world, their checksums, and the blocks' geometry.
    Never raises on I/O."""
    path = Path(path)
    if path.is_dir():
        try:
            manifest = json.loads((path / "manifest.json").read_text())
        except (OSError, ValueError) as exc:
            return False, f"missing/unreadable manifest ({exc})"
        files = _shard_files(path, manifest.get("nprocs", 0))
        missing = [f.name for f in files if not f.exists()]
        if missing:
            return False, f"missing shard files {missing}"
        checksums = manifest.get("checksums")
        if checksums is not None:
            for f in files:
                want = checksums.get(f.name)
                if want is None:
                    return False, f"manifest has no checksum for {f.name}"
                try:
                    got = _sha256_file(f)
                except OSError as exc:
                    return False, f"unreadable shard {f.name} ({exc})"
                if got != want:
                    return False, f"checksum mismatch in {f.name}"
        geo = _check_shard_geometry(files, manifest)
        if geo is not None:
            return False, geo
        if checksums is None:
            return True, "unverified (manifest has no checksums; legacy)"
        return True, "verified"
    if not path.exists():
        return False, "missing file"
    side = checksum_sidecar(path)
    if not side.exists():
        return True, "unverified (no checksum sidecar; legacy)"
    try:
        want = side.read_text().strip()
    except OSError as exc:
        return False, f"unreadable checksum sidecar ({exc})"
    try:
        got = _sha256_file(path)
    except OSError as exc:
        return False, f"unreadable checkpoint ({exc})"
    if got != want:
        return False, "checksum mismatch"
    return True, "verified"


def _newest_good(candidates, verify: bool) -> Path | None:
    for path in sorted(candidates, key=lambda p: (_step_of(p), p.name), reverse=True):
        if not verify:
            return path
        ok, detail = verify_checkpoint(path)
        if ok:
            return path
        warnings.warn(f"skipping corrupt checkpoint {path}: {detail} — resuming from the "
                      f"next older good one instead", stacklevel=3)
    return None


def latest(directory=CHECKPOINT_DIR, verify: bool = True) -> Path | None:
    """The newest consolidated checkpoint that verifies (corrupt ones are
    skipped with a warning)."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    return _newest_good(directory.glob("checkpoint-*.msgpack"), verify)


def latest_sharded(directory=CHECKPOINT_DIR, verify: bool = True) -> Path | None:
    """The newest published sharded checkpoint that verifies."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    return _newest_good((p for p in directory.glob("*.sharded")
                         if p.is_dir() and (p / "manifest.json").exists()), verify)


def latest_pt(directory=CHECKPOINT_DIR) -> Path | None:
    """The newest of the port's `.pt` checkpoints (they have no sidecar)."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    return _newest_good(directory.glob("checkpoint-*.pt"), verify=False)


def latest_any(directory=CHECKPOINT_DIR, verify: bool = True) -> Path | None:
    """The newest good checkpoint of any format, by training step."""
    found = [p for p in (latest(directory, verify), latest_sharded(directory, verify),
                         latest_pt(directory)) if p]
    return max(found, key=lambda p: (_step_of(p), p.name)) if found else None


def all_checkpoints(directory=CHECKPOINT_DIR) -> list[Path]:
    """Every published checkpoint of the three formats, ascending by step
    (none verified: callers verify what they restore)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = list(directory.glob("checkpoint-*.msgpack")) + list(directory.glob("checkpoint-*.pt"))
    out += [p for p in directory.glob("*.sharded")
            if p.is_dir() and (p / "manifest.json").exists()]
    return sorted(out, key=lambda p: (_step_of(p), p.name))


def latest_good(directory=CHECKPOINT_DIR, max_step: int | None = None) -> Path | None:
    """The newest checkpoint that verifies with step <= `max_step` (the
    rollback target); corrupt ones are skipped with a warning."""
    for path in reversed(all_checkpoints(directory)):
        if max_step is not None and _step_of(path) > max_step:
            continue
        ok, detail = verify_checkpoint(path)
        if ok:
            return path
        warnings.warn(f"skipping corrupt checkpoint {path}: {detail} — resuming from the "
                      f"next older good one instead", stacklevel=2)
    return None


def prune_checkpoints(directory=CHECKPOINT_DIR, keep: int = 1,
                      assume_newest_verified: bool = False) -> list[str]:
    """`--keep_checkpoints K`: delete the published checkpoints older than
    the newest `keep` (with their sidecars); returns their names. A
    quarantined timeline matches no published name and is never touched;
    when none of the kept checkpoints verifies, the newest one that does is
    spared. `assume_newest_verified` skips verifying the kept ones (the
    trainer prunes right after its own publish). Rank 0 only; a failed
    deletion is skipped."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    candidates = all_checkpoints(directory)
    doomed, kept = candidates[:-keep], candidates[-keep:]
    if not doomed:
        return []
    if not assume_newest_verified and not any(verify_checkpoint(p)[0] for p in reversed(kept)):
        for p in reversed(doomed):
            if verify_checkpoint(p)[0]:
                doomed = [d for d in doomed if d != p]
                break
    removed = []
    for path in doomed:
        try:
            if path.is_dir():
                shutil.rmtree(path)
            else:
                path.unlink()
                for side in sidecars(path):
                    side.unlink(missing_ok=True)
        except OSError:
            continue
        removed.append(path.name)
    return removed
