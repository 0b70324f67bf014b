"""Runtime initialisation and the device meshes (twin of `tpukit/mesh.py`:
`initialize_runtime` :24, `is_process_zero` :139, `create_mesh` :144,
`sync_global_devices` :187): a 1-D `data` mesh for DDP and FSDP, a 2-D
`(data, stage)` one for the pipeline, a 2-D `(data, model)` one for
tensor parallelism and the serving grid, a 2-D `(data, seq)` one for
context parallelism and a 2-D `(data, expert)` one for expert parallelism.

tpukit's runtime owns its devices and builds a `jax.sharding.Mesh`; the port
brings up a c10d default process group and a `DeviceMesh` over it. The group
comes from, in this order:

  - an existing default group, reused as it is;
  - an explicit `(address, world_size, rank)`, e.g. `tcp://localhost:29500`;
  - a launcher's environment (`torchrun`: `MASTER_ADDR`, `MASTER_PORT`,
    `WORLD_SIZE`, `RANK`, `LOCAL_RANK`);
  - otherwise a world of one over an in-process `HashStore`.

The backend is NCCL for `cuda` and gloo for `cpu`. Rank r binds
`cuda:{LOCAL_RANK}`. Nothing here falls back to gloo on the CPU when a card
was asked for: the device comes from `tpukit_torch.resolve_device`.

A fleet replica over a model-parallel grid is a world of its own
(`initialize_subset_world`): its ranks meet at an explicit address, and
rank r binds the r-th device of the replica's subset of `device_list`.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpukit_torch import resolve_device


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_runtime(device=None, address: str | None = None,
                       world_size: int | None = None, rank: int | None = None) -> torch.device:
    """Bring up (or reuse) the default process group; returns the device
    this rank computes on (`cuda:{LOCAL_RANK}` or `cpu`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend_for(dev):
            raise RuntimeError(f"the default process group runs {dist.get_backend()}, and "
                               f"{dev.type} needs {backend_for(dev)}")
        return dev
    explicit = (address, world_size, rank)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("pass address, world_size and rank together, got "
                             f"{address!r}, {world_size!r}, {rank!r}")
        dist.init_process_group(backend_for(dev), init_method=address,
                                world_size=world_size, rank=rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend_for(dev))  # env://, the launcher's rendezvous
    else:
        dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def device_list(device) -> list[torch.device]:
    """The devices a fleet carves into replica subsets (the port's
    `jax.devices()`): every card for `cuda`; for `cpu`, as many CPU entries
    as `TPUKIT_CPU_DEVICES` says (tpukit's variable, `tpukit/__init__.py:21-30`),
    one without it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * int(os.environ.get("TPUKIT_CPU_DEVICES") or 1)


def subset_backend(devices) -> str:
    """The backend of a world over `devices`, one rank each: NCCL over
    distinct cards; gloo on the CPU and where a card repeats (NCCL refuses
    two ranks on one card)."""
    devices = [torch.device(d) for d in devices]
    cards = [d for d in devices if d.type == "cuda"]
    return "nccl" if cards and len(set(cards)) == len(devices) else "gloo"


def initialize_subset_world(address: str, devices, rank: int, timeout_s: float) -> torch.device:
    """Bring up this process's default group as rank `rank` of a world of
    its own over `devices` (one rank a device, `subset_backend`'s backend),
    meeting at `address` (e.g. `file://<fresh path>`). The rank binds
    `devices[rank]`, not `cuda:{LOCAL_RANK}`, and sets it as the current
    device before anything is built or launched. A collective that waits
    longer than `timeout_s` raises. Returns the device."""
    devices = [torch.device(d) for d in devices]
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(subset_backend(devices), init_method=address,
                            world_size=len(devices), rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shutdown_runtime() -> None:
    """Destroy the default group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def scoped_runtime():
    """On exit, destroy a default group brought up inside the block; one
    that existed before it stays up (a caller's, reused)."""
    existed = dist.is_initialized()
    try:
        yield
    finally:
        if not existed:
            shutdown_runtime()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_process_zero() -> bool:
    """Twin of the reference's `rank == 0` gating of prints, samples and
    the checkpoint write."""
    return rank() == 0


def create_mesh(axes: dict[str, int] | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D `data` mesh over the default group's ranks: `{"data": -1}`
    (or None) takes every rank, `{"data": n}` needs n to be the world."""
    world = world_size()
    axes = {"data": -1} if axes is None else axes
    if set(axes) != {"data"}:
        raise ValueError(f"the port's mesh has one axis, 'data'; got {axes}")
    size = world if axes["data"] == -1 else axes["data"]
    if size != world:
        raise ValueError(f"mesh {axes} needs {size} ranks, the world has {world}")
    return init_device_mesh(device_type, (size,), mesh_dim_names=("data",))


def create_pipeline_mesh(data: int = 1, stage: int | None = None,
                         device_type: str = "cuda") -> DeviceMesh:
    """A 2-D `(data, stage)` mesh over the default group's ranks, stages
    innermost (tpukit `main-pipe-ddp.py` `pick_grid`): rank r sits at data
    index r // stage and stage r % stage. `stage` defaults to world / data;
    `data * stage` must be the world."""
    world = world_size()
    stage = world // data if stage is None else stage
    if data < 1 or stage < 1 or data * stage != world:
        raise ValueError(f"a (data {data}, stage {stage}) pipeline grid needs {data * stage} "
                         f"ranks, the world has {world}")
    return init_device_mesh(device_type, (data, stage), mesh_dim_names=("data", "stage"))


def create_tp_mesh(data: int = 1, model: int | None = None, device_type: str = "cuda",
                   idle_ok: bool = False) -> DeviceMesh:
    """A 2-D `(data, model)` mesh over the default group's ranks, `model`
    innermost (tpukit `main-tp.py:14-16`): rank r sits at data index
    r // model and model index r % model, so a model group is consecutive
    ranks. `model` defaults to world / data; `data * model` must be the
    world, or with `idle_ok` (a serving grid that leaves ranks idle, as
    tpukit's leaves devices) at most the world: the mesh then spans ranks
    `[0, data * model)` and the others hold no coordinate
    (`get_coordinate()` is None). Every rank of the world calls it.
    `get_group("model")` and `get_group("data")` are its groups."""
    world = world_size()
    model = world // data if model is None else model
    used = data * model
    if data < 1 or model < 1 or used > world or (used < world and not idle_ok):
        raise ValueError(f"a (data {data}, model {model}) grid needs {used} ranks, "
                         f"the world has {world}")
    if used == world:
        return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    return DeviceMesh(device_type, torch.arange(used).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def create_cp_mesh(data: int = 1, seq: int | None = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A 2-D `(data, seq)` mesh over the default group's ranks, `seq`
    innermost (tpukit's `create_mesh({"data": d, "seq": s})` order): rank
    r sits at data index r // seq and sequence index r % seq. `seq`
    defaults to world / data; `data * seq` must be the world."""
    world = world_size()
    seq = world // data if seq is None else seq
    if data < 1 or seq < 1 or data * seq != world:
        raise ValueError(f"a (data {data}, seq {seq}) grid needs {data * seq} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, (data, seq), mesh_dim_names=("data", "seq"))


def create_ep_mesh(data: int = 1, expert: int | None = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A 2-D `(data, expert)` mesh over the default group's ranks, `expert`
    innermost (`main-moe.py:50-51`'s `create_mesh({"data": d, "expert":
    e})`): rank r sits at data index r // expert and expert index r %
    expert, so an expert group is consecutive ranks, and a batch's rows
    split over both axes in that order go to the ranks in rank order.
    `expert` defaults to world / data; `data * expert` must be the world.
    `get_group("expert")` and `get_group("data")` are its groups; the whole
    grid is the default group."""
    world = world_size()
    expert = world // data if expert is None else expert
    if data < 1 or expert < 1 or data * expert != world:
        raise ValueError(f"a (data {data}, expert {expert}) grid needs {data * expert} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, (data, expert), mesh_dim_names=("data", "expert"))


def stage_neighbours(mesh: DeviceMesh) -> tuple[int, int]:
    """The global ranks of this rank's previous and next stage in its data
    replica's stage ring (`(s - 1) % S`, `(s + 1) % S`), the peers of its
    point-to-point sends."""
    ranks = dist.get_process_group_ranks(mesh.get_group("stage"))
    s = mesh.get_local_rank("stage")
    return ranks[(s - 1) % len(ranks)], ranks[(s + 1) % len(ranks)]


def sync_global_devices() -> None:
    """A barrier across the world (twin of `dist.barrier()`); nothing
    without a process group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
