"""Fleet replicas over a model-parallel grid (`FleetConfig.devices_per_replica`
above 1; twin of tpukit's subset meshes, `tpukit/serve/fleet.py:343-365,
437-469`).

tpukit's router drives each replica's subset mesh from its own process. The
port serves a grid as one process a device over c10d (`serve/__main__.py`),
so here a grid replica is a world of its own: D rank processes (`python -m
tpukit_torch.serve.replica_world`), rank r on the r-th device of the
replica's subset (`mesh.initialize_subset_world`: NCCL over distinct cards,
gloo where a card repeats and on the CPU). Each rank holds a `ServeEngine`
on `mesh.create_tp_mesh` over `pick_serve_grid(D, heads, slots, paged)`,
with its `TensorParallel` shard of the parameters; ranks the grid leaves
idle (a paged grid's model degree is capped by the heads) follow the
command loop and hold no engine. The router never joins a replica's world,
so a grid fleet also runs inside an outer `torchrun` world. It drives each
world through a `GridReplica`, a handle with the surface of the engine it
drives in-process.

  - **Lockstep.** The router pickles each command once and sends it to
    every rank over the rank's own socket, so every rank applies the same
    admit batch at the same clock and enters the same collectives in the
    same order. Rank 0 replies with the engine's host state
    (`ServeEngine.host_state`), which the handle's properties read. A
    quantum's dispatch and a paged poll return without waiting, so the
    router dispatches every world's quantum before it syncs any; a read of
    the handle's state waits for the replies it is owed.
  - **Parameters.** The host copy is written once into an anonymous
    shared-memory file (`HostParams`, a `memfd`) that every rank maps; no
    command carries parameters.
  - **Telemetry.** The engine gives its planes to the grid's first rank only
    (`engine.py`'s rule). Rank 0's logger, recorder, tracer and metrics are
    relays: every call is kept and replayed on the router's planes with the
    next reply, so the replica's `kind="serve"` windows, flight-recorder
    rows, trace events and metric observations reach the router's as a
    meshless replica's do. The relayed tracer keeps the router's clock
    (its `epoch` travels with every command; `perf_counter` is the host's
    monotonic clock, checked to be one across processes when a world
    starts), and asks the router for the shared tracer's snapshot where the
    engine reads it.
  - **Failures.** A rank that exits, a channel that closes or a reply that
    does not come within `REPLY_TIMEOUT_S` makes the handle kill the world
    and raise `ReplicaWorldError`, naming the replica and carrying each
    rank's log tail; nothing falls back to a meshless replica or the CPU. A
    rank whose router is gone reads EOF on its socket and exits.
  - **The page handoff** into a grid replica is one command
    (`adopt_handoff`): on every rank the claim of the prefix pages, the
    allocation, the write of that rank's heads of the block and
    `adopt_prefilled`, in lockstep (`adopt_block`, which the router runs
    itself for an in-process destination). A grid prefill worker gathers its pages'
    heads to rank 0 (`read_pages`).

Run as a module, this file is one rank: `python -m
tpukit_torch.serve.replica_world SOCKET_FD MEMFD`, started by `GridReplica`.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import Connection
from pathlib import Path

import torch

# seconds a rank may take to reply, or a collective to complete
REPLY_TIMEOUT_S = 600.0
# seconds a closing world's ranks may take to exit before they are killed
EXIT_TIMEOUT_S = 60.0
_LOG_TAIL = 4000  # characters of each rank's log an error carries

# commands every rank replies to; rank 0 alone replies to the others
_ALL_RANKS = ("init", "exit")


class ReplicaWorldError(RuntimeError):
    """A grid replica's world failed: a rank exited, a channel closed, or a
    reply did not come in time. The message names the replica and carries
    its ranks' log tails."""


class HostParams:
    """ONE host copy of the parameters in an anonymous shared-memory file
    (`os.memfd_create`), which every rank of every grid world maps: each
    leaf's bytes at an offset aligned to 64, listed in `layout` as `(path,
    dtype, shape, offset, bytes)`. `close` releases the router's file; a
    rank's mapping outlives it."""

    def __init__(self, params: dict):
        from tpukit_torch.shardings import leaves, paths

        flat = [(name, leaf.detach().to("cpu").contiguous().reshape(-1))
                for name, leaf in zip(paths(params), leaves(params))]
        self.layout, off = [], 0
        for (name, t), leaf in zip(flat, leaves(params)):
            n = t.numel() * t.element_size()
            self.layout.append((name, str(t.dtype).removeprefix("torch."), tuple(leaf.shape),
                                off, n))
            off = -(-(off + n) // 64) * 64
        self.size = max(off, 1)
        self.fd = os.memfd_create("tpukit-host-params")
        os.ftruncate(self.fd, self.size)
        with mmap.mmap(self.fd, self.size) as mm:
            view = torch.frombuffer(mm, dtype=torch.uint8)
            for (_, t), (_, _, _, off, n) in zip(flat, self.layout):
                view[off: off + n].copy_(t.view(torch.uint8))
            del view

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def load_params(fd: int, size: int, layout, device: torch.device) -> dict:
    """A rank's copy of the parameters from the router's `HostParams` file,
    on `device`: the nested tree of `layout`'s paths."""
    tree: dict = {}
    with mmap.mmap(fd, size, access=mmap.ACCESS_COPY) as mm:
        view = torch.frombuffer(mm, dtype=torch.uint8)
        for name, dtype, shape, off, n in layout:
            t = view[off: off + n].view(getattr(torch, dtype)).reshape(shape)
            node = tree
            *parents, leaf = name.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = t.to(device) if device.type == "cuda" else t.clone()
            del t
        del view
    return tree


# ---- the router's side -------------------------------------------------------


@dataclasses.dataclass
class LaneView:
    """A grid replica's lane as its router reads it (the fields of
    `engine._Lane` that the handoff and the requeue use)."""

    req: object
    phase: str
    pages: list
    prefill_end: int
    prompt_len: int
    admit_s: float
    key: object


class _Spans:
    def __init__(self, handle):
        self._handle = handle

    def epoch(self) -> dict:
        """The rank-0 engine's `SpanTimeline.epoch()`."""
        return self._handle._call("spans_epoch")


class _Allocator:
    """The rank-0 allocator's stats, as of the last reply."""

    def __init__(self, handle):
        self._handle = handle

    @property
    def stats(self):
        return self._handle._read("stats")


class GridReplica:
    """A fleet replica served by a world of `len(devices)` rank processes,
    one a device of `devices`, over the `(data, model)` grid `grid`
    (`pick_serve_grid`'s). It has the surface of `ServeEngine` that
    `FleetRouter` drives (`admit`, `poll_prefill`, `dispatch_decode`, `sync`,
    `finish`, `requeue_live`, `completions`, the counters, `last_summary`,
    `spans`, `stuck_rids`, `replica`, `device`), plus the handoff's
    `adopt_handoff`, `read_pages`, `release_lane` and `_lanes`. The world
    starts in the constructor without being waited for: the first read
    waits for every rank's start-up reply. `close` ends and reaps it."""

    def __init__(self, replica, devices, host: HostParams, cfg, serve, eos_id: int, grid: dict,
                 *, logger=None, recorder=None, tracer=None, metrics=None):
        self.replica = replica
        self.devices = [_indexed(d) for d in devices]
        self.device = self.devices[0]
        self.serve = serve
        self._grid = dict(grid)  # the axes the ranks report at start-up replace these
        self.completions: list = []
        self.rank_launches: list | None = None  # each rank's kernel launches, at close
        self.spans = _Spans(self)
        self.allocator = _Allocator(self)
        self._planes = dict(logger=logger, recorder=recorder, tracer=tracer, metrics=metrics)
        self._reqs: dict = {}  # rid -> the Request the router sent
        self._state: dict = {}
        self._stuck: set = set()
        self._result = None
        self._owed: list[str] = []  # the commands whose replies are owed, in order
        self._closed = False
        self._dir = Path(tempfile.mkdtemp(prefix=f"tpukit-replica-{replica}-"))
        self._logs = [self._dir / f"rank{r}.log" for r in range(len(self.devices))]
        self._procs, self._conns = [], []
        env = _rank_env()
        init = dict(replica=replica, devices=[str(d) for d in self.devices], grid=self._grid,
                    store=f"file://{self._dir / 'store'}", cfg=cfg, serve=serve,
                    eos_id=int(eos_id), layout=host.layout, size=host.size,
                    planes=[k for k, v in self._planes.items() if v is not None],
                    threads=torch.get_num_threads(), timeout=REPLY_TIMEOUT_S)
        try:
            for r in range(len(self.devices)):
                mine, theirs = socket.socketpair()
                with open(self._logs[r], "wb") as log:
                    self._procs.append(subprocess.Popen(
                        [sys.executable, "-m", "tpukit_torch.serve.replica_world",
                         str(theirs.fileno()), str(host.fd)],
                        pass_fds=(theirs.fileno(), host.fd), stdin=subprocess.DEVNULL,
                        stdout=log, stderr=subprocess.STDOUT, env=env))
                theirs.close()
                self._conns.append(Connection(mine.detach()))
            self._t_sent = time.perf_counter()
            for r, conn in enumerate(self._conns):
                conn.send_bytes(pickle.dumps(dict(init, rank=r)))
        except BaseException:
            self._kill()
            raise
        self._owed.append("init")

    # -- the engine's surface -------------------------------------------------

    def ready(self) -> None:
        """Wait for the world's start: every rank's start-up reply."""
        self._drain()

    @property
    def grid(self) -> dict:
        """The `(data, model)` axes of the world's mesh, as its ranks built it."""
        self.ready()
        return self._grid

    @property
    def free_slots(self) -> int:
        return self._read("free_slots")

    @property
    def free_pages(self) -> int:
        return self._read("free_pages")

    @property
    def live_lanes(self) -> int:
        return self._read("live_lanes")

    @property
    def decoding_lanes(self) -> int:
        return self._read("decoding_lanes")

    @property
    def generated_tokens(self) -> int:
        return self._read("generated_tokens")

    @property
    def admitted(self) -> int:
        return self._read("admitted")

    @property
    def steps(self) -> int:
        return self._read("steps")

    @property
    def prefill_dispatches(self) -> int:
        return self._read("prefill_dispatches")

    @property
    def last_summary(self) -> dict | None:
        return self._read("last_summary")

    @property
    def _lanes(self) -> dict:
        return {slot: LaneView(self._reqs[rid], *rest)
                for slot, rid, *rest in self._read("lanes")}

    @property
    def stuck_rids(self) -> set:
        return self._stuck

    @stuck_rids.setter
    def stuck_rids(self, rids) -> None:
        self._stuck = set(rids)
        self._post("stuck", sorted(self._stuck))

    def admit(self, reqs: list, now: float) -> list:
        """The engine's `admit`. The ring takes up to its free slots (the
        command is not waited for); a paged pool decides on the ranks."""
        reqs = list(reqs)
        if not self.serve.paged:
            take = reqs[: self.free_slots]
            if take:
                self._keep(take)
                self._post("admit", take, now)
            return reqs[len(take):]
        self._keep(reqs)
        left = self._call("admit", reqs, now)
        return reqs[len(reqs) - left:]

    def poll_prefill(self, now: float) -> None:
        if self.serve.paged:  # the ring prefills at admission
            self._post("poll_prefill", now)

    def dispatch_decode(self) -> bool:
        if not self.decoding_lanes:
            return False
        self._post("dispatch")
        return True

    def sync(self, now: float) -> None:
        self._call("sync", now)

    def finish(self, wall_s: float) -> list:
        self._call("finish", wall_s)
        return self.completions

    def requeue_live(self) -> list:
        return sorted((lane.req for lane in self._lanes.values()), key=lambda r: r.rid)

    def release_lane(self, slot: int) -> None:
        self._post("release_lane", slot)

    def adopt_handoff(self, req, prompt_len: int, block: dict, admit_s: float, now: float,
                      key):
        """Arm a decode lane from a prefilled block of `len(block pages)`
        written pages (CPU tensors, every head): on every rank, claim the
        registered prefix, allocate the rest, write that rank's heads of the
        remaining pages and `adopt_prefilled`. Returns `(pages copied,
        claim seconds, copy seconds)`, or None, changing nothing, when the
        pool cannot cover the request."""
        self._keep([req])
        return self._call("adopt", req, prompt_len, block, admit_s, now, key)

    def read_pages(self, ids) -> dict:
        """The K/V (and scale) rows of pages `ids`, every head, on the CPU."""
        return self._call("read_pages", list(ids))

    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def close(self) -> None:
        """End the world: each rank reports its kernel launches
        (`rank_launches`) and exits; a rank that does not exit within
        `EXIT_TIMEOUT_S` is killed. Every rank process is reaped."""
        if self._closed:
            return
        try:
            self._drain()
            self._post("exit")
            self._drain(EXIT_TIMEOUT_S)
            for p in self._procs:
                p.wait(timeout=EXIT_TIMEOUT_S)
        except (ReplicaWorldError, subprocess.TimeoutExpired):
            pass
        finally:
            self._kill()

    # -- the channel ------------------------------------------------------------

    def _keep(self, reqs) -> None:
        for req in reqs:
            self._reqs[req.rid] = req

    def _read(self, key: str):
        self._drain()
        return self._state[key]

    def _post(self, op: str, *args) -> None:
        """Send `op` to every rank; its reply is owed."""
        if self._closed:
            raise ReplicaWorldError(f"replica {self.replica}: its world is closed")
        self._check_ranks()
        tracer = self._planes["tracer"]
        msg = pickle.dumps((op, args, None if tracer is None else tracer.epoch))
        for r, conn in enumerate(self._conns):
            try:
                conn.send_bytes(msg)
            except OSError as exc:
                self._fail(f"rank {r}'s channel failed on {op!r}: {exc!r}")
        self._owed.append(op)

    def _call(self, op: str, *args):
        self._post(op, *args)
        return self._drain()

    def _drain(self, timeout_s: float | None = None):
        """Read every reply owed, in order; returns the last one's result
        (rank 0's)."""
        while self._owed:
            op = self._owed.pop(0)
            results = []
            for r in range(len(self._conns)) if op in _ALL_RANKS else (0,):
                status, result, state, calls = self._recv(r, op, timeout_s)
                if status != "ok":
                    self._fail(f"rank {r} failed on {op!r}:\n{result}")
                results.append(result)
                if r == 0:
                    self._replay(calls)
                    if state is not None:
                        self.completions.extend(state.pop("completions"))
                        self._state = state
            self._result = results[0]
            if op == "init":
                if not self._t_sent <= self._result["clock"] <= time.perf_counter():
                    self._fail("time.perf_counter is not one clock across this host's "
                               "processes, so the tracer's run clock cannot be shared")
                self._grid = self._result["grid"]
            elif op == "exit":
                self.rank_launches = results
        return self._result

    def _recv(self, r: int, op: str, timeout_s: float | None = None) -> tuple:
        conn = self._conns[r]
        limit = REPLY_TIMEOUT_S if timeout_s is None else timeout_s
        deadline = time.monotonic() + limit
        while True:
            if conn.poll(0.05):
                try:
                    msg = pickle.loads(conn.recv_bytes())
                except (EOFError, OSError):
                    msg = None
                if msg is None:
                    self._fail(f"rank {r} closed its channel during {op!r}")
                if msg[0] == "ask":  # rank 0's tracer reads the shared tracer
                    self._answer(conn, *msg[1:])
                    continue
                return msg
            if op != "exit":
                self._check_ranks(op)
            if time.monotonic() > deadline:
                self._fail(f"no reply from rank {r} to {op!r} within {limit} s")

    def _answer(self, conn, what: str, calls) -> None:
        self._replay(calls)
        tracer = self._planes["tracer"]
        value = tracer.snapshot() if what == "snapshot" else tracer.dropped_by_replica
        conn.send_bytes(pickle.dumps(value))

    def _replay(self, calls) -> None:
        for plane, method, args, kwargs in calls:
            getattr(self._planes[plane], method)(*args, **kwargs)

    def _check_ranks(self, op: str | None = None) -> None:
        for r, p in enumerate(self._procs):
            if p.poll() is not None:
                self._fail(f"rank {r} exited with code {p.returncode}"
                           + (f" during {op!r}" if op else ""))

    def _fail(self, why: str):
        """Kill the world and raise, with each rank's exit code (before the
        kill; a rank that is failing gets a moment to exit) and log tail."""
        codes = []
        for p in self._procs:
            try:
                codes.append(p.wait(timeout=2.0))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._reap()
        tails = []
        for r, (path, code) in enumerate(zip(self._logs, codes)):
            text = path.read_text(errors="replace") if path.exists() else ""
            tails.append(f"--- rank {r} ({self.devices[r]}, "
                         + ("running" if code is None else f"exit code {code}")
                         + f") log tail ---\n{text[-_LOG_TAIL:]}")
        self._kill()
        raise ReplicaWorldError(f"replica {self.replica} (world over "
                                f"{[str(d) for d in self.devices]}): {why}\n" + "\n".join(tails))

    def _reap(self) -> None:
        """Kill every rank still running, and wait for every rank."""
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()

    def _kill(self) -> None:
        """Kill and reap every rank still running; drop the channels and
        the world's directory (the store and the logs)."""
        self._closed = True
        self._reap()
        for conn in self._conns:
            conn.close()
        self._conns = []
        self._owed = []
        shutil.rmtree(self._dir, ignore_errors=True)


def _indexed(device) -> torch.device:
    """`device`, a card with its index: a rank process has no current card
    to take for a bare `cuda`."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _rank_env() -> dict:
    """A rank's environment: this process's, with the repository on the path
    and no launcher's rendezvous (a rank's world is its own)."""
    root = str(Path(__file__).resolve().parents[2])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT", "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env["PYTHONUNBUFFERED"] = "1"  # a killed rank's log is whole
    return env


# ---- a rank's side -----------------------------------------------------------


class _Relay:
    """A telemetry plane on rank 0 (logger, recorder, metrics): each call
    is kept, in order, for the router to replay on its own plane."""

    def __init__(self, plane: str, calls: list):
        self._plane, self._calls = plane, calls

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, **kwargs):
            self._calls.append((self._plane, method, args, kwargs))
        return call


class _TraceRelay:
    """Rank 0's tracer: events are kept for the router's tracer, `now()`
    runs on the router's epoch, and the reads the engine makes of the
    shared tracer (`snapshot`, `dropped_by_replica`) are asked of the
    router, after the events kept so far are handed over."""

    def __init__(self, calls: list, conn: Connection):
        self._calls, self._conn = calls, conn
        self.epoch: float | None = None

    def now(self) -> float:
        if self.epoch is None:
            self.epoch = time.perf_counter()
        return time.perf_counter() - self.epoch

    def emit(self, ev: str, trace: int, **fields) -> None:
        self._calls.append(("tracer", "emit", (ev, trace), fields))

    def _ask(self, what: str):
        self._conn.send_bytes(pickle.dumps(("ask", what, list(self._calls))))
        self._calls.clear()
        return pickle.loads(self._conn.recv_bytes())

    def snapshot(self) -> list:
        return self._ask("snapshot")

    @property
    def dropped_by_replica(self) -> dict:
        return self._ask("dropped_by_replica")


def launch_counts() -> dict:
    """This process's kernel launches: each kernel module's `launches`, by
    the module's name."""
    from tpukit_torch.ops import flash_attention, fused_head_ce, moe_gemm, paged_attention

    return {mod.__name__.rsplit(".", 1)[1]: dict(mod.launches)
            for mod in (paged_attention, flash_attention, fused_head_ce, moe_gemm)}


def _pool_keys(engine) -> list[str]:
    return [k for k in ("k", "v", "ks", "vs") if k in engine.cache]


def read_block(engine, ids) -> dict:
    """Pages `ids` of this rank's pools with every head of its model group
    (gathered over it, as bytes), on the CPU."""
    import torch.distributed as dist

    from tpukit_torch.serve import paged as paged_lib

    idx = torch.tensor(list(ids), dtype=torch.long, device=engine.device)
    tp = engine.cfg.tp
    out = {}
    for key in _pool_keys(engine):
        part = paged_lib.extract_pages(engine.cache[key], idx).contiguous()
        if tp is not None and tp.size > 1:
            raw = part.view(torch.uint8)
            parts = [torch.empty_like(raw) for _ in range(tp.size)]
            dist.all_gather(parts, raw, group=tp.group)
            part = torch.cat(parts, dim=2).view(part.dtype)
        out[key] = part.cpu()
    return out


def adopt_block(engine, req, prompt_len: int, block: dict, admit_s: float, now: float, key):
    """The destination's half of a handoff, into an in-process engine
    (`FleetRouter._adopt`) or on one rank of a grid world
    (`GridReplica.adopt_handoff`): claim the pages the registry already
    holds for the request's prefix (refcounted, so pool pressure cannot
    reclaim them under this reader), allocate the rest of its footprint,
    write this engine's heads of the block's remaining pages and
    `adopt_prefilled`. `block` holds the written pages, every head, on any
    device. Returns `(pages copied, claim seconds, copy seconds)`, or None,
    changing nothing, when the pool cannot cover the request."""
    from tpukit_torch.serve import paged as paged_lib

    t0 = time.perf_counter()
    p = engine.serve.page_size
    matched = engine.allocator.lookup_prefix(req.ids, (prompt_len - 1) // p)
    engine.allocator.claim(matched)
    limit = min(prompt_len + req.max_new_tokens, engine.serve.width)
    fresh = engine.allocator.alloc(-(-limit // p) - len(matched))
    if fresh is None:
        engine.allocator.release(matched)
        return None
    c0 = time.perf_counter()
    written = next(iter(block.values())).shape[1]
    ids = fresh[: written - len(matched)]
    if ids:
        cfg = engine.cfg
        first = cfg.tp.rank * cfg.local_heads if cfg.tp is not None and cfg.heads_split else 0
        idx = torch.tensor(ids, dtype=torch.long, device=engine.device)
        for name in _pool_keys(engine):
            part = block[name][:, len(matched):written].narrow(2, first, cfg.local_heads)
            paged_lib.insert_pages(engine.cache[name], idx, part.to(engine.device))
    c1 = time.perf_counter()
    engine.adopt_prefilled(req, list(matched) + list(fresh), len(matched), admit_s, now, key)
    return written - len(matched), c0 - t0, c1 - c0


def _serve_rank(conn: Connection, mem_fd: int) -> int:
    import torch.distributed as dist

    from tpukit_torch import mesh as mesh_lib
    from tpukit_torch import resolve_device
    from tpukit_torch.serve.engine import ServeEngine
    from tpukit_torch.shardings import TensorParallel

    init = pickle.loads(conn.recv_bytes())
    rank, devices = init["rank"], [torch.device(d) for d in init["devices"]]
    resolve_device(devices[rank].type)
    if devices[rank].type == "cpu":
        torch.set_num_threads(init["threads"])
    device = mesh_lib.initialize_subset_world(init["store"], devices, rank, init["timeout"])
    grid = init["grid"]
    grid_mesh = mesh_lib.create_tp_mesh(grid["data"], grid["model"], device.type, idle_ok=True)
    calls: list = []
    tracer = engine = None
    if grid_mesh.get_coordinate() is not None:  # an idle rank holds no engine
        strategy = TensorParallel(mesh=grid_mesh)
        strategy.validate_config(init["cfg"])
        params = strategy.setup(load_params(mem_fd, init["size"], init["layout"], device))
        planes = {}
        if rank == 0:
            for name in init["planes"]:
                planes[name] = _TraceRelay(calls, conn) if name == "tracer" else _Relay(name, calls)
            tracer = planes.get("tracer")
        engine = ServeEngine(params, init["cfg"], init["serve"], eos_id=init["eos_id"],
                             device=device, mesh=grid_mesh, replica=init["replica"], **planes)
        for dim in range(grid_mesh.ndim):  # each group's communicator is set up at start
            dist.all_reduce(torch.zeros(1, device=device), group=grid_mesh.get_group(dim))
    os.close(mem_fd)
    ops = {} if engine is None else dict(
        admit=lambda reqs, now: len(engine.admit(reqs, now)),
        poll_prefill=engine.poll_prefill,
        dispatch=engine.dispatch_decode,
        sync=engine.sync,
        finish=lambda wall: engine.finish(wall) and None,
        spans_epoch=engine.spans.epoch,
        stuck=lambda rids: setattr(engine, "stuck_rids", set(rids)),
        release_lane=engine.release_lane,
        adopt=lambda *args: adopt_block(engine, *args),
        read_pages=lambda ids: read_block(engine, ids),
    )
    reported = 0  # completions already sent
    op, result = "init", dict(grid=dict(data=grid_mesh.size(0), model=grid_mesh.size(1)),
                              clock=time.perf_counter())
    with torch.no_grad():
        while True:
            if rank == 0 or op in _ALL_RANKS:
                state = None
                if rank == 0:
                    state = engine.host_state(reported)
                    reported = len(engine.completions)
                conn.send_bytes(pickle.dumps(("ok", result, state, list(calls))))
                calls.clear()
            if op == "exit":
                dist.destroy_process_group()
                return 0
            try:
                data = conn.recv_bytes()
            except EOFError:  # the router is gone
                return 0
            op, args, epoch = pickle.loads(data)
            if tracer is not None and epoch is not None:
                tracer.epoch = epoch
            try:
                result = launch_counts() if op == "exit" else (
                    ops[op](*args) if engine is not None else None)
            except Exception:
                if rank == 0:
                    conn.send_bytes(pickle.dumps(("error", traceback.format_exc(), None, [])))
                raise


def main(argv=None) -> int:
    """One rank of a grid replica's world: `SOCKET_FD MEMFD` (see the module
    docstring)."""
    import faulthandler

    faulthandler.enable()  # a native crash leaves its stack in the rank's log
    argv = sys.argv[1:] if argv is None else argv
    return _serve_rank(Connection(int(argv[0])), int(argv[1]))


if __name__ == "__main__":
    sys.exit(main())
