"""The record of the c10d calls one step issued: the port's counterpart of
`tpukit/analysis/hlo_ir.py`.

tpukit audits the optimized HLO of a compiled step. The eager port compiles
nothing, so what it audits is the step itself as it ran: `record_comm()`
wraps `torch.distributed`'s functions for the length of a block and
appends one `CommCall` a call to a `CommTrace`. Each call carries:

  - `op`: tpukit's HLO name of the collective (`all-reduce`, `all-gather`,
    `reduce-scatter`, `all-to-all`, `collective-permute`, `broadcast`);
    the c10d function is kept as `fn`;
  - `dtype`: the payload's element type in HLO spelling (`f32`, `bf16`,
    `s8`, `s32`, ...);
  - `bytes`: tpukit's result-payload convention (`obs.xla.collective_bytes`):
    the output of a gather, a reduce-scatter and an all-to-all, the tensor
    of an all-reduce and a broadcast, the received buffer of a
    point-to-point receive;
  - `group`: the group's size, `async_op`, and the call's place in the
    step: the count of ATen ops the step had run when it was issued (and,
    for an async handle, when it was waited on), and whether it was issued
    from the backward.

Point-to-point traffic (`batch_isend_irecv`, `isend`, `irecv`: the
pipeline's stage hops, the context-parallel ring) is `collective-permute`,
as tpukit's HLO names a `ppermute`. A receive is one collective-permute
with the received bytes (its result); a send is recorded with op `send`
and counts as none, since its result is the peer's. Calls a wrapped
function makes to another (`batch_isend_irecv` to `isend`) are recorded
once, at the outer call.

The step's autograd work is counted by a `TorchDispatchMode` (`clock=True`):
every ATen op the step runs, and which of them run in the backward outside
a node that itself issued a collective (the wire's own quantize and pack).
From those, `CommTrace.backward_left(call)` is the model's backward work
still to run when the call was issued: what an eager step has left to hide
a collective behind (`rules.py`'s `overlap`). The CUDA kernels the port
launches through `ctypes` are not ATen ops; the allocations around them
are.

DDP's reducer calls its all-reduces from C++, out of this wrapper's reach:
`DataParallel` registers a comm hook that issues them through
`torch.distributed.all_reduce` (the default hook's arithmetic), so they are
recorded. DTensor's functional collectives (`full_tensor`, redistribution)
run as C++ ops and are not recorded; the port's steps call them only to
gather whole leaves for checkpoints and checksums.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as c10d
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
                  "all-to-all", "broadcast")

# c10d function -> tpukit's op name of its call (batch_isend_irecv: each op's)
_WRAPPED = {
    "all_reduce": "all-reduce",
    "broadcast": "broadcast",
    "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "all_gather": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "batch_isend_irecv": None,
    "isend": "send",
    "irecv": "collective-permute",
}
# the keyword of the result where FSDP2 passes keywords
_RESULT_KEYS = ("output_tensor", "output", "tensor", "output_tensor_list", "tensor_list")

_HLO_DTYPE = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16", torch.float64: "f64",
    torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
    torch.int64: "s64", torch.bool: "pred",
}

_ITEMSIZE = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "f16": 2, "bf16": 2, "s32": 4, "u32": 4,
             "f32": 4, "s64": 8, "u64": 8, "f64": 8}

# integer element types wide enough to be index plumbing (s8/u8 are
# quantized payloads, pred a mask), as tpukit's hlo_ir
INDEX_DTYPES = ("s32", "u32", "s64", "u64")


def itemsize(dtype: str) -> int | None:
    """Bytes per element of an HLO type name."""
    return _ITEMSIZE.get(dtype)


def hlo_dtype(t: torch.Tensor) -> str:
    """A tensor's element type in HLO spelling."""
    return _HLO_DTYPE.get(t.dtype, str(t.dtype).replace("torch.", ""))


@dataclass
class CommCall:
    """One c10d call of a step."""

    seq: int
    op: str
    fn: str
    dtype: str
    bytes: int
    group: int
    async_op: bool = False
    ops_at_issue: int = 0
    in_backward: bool = False
    ops_at_wait: int | None = None
    node: int | None = None  # the autograd node that issued it, in the backward

    @property
    def name(self) -> str:
        return f"{self.fn}#{self.seq}"


@dataclass
class CommTrace:
    """The calls of one recorded block, in issue order, and its op clock."""

    calls: list[CommCall] = field(default_factory=list)
    ops: int = 0  # ATen ops the block ran (0 without the clock)
    _bwd: list = field(default_factory=list)  # (op ordinal, node id) of backward ops
    # the nodes seen, kept alive so that no two share an id
    _nodes: dict = field(default_factory=dict)

    def node_id(self, node) -> int | None:
        if node is None:
            return None
        self._nodes.setdefault(id(node), node)
        return id(node)

    def collectives(self) -> list[CommCall]:
        """The calls with a result on this rank (sends excluded)."""
        return [c for c in self.calls if c.op in COLLECTIVE_OPS]

    def async_calls(self) -> list[CommCall]:
        return [c for c in self.collectives() if c.async_op]

    def backward_left(self, call: CommCall) -> int:
        """The model's backward ops still to run when `call` was issued: ops
        of the backward, outside every node that issued a collective, after
        the call's issue."""
        wire = {c.node for c in self.calls if c.node is not None}
        return sum(1 for ordinal, node in self._bwd
                   if ordinal > call.ops_at_issue and node not in wire)

    def backward_ops(self) -> int:
        wire = {c.node for c in self.calls if c.node is not None}
        return sum(1 for _, node in self._bwd if node not in wire)


def collective_summary(trace: CommTrace) -> dict[str, dict[str, int]]:
    """`{op: {count, bytes}}` over the calls with a result on this rank,
    tpukit's `hlo_ir.collective_summary` shape."""
    out: dict[str, dict[str, int]] = {}
    for c in trace.collectives():
        rec = out.setdefault(c.op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += c.bytes
    return out


class _Clock(TorchDispatchMode):
    """Counts the ATen ops a block runs, and notes those of the backward with
    the autograd node that ran them."""

    def __init__(self, trace: CommTrace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.trace.ops += 1
        if torch._C._current_graph_task_id() != -1:
            node = self.trace.node_id(torch._C._current_autograd_node())
            self.trace._bwd.append((self.trace.ops, node))
        return func(*args, **(kwargs or {}))


_state = threading.local()


def _tensors(arg) -> list:
    if isinstance(arg, torch.Tensor):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [t for a in arg for t in _tensors(a)]
    return []


def _group_size(group) -> int:
    try:
        return dist.get_world_size(group)
    except (RuntimeError, ValueError):
        return 1


class _Recorder:
    def __init__(self, trace: CommTrace):
        self.trace = trace

    def add(self, op: str, fn: str, result, group, async_op: bool) -> CommCall:
        ts = _tensors(result)
        in_bwd = torch._C._current_graph_task_id() != -1
        node = torch._C._current_autograd_node() if in_bwd else None
        call = CommCall(seq=len(self.trace.calls), op=op, fn=fn,
                        dtype=hlo_dtype(ts[0]) if ts else "f32",
                        bytes=0 if op == "send" else sum(t.numel() * t.element_size()
                                                         for t in ts),
                        group=_group_size(group), async_op=async_op,
                        ops_at_issue=self.trace.ops, in_backward=in_bwd,
                        node=self.trace.node_id(node))
        self.trace.calls.append(call)
        return call

    def on_wait(self, work, call: CommCall):
        """Note the op clock where an async handle is waited on."""
        if work is None or not hasattr(work, "wait"):
            return work
        trace, real = self.trace, work.wait

        def wait(*args, **kwargs):
            if call.ops_at_wait is None:
                call.ops_at_wait = trace.ops
            return real(*args, **kwargs)

        try:
            work.wait = wait
        except (AttributeError, TypeError):
            pass  # a C++ handle that takes no attribute: its wait stays unseen
        return work

    def wrap(self, fn_name: str, real):
        op = _WRAPPED[fn_name]
        rec = self

        def recorded(*args, **kwargs):
            if getattr(_state, "depth", 0):
                return real(*args, **kwargs)
            _state.depth = 1
            try:
                if fn_name == "batch_isend_irecv":
                    p2p = args[0] if args else kwargs["p2p_op_list"]
                    calls = [rec.add("send" if p.op is c10d.isend else "collective-permute",
                                     fn_name, p.tensor, p.group, True) for p in p2p]
                    works = real(*args, **kwargs)
                    for w, call in zip(works or [], calls):
                        rec.on_wait(w, call)
                    return works
                result = args[0] if args else next(kwargs[k] for k in _RESULT_KEYS
                                                       if k in kwargs)
                group = kwargs.get("group")
                async_op = bool(kwargs.get("async_op", False)) or fn_name in ("isend", "irecv")
                call = rec.add(op, fn_name, result, group, async_op)
                work = real(*args, **kwargs)
                return rec.on_wait(work, call) if async_op else work
            finally:
                _state.depth = 0

        recorded.__wrapped__ = real
        return recorded


@contextlib.contextmanager
def record_comm(clock: bool = True):
    """Record every c10d call the block makes (this thread and the autograd
    engine's) into the `CommTrace` it yields; `clock` also counts the
    block's ATen ops."""
    trace = CommTrace()
    rec = _Recorder(trace)
    patched = []
    for name in _WRAPPED:
        real = getattr(dist, name, None)
        if real is None:
            continue
        wrapped = rec.wrap(name, real)
        for ns in (dist, c10d):
            if getattr(ns, name, None) is real:
                setattr(ns, name, wrapped)
                patched.append((ns, name, real))
    mode = _Clock(trace) if clock else contextlib.nullcontext()
    try:
        with mode:
            yield trace
    finally:
        for ns, name, real in patched:
            setattr(ns, name, real)


def comm_bytes(fn) -> dict:
    """`fn()` run under `record_comm`: `{c10d function: {count, bytes}}` of
    its calls with a result (the bytes of the output; the tensor of an
    all-reduce and a broadcast)."""
    with record_comm(clock=False) as trace:
        fn()
    out: dict = {}
    for c in trace.collectives():
        rec = out.setdefault(c.fn, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += c.bytes
    return out
