"""The port's comm audit (`tpukit_torch/analysis/`) against tpukit's
(`tpukit/analysis/`, `tools/hlolint.py`).

  - The closed forms the port gained equal tpukit's at `backend=None`
    where the two conventions agree (`scan_layers` off, f32 compute, so
    nothing is upcast on the wire): EP's `expected_a2a`, `dispatch_comm`
    and `overlap_comm`, DP's `overlap_comm`, `decode_step_comm` on a
    model-only grid, and the plans built from them, op by op. Where they
    cannot agree the mapping is stated and held: the pipeline's hops
    (tpukit one `ppermute` instance a shipping tick for every stage, the
    port one call a receiving rank), and the data axis of the serving grid
    (the port gathers every replica's logits to sample; tpukit only for
    top-k).
  - Every rule on hand-built traces, each with a negative control that
    must fire: a surplus all-reduce under an exhaustive plan, a bf16
    payload under an int8 wire, an s32 gather over the threshold, a serial
    bucket wire under a declared overlap.
  - `summarize` gives tpukit's dict on the same findings; `waive` takes
    tpukit's rule names.
  - `record_comm` on real calls of a world of one: results, dtypes, the
    point-to-point convention, and the op clock's backward.
  - The measured traces of every audited world at 2 and 4 gloo ranks
    (recorded by `tests/torch_dist_worker.py` inside the spawns of
    `tests/test_torch_distributed.py`'s `world_run`) equal their plans
    (exactly for decode) and lint clean, the bucket wires' overlap gate
    included: the DDP and FSDP buckets are issued from the backward, all
    but the last with the weight products of the last still to run. The
    same traces rebuilt in the serial order (every wire after the last
    backward op) fail the gate with none hidden.
  - `python -m tpukit_torch.analysis` refuses the CPU unless asked.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.analysis import Finding as TkFinding
from tpukit.analysis import decode_comm_plan as tk_decode_comm_plan
from tpukit.analysis import summarize as tk_summarize
from tpukit.analysis import train_comm_plan as tk_train_comm_plan
from tpukit.mesh import create_mesh as tk_create_mesh
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.model import init_params as tk_init_params
from tpukit.ops.moe_dispatch import expected_a2a as tk_expected_a2a
from tpukit.pipeline import Pipeline1F1B as TkPipeline1F1B
from tpukit.pipeline_schedule import cached_schedule as tk_cached_schedule
from tpukit.serve.decode import decode_step_comm as tk_decode_step_comm
from tpukit.shardings import FSDP as TkFSDP
from tpukit.shardings import DataParallel as TkDataParallel
from tpukit.shardings import ExpertParallel as TkExpertParallel
import tpukit_torch
from tpukit_torch import mesh
from tpukit_torch.analysis import (WAIVABLE, CommCall, CommPlan, CommTrace, Finding,
                                   assert_clean, collective_summary, decode_comm_plan,
                                   fleet_decode_comm_plan, lint_trace, record_comm,
                                   summarize, train_comm_plan)
from tpukit_torch.analysis import __main__ as audit
from tpukit_torch.analysis.rules import OVERLAP_MIN_CONCURRENT, S32_PLUMBING_MIN_BYTES
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.ops.moe_dispatch import ExpertGrid, expected_a2a
from tpukit_torch.pipeline import Pipeline1F1B
from tpukit_torch.serve.decode import decode_step_comm
from tpukit_torch.shardings import DataParallel, ExpertParallel
from test_torch_distributed import global_batch, init_params, tk_cfg, world_run  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def _cfgs(**kw):
    """The same config in both packages, f32 compute, layers unrolled."""
    base = dict(dim=64, head_dim=16, heads=8, num_layers=4, vocab_size=128,
                max_position_embeddings=32)
    base.update(kw)
    return (TkGPTConfig(**base, compute_dtype=jnp.float32, scan_layers=False),
            GPTConfig(**base, compute_dtype=torch.float32))


def _tk_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return tk_create_mesh(axes, jax.devices()[:n])


def _counts(rec: dict) -> dict:
    return {"count": rec["count"], "bytes": rec["bytes"]}


# ------------------------------------------------------ closed forms ----

EP_CASES = [(d, e, comm, remat) for d, e in ((1, 2), (2, 2), (1, 4))
            for comm in ("f32", "bf16", "int8") for remat in (False, True)]


@pytest.mark.parametrize("data,expert,comm,remat", EP_CASES,
                         ids=[f"d{d}e{e}-{c}{'-remat' if r else ''}" for d, e, c, r in EP_CASES])
def test_expected_a2a_and_ep_plan_match_tpukit(data, expert, comm, remat):
    """`expected_a2a`, `ExpertParallel.dispatch_comm` / `overlap_comm` and
    the EP plan against tpukit's at `backend=None`, train and eval: equal
    counts and bytes; the wire dtype equal wherever tpukit declares one
    (the port also names f32's, which c10d carries as is)."""
    tk, pt = _cfgs(num_experts=2 * expert, comm_dtype=comm, remat_layers=remat,
                   grad_buckets=1)
    ref = tk_expected_a2a(tk, data, expert, 8 * data * expert, 16)
    got = expected_a2a(pt, data, expert, 8 * data * expert, 16)
    assert got["buffer_bytes"] == ref["buffer_bytes"]
    for phase in ("train", "eval"):
        assert _counts(got[phase]) == _counts(ref[phase]), phase
    tk_ep = TkExpertParallel(_tk_mesh({"data": data, "expert": expert}))
    ep = ExpertParallel(ExpertGrid(data=data, expert=expert))
    assert ep.overlap_comm(pt, None) == tk_ep.overlap_comm(tk, None) == {
        "all-to-all": 2 * pt.num_layers}
    for phase in ("train", "eval"):
        mine = train_comm_plan(ep, pt, global_batch=8 * data * expert, seq=16, phase=phase)
        theirs = tk_train_comm_plan(tk_ep, tk, global_batch=8 * data * expert, seq=16,
                                    backend=None, phase=phase)
        assert mine.ops == theirs.ops and mine.overlap == theirs.overlap
        assert mine.exhaustive is theirs.exhaustive is False
        for op, dt in theirs.wire.items():
            assert mine.wire[op] == dt
    assert expected_a2a(pt, data, 1, 8, 16)["train"] == {"count": 0, "bytes": 0}
    assert expected_a2a(pt, data, expert, 8 * data * expert + 1, 16) is None


def _less_one(declared: dict | None) -> dict | None:
    """tpukit's bucket declaration (B of each op) as the port declares it:
    B - 1, the wires an eager order can hide (`DataParallel._declared`)."""
    return None if declared is None else {op: n - 1 for op, n in declared.items()}


@pytest.mark.parametrize("buckets", [0, 1, 2, 4, 7])
def test_dp_overlap_declaration_matches_tpukit(buckets):
    """`DataParallel.overlap_comm` against tpukit's on the same tree: one
    a2a and one all-gather a bucket but the last issued (tpukit: a bucket),
    from 2 buckets up."""
    tk, pt = _cfgs(comm_dtype="int8", grad_buckets=buckets)
    shapes = jax.eval_shape(lambda: tk_init_params(jax.random.PRNGKey(0), tk))
    params = gpt.init_params(pt, device="meta")
    mine = DataParallel().overlap_comm(pt, params)
    theirs = TkDataParallel(_tk_mesh({"data": 2})).overlap_comm(tk, shapes)
    assert mine == _less_one(theirs)
    assert (mine is None) == (buckets < 2)


DECODE_CASES = [(m, paged, t, top_k) for m in (2, 4) for paged in (False, True)
                for t in (1, 4) for top_k in (0, 40) if not (paged and t > 1)]


@pytest.mark.parametrize("model,paged,t,top_k", DECODE_CASES,
                         ids=[f"m{m}-{'paged' if p else 'ring'}-t{t}-k{k}"
                              for m, p, t, k in DECODE_CASES])
def test_decode_step_comm_matches_tpukit_on_a_model_grid(model, paged, t, top_k):
    """On a model-only grid the port's decode tick issues tpukit's
    collectives: `decode_step_comm` and the exhaustive plans equal
    tpukit's, op by op, for the ring, the paged cache and the verify
    window."""
    tk, pt = _cfgs(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=160,
                   max_position_embeddings=64)
    tk_mesh = _tk_mesh({"model": model})
    grid = {"data": 1, "model": model}
    assert decode_step_comm(pt, grid, 4, top_k, paged, t) == tk_decode_step_comm(
        tk, tk_mesh, 4, top_k=top_k, paged=paged, verify_tokens=t)
    mine = decode_comm_plan(pt, grid, 4, top_k=top_k, paged=paged, verify_tokens=t)
    theirs = tk_decode_comm_plan(tk, tk_mesh, 4, top_k=top_k, paged=paged, verify_tokens=t)
    assert (mine.label, mine.ops, mine.wire, mine.exhaustive) == (
        theirs.label, theirs.ops, theirs.wire, theirs.exhaustive)
    if not paged and t == 1:
        fleet = fleet_decode_comm_plan(pt, grid, 4, top_k=top_k)
        assert fleet.ops == mine.ops and fleet.label == f"fleet replica {mine.label}"


@pytest.mark.parametrize("top_k", [0, 40])
def test_decode_step_comm_on_a_data_axis_gathers_every_replica(top_k):
    """The stated difference on a data axis: the port gathers every
    replica's logits `[N, t, V]` to sample on each rank, top-k or not;
    tpukit gathers them only for top-k. The model-axis terms agree."""
    tk, pt = _cfgs(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=160,
                   max_position_embeddings=64)
    ref = tk_decode_step_comm(tk, _tk_mesh({"data": 2, "model": 2}), 4, top_k=top_k)
    got = decode_step_comm(pt, {"data": 2, "model": 2}, 4, top_k=top_k)
    assert got["all-reduce"] == ref["all-reduce"]
    full = 4 * pt.padded_vocab_size * 4
    want = {"count": 2, "bytes": ref["all-gather"]["bytes"] + full}
    if top_k:
        want = ref["all-gather"]
    assert got["all-gather"] == want
    with pytest.raises(ValueError, match="model-only grid"):
        decode_step_comm(pt, {"data": 2, "model": 2}, 4, paged=True)


@pytest.mark.parametrize("stages,virtual,moe", [(2, 2, False), (4, 2, False), (4, 2, True),
                                                (4, 1, True)])
def test_pipe_comm_maps_onto_tpukit_ship_ticks(stages, virtual, moe):
    """tpukit's `pipe_comm` counts one `ppermute` instance a shipping tick
    (every stage's buffer at once); the port counts one call a receiving
    rank. The mapping: the same payload a hop, the ranks' receives summing
    to every activation and cotangent the schedule ships (2 M (G - 1)
    training, M (G - 1) forward only), no rank receiving more than once a
    direction a tick, and the MoE stage-only grid pinning all-to-all to
    zero in both."""
    num_experts = 4 if moe else 0
    tk, pt = _cfgs(num_layers=8, virtual_stages=virtual, num_experts=num_experts)
    M, G = 4, stages * virtual
    tk_pipe = TkPipeline1F1B(_tk_mesh({"stage": stages}), num_microbatches=M,
                             moe_dispatch="pallas" if moe else None)
    pipe = Pipeline1F1B(num_microbatches=M, stages=stages,
                        moe_dispatch="pallas" if moe else None)
    for phase, hops in (("train", 2 * M * (G - 1)), ("eval", M * (G - 1))):
        ref = tk_pipe.pipe_comm(tk, global_batch=8, seq=16, phase=phase)
        got = [pipe.pipe_comm(pt, global_batch=8, seq=16, phase=phase, stage=s)
               for s in range(stages)]
        payload = (8 // M) * 16 * pt.dim * 4
        assert all(g["collective-permute"]["bytes"] == g["collective-permute"]["count"] * payload
                   for g in got)
        assert sum(g["collective-permute"]["count"] for g in got) == hops
        if ref is not None:  # tpukit claims the interleaved and the MoE machines
            cp = ref["collective-permute"]
            assert cp["bytes"] == cp["count"] * payload
            sched = tk_cached_schedule(stages, virtual, M, include_backward=phase == "train")
            assert cp["count"] == sched.stats["ship_fwd_ticks"] + sched.stats["ship_bwd_ticks"]
            assert max(g["collective-permute"]["count"] for g in got) <= cp["count"]
            if moe:
                assert ref["all-to-all"] == {"count": 0, "bytes": 0}
        if moe:
            assert all(g["all-to-all"] == {"count": 0, "bytes": 0} for g in got)


# ------------------------------------------------------------- rules ----


def _call(op: str, dtype: str, nbytes: int, seq: int = 0, **kw) -> CommCall:
    return CommCall(seq=seq, op=op, fn=kw.pop("fn", op.replace("-", "_")), dtype=dtype,
                    bytes=nbytes, group=2, **kw)


def _trace(*calls, bwd_ops: int = 0, after: int = 0) -> CommTrace:
    """A trace of `calls`, with `bwd_ops` backward ops run after op
    ordinal `after`."""
    trace = CommTrace(calls=list(calls))
    trace._bwd = [(after + i + 1, None) for i in range(bwd_ops)]
    trace.ops = after + bwd_ops
    return trace


A2A = {"all-to-all": {"count": 1, "bytes": 1024}}


def test_comm_plan_rule_and_its_surplus_control():
    ok = _trace(_call("all-to-all", "s8", 1024), _call("all-reduce", "f32", 4, seq=1))
    assert not lint_trace(ok, plan=CommPlan("step", ops=dict(A2A)))
    # the negative control: a surplus all-reduce under an exhaustive plan
    found = lint_trace(ok, plan=CommPlan("decode", ops=dict(A2A), exhaustive=True))
    assert [(f.rule, f.severity, f.data["op"]) for f in found] == [
        ("comm-plan", "error", "all-reduce")]
    # a byte drift and a missing call
    drift = _trace(_call("all-to-all", "s8", 1000))
    assert [f.rule for f in lint_trace(drift, plan=CommPlan("s", ops=dict(A2A)))] == [
        "comm-plan"]
    with pytest.raises(AssertionError, match=r"\[comm-plan\]"):
        assert_clean(lint_trace(_trace(), plan=CommPlan("s", ops=dict(A2A))))


def test_wire_upcast_rule_and_its_bf16_under_int8_control():
    plan = CommPlan("ddp", ops=dict(A2A), wire={"all-to-all": "s8"}, comm_dtype="int8")
    assert not lint_trace(_trace(_call("all-to-all", "s8", 1024)), plan=plan)
    found = lint_trace(_trace(_call("all-to-all", "bf16", 1024)), plan=plan)
    assert [(f.rule, f.severity, f.data["actual"]) for f in found] == [
        ("wire-upcast", "error", "bf16")]


def test_s32_plumbing_rule_and_its_gather_control():
    small = _trace(_call("all-gather", "s32", S32_PLUMBING_MIN_BYTES))
    assert not lint_trace(small)
    big = _trace(_call("all-gather", "s32", 4096))
    assert [(f.rule, f.severity) for f in lint_trace(big)] == [("s32-index-plumbing", "warn")]
    plan = CommPlan("s", ops={"all-gather": {"count": 1, "bytes": 4096}})
    assert [(f.rule, f.severity) for f in lint_trace(big, plan=plan)] == [
        ("s32-index-plumbing", "error")]
    assert not lint_trace(_trace(_call("all-gather", "s8", 4096)), plan=plan)


def test_overlap_gate_and_its_serial_bucket_control():
    """Two declared bucket wires issued in the backward with the model's
    backward still to run pass the gate; the same wires issued after the
    whole backward (the serial schedule) fail it."""
    plan = CommPlan("ddp", ops={"all-to-all": {"count": 2, "bytes": 2048}},
                    overlap={"all-to-all": 2})
    hidden = _trace(_call("all-to-all", "s8", 1024, ops_at_issue=0, in_backward=True),
                    _call("all-to-all", "s8", 1024, seq=1, ops_at_issue=10, in_backward=True),
                    bwd_ops=10 + OVERLAP_MIN_CONCURRENT)
    found = lint_trace(hidden, plan=plan)
    assert [(f.rule, f.severity) for f in found] == [("overlap", "info")]
    assert found[0].data["overlappable"] == 2
    serial = _trace(_call("all-to-all", "s8", 1024, ops_at_issue=40),
                    _call("all-to-all", "s8", 1024, seq=1, ops_at_issue=41),
                    bwd_ops=40)
    found = lint_trace(serial, plan=plan)
    assert [(f.rule, f.severity) for f in found] == [("overlap", "error")]
    assert summarize(found)["overlap_gate"] == {"declared": 2, "overlappable": 0, "ok": False}
    # undeclared, the same schedule only reports
    assert not [f for f in lint_trace(serial, plan=CommPlan("ddp", ops=plan.ops))
                if f.severity == "error"]


def test_overlap_report_of_async_handles():
    """An async handle waited on at once is reported; on a declared world,
    where backward was left to hide it, it is an error."""
    at_once = _call("all-to-all", "s8", 1024, async_op=True, ops_at_issue=5, ops_at_wait=5,
                    in_backward=True)
    spread = _call("all-to-all", "s8", 1024, seq=1, async_op=True, ops_at_issue=6,
                   ops_at_wait=30, in_backward=True)
    trace = _trace(at_once, spread, bwd_ops=40)
    found = lint_trace(trace)
    assert [(f.severity, f.data["overlapped"]) for f in found] == [("info", False),
                                                                    ("info", True)]
    declared = CommPlan("ep", ops={"all-to-all": {"count": 2, "bytes": 2048}},
                        overlap={"all-to-all": 1})
    assert [f.severity for f in lint_trace(trace, plan=declared)
            if "compute_between" in f.data] == ["error", "info"]
    assert summarize(found)["overlap"] == {"pairs": 2, "overlapped": 1}


def test_summarize_gives_tpukits_verdict_on_the_same_findings():
    rows = [("comm-plan", "error", {"op": "all-to-all"}),
            ("s32-index-plumbing", "warn", {"op": "all-gather"}),
            ("overlap", "info", {"compute_between": 3, "overlapped": True}),
            ("overlap", "info", {"compute_between": 0, "overlapped": False}),
            ("overlap", "error", {"declared": 4, "overlappable": 1}),
            ("wire-upcast", "error", {"op": "all-to-all"})]
    for n in range(len(rows) + 1):
        mine = [Finding(r, s, "m", data=d) for r, s, d in rows[:n]]
        theirs = [TkFinding(r, s, "m", data=d) for r, s, d in rows[:n]]
        assert summarize(mine) == tk_summarize(theirs)
        assert [f.to_record(world="w") for f in mine] == [f.to_record(world="w")
                                                          for f in theirs]


def test_ring_wire_bytes_match_tpukit():
    from tpukit.analysis import ring_wire_bytes as tk_ring_wire_bytes
    from tpukit_torch.analysis import ring_wire_bytes

    coll = {op: {"count": 2, "bytes": 1000 + 7 * i} for i, op in enumerate(
        ("all-reduce", "all-gather", "all-to-all", "reduce-scatter", "collective-permute",
         "broadcast"))}
    for world in (1, 2, 4, 8):
        assert ring_wire_bytes(coll, world) == tk_ring_wire_bytes(coll, world)


def test_waive_takes_tpukits_rule_names():
    trace = _trace(_call("all-gather", "s32", 4096))
    assert lint_trace(trace, waive=("s32-index-plumbing",)) == []
    assert len(lint_trace(trace, waive=WAIVABLE)) == 1  # tpukit-only rules skip nothing
    with pytest.raises(ValueError, match="unknown comm audit rule"):
        lint_trace(trace, waive=("no-such-rule",))


# ---------------------------------------------------------- recording ----


class _ReduceInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g)
        return g


def test_record_comm_on_a_world_of_one():
    """Real c10d calls: tpukit's names, HLO dtypes and result bytes; a
    point-to-point receive is a collective-permute and a send counts as
    none; a call from a backward Function is in the backward, with the
    model's later backward ops counted and the Function's own excluded;
    nested calls are recorded once; the functions are restored."""
    dist = torch.distributed
    real = dist.all_reduce
    with mesh.scoped_runtime():
        mesh.initialize_runtime("cpu")
        x = torch.ones(8, requires_grad=True)
        w = torch.ones(8, requires_grad=True)
        with record_comm() as trace:
            dist.all_reduce(torch.ones(3, dtype=torch.bfloat16))
            out = torch.empty(4, dtype=torch.int8)
            dist.all_gather_into_tensor(out, torch.ones(4, dtype=torch.int8))
            dist.broadcast(torch.ones(2, dtype=torch.int32), src=0)
            y = (_ReduceInBackward.apply(x) * w).sin().sum()
            y.backward()
        assert dist.all_reduce is real
        got = [(c.fn, c.op, c.dtype, c.bytes, c.in_backward) for c in trace.calls]
        assert got == [("all_reduce", "all-reduce", "bf16", 6, False),
                       ("all_gather_into_tensor", "all-gather", "s8", 4, False),
                       ("broadcast", "broadcast", "s32", 8, False),
                       ("all_reduce", "all-reduce", "f32", 32, True)]
        assert trace.backward_left(trace.calls[-1]) < trace.backward_ops()
        assert trace.backward_left(trace.calls[0]) == trace.backward_ops() > 0
        assert collective_summary(trace)["all-reduce"] == {"count": 2, "bytes": 38}


# ----------------------------------------------- the worlds on gloo ----


@pytest.mark.parametrize("name", audit.WORLDS)
def test_audited_worlds_meet_their_plans(world_run, name):
    """Every audited world at 2 and 4 gloo ranks, on every rank: the
    measured collectives equal the plan's kinds (all of them for the
    exhaustive decode plans), and lint finds no error. On the bucket
    worlds the gate is met: at least as many wires of each declared op as
    declared (B - 1) are issued in the backward with
    OVERLAP_MIN_CONCURRENT or more of its ops still to run."""
    ranks = json.loads(str(world_run["got"][f"audit/{name}"]))
    assert len(ranks) == world_run["world"]
    for r, rec in enumerate(ranks):
        plan, measured = rec["plan"], rec["measured"]
        errors = [f for f in rec["findings"] if f["severity"] == "error"]
        if plan is not None:
            for op, want in plan["ops"].items():
                assert measured.get(op, {"count": 0, "bytes": 0}) == want, (r, op)
            if plan["exhaustive"]:
                assert set(measured) == set(plan["ops"]), r
        assert not errors, (r, errors)
        if name in ("ddp_overlap", "fsdp_overlap"):
            assert plan["overlap"]
            for op, need in plan["overlap"].items():
                left = [c["left"] for c in rec["calls"] if c["op"] == op and c["in_backward"]]
                assert sum(v >= OVERLAP_MIN_CONCURRENT for v in left) >= need, (r, op, left)
    if name in audit.DECODE_WORLDS:
        assert all(rec["plan"]["exhaustive"] for rec in ranks)
    if name == "ep_overlap":
        gate = [f for f in ranks[0]["findings"] if "declared" in f.get("data", {})]
        assert gate and gate[0]["data"]["overlappable"] >= gate[0]["data"]["declared"]


@pytest.mark.parametrize("name", ["ddp_overlap", "fsdp_overlap"])
def test_serial_bucket_order_fails_the_gate(world_run, name):
    """The negative control of the repaired bucket worlds: each rank's
    recorded trace rebuilt in the serial order the port ran before the
    weight products were deferred (every wire issued after the last
    backward op) fails the B - 1 declaration with none of its wires
    hidden, on every rank."""
    ranks = json.loads(str(world_run["got"][f"audit/{name}"]))
    for r, rec in enumerate(ranks):
        plan = CommPlan(f"{name} serial", ops=rec["plan"]["ops"], wire=rec["plan"]["wire"],
                        overlap=rec["plan"]["overlap"])
        last = max(rec["bwd"])
        serial = CommTrace(
            calls=[CommCall(seq=i, op=c["op"], fn=c["fn"], dtype=c["dtype"], bytes=c["bytes"],
                            group=c["group"], ops_at_issue=last + i, in_backward=True)
                   for i, c in enumerate(rec["calls"])],
            ops=rec["ops"] + len(rec["calls"]), _bwd=[(o, None) for o in rec["bwd"]])
        errors = [f for f in lint_trace(serial, plan=plan) if f.severity == "error"]
        assert errors and all(f.rule == "overlap" and f.data["overlappable"] == 0
                              for f in errors), (r, errors)
        assert {f.data["op"] for f in errors} == set(plan.overlap), r
        # as recorded, the same plan passes
        measured = CommTrace(
            calls=[CommCall(seq=i, op=c["op"], fn=c["fn"], dtype=c["dtype"], bytes=c["bytes"],
                            group=c["group"], ops_at_issue=c["ops_at_issue"],
                            in_backward=c["in_backward"])
                   for i, c in enumerate(rec["calls"])],
            ops=rec["ops"], _bwd=[(o, None) for o in rec["bwd"]])
        assert not [f for f in lint_trace(measured, plan=plan) if f.severity == "error"], r


@pytest.mark.parametrize("world_run", [2], indirect=True, ids=["world2"])
def test_audited_plans_match_tpukits_where_declared(world_run, tk_cfg):
    """The DDP and FSDP plans the ranks held their traces to against
    tpukit's `train_comm_plan` at `backend=None` on the same config and a
    `data` mesh of as many devices (the bucket worlds' overlap declaration
    too)."""
    for name, cls in (("ddp_int8", TkDataParallel), ("fsdp_int8", TkFSDP),
                      ("ddp_overlap", TkDataParallel), ("fsdp_overlap", TkFSDP)):
        plan = json.loads(str(world_run["got"][f"audit/{name}"]))[0]["plan"]
        cfg = TkGPTConfig(dim=64, head_dim=16, heads=8, num_layers=4, vocab_size=128,
                          max_position_embeddings=32, compute_dtype=jnp.float32,
                          comm_dtype="int8", grad_buckets=4 if "overlap" in name else 0)
        strategy = cls(_tk_mesh({"data": 2}))
        state_shapes = jax.eval_shape(lambda cfg=cfg: tk_init_params(jax.random.PRNGKey(0),
                                                                    cfg))
        ref = tk_train_comm_plan(strategy, cfg, param_shapes=state_shapes, backend=None)
        assert plan["ops"] == ref.ops, name
        assert plan["wire"] == ref.wire, name
        assert plan["overlap"] == (_less_one(ref.overlap) if "overlap" in name
                                   else ref.overlap), name


def test_cli_exits_1_on_an_error_and_report_renders_it(tmp_path, monkeypatch):
    """`python -m tpukit_torch.analysis --world 2 --device cpu` on a clean
    world and a bucket world: exit 0, the `kind="hlolint"` JSONL of both
    ranks with `world` and `rank`, which `tools/report.py` renders with
    exit 0. A rank whose world has an error (the bucket wires issued after
    the backward, as a recorded serial trace) exits 1 and writes the error,
    which the report renders too."""
    out = tmp_path / "audit.jsonl"
    proc = subprocess.run([sys.executable, "-m", "tpukit_torch.analysis", "--world", "2",
                           "--device", "cpu", "--worlds", "ddp_int8,ddp_overlap", "--out",
                           str(out)], cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert "comm audit world ddp_int8: clean" in proc.stderr
    assert "comm audit world ddp_overlap: clean" in proc.stderr
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert not [r for r in records if r["severity"] == "error"]
    gate = [r for r in records if r["world"] == "ddp_overlap" and "declared" in r["data"]]
    assert {r["rank"] for r in gate} == {0, 1}
    assert all(r["data"]["overlappable"] >= r["data"]["declared"] == 3 for r in gate)
    assert all(r["kind"] == "hlolint" for r in records)
    from tools import report

    assert report.main([str(out)]) == 0
    assert "ddp_overlap" in report.summarize(report.load(str(out)))

    plan = CommPlan("ddp", ops={"all-to-all": {"count": 2, "bytes": 2048}},
                    overlap={"all-to-all": 1})
    serial = _trace(_call("all-to-all", "s8", 1024, ops_at_issue=40, in_backward=True),
                    _call("all-to-all", "s8", 1024, seq=1, ops_at_issue=41, in_backward=True),
                    bwd_ops=40)
    monkeypatch.setattr(audit, "build_world",
                        lambda name, world, device: {"name": name, "trace": serial,
                                                     "plan": plan})
    bad = tmp_path / "serial.jsonl"
    with mesh.scoped_runtime():
        code = audit.main(["--world", "1", "--device", "cpu", "--worlds", "ddp_overlap",
                           "--out", str(bad), "--rank", "0",
                           "--address", f"file://{tmp_path / 'store'}"])
    assert code == 1
    errors = [json.loads(line) for line in bad.read_text().splitlines()
              if json.loads(line)["severity"] == "error"]
    assert [(r["world"], r["rule"], r["rank"]) for r in errors] == [
        ("ddp_overlap", "overlap", 0)]
    assert report.main([str(bad)]) == 0


def test_cli_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        audit.main(["--world", "1"])
    with pytest.raises(SystemExit, match="unknown world 'nope'"):
        audit.build_world("nope", 1, torch.device("cpu"))
    with pytest.raises(SystemExit):
        audit.main(["--world", "1", "--waive", "no-such-rule"])
