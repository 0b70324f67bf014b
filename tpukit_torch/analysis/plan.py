"""CommPlan: the declared collective schedule of one step (a copy of
`tpukit/analysis/plan.py`, over the port's strategies).

A plan is `{op: {count, bytes}}` plus, where the formula fixes it, the wire
element type each op's payload must travel at, so the rule engine
(`rules.py`) diffs every audited step the same way and `wire-upcast` has a
declared dtype to check. `exhaustive=True` means the plan is the step's
whole collective set (the decode audit); False means it covers the
hand-placed ops only, and the loss's and count's scalar all-reduces ride
alongside unchecked.

The counting convention differs from tpukit's by construction. tpukit
counts HLO instances of one compiled program: a scanned layer stack
(`scan_layers`) emits each op once, and the pipeline's `ppermute` shifts
every stage's buffer in one instance a shipping tick. The port counts the
c10d calls one step issued on one rank (`comm_ir.CommTrace`), every layer
unrolled (its trunk is a Python loop, `scan_layers` or not), and a
pipeline hop as the receiving rank's `collective-permute`. Where tpukit's
forms are taken at `scan_layers` off the two agree call for instance; the
pipeline's are related tick by tick (`Pipeline.pipe_comm`).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CommPlan:
    """Declared per-step collective expectation for one step."""

    label: str
    # op kind -> {"count": int, "bytes": int} (result-payload convention,
    # the numbers comm_ir.collective_summary reports)
    ops: dict[str, dict] = field(default_factory=dict)
    # op kind -> element type its payload must travel at ("s8", "f32",
    # "bf16"); declared only for kinds the plan owns every call of
    wire: dict[str, str] = field(default_factory=dict)
    # True: measured collectives must equal `ops` exactly, surplus kinds
    # are violations (the decode audit). False: only the kinds in `ops`
    exhaustive: bool = False
    # nominal comm dtype the run declared (--comm_dtype), for reporting
    comm_dtype: str = "f32"
    # overlap declaration (--grad_buckets): {op: K}, at least K calls of
    # that kind must each be issued with enough of the backward still to
    # run to hide behind (`Strategy.overlap_comm`); None = serial, and the
    # `overlap` rule only reports
    overlap: dict | None = None

    def expected(self, op: str) -> dict:
        return self.ops.get(op, {"count": 0, "bytes": 0})


def _wire_dtype_of(comm_dtype: str) -> str:
    return {"int8": "s8", "bf16": "bf16"}.get(comm_dtype, "f32")


# expected_a2a's wire marker speaks torch dtype names for compute dtypes
# ("float32") and its own tag for packed payloads; the trace speaks HLO's
_WIRE_TO_HLO = {
    "s8-packed": "s8", "int8": "s8",
    "float32": "f32", "f32": "f32",
    "bfloat16": "bf16", "bf16": "bf16",
    "float16": "f16", "f16": "f16",
    "float64": "f64", "f64": "f64",
}


def train_comm_plan(strategy, cfg, *, params=None, global_batch=None, seq=None,
                    phase="train") -> CommPlan | None:
    """The train-step plan of a strategy and config (tpukit
    `train_comm_plan`): `grad_comm` (the hand-placed DDP/FSDP wire),
    `dispatch_comm` (EP's exchange) and `pipe_comm` (the interleaved
    pipeline's hops) folded into one CommPlan, or None when the strategy
    hand-places nothing (plain DDP and FSDP2 are measured, not predicted).
    `params` (the train state's tree) feeds `grad_comm` and `overlap_comm`;
    `global_batch` and `seq` feed the others. `phase="eval"` builds the
    forward-only plan."""
    comm = getattr(cfg, "comm_dtype", "f32")
    ops: dict[str, dict] = {}
    wire: dict[str, str] = {}

    grad_fn = getattr(strategy, "grad_comm", None) if phase == "train" else None
    if grad_fn is not None and params is not None:
        gexp = grad_fn(cfg, params)
        if gexp:
            for op, rec in gexp.items():
                ops[op] = {"count": rec["count"], "bytes": rec["bytes"]}
            wdt = _wire_dtype_of(comm)
            if "all-to-all" in gexp:
                wire["all-to-all"] = wdt
            if "all-gather" in gexp:
                # DDP's two-shot gathers the packed payload; FSDP's forward
                # gathers stay full precision by design
                wire["all-gather"] = wdt if strategy.name == "ddp" else "f32"

    disp_fn = getattr(strategy, "dispatch_comm", None)
    if disp_fn is not None and global_batch is not None and seq is not None:
        dexp = disp_fn(cfg, global_batch=global_batch, seq=seq)
        if dexp:
            rec_p = dexp.get(phase, {"count": 0, "bytes": 0})
            if rec_p.get("count"):
                rec = ops.setdefault("all-to-all", {"count": 0, "bytes": 0})
                rec["count"] += rec_p["count"]
                rec["bytes"] += rec_p["bytes"]
                wname = rec_p.get("wire")
                if wname:
                    wire["all-to-all"] = _WIRE_TO_HLO.get(wname, wname)
                elif comm != "f32":
                    wire["all-to-all"] = _wire_dtype_of(comm)

    pipe_fn = getattr(strategy, "pipe_comm", None)
    if pipe_fn is not None and global_batch is not None and seq is not None:
        pexp = pipe_fn(cfg, global_batch=global_batch, seq=seq, phase=phase)
        if pexp:
            for op, rec in pexp.items():
                dst = ops.setdefault(op, {"count": 0, "bytes": 0})
                dst["count"] += rec["count"]
                dst["bytes"] += rec["bytes"]

    if not ops:
        return None
    overlap = None
    overlap_fn = getattr(strategy, "overlap_comm", None)
    if phase == "train" and overlap_fn is not None:
        overlap = overlap_fn(cfg, params)
    return CommPlan(label=f"{strategy.name} {phase} step", ops=ops, wire=wire,
                    exhaustive=False, comm_dtype=comm, overlap=overlap)


def decode_comm_plan(cfg, mesh, slots: int, top_k: int = 0, paged: bool = False,
                     verify_tokens: int = 1) -> CommPlan:
    """The serving decode-step plan: `serve.decode.decode_step_comm` as an
    exhaustive CommPlan, the step's every collective (tpukit
    `decode_comm_plan`). `mesh` is `{"data": d, "model": m}`;
    `verify_tokens = spec_k + 1` prices the speculative verify step
    instead."""
    from tpukit_torch.serve.decode import decode_step_comm

    expected = decode_step_comm(cfg, mesh, slots, top_k=top_k, paged=paged,
                                verify_tokens=verify_tokens)
    label = ("spec verify step" if verify_tokens > 1
             else f"decode step [{'paged' if paged else 'ring'}]")
    return CommPlan(label=label, ops={op: dict(rec) for op, rec in expected.items()},
                    wire={}, exhaustive=True, comm_dtype=getattr(cfg, "comm_dtype", "f32"))


def fleet_decode_comm_plan(cfg, mesh, slots: int, top_k: int = 0,
                           paged: bool = False) -> CommPlan:
    """A fleet replica's decode plan (tpukit `fleet_decode_comm_plan`): the
    router schedules on the host and adds no collective, so a replica's
    step audits against the standalone engine's plan unchanged."""
    p = decode_comm_plan(cfg, mesh, slots, top_k=top_k, paged=paged)
    p.label = f"fleet replica {p.label}"
    return p


def ring_wire_bytes(collectives: dict[str, dict], world: int) -> int:
    """Bytes each rank moves over a ring for `collectives` (result payloads,
    as `collective_summary` reports them), by the ring-algorithm cost
    model (tpukit `ring_wire_bytes`):

      all-reduce         2 * R * (world-1)/world
      all-gather             R * (world-1)/world
      all-to-all             R * (world-1)/world
      reduce-scatter         R * (world-1)
      collective-permute     R
    """
    if world <= 1:
        return 0
    frac = (world - 1) / world
    mult = {"all-reduce": 2.0 * frac, "all-gather": frac, "all-to-all": frac,
            "reduce-scatter": float(world - 1), "collective-permute": 1.0}
    total = 0.0
    for op, rec in collectives.items():
        total += rec.get("bytes", 0) * mult.get(op, 1.0)
    return int(total)
