"""The comm audit's rules over a step's c10d trace (twin of
`tpukit/analysis/rules.py`).

`lint_trace` runs every rule over a `comm_ir.CommTrace` and the caller's
declared `CommPlan` and returns findings, errors first; `assert_clean`
raises on errors. The rules are tpukit's, read off the trace instead of
the HLO:

  comm-plan          The plan diffed against the trace's collectives: each
                     declared op's count and bytes exactly; with an
                     exhaustive plan (decode) every undeclared op is an
                     error too.
  s32-index-plumbing Integer payloads over S32_PLUMBING_MIN_BYTES (s32,
                     s64: index exchange; s8/u8 are quantized data). Error
                     where a plan is declared (the step is hand-placed),
                     warn elsewhere.
  wire-upcast        A call of a declared op whose payload's element type
                     is wider than the plan's wire dtype (a bf16 or int8
                     wire carried at f32). c10d moves bf16 at 2 bytes on
                     every backend, so there is no CPU excuse here: any
                     widening is an error.
  overlap            The reporting half: each async handle, with the ATen
                     ops the step ran between its issue and its wait
                     ("info"). The gate half, where the plan declares
                     overlap ({op: K}): at least K calls of each declared
                     op must be issued in the backward with at least
                     OVERLAP_MIN_CONCURRENT of the model's backward ops
                     still to run (`CommTrace.backward_left`: the work an
                     eager step has left to hide the wire behind; the
                     wire's own quantize and pack excluded). A shortfall
                     is an error. On a declared world an async handle of a
                     declared op waited with nothing run in between, where
                     that much backward was left, is an error too.

tpukit's `involuntary-remat` (GSPMD's replicate-then-repartition warning)
and `donation-dropped` (the executable's alias table) have no counterpart
in eager PyTorch: nothing partitions the step and nothing is donated.
`waive` accepts their names (`WAIVABLE`) and skips nothing for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpukit_torch.analysis import comm_ir
from tpukit_torch.analysis.comm_ir import CommTrace, collective_summary
from tpukit_torch.analysis.plan import CommPlan

# integer payloads smaller than this are scalar bookkeeping (token counts)
S32_PLUMBING_MIN_BYTES = 256

# a declared-overlap call counts as overlappable when at least this many of
# the model's backward ATen ops are still to run at its issue (tpukit's
# constant, there counted in fused HLO instructions)
OVERLAP_MIN_CONCURRENT = 16

SEVERITIES = ("error", "warn", "info")

# tpukit's rules with no counterpart in the eager port (see the docstring)
WAIVABLE = ("involuntary-remat", "donation-dropped")


@dataclass
class Finding:
    """One rule verdict: "error" fails `assert_clean`, "warn" renders
    loudly and passes, "info" reports."""

    rule: str
    severity: str
    message: str
    computation: str | None = None
    instruction: str | None = None
    data: dict = field(default_factory=dict)

    def to_record(self, **common) -> dict:
        """JSONL row (kind="hlolint", tpukit's schema)."""
        rec = {"kind": "hlolint", "rule": self.rule, "severity": self.severity,
               "message": self.message}
        if self.computation:
            rec["computation"] = self.computation
        if self.instruction:
            rec["instruction"] = self.instruction
        if self.data:
            rec["data"] = self.data
        rec.update(common)
        return rec


def _rule_comm_plan(trace: CommTrace, ctx: dict) -> list[Finding]:
    plan: CommPlan | None = ctx.get("plan")
    if plan is None:
        return []
    measured = collective_summary(trace)
    out = []
    for op, exp in sorted(plan.ops.items()):
        got = measured.get(op, {"count": 0, "bytes": 0})
        if got["count"] != exp["count"] or got["bytes"] != exp["bytes"]:
            out.append(Finding(
                rule="comm-plan", severity="error",
                message=(f"{plan.label}: {op} measured x{got['count']} {got['bytes']}B vs "
                         f"declared x{exp['count']} {exp['bytes']}B"),
                data={"op": op, "measured": got, "expected": dict(exp)}))
    if plan.exhaustive:
        for op, got in sorted(measured.items()):
            if op not in plan.ops:
                out.append(Finding(
                    rule="comm-plan", severity="error",
                    message=(f"{plan.label}: unplanned {op} x{got['count']} {got['bytes']}B "
                             f"(plan is exhaustive — every collective must be declared)"),
                    data={"op": op, "measured": got}))
    return out


def _rule_s32_index_plumbing(trace: CommTrace, ctx: dict) -> list[Finding]:
    severity = "error" if ctx.get("plan") is not None else "warn"
    out = []
    for call in trace.collectives():
        if call.dtype not in comm_ir.INDEX_DTYPES or call.bytes <= S32_PLUMBING_MIN_BYTES:
            continue
        out.append(Finding(
            rule="s32-index-plumbing", severity=severity,
            message=(f"{call.fn} %{call.name} moves {call.bytes}B of {call.dtype} payload — "
                     f"index plumbing on the wire (exchange the values, or keep the "
                     f"indices local)"),
            instruction=call.name,
            data={"op": call.op, "int_bytes": call.bytes, "dtypes": [call.dtype]}))
    return out


def _rule_wire_upcast(trace: CommTrace, ctx: dict) -> list[Finding]:
    plan: CommPlan | None = ctx.get("plan")
    if plan is None or not plan.wire:
        return []
    out = []
    for call in trace.collectives():
        expected = plan.wire.get(call.op)
        if expected is None:
            continue
        size, exp_size = comm_ir.itemsize(call.dtype), comm_ir.itemsize(expected) or 4
        if size is None or size <= exp_size:
            continue
        out.append(Finding(
            rule="wire-upcast", severity="error",
            message=(f"{call.fn} %{call.name} moves {call.dtype} payload, declared wire "
                     f"dtype is {expected} — the payload travels wider than the config "
                     f"promised"),
            instruction=call.name,
            data={"op": call.op, "declared": expected, "actual": call.dtype,
                  "bytes": call.bytes}))
    return out


def _rule_overlap(trace: CommTrace, ctx: dict) -> list[Finding]:
    plan: CommPlan | None = ctx.get("plan")
    declared = getattr(plan, "overlap", None) if plan is not None else None
    out = []
    for call in trace.async_calls():
        if call.ops_at_wait is None:
            continue  # completed out of sight (DDP's reducer waits on its hook's futures)
        between = call.ops_at_wait - call.ops_at_issue
        overlapped = between > 0
        left = trace.backward_left(call)
        could = (bool(declared) and call.op in declared and not overlapped
                 and call.in_backward and left >= OVERLAP_MIN_CONCURRENT)
        out.append(Finding(
            rule="overlap", severity="error" if could else "info",
            message=(f"{call.fn} %{call.name}: {between} op(s) between issue and wait — "
                     + ("overlapped" if overlapped else
                        "NO overlap (the handle was waited on at once"
                        + (f", with {left} backward op(s) left to hide it behind on a "
                           f"world that DECLARED overlap)" if could else ")"))),
            instruction=call.name,
            data={"op": call.op, "compute_between": between, "overlapped": overlapped}))
    if not declared:
        return out
    for op, need in sorted(declared.items()):
        calls = [c for c in trace.collectives() if c.op == op]
        left = {c.name: trace.backward_left(c) if c.in_backward else 0 for c in calls}
        hidden = [n for n, v in left.items() if v >= OVERLAP_MIN_CONCURRENT]
        occupancy = sorted(left.values())
        data = {"op": op, "declared": int(need), "measured": len(calls),
                "overlappable": len(hidden),
                "min_concurrent": occupancy[0] if occupancy else 0,
                "max_concurrent": occupancy[-1] if occupancy else 0,
                "threshold": OVERLAP_MIN_CONCURRENT}
        if len(hidden) < int(need):
            out.append(Finding(
                rule="overlap", severity="error",
                message=(f"{plan.label}: declared {need} overlap-scheduled {op} wire(s), "
                         f"only {len(hidden)} of {len(calls)} are issued in the backward "
                         f"with >= {OVERLAP_MIN_CONCURRENT} backward op(s) still to run "
                         f"(per call {occupancy}) — the schedule is serial where it claims "
                         f"to overlap"),
                data=data))
        else:
            out.append(Finding(
                rule="overlap", severity="info",
                message=(f"{plan.label}: overlap gate ok — {len(hidden)}/{len(calls)} {op} "
                         f"wire(s) issued with backward left to hide behind (declared "
                         f"{need}, least left {data['min_concurrent']})"),
                data=data))
    return out


RULES = {
    "comm-plan": _rule_comm_plan,
    "s32-index-plumbing": _rule_s32_index_plumbing,
    "wire-upcast": _rule_wire_upcast,
    "overlap": _rule_overlap,
}


def lint_trace(trace: CommTrace, *, plan: CommPlan | None = None,
               waive: tuple[str, ...] = ()) -> list[Finding]:
    """Run every rule over a step's trace (tpukit `lint_module`). `waive`
    names rules to skip; tpukit's names without a counterpart here are
    accepted and skip nothing. Findings come back error-first."""
    unknown = set(waive) - set(RULES) - set(WAIVABLE)
    if unknown:
        raise ValueError(f"unknown comm audit rule(s) in waiver: {sorted(unknown)} — known: "
                         f"{sorted(RULES)} (and tpukit's {sorted(WAIVABLE)})")
    ctx = {"plan": plan}
    findings: list[Finding] = []
    for name, rule in RULES.items():
        if name not in waive:
            findings.extend(rule(trace, ctx))
    order = {s: i for i, s in enumerate(SEVERITIES)}
    findings.sort(key=lambda f: (order.get(f.severity, 99), f.rule))
    return findings


def summarize(findings: list[Finding]) -> dict:
    """The verdict for a JSONL record (tpukit's keys): error and warn
    counts, the violated rules, and the overlap tallies."""
    errors = [f for f in findings if f.severity == "error"]
    warns = [f for f in findings if f.severity == "warn"]
    pairs = [f for f in findings if f.rule == "overlap" and "compute_between" in f.data]
    gates = [f for f in findings if f.rule == "overlap" and "declared" in f.data]
    out = {"clean": not errors, "errors": len(errors), "warnings": len(warns),
           "violations": sorted({f.rule for f in errors})}
    if warns:
        out["warned"] = sorted({f.rule for f in warns})
    if pairs:
        out["overlap"] = {"pairs": len(pairs),
                          "overlapped": sum(1 for f in pairs if f.data.get("overlapped"))}
    if gates:
        out["overlap_gate"] = {"declared": sum(f.data["declared"] for f in gates),
                               "overlappable": sum(f.data["overlappable"] for f in gates),
                               "ok": all(f.severity != "error" for f in gates)}
    return out


def assert_clean(findings: list[Finding], label: str = "") -> None:
    """Raise on any error finding, every error in the message."""
    errors = [f for f in findings if f.severity == "error"]
    if not errors:
        return
    lines = "\n".join(f"  [{f.rule}] {f.message}" for f in errors)
    raise AssertionError(f"comm audit: {len(errors)} violation(s)"
                         + (f" in {label}" if label else "") + f":\n{lines}")
