"""tpukit_torch.analysis: the comm audit (twin of `tpukit/analysis/`).

Three layers, as tpukit's:

  - `comm_ir`: the record of the c10d calls one step issued (`CommTrace`),
    the program the port audits in place of tpukit's optimized HLO;
  - `plan`: `CommPlan`, the declared collective schedule (`grad_comm`,
    `dispatch_comm`, `pipe_comm`, `decode_step_comm` behind one shape);
  - `rules`: the named rules and `lint_trace`.

`python -m tpukit_torch.analysis` is the CLI (tpukit's `tools/hlolint.py
--world N`); `train.fit` writes the `kind="xla"` record (`xla_record`)
with the same engine, and the bench keeps its headline step's.
"""

from tpukit_torch.analysis.comm_ir import (  # noqa: F401
    COLLECTIVE_OPS,
    CommCall,
    CommTrace,
    collective_summary,
    comm_bytes,
    record_comm,
)
from tpukit_torch.analysis.plan import (  # noqa: F401
    CommPlan,
    decode_comm_plan,
    fleet_decode_comm_plan,
    ring_wire_bytes,
    train_comm_plan,
)
from tpukit_torch.analysis.rules import (  # noqa: F401
    RULES,
    WAIVABLE,
    Finding,
    assert_clean,
    lint_trace,
    summarize,
)


def xla_record(fn_name: str, trace: CommTrace, strategy, cfg, params, global_batch: int,
               seq: int, backend: str) -> dict:
    """The `kind="xla"` record of one recorded step (tpukit `train.py:803-905`,
    `obs.compiled_stats`): the strategy's expected comm ops and closed forms,
    the lint verdict against its plan and the collectives measured. No
    program is compiled, so the cost fields tpukit's backend fills are
    None."""
    phase = "train" if fn_name == "train_step" else "eval"
    extra: dict = {}
    audit_fn = getattr(strategy, "dispatch_comm", None)
    if audit_fn is not None:
        audit = audit_fn(cfg, global_batch=global_batch, seq=seq)
        if audit:
            extra["a2a_expected"] = audit[phase]
    grad_fn = getattr(strategy, "grad_comm", None)
    if grad_fn is not None and fn_name == "train_step":
        gaudit = grad_fn(cfg, params)
        if gaudit:
            extra["quant_grad_expected"] = gaudit
            extra["comm_dtype"] = cfg.comm_dtype
    plan = train_comm_plan(strategy, cfg, params=params, global_batch=global_batch, seq=seq,
                           phase=phase)
    extra["hlolint"] = summarize(lint_trace(trace, plan=plan))
    return dict(kind="xla", fn=fn_name, strategy=strategy.name, backend=backend,
                expected_comm_ops=list(strategy.comm_ops_for(cfg)), **extra, flops=None,
                bytes_accessed=None, transcendentals=None, memory=None,
                collectives=collective_summary(trace))
