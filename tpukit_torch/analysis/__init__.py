"""tpukit_torch.analysis: the comm audit (twin of `tpukit/analysis/`).

Three layers, as tpukit's:

  - `comm_ir`: the record of the c10d calls one step issued (`CommTrace`),
    the program the port audits in place of tpukit's optimized HLO;
  - `plan`: `CommPlan`, the declared collective schedule (`grad_comm`,
    `dispatch_comm`, `pipe_comm`, `decode_step_comm` behind one shape);
  - `rules`: the named rules and `lint_trace`.

`python -m tpukit_torch.analysis` is the CLI (tpukit's `tools/hlolint.py
--world N`); `train.fit` writes the `kind="xla"` record with the same
engine.
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
