"""The port's twin of tpukit's `bench.py`, `tools/bench_ladder.py` and
`tools/train_induction.py`: `python -m tpukit_torch.bench` (see
`__main__`), the shared harness and the ladder (`ladder`), the training
records (`records`), the serving records and the induction trainer
(`serving`), and `python -m tpukit_torch.bench.induction`.
"""

from tpukit_torch.bench.ladder import (  # noqa: F401
    LADDER,
    bench_shape,
    make_batch,
    run_ladder,
    setup_step,
    time_windows,
)
from tpukit_torch.bench.records import (  # noqa: F401
    bench_comm_overlap,
    bench_elastic_restore,
    bench_host_pipeline,
    bench_moe_dispatch_ladder,
    bench_moe_ep_comm,
    bench_obs_overhead,
    bench_pipe_interleave,
    bench_pipe_moe,
    bench_quant_comm,
)
from tpukit_torch.bench.serving import (  # noqa: F401
    bench_decode_fused,
    bench_fleet_serving,
    bench_metrics_overhead,
    bench_paged_kv,
    bench_serve_dispatch_attribution,
    bench_serve_trace_overhead,
    bench_serving,
    bench_spec_decode,
)
