"""The port's twin of tpukit's `bench.py` and `tools/bench_ladder.py`:
`python -m tpukit_torch.bench` (see `__main__`), the shared harness and
the ladder (`ladder`), and the training records (`records`).
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
