"""The port's telemetry and failure observability (twin of `tpukit/obs/`),
one module a pillar:

  - `meter`      `MFUMeter` (tokens/sec, MFU on the card's peak),
                 `profiler_trace` (`torch.profiler`, Chrome traces),
                 the JSONL `StepLogger`;
  - `spans`      `SpanTimeline`: the host-phase wall-clock breakdown and
                 the goodput fraction;
  - `memory`     `live_memory_stats`: the caching allocator's gauges under
                 tpukit's keys;
  - `metrics`    mergeable counters, gauges and log-bucket histograms,
                 the per-rank snapshot files and the OpenMetrics text,
                 SLO accounting;
  - `sentinels`  the global grad/update/param norms and the loss
                 `SpikeSentinel`;
  - `heartbeat`  per-rank liveness files, the straggler and divergence
                 checks;
  - `trace`      request-scoped serving traces: `TraceRecorder`'s span-event
                 rings, per-request span trees with phase walls, the
                 completeness invariant and the Chrome-trace exporter behind
                 `tools/traceview.py`;
  - `recorder`   `FlightRecorder`, the bounded ring of recent history;
  - `watchdog`   `HangWatchdog`, the diagnostics bundles, `AnomalyTracer`;
  - `divergence` state checksums, tpukit's value bit for bit.

`train.fit` wires the training planes and `serve.engine.ServeEngine` the
serving ones (windows, traces, metrics, SLOs); `tools/report.py` renders a
run's JSONL, `tools/traceview.py` its traces, `tools/flightview.py` a
bundle and `tools/top.py` a `--metrics_dir`. tpukit's `xla.py` (HLO
analysis) has no twin here.
"""

from tpukit_torch.obs.divergence import (  # noqa: F401
    format_checksum,
    make_state_checksum,
    tree_checksum,
)
from tpukit_torch.obs.heartbeat import Heartbeat  # noqa: F401
from tpukit_torch.obs.memory import live_memory_stats  # noqa: F401
from tpukit_torch.obs.meter import (  # noqa: F401
    MFUMeter,
    StepLogger,
    matmul_param_count,
    moe_active_flops_per_token,
    peak_flops_per_chip,
    profiler_trace,
    train_flops_per_token,
)
from tpukit_torch.obs.metrics import (  # noqa: F401
    Histogram,
    MetricRegistry,
    SloAccountant,
    SloSpecError,
    SloTarget,
    merge_snapshot_dir,
    parse_slo,
    publish_snapshot,
    to_openmetrics,
    write_merged,
)
from tpukit_torch.obs.recorder import FlightRecorder  # noqa: F401
from tpukit_torch.obs.trace import (  # noqa: F401
    PHASES,
    TraceRecorder,
    build_trees,
    completeness,
    flush_to_logger,
    phase_stats,
    request_trace_id,
    to_chrome,
)
from tpukit_torch.obs.sentinels import SpikeEvent, SpikeSentinel, global_norms  # noqa: F401
from tpukit_torch.obs.spans import GOODPUT_SPANS, SpanTimeline, format_breakdown  # noqa: F401
from tpukit_torch.obs.watchdog import (  # noqa: F401
    AnomalyTracer,
    HangWatchdog,
    all_thread_stacks,
    write_bundle,
)
