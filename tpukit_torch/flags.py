"""The training CLI flags (twin of `tpukit/flags.py:24-373`, the training
parser).

Every tpukit flag parses, with tpukit's name and default, plus `--device`
(cuda unless `cpu` is asked for). `check_carried` raises `NotPortedError`,
naming the ROADMAP.md item, for a flag this slice does not carry that is set
to anything but its default. `--prefetch N` runs the host side of the input
pipeline N batches ahead on a worker thread (`prefetch.HostPrefetcher`;
`0` loads synchronously, with the same losses). The resilience flags
(`--resume latest`, `--chaos_spec`, `--on_anomaly`, `--max_rollbacks`,
`--spike_threshold`, `--spike_action`, `--io_retries`, `--async_checkpoint`,
`--keep_checkpoints`, `--heartbeat_dir`, `--heartbeat_timeout`) and the
telemetry flags (`--metrics_log`, `--metrics_dir`, `--no_metrics`,
`--log_grad_norms`, `--profile_dir`, `--debug_nans`, `--hang_timeout`,
`--debug_dir`, `--trace_on_anomaly`, `--divergence_check_freq`) are
carried, and `fit` validates them with tpukit's errors. `--disable_compile` is
accepted: the port runs eagerly either way. `--num_workers` is accepted
for CLI parity, as in tpukit.
"""

from __future__ import annotations

import argparse
import dataclasses

from tpukit_torch import NotPortedError


@dataclasses.dataclass
class TrainFlags:
    batch_size: int = 64
    epochs: int = 5
    sequence_length: int = 256
    dim: int = 256
    head_dim: int = 32
    heads: int = 8
    num_layers: int = 8
    learning_rate: float = 1e-4
    dataset_slice: str = "100%"
    num_workers: int = 4
    disable_amp: bool = False
    disable_compile: bool = False
    cpu_offload: bool = False
    seed: int = 0
    dropout: float = 0.0
    checkpoint_every: int = 0  # steps; 0 = end of training only
    checkpoint_format: str = "auto"  # auto | consolidated | sharded
    async_checkpoint: bool = False
    keep_checkpoints: int = 0
    resume: str = ""  # a checkpoint path, any format, or "latest"
    prefetch: int = 2
    compilation_cache_dir: str = ""
    profile_dir: str = ""
    metrics_log: str = ""
    no_metrics: bool = False
    metrics_dir: str = ""
    debug_nans: bool = False
    log_grad_norms: bool = False
    spike_threshold: float = 0.0
    spike_action: str = "warn"
    heartbeat_dir: str = ""
    heartbeat_timeout: float = 120.0
    hang_timeout: float = 0.0
    debug_dir: str = ""
    trace_on_anomaly: int = 0
    divergence_check_freq: int = 0
    on_anomaly: str = "none"
    max_rollbacks: int = 3
    io_retries: int = 3
    chaos_spec: str = ""
    remat: bool = False
    scan_layers: bool = False
    microbatches: int = 0
    cp_attention: str = "ring"
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
    num_experts: int = 0
    moe_top_k: int = 1
    moe_dispatch: str = "a2a"
    comm_dtype: str = "f32"
    quant_stochastic: bool = False
    grad_buckets: int = 0
    device: str = "cuda"


# The canonical flags of every reference recipe (main-single.py:156-167).
_CORE_FLAGS = [
    ("batch_size", int), ("epochs", int), ("sequence_length", int), ("dim", int),
    ("head_dim", int), ("heads", int), ("num_layers", int), ("learning_rate", float),
    ("dataset_slice", str), ("num_workers", int),
]

# flag -> the ROADMAP.md item that carries it; set to a non-default value,
# each raises NotPortedError in this slice
NOT_CARRIED = {
    "compilation_cache_dir": "item 18 'Tracing and metrics' (the eager port compiles no "
                             "programs to cache)",
}


def build_parser(cpu_offload: bool = False, num_experts: bool = False,
                 pipeline_schedule: bool = False, default_experts: int = 8,
                 cp_attention: bool = False) -> argparse.ArgumentParser:
    """tpukit's training parser plus `--device`; of its recipe-specific
    groups, `--cpu_offload` (recipe 3), `--cp_attention` (recipe 7), the
    pipeline's (`--schedule`, also spelled `--pipeline_schedule`, and
    `--virtual_stages`; recipes 4 and 5) and the MoE one (`num_experts`,
    recipe 8; the pipeline recipes default it to 0) are carried."""
    parser = argparse.ArgumentParser()
    d = TrainFlags()
    for name, typ in _CORE_FLAGS:
        parser.add_argument(f"--{name}", type=typ, default=getattr(d, name))
    if cpu_offload:
        parser.add_argument("--cpu_offload", action="store_true")
    if cp_attention:
        parser.add_argument("--cp_attention", choices=("ring", "ulysses"),
                            default=d.cp_attention)
    if pipeline_schedule:
        parser.add_argument("--schedule", "--pipeline_schedule", dest="pipeline_schedule",
                            choices=("gpipe", "1f1b"), default=d.pipeline_schedule)
        parser.add_argument("--virtual_stages", type=int, default=d.virtual_stages)
    if num_experts:
        parser.add_argument("--num_experts", type=int, default=default_experts)
        parser.add_argument("--moe_top_k", type=int, default=d.moe_top_k)
        parser.add_argument("--moe_dispatch", choices=("a2a", "xla", "pallas"),
                            default=d.moe_dispatch)
    for name in ("disable_amp", "disable_compile", "async_checkpoint", "no_metrics",
                 "debug_nans", "log_grad_norms", "quant_stochastic", "remat", "scan_layers"):
        parser.add_argument(f"--{name}", action="store_true")
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--dropout", type=float, default=d.dropout)
    parser.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    parser.add_argument("--checkpoint_format", choices=("auto", "consolidated", "sharded"),
                        default=d.checkpoint_format,
                        help="auto (the default): the port's own checkpoint-<step>.pt; "
                        "consolidated: tpukit's flax msgpack + sha256 sidecar; sharded: "
                        "tpukit's directory of npz blocks + manifest. tpukit reads the last "
                        "two; `--resume` and the server read all three")
    parser.add_argument("--keep_checkpoints", type=int, default=d.keep_checkpoints)
    parser.add_argument("--resume", type=str, default=d.resume)
    parser.add_argument("--prefetch", type=int, default=d.prefetch)
    for name in ("compilation_cache_dir", "profile_dir", "metrics_log", "metrics_dir",
                 "heartbeat_dir", "debug_dir", "chaos_spec"):
        parser.add_argument(f"--{name}", type=str, default=getattr(d, name))
    parser.add_argument("--spike_threshold", type=float, default=d.spike_threshold)
    parser.add_argument("--spike_action", choices=("warn", "abort"), default=d.spike_action)
    parser.add_argument("--heartbeat_timeout", type=float, default=d.heartbeat_timeout)
    parser.add_argument("--hang_timeout", type=float, default=d.hang_timeout)
    parser.add_argument("--trace_on_anomaly", type=int, default=d.trace_on_anomaly)
    parser.add_argument("--divergence_check_freq", type=int, default=d.divergence_check_freq)
    parser.add_argument("--on_anomaly", choices=("none", "rollback"), default=d.on_anomaly)
    parser.add_argument("--max_rollbacks", type=int, default=d.max_rollbacks)
    parser.add_argument("--io_retries", type=int, default=d.io_retries)
    parser.add_argument("--comm_dtype", choices=("f32", "bf16", "int8"), default=d.comm_dtype)
    parser.add_argument("--grad_buckets", type=int, default=d.grad_buckets)
    parser.add_argument("--microbatches", type=int, default=d.microbatches)
    parser.add_argument("--device", choices=("cuda", "cpu"), default=d.device)
    return parser


def parse_flags(argv=None, cpu_offload: bool = False, num_experts: bool = False,
                pipeline_schedule: bool = False, default_experts: int = 8,
                cp_attention: bool = False) -> TrainFlags:
    return TrainFlags(**vars(build_parser(cpu_offload, num_experts, pipeline_schedule,
                                          default_experts, cp_attention).parse_args(argv)))


def check_carried(flags: TrainFlags) -> None:
    """Raise `NotPortedError` for the first flag this slice does not carry
    that differs from its default."""
    default = TrainFlags()
    for name, item in NOT_CARRIED.items():
        value = getattr(flags, name)
        if value == getattr(default, name):
            continue
        raise NotPortedError(f"--{name} {value!r} is not in the port yet (ROADMAP.md, "
                             f"queue A {item})")
