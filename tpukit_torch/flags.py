"""The training CLI flags (twin of `tpukit/flags.py:24-373`, the training
parser).

Every tpukit flag parses, with tpukit's name and default, plus `--device`
(cuda unless `cpu` is asked for). `check_carried` raises `NotPortedError`,
naming the ROADMAP.md item, for a flag this slice does not carry that is set
to anything but its default. `--prefetch` is accepted as given: tpukit
documents its prefetch thread as value-identical to the synchronous path
(`flags.py:72-76`), and the port loads synchronously. `--disable_compile`
is accepted: the port runs eagerly either way. `--num_workers` is accepted
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
    resume: str = ""  # a checkpoint path ("latest" is not carried)
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
    "cpu_offload": "item 6 'FSDP'",
    "dropout": "item 9 'Seeded sampling' (dropout parity needs threefry)",
    "checkpoint_format": "item 6 'FSDP' (sharded checkpoints)",
    "async_checkpoint": "item 17 'Resilience'",
    "keep_checkpoints": "item 17 'Resilience'",
    "compilation_cache_dir": "item 18 'Tracing and metrics' (the eager port compiles no "
                             "programs to cache)",
    "profile_dir": "item 18 'Tracing and metrics'",
    "metrics_log": "item 18 'Tracing and metrics' (JSONL StepLogger records)",
    "metrics_dir": "item 18 'Tracing and metrics'",
    "debug_nans": "item 18 'Tracing and metrics'",
    "log_grad_norms": "item 18 'Tracing and metrics'",
    "spike_threshold": "item 18 'Tracing and metrics'",
    "spike_action": "item 18 'Tracing and metrics'",
    "heartbeat_dir": "item 17 'Resilience'",
    "heartbeat_timeout": "item 17 'Resilience'",
    "hang_timeout": "item 18 'Tracing and metrics'",
    "debug_dir": "item 18 'Tracing and metrics'",
    "trace_on_anomaly": "item 18 'Tracing and metrics'",
    "divergence_check_freq": "item 18 'Tracing and metrics'",
    "on_anomaly": "item 17 'Resilience'",
    "max_rollbacks": "item 17 'Resilience'",
    "io_retries": "item 17 'Resilience'",
    "chaos_spec": "item 17 'Resilience'",
    "microbatches": "item 7 'Pipeline and pipeline x DDP'",
    "cp_attention": "item 15 'Context parallel'",
    "pipeline_schedule": "item 7 'Pipeline and pipeline x DDP'",
    "virtual_stages": "item 7 'Pipeline and pipeline x DDP'",
    "comm_dtype": "item 16 'Quantized collectives and grad buckets'",
    "quant_stochastic": "item 16 'Quantized collectives and grad buckets'",
    "grad_buckets": "item 16 'Quantized collectives and grad buckets'",
}


def build_parser(num_experts: bool = False) -> argparse.ArgumentParser:
    """tpukit's training parser plus `--device`; of its recipe-specific
    groups, only the MoE one (`num_experts`, recipe 8) is carried."""
    parser = argparse.ArgumentParser()
    d = TrainFlags()
    for name, typ in _CORE_FLAGS:
        parser.add_argument(f"--{name}", type=typ, default=getattr(d, name))
    if num_experts:
        parser.add_argument("--num_experts", type=int, default=8)
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
                        default=d.checkpoint_format)
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


def parse_flags(argv=None, num_experts: bool = False) -> TrainFlags:
    return TrainFlags(**vars(build_parser(num_experts).parse_args(argv)))


def check_carried(flags: TrainFlags) -> None:
    """Raise `NotPortedError` for the first flag this slice does not carry
    that differs from its default ("consolidated" checkpoints are the
    port's own format, so that value is carried too)."""
    default = TrainFlags()
    for name, item in NOT_CARRIED.items():
        value = getattr(flags, name)
        if value == getattr(default, name):
            continue
        if name == "checkpoint_format" and value == "consolidated":
            continue
        raise NotPortedError(f"--{name} {value!r} is not in the port yet (ROADMAP.md, "
                             f"queue A {item})")
    if flags.resume == "latest":
        raise NotPortedError("--resume latest is not in the port yet (ROADMAP.md, queue A "
                             "item 17 'Resilience'); pass a checkpoint path")
    if flags.prefetch < 0:
        raise ValueError(f"--prefetch must be >= 0, got {flags.prefetch}")
