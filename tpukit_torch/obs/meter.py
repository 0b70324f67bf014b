"""Throughput and MFU metering, the profiler trace and the JSONL step log
(twin of `tpukit/obs/meter.py`).

  - `MFUMeter`: tokens/sec, tokens/sec/card and model FLOPs utilization
    against the card's peak dense bf16 rate (`peak_flops_per_chip`).
  - `profiler_trace`: `torch.profiler` around the training loop when
    `--profile_dir` is set; on a CUDA device it records CPU and CUDA
    activity and writes a Chrome trace into the directory.
  - `StepLogger`: machine-readable JSONL records (the surface
    `tools/report.py` renders), one write per line.

FLOPs model (tpukit's, the PaLM appendix's): per token, a forward pass
costs `2 * P_matmul` for the parameter matmuls plus `4 * S * inner_dim` per
layer for the attention scores and values; training costs 3x forward.
Embedding gathers are left out of P_matmul; the lm_head is counted at the
padded vocab width.

**The clock** (the port's rule since its first trainer, tpukit's meter
otherwise): one clock for the run, started when the first step returns
with the card's queue drained (`update` after a sync: that step's tokens
are not counted, so the kernels' first build and load stay out), the real
tokens of every later step added, the time read only after a sync
(`tick`: the window's read of the loss, the epoch's end). Reading the time
at a step's enqueue would time the host's queue, not the card.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

from tpukit_torch.model.gpt import FFN_MULT, GPTConfig

# Peak dense bf16 FLOP/s per card, by `torch.cuda.get_device_name()` prefix:
# the H100 SXM's datasheet figure (the one PERF.md's kernel bounds use).
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def device_kind(device=None) -> str | None:
    """`torch.cuda.get_device_name` of a CUDA device, None elsewhere (no
    sync: the name is the driver's)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def peak_flops_per_chip(kind: str | None = None) -> float | None:
    """The card's peak dense bf16 FLOP/s, or None (the CPU, an unknown
    card): MFU is then undefined, as on tpukit's CPU."""
    if not kind:
        return None
    for key, val in sorted(_PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if kind.lower().startswith(key.lower()):
            return val
    return None


def matmul_param_count(cfg: GPTConfig) -> int:
    """Parameters that take part in matmuls (no embedding gathers), the
    lm_head at the padded vocab width."""
    inner = cfg.inner_dim
    per_layer = 3 * cfg.dim * inner + inner * cfg.dim + 2 * cfg.dim * (cfg.dim * FFN_MULT)
    return cfg.num_layers * per_layer + cfg.dim * cfg.padded_vocab_size


def train_flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """fwd (2 P + attention) x 3 for forward and backward."""
    attn = 4 * seq_len * cfg.inner_dim * cfg.num_layers
    return 3 * (2 * matmul_param_count(cfg) + attn)


def moe_active_flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Training FLOPs per token counting only the active expert parameters
    (the `router_top_k` routed experts plus the router); a dense config's
    `train_flops_per_token`."""
    if cfg.num_experts <= 0:
        return train_flops_per_token(cfg, seq_len)
    inner = cfg.inner_dim
    ffn = 2 * cfg.dim * (cfg.dim * FFN_MULT)
    per_layer = (3 * cfg.dim * inner + inner * cfg.dim + cfg.router_top_k * ffn
                 + cfg.dim * cfg.num_experts)
    params = cfg.num_layers * per_layer + cfg.dim * cfg.padded_vocab_size
    attn = 4 * seq_len * inner * cfg.num_layers
    return 3 * (2 * params + attn)


class MFUMeter:
    """tokens/sec and MFU over the run (the clock rule above). `update`
    once a step with the step's real global tokens; `tick` after a sync."""

    def __init__(self, cfg: GPTConfig, seq_len: int, num_chips: int = 1,
                 peak: float | None = None):
        self.flops_per_token = train_flops_per_token(cfg, seq_len)
        self.num_chips = num_chips
        self.peak = peak
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self._tokens = 0
        self._steps = 0
        self._elapsed = 0.0

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def update(self, tokens: int) -> None:
        """The first call starts the clock (call it after a sync; its tokens
        are not counted); later calls add their tokens."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
            return
        self._tokens += tokens
        self._steps += 1

    def tick(self) -> None:
        """Read the clock (after a sync): the elapsed time the rates use."""
        if self._t0 is not None:
            self._elapsed = time.perf_counter() - self._t0

    @property
    def total_tokens(self) -> int:
        """Real global tokens of the timed steps (every step but the first)."""
        return self._tokens

    @property
    def elapsed(self) -> float:
        return self._elapsed

    @property
    def tokens_per_sec(self) -> float | None:
        if self._steps == 0 or self._elapsed <= 0:
            return None
        return self._tokens / self._elapsed

    @property
    def tokens_per_sec_per_chip(self) -> float | None:
        tps = self.tokens_per_sec
        return tps / self.num_chips if tps else None

    @property
    def mfu(self) -> float | None:
        tps = self.tokens_per_sec_per_chip
        if tps is None or self.peak is None:
            return None
        return tps * self.flops_per_token / self.peak


def profiler_activities(device) -> list:
    """CPU activity, and CUDA activity on a CUDA device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def export_trace(prof, directory, device, name: str) -> Path:
    """Write `prof`'s Chrome trace as `<directory>/<name>`; on a CUDA device
    raise unless the profiler recorded CUDA kernels (a profiler that sees
    only the host would pass a trace with no device in it)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / name
    prof.export_chrome_trace(str(path))
    if torch.device(device).type == "cuda":
        events = json.loads(path.read_text()).get("traceEvents", [])
        if not any(ev.get("cat") == "kernel" for ev in events):
            raise RuntimeError(f"the profiler recorded no CUDA kernel on {device} "
                               f"(trace {path}): CUPTI tracing is unavailable")
    return path


@contextlib.contextmanager
def profiler_trace(profile_dir: str = "", device="cpu", rank: int = 0):
    """`torch.profiler` around the block when `profile_dir` is set (a no-op
    otherwise): CPU and, on a CUDA device, CUDA activity; on exit the Chrome
    trace `trace-p<rank>.json` lands in the directory."""
    if not profile_dir:
        yield
        return
    with torch.profiler.profile(activities=profiler_activities(device)) as prof:
        yield
    export_trace(prof, profile_dir, device, f"trace-p{rank:05d}.json")


class StepLogger:
    """The JSONL log (`--metrics_log`): one JSON object a line, told apart
    by `kind`. A no-op when `path` is empty. The stream is opened once,
    line-buffered, and each record is one `write` of one whole line, so a
    crash leaves at worst one torn last line, which `tools/report.py`'s
    loader tolerates."""

    def __init__(self, path: str = ""):
        self._f = open(path, "a", buffering=1) if path else None

    def log(self, **record) -> None:
        if self._f is None:
            return
        record.setdefault("time", time.time())
        self._f.write(json.dumps(record) + "\n")  # one write per record

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
