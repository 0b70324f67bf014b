"""The trainer: train state, steps and the epoch loop (twin of the core of
`tpukit/train.py`: `make_optimizer` :116, the steps of `make_step_fns`
:156-183, `fit` :362 and `_fit_body` :444).

Loop surface, as tpukit's:
  - the running train loss printed every PRINT_FREQ = 8 steps (the first
    window closes at the 9th step, as tpukit's `i > 0 and not i % 8`);
  - per-epoch validation loss and masked accuracy, weighted by each
    batch's valid-token count, in bf16 whatever `--disable_amp` says;
  - three greedy samples of GENERATION_PROMPTS per epoch (20 new tokens,
    clamped to the position table), through `sampling.generate_batch`:
    one full-width prefill of the batch and ring-cached steps, as tpukit's
    `generate_samples` decodes them. The config has no `moe_dispatch`, so
    MoE samples run the meshless "xla" dispatch, as tpukit's do;
  - a checkpoint at the end (and every `--checkpoint_every` steps) in the
    `--checkpoint_format` (`checkpoint.save_auto`: the port's `.pt` by
    default, tpukit's consolidated msgpack or sharded directory on
    request); `--resume` reads any of the three;
  - a strategy's host transform of every batch (`host_batch_fn`, tpukit
    `train.py:685-694`: ContextParallel's zigzag permutation) before it
    moves to the device;
  - throughput and MFU by the meter (`obs/meter.py`): one clock for the
    run, started when the first step returns (the card's queue drained),
    the real global tokens of every later step (the loader's closed-form
    row counts, no collective), the time read after a sync.
Under `DataParallel`, `FSDP`, the pipeline, `TensorParallel`,
`ContextParallel` and `ExpertParallel` the loop is rank-aware
(tpukit `train.py:501-545`): the global batch is `--batch_size` x data
replicas rows, each replica (under `ExpertParallel` each rank of the grid)
loading its `DistributedSampler` share (every stage rank of a pipeline
replica the same rows); eval sums and the train token count are summed
over the ranks that hold different rows; rank 0 alone prints, samples and
writes the checkpoint, after every rank has taken part in gathering what
they need. The step runs eagerly: forward, loss, backward and `torch.optim.AdamW` in
place.

The recovery plane (tpukit `train.py:362-443` and `_fit_body`'s helpers,
ROADMAP.md item 17): `--prefetch N` runs the host pipeline N batches ahead
on a worker thread (`prefetch.py`); `--resume latest` takes the newest good
checkpoint; an explicit `--resume PATH` must verify; a preemption
checkpoint's sidecar continues its epoch at its batch; SIGTERM/SIGINT
checkpoint and raise `Preempted` (exit 75); the loss sentinel
(`--spike_threshold`) warns, aborts (76) or, under `--on_anomaly
rollback`, restores the newest good checkpoint older than the window in
place (77 once `--max_rollbacks` is spent); `--chaos_spec` injects faults;
`--io_retries` retries transient I/O; `--async_checkpoint` and
`--keep_checkpoints` write in the background and prune; `--heartbeat_dir`
holds the heartbeat files and, for several ranks, the collective rollback
and preemption decisions.

Telemetry and failure observability (tpukit `train.py:739-2001`, `obs/`):
rank 0 writes tpukit's JSONL records to `--metrics_log` (`train` a window,
with tokens/sec, MFU on the card's peak, goodput and the span fractions,
the norms of `--log_grad_norms`, the `hbm` gauges and the prefetch gauges;
`validation`, `epoch`, the `metrics` epilogue; and the events: `retry`,
`chaos`, `preempt`, `rollback`, `resize`, `ckpt_prune`, `spike`,
`straggler`, `divergence`, `divergence_check`, `watchdog`,
`anomaly_trace`), and every rank a metrics snapshot to `--metrics_dir`.
The flight recorder is always on; `--hang_timeout` arms the watchdog
around every warm iteration and `--debug_dir` holds its bundles;
`--trace_on_anomaly K` profiles K steps after the first anomaly,
`--profile_dir` the whole loop (`torch.profiler`); `--divergence_check_freq
N` checksums the state every N steps into the heartbeats, and a divergence
drives the deferred collective rollback; `--debug_nans` raises
`FloatingPointError` at the first NaN. The `xla` record comes from the comm
audit (`analysis/`): rank 0's first train and eval step recorded, their
collectives against the strategy's plan; its `flops`, `bytes_accessed`,
`transcendentals` and `memory` are None (no compiled program). No `compile_cache` record: the
eager port compiles no programs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode

from tpukit_torch import random as tk_random
from tpukit_torch import resolve_device
from tpukit_torch import chaos as chaos_lib
from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch import mesh as mesh_lib
from tpukit_torch import reshard as reshard_lib
from tpukit_torch import retry as retry_lib
from tpukit_torch.analysis import comm_ir
from tpukit_torch.analysis import xla_record
from tpukit_torch.batching import IGNORE_INDEX, prepare_batch
from tpukit_torch.data import get_dataset, get_tokenizer, transform_dataset
from tpukit_torch.flags import TrainFlags, check_carried
from tpukit_torch.loader import DataLoader
from tpukit_torch.model import gpt
from tpukit_torch.obs.divergence import format_checksum, make_state_checksum
from tpukit_torch.obs.heartbeat import Heartbeat
from tpukit_torch.obs.memory import live_memory_stats
from tpukit_torch.obs.meter import (MFUMeter, StepLogger, device_kind, peak_flops_per_chip,
                                    profiler_trace)
from tpukit_torch.obs.metrics import (MetricRegistry, merge_snapshot_dir, publish_snapshot,
                                      write_merged)
from tpukit_torch.obs.recorder import FlightRecorder
from tpukit_torch.obs.sentinels import SpikeSentinel, global_norms
from tpukit_torch.obs.spans import SpanTimeline, format_breakdown
from tpukit_torch.obs.watchdog import AnomalyTracer, HangWatchdog
from tpukit_torch.prefetch import HostPrefetcher
from tpukit_torch.recovery import (AnomalyAbort, PreemptCoordinator, Preempted,
                                   PreemptionGuard, RecoveryEngine, RollbackBudgetExhausted,
                                   RollbackCoordinator, RollbackPlan)
from tpukit_torch.sampling import generate_batch
from tpukit_torch.shardings import Strategy, leaves, unflatten

PRINT_FREQ = 8
GENERATION_PROMPTS = ["The big brown cat ", "One day, ", "She said "]


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), their optimizer, the
    number of steps taken, the strategy that set the tree up (None for
    a plain tree), which checkpoints gather and place leaves through, and
    the learning-rate schedule, if the rate is not constant."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0
    strategy: Strategy | None = None
    lr_schedule: Any = None  # count -> learning rate, or None for a constant rate


def make_optimizer(params: dict, learning_rate: float) -> torch.optim.AdamW:
    """`torch.optim.AdamW` over every leaf with tpukit's hyper-parameters
    (betas 0.9/0.999, eps 1e-8, weight decay 1e-2 on all leaves, as optax's
    adamw applies it). It updates the parameters in place; its rounding
    order differs from optax's by an ulp here and there. A tree that mixes
    FSDP's sharded DTensors with plain (replicated) leaves steps one leaf
    at a time: the multi-tensor kernels refuse the mixture."""
    flat = leaves(params)
    mixed = len({isinstance(p, DTensor) for p in flat}) > 1
    return torch.optim.AdamW(flat, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-2, foreach=False if mixed else None)


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """optax's `cosine_decay_schedule(init_value, decay_steps)` (alpha 0,
    exponent 1): `count -> init_value * 0.5 * (1 + cos(pi * min(count,
    decay_steps) / decay_steps))`, in f32 as optax computes it under jit.
    optax's first update reads count 0."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}")

    def schedule(count: int) -> float:
        t = np.minimum(np.float32(count), np.float32(decay_steps))
        decay = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * t
                                                           / np.float32(decay_steps)))
        return float(np.float32(init_value) * decay)
    return schedule


def create_train_state(params: dict, learning_rate, strategy: Strategy | None = None,
                       cfg: gpt.GPTConfig | None = None) -> TrainState:
    """The state of `params`; with a strategy, of the tree its `setup`
    makes of them (wrapped, sharded under FSDP, this stage's block under
    the pipeline), after its `prepare_params` when `cfg` is given (tpukit
    `train.py:112`: the pipeline's padded, permuted stack), the optimizer
    built afterwards over that tree: each rank's AdamW covers its own
    leaves. `learning_rate` is a float, or a schedule `count -> rate`
    (`cosine_decay_schedule`, as optax takes one): `train_step` sets the
    rate of the update it is about to make, at count `state.step`."""
    for p in leaves(params):
        p.requires_grad_(True)
    if strategy is not None:
        if cfg is not None:
            params = strategy.prepare_params(params, cfg)
            for p in leaves(params):
                p.requires_grad_(True)
        params = strategy.setup(params)
    schedule = learning_rate if callable(learning_rate) else None
    rate = schedule(0) if schedule is not None else learning_rate
    return TrainState(params=params, optimizer=make_optimizer(params, rate),
                      strategy=strategy, lr_schedule=schedule)


def to_device(model_batch: dict, targets: np.ndarray, device) -> tuple[dict, torch.Tensor]:
    """`prepare_batch`'s numpy output as tensors on `device`."""
    return host_to_device(to_host(model_batch, targets, pin=False), device)


def to_host(model_batch: dict, targets: np.ndarray, pin: bool) -> tuple[dict, torch.Tensor]:
    """`prepare_batch`'s numpy output as host tensors, in pinned memory with
    `pin` (host work only: the prefetch worker runs it)."""
    def tensor(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.pin_memory() if pin else t
    return {k: tensor(v) for k, v in model_batch.items()}, tensor(targets)


def host_to_device(host: tuple[dict, torch.Tensor], device) -> tuple[dict, torch.Tensor]:
    """`to_host`'s tensors on `device`, copied on the training thread's
    current stream (asynchronously from pinned memory)."""
    batch, targets = host
    return ({k: v.to(device, non_blocking=True) for k, v in batch.items()},
            targets.to(device, non_blocking=True))


def dropout_key(seed: int, step: int, device) -> torch.Tensor:
    """The dropout key of training step `step` (tpukit `train.py:145-167`):
    `fold_in(PRNGKey(seed ^ 0x5EED), step)`."""
    return tk_random.fold_in(tk_random.PRNGKey(seed ^ 0x5EED, device=device), step)


def train_step(state: TrainState, cfg: gpt.GPTConfig, strategy: Strategy, batch: dict,
               targets, seed: int = 0, log_grad_norms: bool = False):
    """One step: loss and gradients by the strategy, then AdamW in place.
    With `cfg.dropout > 0` the step draws its masks from `dropout_key(seed,
    step)`; the same key feeds the stochastic rounding of the int8
    gradient wire (`quant_stochastic`, tpukit `train.py:149-152`). Returns
    the loss (a detached device scalar); with `log_grad_norms`, (loss,
    `{grad,update,param}_norm` device scalars), as tpukit's step returns
    them: the update is the parameters' change over AdamW's in-place step,
    taken against a copy made before it."""
    keyed = cfg.dropout > 0 or (cfg.quant_stochastic and cfg.comm_dtype == "int8")
    rng = dropout_key(seed, state.step, targets.device) if keyed else None
    loss, grads = strategy.value_and_grad(state.params, cfg, batch, targets, rng=rng)
    flat = leaves(state.params)
    before = [p.detach().clone() for p in flat] if log_grad_norms else None
    for p, g in zip(flat, leaves(grads)):
        p.grad = g
    if state.lr_schedule is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_schedule(state.step)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    if not log_grad_norms:
        return loss
    updates = unflatten(state.params, [p.detach() - b for p, b in zip(flat, before)])
    return loss, global_norms(grads, updates, state.params, strategy=state.strategy)


def eval_step(state: TrainState, cfg: gpt.GPTConfig, strategy: Strategy, batch: dict,
              targets) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy x 100) in bf16 compute: tpukit's eval autocast is
    always on (`train.py:144`)."""
    with torch.no_grad():
        return strategy.loss_fn(state.params, cfg.replace(compute_dtype=torch.bfloat16),
                                batch, targets, with_accuracy=True)


def generate_samples(params: dict, cfg: gpt.GPTConfig, tokenizer,
                     prompts=GENERATION_PROMPTS, max_new_tokens: int = 20,
                     temperature: float = 0.0, top_k: int = 0, seed: int = 0) -> list[str]:
    """Continuations of `prompts` in one batched ring-cached decode (twin of
    `tpukit/train.py:302`), greedy unless `temperature > 0`, decoded with
    special tokens skipped, on the device the parameters are on."""
    with torch.no_grad():
        return generate_batch(params, cfg, list(prompts), tokenizer,
                              max_new_tokens=max_new_tokens, temperature=temperature,
                              top_k=top_k, seed=seed)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    tokenizer: Any
    config: gpt.GPTConfig
    checkpoint_path: Any
    metrics: dict


def build_config(flags: TrainFlags, vocab_size: int) -> gpt.GPTConfig:
    """The model config of a run (tpukit `train.py:466-483`)."""
    return gpt.GPTConfig(
        dim=flags.dim, head_dim=flags.head_dim, heads=flags.heads,
        num_layers=flags.num_layers, vocab_size=vocab_size,
        max_position_embeddings=flags.sequence_length, dropout=flags.dropout,
        compute_dtype=torch.float32 if flags.disable_amp else torch.bfloat16,
        remat_layers=flags.remat, scan_layers=flags.scan_layers,
        num_experts=flags.num_experts, router_top_k=flags.moe_top_k,
        virtual_stages=flags.virtual_stages, comm_dtype=flags.comm_dtype,
        quant_stochastic=flags.quant_stochastic, grad_buckets=flags.grad_buckets,
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _NanCheck(TorchFunctionMode):
    """Every floating tensor a torch function returns on this thread is
    checked for NaN (uninitialized `empty` buffers aside)."""

    _UNINITIALIZED = {"empty", "empty_like", "new_empty", "empty_strided",
                      "new_empty_strided"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") not in self._UNINITIALIZED:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if not isinstance(t, torch.Tensor) or not t.is_floating_point():
                    continue
                local = t.to_local() if isinstance(t, DTensor) else t
                if local.numel() and bool(torch.isnan(local).any()):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def _debug_nans_scope():
    """`--debug_nans` (twin of tpukit `train.py:344-351`, which sets
    `jax_debug_nans`): raise `FloatingPointError` at the first NaN a forward
    op returns (`_NanCheck`, a torch function mode on the training thread)
    or a backward function returns (`torch.autograd.detect_anomaly`, the
    kernels' `autograd.Function`s included). As `jax_debug_nans`, NaN only:
    an Inf passes (the plain flash path and the ring carry -inf masks by
    design). The previous state comes back on any exit."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True), _NanCheck():
            yield
    except RuntimeError as exc:
        if "returned nan values" in str(exc):
            raise FloatingPointError(str(exc)) from exc
        raise


def _check_recovery_flags(flags: TrainFlags) -> None:
    """tpukit's flag validation (`train.py:379-400`)."""
    if flags.prefetch < 0:
        raise ValueError(f"--prefetch must be >= 0, got {flags.prefetch}")
    if flags.hang_timeout < 0:
        raise ValueError(f"--hang_timeout must be >= 0, got {flags.hang_timeout}")
    if flags.divergence_check_freq < 0:
        raise ValueError(f"--divergence_check_freq must be >= 0, got "
                         f"{flags.divergence_check_freq}")
    if flags.on_anomaly not in ("none", "rollback"):
        raise ValueError(f"--on_anomaly must be none|rollback, got {flags.on_anomaly!r}")
    if flags.max_rollbacks < 0:
        raise ValueError(f"--max_rollbacks must be >= 0, got {flags.max_rollbacks}")
    if flags.io_retries < 0:
        raise ValueError(f"--io_retries must be >= 0, got {flags.io_retries}")
    if flags.keep_checkpoints < 0:
        raise ValueError(f"--keep_checkpoints must be >= 0 (0 keeps everything), got "
                         f"{flags.keep_checkpoints}")


def fit(flags: TrainFlags, strategy: Strategy, num_epochs: int | None = None) -> FitResult:
    """The training entry point of the port's recipes: data, model, the
    epoch loop, samples and the final checkpoint. Runs on `flags.device`
    (cuda unless `cpu` is asked for). Validates the recovery and telemetry
    flags, installs the chaos engine, the I/O retry policy and the
    preemption guard for the run, and takes them down again on every way
    out (tpukit `train.py:362-443`)."""
    check_carried(flags)
    _check_recovery_flags(flags)
    device = resolve_device(flags.device)
    rank, nprocs = 0, 1
    if strategy.distributed:
        device = mesh_lib.initialize_runtime(device)
        rank, nprocs = mesh_lib.rank(), mesh_lib.world_size()
    if flags.on_anomaly == "rollback" and nprocs > 1 and not flags.heartbeat_dir:
        raise ValueError("--on_anomaly rollback needs --heartbeat_dir on multi-process "
                         "runs: the rollback decision is published through the shared "
                         "heartbeat directory")
    chaos_engine = (chaos_lib.ChaosEngine(flags.chaos_spec, seed=flags.seed, process_index=rank,
                                          process_count=nprocs)
                    if flags.chaos_spec else None)
    retry_log = retry_lib.RetryLog()
    prev_policy = retry_lib.set_default_policy(retry_lib.RetryPolicy(retries=flags.io_retries))
    retry_lib.set_observer(retry_log)
    prev_chaos = chaos_lib.install(chaos_engine)
    guard = PreemptionGuard()
    try:
        with guard:
            return _fit_body(flags, strategy, num_epochs, device, chaos_engine, retry_log, guard)
    finally:
        chaos_lib.install(prev_chaos)
        retry_lib.set_observer(None)
        retry_lib.set_default_policy(prev_policy)


def _restore_io(path: Path) -> dict:
    """A checkpoint's fields of tpukit's `resize` record: its format, the
    bytes read (on disk) and the blocks (a file is one; a sharded
    directory, its shards' arrays)."""
    if path.is_dir():
        shards = sorted(path.glob("shard-*.npz"))
        blocks = 0
        for shard in shards:
            with np.load(shard) as archive:
                blocks += len(archive.files)
        return {"format": "sharded", "bytes_read": sum(f.stat().st_size for f in shards),
                "blocks_read": blocks}
    return {"format": "pt" if path.suffix == ".pt" else "consolidated",
            "bytes_read": path.stat().st_size, "blocks_read": 1}


def _fit_body(flags: TrainFlags, strategy: Strategy, num_epochs: int | None, device,
              chaos_engine, retry_log, preempt_guard: PreemptionGuard) -> FitResult:
    tokenizer = get_tokenizer()
    tokenizer.pad_token_id = 2  # every recipe pins pad to 2
    pad_id = tokenizer.pad_token_id
    cfg = build_config(flags, tokenizer.vocab_size)
    strategy.validate_config(cfg)
    rank = shard_rank = 0
    nprocs = 1
    if strategy.distributed:
        rank, nprocs, shard_rank = mesh_lib.rank(), mesh_lib.world_size(), strategy.row_shard()
    replicas, shards = strategy.data_replicas, strategy.row_shards
    p0 = rank == 0
    global_batch = flags.batch_size * replicas
    if global_batch % strategy.batch_divisor:
        raise ValueError(
            f"global batch {global_batch} (batch_size {flags.batch_size} x "
            f"{replicas} data shards) must be a multiple of {strategy.batch_divisor} for the "
            f"{strategy.name} strategy")

    train_ds, validation_ds = get_dataset(slice_size=flags.dataset_slice)
    train_ds = transform_dataset(train_ds, tokenizer, max_length=flags.sequence_length)
    validation_ds = transform_dataset(validation_ds, tokenizer,
                                      max_length=flags.sequence_length)
    # the global batch is batch_size rows on each of the data replicas, its
    # rows split between the strategy's row shards (a replica each, or
    # under ExpertParallel a rank each), each loading its DistributedSampler
    # share (every stage rank of a pipeline replica the same rows);
    # wrap-padding keeps every train step full-shape; validation pads with
    # all-ignore rows so its metrics are those of the exact partial batch
    rows = global_batch // shards
    shard = dict(num_replicas=shards, rank=shard_rank)
    train_loader = DataLoader(train_ds, rows, shuffle=True, seed=flags.seed,
                              pad_to_batch=True, **shard)
    validation_loader = DataLoader(validation_ds, rows, shuffle=False,
                                   pad_to_batch=True, pad_mode="empty", pad_fill=pad_id,
                                   **shard)

    state = create_train_state(gpt.init_params(cfg, seed=flags.seed, device=device),
                               flags.learning_rate, strategy, cfg)
    # the world every save records, and a resume compares (tpukit :555-558)
    run_world = reshard_lib.current_world(strategy, global_batch=global_batch)

    # a preemption checkpoint continues its epoch at its batch (tpukit
    # :560-674); any other checkpoint trains --epochs more from batch 0
    start_epoch, start_skip = 0, 0
    resize_event = None
    if flags.resume:
        resume_path = (ckpt_lib.latest_any() if flags.resume == "latest"
                       else Path(flags.resume))
        if resume_path is None or not resume_path.exists():
            raise FileNotFoundError(f"--resume {flags.resume}: no checkpoint found")
        if flags.resume != "latest":  # latest_any verified its pick
            ok, detail = ckpt_lib.verify_checkpoint(resume_path)
            if not ok:
                raise ValueError(f"--resume {flags.resume}: checkpoint {resume_path} "
                                 f"failed integrity verification ({detail})")
        meta = ckpt_lib.read_meta(resume_path)
        saved_w = reshard_lib.saved_world(resume_path)
        mismatch = reshard_lib.describe_mismatch(saved_w, run_world)
        if mismatch and meta and meta.get("resize_to") is not None:
            want = int(meta["resize_to"])
            if want != run_world["device_count"]:
                raise RuntimeError(
                    f"--resume {flags.resume}: checkpoint {resume_path} was "
                    f"preempt-saved by a resize@N:{want} chaos fault "
                    f"expecting relaunch at {want} devices, but this world "
                    f"has {run_world['device_count']}")
        swept = (reshard_lib.sweep_stale_world(flags.heartbeat_dir)
                 if mismatch and flags.heartbeat_dir and p0 else [])
        t_restore = time.perf_counter()
        ckpt_lib.restore_any(resume_path, state)
        if mismatch:
            # the restore put another world's checkpoint in place: tpukit's
            # elastic-resize record (its `reshard_restore` info, :619-631)
            resize_event = dict(
                kind="resize", step=state.step, checkpoint=str(resume_path),
                mismatch=mismatch, saved_world=saved_w, world=run_world, swept=swept,
                **_restore_io(resume_path), wall_s=round(time.perf_counter() - t_restore, 6))
        if meta and meta.get("preempted"):
            start_epoch = int(meta.get("epoch", 0))
            start_skip = int(meta.get("batch_in_epoch", 0))
            saved_gb = (saved_w or {}).get("global_batch")
            if start_skip and saved_gb and saved_gb != global_batch:
                warnings.warn(
                    f"mid-epoch resume across a global-batch change "
                    f"({saved_gb} -> {global_batch} rows): batch_in_epoch "
                    f"counts the OLD world's batches, so the stream position "
                    f"is approximate — hold batch_size x data-shards "
                    f"constant across a resize for exact continuation", stacklevel=2)
        if p0:
            print(f"resumed from {resume_path} at step {state.step}"
                  + (f" (resharded: {mismatch})" if mismatch else "")
                  + (f" (preempted mid-epoch: continuing epoch {start_epoch} at batch "
                     f"{start_skip})" if meta and meta.get("preempted") else ""))
    if chaos_engine is not None and chaos_engine.skip_batches:
        # skip@N: the stream position a rollback leaves, step counter kept
        start_skip += chaos_engine.skip_batches

    epochs = flags.epochs if num_epochs is None else num_epochs
    windows, eval_metrics, texts = [], {}, []
    checkpoint_path = None

    # the strategy's host transform (ContextParallel's zigzag permutation),
    # applied to every train and eval batch before it moves to the device
    host_batch = strategy.host_batch_fn(cfg)
    pin = device.type == "cuda"

    def host_pipeline(raw):
        """The host side of one batch, which the prefetch worker runs."""
        model_batch, targets = prepare_batch(raw, pad_id)
        if host_batch is not None:
            model_batch, targets = host_batch(model_batch, targets)
        return raw, to_host(model_batch, targets, pin)

    def on_device(raw):
        return host_to_device(host_pipeline(raw)[1], device)

    async_saver = ckpt_lib.AsyncCheckpointer() if flags.async_checkpoint else None

    def save_checkpoint(meta: dict | None = None):
        meta = {**(meta or {}), "world": run_world}
        saver = async_saver if async_saver is not None else ckpt_lib
        return saver.save_auto(state, flags.checkpoint_format, flags, meta=meta)

    def prune() -> None:
        """Retention (--keep_checkpoints K) after a publish, with its
        `ckpt_prune` record (tpukit :716-737)."""
        if flags.keep_checkpoints <= 0 or not p0:
            return
        removed = ckpt_lib.prune_checkpoints(ckpt_lib.CHECKPOINT_DIR,
                                             keep=flags.keep_checkpoints,
                                             assume_newest_verified=True)
        if removed:
            logger.log(kind="ckpt_prune", step=host_step, keep=flags.keep_checkpoints,
                       pruned=removed)
            recorder.record("ckpt_prune", step=host_step, pruned=len(removed))

    # ---- telemetry (tpukit :739-790): rank 0 alone logs ------------------
    seq = flags.sequence_length - 1  # the model sees S - 1 after the shift
    meter = MFUMeter(cfg, seq, num_chips=nprocs, peak=peak_flops_per_chip(device_kind(device)))
    logger = StepLogger(flags.metrics_log if p0 else "")
    spans = SpanTimeline()
    recorder = FlightRecorder()  # always on: a bounded ring, read by bundles
    # the metrics plane derives from what the loop already measures; it
    # adds no sync, and --no_metrics changes no number of the run
    metric_reg = None if flags.no_metrics else MetricRegistry()

    def publish_metrics() -> None:
        """Each rank's snapshot into --metrics_dir at the window's cadence;
        rank 0 merges them (the heartbeat files' discipline)."""
        if metric_reg is None or not flags.metrics_dir:
            return
        publish_snapshot(flags.metrics_dir, rank, metric_reg, process_count=nprocs,
                         time_s=time.time())
        if p0:
            merged, meta = merge_snapshot_dir(flags.metrics_dir, nprocs)
            write_merged(flags.metrics_dir, merged, meta=meta)

    if resize_event is not None:
        logger.log(**resize_event)
        recorder.record("resize", step=resize_event["step"], mismatch=resize_event["mismatch"])

    # the window loss is the global mean on every rank, so the sentinel's
    # decisions are the same on every rank
    sentinel = SpikeSentinel(flags.spike_threshold) if flags.spike_threshold > 0 else None
    spike_events = 0
    heart = (Heartbeat(flags.heartbeat_dir, rank, nprocs, timeout_s=flags.heartbeat_timeout)
             if flags.heartbeat_dir else None)
    recovery = (RecoveryEngine(ckpt_lib.CHECKPOINT_DIR, max_rollbacks=flags.max_rollbacks,
                               coordinator=RollbackCoordinator(
                                   flags.heartbeat_dir or None, process_index=rank,
                                   process_count=nprocs, timeout_s=flags.heartbeat_timeout))
                if flags.on_anomaly == "rollback" else None)
    preempt_coord = None
    if nprocs > 1:
        if flags.heartbeat_dir:
            preempt_coord = PreemptCoordinator(flags.heartbeat_dir, process_index=rank,
                                               process_count=nprocs)
        elif p0:
            warnings.warn("multi-process run without --heartbeat_dir: a SIGTERM/SIGINT "
                          "preemption checkpoint cannot be coordinated across processes "
                          "and may deadlock the step-keyed collective save if ranks "
                          "observe the signal at different steps")
    host_step = state.step
    if preempt_coord is not None:
        preempt_coord.run_start = host_step  # this incarnation's tag
    timeline = 0  # rollbacks executed
    skip_save_step = -1  # no periodic re-save of the step just restored
    running, win_n, norms = None, 0, None
    pf_live: dict[str, Any] = {"pf": None}
    events: dict[str, list] = {"rollbacks": [], "chaos": [], "retries": [], "spikes": []}
    null_polls = [0]

    # ---- failure observability (tpukit :968-1077) ------------------------
    debug_dir = flags.debug_dir or (
        "debug" if flags.hang_timeout > 0 or flags.trace_on_anomaly > 0
        or flags.divergence_check_freq > 0 else "")

    def prefetch_probe():
        pf = pf_live["pf"]
        return None if pf is None else {"depth": pf.depth, "buffered": pf.buffered}

    watchdog = (HangWatchdog(
        debug_dir, timeout_s=flags.hang_timeout, recorder=recorder, heartbeat=heart,
        probes={"host_step": lambda: host_step,
                "async_checkpoint_in_flight": (
                    lambda: async_saver.in_flight if async_saver else False),
                "prefetcher": prefetch_probe},
        config=flags, device=device) if debug_dir else None)
    # trace-on-anomaly: the first anomaly arms a capture of the next K
    # steps; a whole-run --profile_dir trace excludes it (one profiler)
    tracer = (AnomalyTracer(os.path.join(debug_dir, "anomaly_trace"), flags.trace_on_anomaly,
                            device=device, rank=rank)
              if flags.trace_on_anomaly > 0 and debug_dir and not flags.profile_dir else None)
    checksum_fn = make_state_checksum() if flags.divergence_check_freq > 0 else None
    if checksum_fn is not None and nprocs > 1 and heart is None:
        raise ValueError(
            "--divergence_check_freq needs --heartbeat_dir on multi-"
            "process runs: checksums are compared across processes "
            "through the shared heartbeat files")
    last_checksum: tuple[int, str] | None = None  # (step, hex)
    reported_divergence: set = set()  # (process, checksum step, checksum) once each
    # a check step enqueues its folds; the window's sync reads them
    pending_checks: list[tuple[int, dict]] = []
    hangs_logged = 0

    def flush_checks() -> None:
        nonlocal last_checksum
        for st, ck in pending_checks:
            cs = format_checksum(ck)
            last_checksum = (st, cs)
            recorder.record("divergence_check", step=st, checksum=cs)
            logger.log(kind="divergence_check", step=st, checksum=cs)
        pending_checks.clear()

    def note_anomaly(reason: str, step: int) -> None:
        """Every anomaly lands in the ring; the first arms the trace."""
        recorder.record("anomaly", reason=reason, step=step)
        if tracer is not None and tracer.trigger(reason):
            logger.log(kind="anomaly_trace", event="armed", reason=reason, step=step)

    def dump_bundle(reason: str, step: int, **ctx):
        if watchdog is None:
            return None
        path = watchdog.trigger(reason, step=step, **ctx)
        if path is not None:
            logger.log(kind="watchdog", event="bundle", reason=reason, step=step,
                       bundle=str(path))
        return path

    def drain_side_events() -> None:
        """Retries and chaos firings since the last drain (any thread's)
        into the JSONL, the ring and the fit's events."""
        for ev in retry_log.drain():
            events["retries"].append(ev)
            logger.log(kind="retry", step=host_step, **ev)
            recorder.record("retry", step=host_step, **ev)
            if metric_reg is not None:
                metric_reg.inc("train_retries")
        if chaos_engine is not None:
            for ev in chaos_engine.drain_fired():
                rec = dict(ev)
                rec.setdefault("step", host_step)
                events["chaos"].append(rec)
                logger.log(kind="chaos", **rec)
                recorder.record("chaos", **rec)

    def check_preempt(consumed: int | None, epoch_idx: int) -> None:
        """SIGTERM/SIGINT: a durable checkpoint with the resume position
        (`consumed` batches of epoch `epoch_idx`; None once its training
        phase is done), then `Preempted` (tpukit :1099-1199). Several ranks
        meet at the decision file's boundary."""
        sig = preempt_guard.pending
        if preempt_coord is not None:
            boundary = consumed is None or host_step % PRINT_FREQ == 0
            if sig is not None:
                preempt_coord.request(sig)
            elif not boundary:
                return
            elif consumed is None:
                null_polls[0] += 1
                if null_polls[0] % PRINT_FREQ:
                    return
            dec = preempt_coord.read()
            if dec is None and p0 and boundary:
                req = sig or preempt_coord.any_request()
                if req is not None:
                    dec = preempt_coord.publish(
                        req, execute_after=(host_step // PRINT_FREQ + 2) * PRINT_FREQ)
            if dec is None or host_step != int(dec["execute_after"]):
                return
            sig = dec["signal"]
        elif sig is None:
            return
        if watchdog is not None:
            watchdog.disarm()
        if consumed is None:
            ep, nb = epoch_idx + 1, 0
        else:
            ep, nb = epoch_idx, consumed
            if nb >= len(train_loader):
                ep, nb = ep + 1, 0  # the epoch's end: the resume starts the next
        meta = {"step": host_step, "epoch": ep, "batch_in_epoch": nb, "preempted": True,
                "signal": sig}
        if chaos_engine is not None and chaos_engine.resize_target is not None:
            meta["resize_to"] = chaos_engine.resize_target
        with spans.span("checkpoint"):
            path = save_checkpoint(meta)
            if async_saver is not None:
                async_saver.wait()  # the exit is next: durable now
        recorder.record("preempt", step=host_step, signal=sig)
        logger.log(kind="preempt", step=host_step, signal=sig, epoch=ep, batch_in_epoch=nb,
                   checkpoint=str(path))
        if metric_reg is not None:
            metric_reg.inc("train_preempts")
        if heart is not None:
            heart.beat(host_step, timeline=timeline)
        drain_side_events()
        publish_metrics()
        if p0:
            print(f"preempted by {sig} at step {host_step}; checkpoint {path}", flush=True)
        logger.close()
        raise Preempted(f"{sig} at step {host_step}; checkpoint {path}; relaunch with "
                        f"--resume latest to continue", checkpoint=path, step=host_step)

    def abort_with(exc_cls, message: str):
        """A checkpoint of the blown-up state, then the exit code's error."""
        nonlocal checkpoint_path
        with spans.span("checkpoint"):
            checkpoint_path = save_checkpoint() or checkpoint_path
            if async_saver is not None:
                async_saver.wait()
        drain_side_events()
        publish_metrics()
        logger.close()
        raise exc_cls(f"{message}; state checkpointed at {checkpoint_path}")

    def execute_rollback(plan) -> None:
        """Restore the plan's checkpoint in place (the live parameter and
        optimizer tensors, so DDP's and FSDP's hold on them stays valid) and
        drop the abandoned timeline's host state; the stream is not rewound
        (tpukit :1224-1290)."""
        nonlocal host_step, running, win_n, norms, last_checksum, timeline, skip_save_step
        if watchdog is not None:
            watchdog.disarm()  # the restore's I/O may outlast the deadline
        if async_saver is not None:
            async_saver.wait()  # published before the quarantine sweep
        quarantined = recovery.quarantine(plan, process_zero=p0)
        pf = pf_live["pf"]
        with pf.quiesce() if pf is not None else contextlib.nullcontext(), \
                spans.span("checkpoint"):
            ckpt_lib.restore_any(plan.target_path, state)
        host_step = plan.target_step
        skip_save_step = host_step
        running, win_n, norms = None, 0, None
        if sentinel is not None:
            sentinel.reset()
        pending_checks.clear()
        last_checksum = None
        timeline += 1
        recovery.committed(plan)
        recovery.coordinator.ack(plan.seq, plan.target_step)
        rec = plan.record()
        logger.log(kind="rollback", timeline=timeline, quarantined=quarantined, **rec)
        recorder.record("rollback", **rec)
        if metric_reg is not None:
            metric_reg.inc("train_rollbacks")
        events["rollbacks"].append({**rec, "timeline": timeline, "quarantined": quarantined,
                                    "windows_before": len(windows)})
        if heart is not None:
            heart.beat(host_step, timeline=timeline)
        if p0:
            print(f"rollback {plan.seq}/{recovery.max_rollbacks} ({plan.reason} at step "
                  f"{plan.anomaly_step}): restored {plan.target_path} at step "
                  f"{plan.target_step}, {plan.steps_lost} steps lost; input stream continues "
                  f"forward", flush=True)

    def try_rollback(reason: str, anomaly_step: int) -> bool:
        """An immediate collective rollback, for anomalies every rank sees
        (the window loss): every rank plans from the shared directory (after
        the async write in flight has published, and a barrier); rank 0
        publishes the decision, the others confirm theirs. False: escalate
        (tpukit :1292-1308)."""
        if recovery is None:
            return False
        if async_saver is not None:
            async_saver.wait()
        mesh_lib.sync_global_devices()
        plan = recovery.plan(reason, anomaly_step, window=PRINT_FREQ)
        if plan is None:
            return False
        if p0:
            recovery.coordinator.publish(plan)
        else:
            recovery.coordinator.confirm(plan)
        execute_rollback(plan)
        return True

    pending_deferred: dict[int, Any] = {}  # rank 0's decisions not yet executed

    def defer_rollback(reason: str, anomaly_step: int) -> bool:
        """A deferred collective rollback, for anomalies only rank 0 sees (a
        divergence): the decision is published one window ahead of its
        execution, so every rank finds it and executes at the same boundary
        (tpukit :1312-1333). A decision already in flight is not pushed
        back."""
        seq_no = recovery.count + 1
        if seq_no in pending_deferred or recovery.coordinator.read(seq_no) is not None:
            return True
        plan = recovery.plan(reason, anomaly_step, window=PRINT_FREQ)
        if plan is None:
            return False
        recovery.coordinator.publish(plan, execute_after=anomaly_step + PRINT_FREQ)
        pending_deferred[plan.seq] = plan
        return True

    def poll_rollback(final: bool = False) -> None:
        """At every window boundary (several ranks): execute a published
        deferred decision once its `execute_after` step is reached; `final`
        (the end of the last epoch's training) executes a pending one
        regardless, after the final-drain rendezvous (tpukit :1335-1397)."""
        if recovery is None or nprocs == 1:
            return
        seq_no = recovery.count + 1
        plan = pending_deferred.pop(seq_no, None)
        if plan is not None:  # rank 0's own deferred decision
            if final or host_step >= plan.anomaly_step + PRINT_FREQ:
                if final:
                    recovery.coordinator.publish_final_drain(host_step)
                execute_rollback(plan)
            else:
                pending_deferred[seq_no] = plan
            return
        if final:
            if p0:
                recovery.coordinator.publish_final_drain(host_step)
            else:
                recovery.coordinator.wait_final_drain()
        rec = recovery.coordinator.read(seq_no)
        if rec is None or "execute_after" not in rec:
            return  # nothing pending (immediate decisions ran via confirm)
        if not final and host_step < int(rec["execute_after"]):
            return
        if rec.get("action") == "abort":
            abort_with(RollbackBudgetExhausted,
                       f"{rec['reason']} at step {rec['anomaly_step']}: rollback budget "
                       f"exhausted ({recovery.count}/{recovery.max_rollbacks} used) or no "
                       f"integrity-verified checkpoint to restore")
        execute_rollback(RollbackPlan(
            seq=int(rec["seq"]), reason=rec["reason"], anomaly_step=int(rec["anomaly_step"]),
            target_step=int(rec["target_step"]), target_path=rec["target_path"],
            steps_lost=int(rec["steps_lost"])))

    def beat() -> None:
        heart.beat(host_step, checksum=last_checksum[1] if last_checksum else None,
                   checksum_step=last_checksum[0] if last_checksum else None,
                   timeline=timeline)

    def on_window(epoch: int, avg: float, norm_vals: dict) -> None:
        """A window's boundary (tpukit :1589-1841): the `train` record, the
        metrics plane, hangs, side events, checksums, heartbeats,
        stragglers, divergence, deferred rollbacks and the sentinel."""
        nonlocal hangs_logged, spike_events
        pre_rollbacks = recovery.count if recovery is not None else 0
        win = spans.window()
        record = dict(kind="train", epoch=epoch, step=host_step, loss=avg,
                      tokens_per_sec=meter.tokens_per_sec, mfu=meter.mfu,
                      goodput=win["goodput"], spans=win["fractions"], window_s=win["total_s"],
                      **norm_vals)
        hbm = live_memory_stats(device)
        if hbm:
            record["hbm"] = hbm
        pf = pf_live["pf"]
        if pf is not None:
            record["prefetch_stall_s"] = round(win["seconds"].get("prefetch_stall", 0.0), 6)
            record["prefetch_occupancy"] = round(pf.window_stats()["occupancy"], 3)
        logger.log(**record)
        recorder.record("window", step=host_step, epoch=epoch, loss=avg, goodput=win["goodput"],
                        window_s=round(win["total_s"], 6))
        if metric_reg is not None:
            for ph, secs in win["seconds"].items():
                if secs > 0:
                    metric_reg.observe("train_span_s", secs, phase=ph)
            metric_reg.observe("train_window_s", win["total_s"])
            metric_reg.gauge("train_goodput", win["goodput"])
            metric_reg.gauge("train_tokens_per_sec", meter.tokens_per_sec)
            if meter.mfu:
                metric_reg.gauge("train_mfu", meter.mfu)
            metric_reg.inc("train_windows")
            publish_metrics()
        if watchdog is not None and len(watchdog.hang_events) > hangs_logged:
            # the monitor thread dumped the bundle(s); the record comes from
            # this thread, each hang with its own bundle
            new = watchdog.hang_events[hangs_logged:]
            hangs_logged = len(watchdog.hang_events)
            logger.log(kind="watchdog", event="hang", step=host_step,
                       hangs=len(watchdog.hang_events),
                       bundles=[e["bundle"] for e in new if e["bundle"]])
            note_anomaly("hang", host_step)
        drain_side_events()
        if pending_checks:
            with spans.span("telemetry"):
                flush_checks()
        if heart is not None:
            beat()
            if p0:
                stragglers = heart.check(step_lag=PRINT_FREQ)
                if stragglers:
                    logger.log(kind="straggler", step=host_step, stragglers=stragglers)
                    recorder.record("straggler", step=host_step, stragglers=stragglers)
                    print(f"heartbeat: straggling processes {stragglers}", flush=True)
                    note_anomaly("straggler", host_step)
                    dump_bundle("straggler", host_step, stragglers=stragglers)
                if checksum_fn is not None and not pending_deferred:
                    # the world's beats of this window, then one report an
                    # incident: a mismatch on the timeline that a decision
                    # in flight will roll back is not reported again
                    if nprocs > 1:
                        heart.await_window(host_step, timeline)
                    diverged = [m for m in heart.check_divergence()
                                if (m["process"], m["checksum_step"], m["checksum"])
                                not in reported_divergence]
                    if diverged:
                        reported_divergence.update(
                            (m["process"], m["checksum_step"], m["checksum"]) for m in diverged)
                        logger.log(kind="divergence", step=host_step, mismatches=diverged)
                        recorder.record("divergence", step=host_step, mismatches=diverged)
                        print(f"divergence: replica checksum mismatch {diverged}", flush=True)
                        note_anomaly("divergence", host_step)
                        dump_bundle("divergence", host_step, mismatches=diverged)
                        if recovery is not None:
                            # rank 0 alone sees it: one rank rolls back here,
                            # several execute the published decision in
                            # poll_rollback
                            if not (try_rollback if nprocs == 1 else defer_rollback)(
                                    "divergence", host_step):
                                if nprocs == 1:
                                    abort_with(RollbackBudgetExhausted,
                                               f"divergence at step {host_step}: rollback "
                                               f"budget exhausted ({recovery.count}/"
                                               f"{recovery.max_rollbacks} used) or no "
                                               f"integrity-verified checkpoint to restore")
                                recovery.coordinator.publish_abort(
                                    recovery.count + 1, "divergence", host_step,
                                    execute_after=host_step + PRINT_FREQ)
        poll_rollback()
        if sentinel is None or (recovery is not None and recovery.count != pre_rollbacks):
            return  # a rollback in this block: `avg` is the abandoned timeline's
        event = sentinel.observe(avg, host_step)
        if event is None:
            return
        spike_events += 1
        events["spikes"].append({**event.record(), "action": flags.spike_action})
        logger.log(kind="spike", action=flags.spike_action, **event.record())
        recorder.record("spike", step=event.step, event=event.kind, action=flags.spike_action)
        note_anomaly(event.kind, host_step)
        dump_bundle(event.kind, host_step)
        if p0:
            print(f"loss sentinel: {event.kind} at step {event.step} (loss {event.loss:.4g})",
                  flush=True)
        if recovery is not None:
            if not try_rollback(event.kind, host_step):
                abort_with(RollbackBudgetExhausted,
                           f"loss sentinel {event.kind} at step {event.step} (loss "
                           f"{event.loss:.6g}): rollback budget exhausted "
                           f"({recovery.count}/{recovery.max_rollbacks} used) or no "
                           f"integrity-verified checkpoint to restore")
        elif flags.spike_action == "abort":
            abort_with(AnomalyAbort, f"loss sentinel aborted training: {event.kind} at step "
                                     f"{event.step} (loss {event.loss:.6g})")

    if heart is not None:
        heart.beat(host_step)  # the liveness file exists before the first step

    # the first call of each step builds and loads the kernels (nvcc on a
    # card), so the watchdog arms only once the step is warm: --hang_timeout
    # bounds the steady-state step, never the build
    warm = {"train": False, "eval": False}
    # the comm audit's `kind="xla"` record (tpukit :803-905), rank 0's first
    # train and eval step run under `comm_ir.record_comm`: the collectives
    # measured, the strategy's closed forms beside them and the lint verdict
    xla_pending = {"train_step", "eval_step"} if (flags.metrics_log and p0) else set()

    def audited(fn_name: str, step_fn, batch):
        if fn_name not in xla_pending:
            return step_fn()
        xla_pending.discard(fn_name)
        with comm_ir.record_comm() as trace:
            out = step_fn()
        with spans.span("telemetry"):
            log_xla_record(fn_name, trace, batch)
        return out

    def log_xla_record(fn_name: str, trace, batch) -> None:
        ids = batch["input_ids"]
        # the rows of the whole grid: each loader's share times the loaders
        logger.log(**xla_record(fn_name, trace, strategy, cfg, state.params,
                                ids.shape[0] * strategy.row_shards, ids.shape[1], device.type))

    def close_obs():
        """On any exit of the training block: flush a partial anomaly trace
        and stop the monitor thread before the final checkpoint's I/O."""
        if tracer is not None and tracer.stop():
            logger.log(kind="anomaly_trace", event="stopped", step=host_step)
        if watchdog is not None:
            watchdog.close()

    maybe_nans = _debug_nans_scope() if flags.debug_nans else contextlib.nullcontext()
    with contextlib.ExitStack() as obs_guard, maybe_nans, \
            profiler_trace(flags.profile_dir, device, rank):
        obs_guard.callback(close_obs)
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            # a preempted epoch's resume drops the batches already trained
            # on; `i` starts at skip - 1, so the windows close where the
            # uninterrupted run's do
            skip = start_skip if epoch == start_epoch else 0
            global_rows = train_loader.global_real_row_counts()
            running, win_n, norms = None, 0, None
            pf = (HostPrefetcher(train_loader, host_pipeline, depth=flags.prefetch, skip=skip)
                  if flags.prefetch > 0 else None)
            pf_live["pf"] = pf
            try:
                if pf is None:
                    it = iter(train_loader)
                    for _ in range(skip):
                        next(it, None)
                i = skip - 1
                while True:
                    check_preempt(i + 1, epoch)
                    # the deadline covers the whole iteration: input wait,
                    # enqueue, the window's sync, a periodic checkpoint
                    if watchdog is not None and warm["train"]:
                        watchdog.arm(host_step + 1)
                    if tracer is not None and tracer.maybe_start():
                        logger.log(kind="anomaly_trace", event="started", step=host_step + 1,
                                   reason=tracer.reason, dir=tracer.trace_dir)
                    if pf is not None:
                        with spans.span("prefetch_stall"):
                            try:
                                raw, host = next(pf)
                            except StopIteration:
                                break
                            batch, targets = host_to_device(host, device)
                        i += 1
                    else:
                        with spans.span("data"):
                            try:
                                raw = next(it)
                            except StopIteration:
                                break
                            i += 1
                            host = host_pipeline(raw)[1]
                        with spans.span("h2d"):
                            batch, targets = host_to_device(host, device)
                    with spans.span("step"):
                        out = audited("train_step", lambda: train_step(
                            state, cfg, strategy, batch, targets, seed=flags.seed,
                            log_grad_norms=flags.log_grad_norms), batch)
                    loss, norms = out if flags.log_grad_norms else (out, None)
                    warm["train"] = True
                    host_step += 1
                    recorder.record("step", step=host_step, epoch=epoch)
                    if chaos_engine is not None:
                        with (pf.quiesce() if pf is not None and chaos_engine.mutates_state_at(
                                host_step) else contextlib.nullcontext()):
                            _, loss, fired = chaos_engine.on_step(host_step, state, loss)
                        if fired:
                            check_preempt(i + 1, epoch)
                    if tracer is not None and tracer.tracing and tracer.step():
                        logger.log(kind="anomaly_trace", event="stopped", step=host_step)
                    if checksum_fn is not None and host_step % flags.divergence_check_freq == 0:
                        with spans.span("telemetry"):
                            pending_checks.append((host_step, checksum_fn(state)))
                    running = loss if running is None else running + loss
                    win_n += 1
                    if not meter.started:
                        with spans.span("sync"):
                            _sync(device)  # the clock starts with the card's queue drained
                    meter.update(int(global_rows[i]) * targets.shape[1])
                    if i > 0 and not i % PRINT_FREQ:
                        with spans.span("sync"):
                            avg = float(running) / win_n  # one host sync per window
                            norm_vals = ({k: float(v) for k, v in norms.items()}
                                         if norms is not None else {})
                        meter.tick()
                        windows.append({"epoch": epoch, "step": host_step, "loss": avg})
                        if p0:
                            print(f"[training] Epoch {epoch + 1}/{epochs} | step {host_step} | "
                                  f"loss: {avg:.3f}", flush=True)
                        running, win_n = None, 0
                        on_window(epoch, avg, norm_vals)
                    if (flags.checkpoint_every and host_step % flags.checkpoint_every == 0
                            and host_step != skip_save_step):
                        if watchdog is not None:
                            watchdog.disarm()  # a sync save may outlast the deadline
                        with spans.span("checkpoint"):
                            checkpoint_path = save_checkpoint() or checkpoint_path
                        recorder.record("checkpoint", step=host_step)
                        prune()
            finally:
                if pf is not None:
                    pf.close()
                pf_live["pf"] = None
            if watchdog is not None:
                watchdog.disarm()
            if meter.started:
                with spans.span("sync"):
                    _sync(device)
                meter.tick()
            if epoch == epochs - 1:
                # a deferred decision published in the last window names a
                # boundary no later poll reaches: drain it before eval
                poll_rollback(final=True)

            # every rank runs every batch (a sharded forward is a
            # collective); the weighted sums are summed over the ranks
            total_loss = total_acc = total_weight = 0.0
            eval_metrics = {"loss": float("nan"), "accuracy": float("nan")}
            for raw in validation_loader:
                check_preempt(None, epoch)  # the epoch's training is done
                if watchdog is not None and warm["eval"]:
                    watchdog.arm(host_step)
                with spans.span("eval"):
                    batch, targets = on_device(raw)
                    weight = float((targets != IGNORE_INDEX).sum())
                    loss, acc = audited("eval_step", lambda: eval_step(
                        state, cfg, strategy, batch, targets), batch)
                    warm["eval"] = True
                    if weight > 0.0:
                        total_loss += float(loss) * weight
                        total_acc += float(acc) * weight
                        total_weight += weight
            total_loss, total_acc, total_weight = strategy.all_sum(
                [total_loss, total_acc, total_weight])
            if total_weight > 0.0:
                eval_metrics = {"loss": total_loss / total_weight,
                                "accuracy": total_acc / total_weight}
            logger.log(kind="validation", epoch=epoch, **eval_metrics)
            recorder.record("validation", epoch=epoch, **eval_metrics)
            if watchdog is not None:
                watchdog.disarm()  # generation and the epoch's end run long

            gen_tokens = min(20, cfg.max_position_embeddings - 2)
            check_preempt(None, epoch)
            with spans.span("generate"):
                # every rank gathers; then the natural layer order for decoding
                full = strategy.inference_params(strategy.full_params(state.params), cfg)
                if p0:
                    print(f"[validation] Epoch {epoch + 1}/{epochs} | loss: "
                          f"{eval_metrics['loss']:.3f}, accuracy: "
                          f"{eval_metrics['accuracy']:.2f}", flush=True)
                    texts = generate_samples(full, cfg, tokenizer, max_new_tokens=gen_tokens)
                    print("Argmax sampling from model")
                    for text in texts:
                        print(text)
                del full

            # the epoch's wall clock by span, and its goodput
            ep = spans.epoch()
            logger.log(kind="epoch", epoch=epoch, goodput=ep["goodput"], total_s=ep["total_s"],
                       seconds=ep["seconds"], fractions=ep["fractions"])
            recorder.record("epoch", epoch=epoch, goodput=ep["goodput"],
                            total_s=round(ep["total_s"], 6))
            if pending_checks:
                flush_checks()  # checks taken since the last window
            if heart is not None:
                beat()
            if p0:
                print(f"epoch {epoch + 1} wallclock: {format_breakdown(ep)}", flush=True)

    checkpoint_path = save_checkpoint()
    if async_saver is not None:
        async_saver.wait()  # fit returns with its last write durable
    prune()
    drain_side_events()
    if metric_reg is not None:
        # the epilogue: cumulative counters and each histogram's summary
        rec_m = dict(kind="metrics", source="train", **metric_reg.summary())
        logger.log(**rec_m)
        recorder.record("metrics", source="train", hists=len(rec_m.get("hists", {})))
        publish_metrics()
    logger.close()
    tokens_per_sec = meter.tokens_per_sec or 0.0
    if p0:
        print(f"throughput: {tokens_per_sec:,.0f} tok/s on {device}"
              + (f", MFU {meter.mfu * 100:.1f}%" if meter.mfu else "")
              + f"; checkpoint {checkpoint_path}")
    metrics = {"eval": eval_metrics, "train_windows": windows, "samples": texts,
               "train_tokens": meter.total_tokens, "tokens_per_sec": tokens_per_sec,
               "tokens_per_sec_per_chip": meter.tokens_per_sec_per_chip, "mfu": meter.mfu,
               "spike_events": spike_events, "retries": retry_log.total, "events": events}
    return FitResult(state=state, tokenizer=tokenizer, config=cfg,
                     checkpoint_path=checkpoint_path, metrics=metrics)
