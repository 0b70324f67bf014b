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
  - throughput by tpukit's meter (`tpukit/obs/meter.py:106-113`): one
    clock for the run, started when the first step returns (the card's
    queue drained), the real tokens of every later step, the time read at
    the last step's return, after a sync.
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
and preemption decisions. Not carried (ROADMAP.md item 18): the JSONL
StepLogger records, the MFU figure, the watchdog, diagnostics bundles,
divergence checksums and the deferred rollback they drive, and the
metrics plane.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from tpukit_torch import random as tk_random
from tpukit_torch import resolve_device
from tpukit_torch import chaos as chaos_lib
from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch import mesh as mesh_lib
from tpukit_torch import reshard as reshard_lib
from tpukit_torch import retry as retry_lib
from tpukit_torch.batching import IGNORE_INDEX, prepare_batch
from tpukit_torch.data import get_dataset, get_tokenizer, transform_dataset
from tpukit_torch.flags import TrainFlags, check_carried
from tpukit_torch.loader import DataLoader
from tpukit_torch.model import gpt
from tpukit_torch.obs.heartbeat import Heartbeat
from tpukit_torch.obs.sentinels import SpikeSentinel
from tpukit_torch.prefetch import HostPrefetcher
from tpukit_torch.recovery import (AnomalyAbort, PreemptCoordinator, Preempted,
                                   PreemptionGuard, RecoveryEngine, RollbackBudgetExhausted,
                                   RollbackCoordinator)
from tpukit_torch.sampling import generate_batch
from tpukit_torch.shardings import Strategy, leaves

PRINT_FREQ = 8
GENERATION_PROMPTS = ["The big brown cat ", "One day, ", "She said "]


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), their optimizer, the
    number of steps taken, and the strategy that set the tree up (None for
    a plain tree), which checkpoints gather and place leaves through."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0
    strategy: Strategy | None = None


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


def create_train_state(params: dict, learning_rate: float, strategy: Strategy | None = None,
                       cfg: gpt.GPTConfig | None = None) -> TrainState:
    """The state of `params`; with a strategy, of the tree its `setup`
    makes of them (wrapped, sharded under FSDP, this stage's block under
    the pipeline), after its `prepare_params` when `cfg` is given (tpukit
    `train.py:112`: the pipeline's padded, permuted stack), the optimizer
    built afterwards over that tree: each rank's AdamW covers its own
    leaves."""
    for p in leaves(params):
        p.requires_grad_(True)
    if strategy is not None:
        if cfg is not None:
            params = strategy.prepare_params(params, cfg)
            for p in leaves(params):
                p.requires_grad_(True)
        params = strategy.setup(params)
    return TrainState(params=params, optimizer=make_optimizer(params, learning_rate),
                      strategy=strategy)


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
               targets, seed: int = 0) -> torch.Tensor:
    """One step: loss and gradients by the strategy, then AdamW in place.
    With `cfg.dropout > 0` the step draws its masks from `dropout_key(seed,
    step)`; the same key feeds the stochastic rounding of the int8
    gradient wire (`quant_stochastic`, tpukit `train.py:149-152`). Returns
    the loss (a detached device scalar)."""
    keyed = cfg.dropout > 0 or (cfg.quant_stochastic and cfg.comm_dtype == "int8")
    rng = dropout_key(seed, state.step, targets.device) if keyed else None
    loss, grads = strategy.value_and_grad(state.params, cfg, batch, targets, rng=rng)
    for p, g in zip(leaves(state.params), leaves(grads)):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return loss


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


def _check_recovery_flags(flags: TrainFlags) -> None:
    """tpukit's flag validation (`train.py:379-400`)."""
    if flags.prefetch < 0:
        raise ValueError(f"--prefetch must be >= 0, got {flags.prefetch}")
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
    (cuda unless `cpu` is asked for). Validates the recovery flags,
    installs the chaos engine, the I/O retry policy and the preemption
    guard for the run, and takes them down again on every way out (tpukit
    `train.py:362-443`)."""
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
        if mismatch and flags.heartbeat_dir and p0:
            reshard_lib.sweep_stale_world(flags.heartbeat_dir)
        ckpt_lib.restore_any(resume_path, state)
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
    # tpukit's meter: the clock starts at the first step's return and stops
    # at the last one's; the first step's tokens are not counted
    train_tokens, t_first, t_last = 0, None, None
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
        if flags.keep_checkpoints > 0 and p0:
            ckpt_lib.prune_checkpoints(ckpt_lib.CHECKPOINT_DIR, keep=flags.keep_checkpoints,
                                       assume_newest_verified=True)

    # the window loss is the global mean on every rank, so the sentinel's
    # decisions are the same on every rank
    sentinel = SpikeSentinel(flags.spike_threshold) if flags.spike_threshold > 0 else None
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
    running, win_n = None, 0
    pf_live: dict[str, Any] = {"pf": None}
    events: dict[str, list] = {"rollbacks": [], "chaos": [], "retries": [], "spikes": []}
    null_polls = [0]

    def drain_side_events() -> None:
        events["retries"] += retry_log.drain()
        if chaos_engine is not None:
            events["chaos"] += chaos_engine.drain_fired()

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
        path = save_checkpoint(meta)
        if async_saver is not None:
            async_saver.wait()  # the exit is next: durable now
        if heart is not None:
            heart.beat(host_step, timeline=timeline)
        drain_side_events()
        if p0:
            print(f"preempted by {sig} at step {host_step}; checkpoint {path}", flush=True)
        raise Preempted(f"{sig} at step {host_step}; checkpoint {path}; relaunch with "
                        f"--resume latest to continue", checkpoint=path, step=host_step)

    def abort_with(exc_cls, message: str):
        """A checkpoint of the blown-up state, then the exit code's error."""
        nonlocal checkpoint_path
        checkpoint_path = save_checkpoint() or checkpoint_path
        if async_saver is not None:
            async_saver.wait()
        drain_side_events()
        raise exc_cls(f"{message}; state checkpointed at {checkpoint_path}")

    def execute_rollback(plan) -> None:
        """Restore the plan's checkpoint in place (the live parameter and
        optimizer tensors, so DDP's and FSDP's hold on them stays valid) and
        drop the abandoned timeline's host state; the stream is not rewound
        (tpukit :1224-1290)."""
        nonlocal host_step, running, win_n, timeline, skip_save_step
        quarantined = recovery.quarantine(plan, process_zero=p0)
        pf = pf_live["pf"]
        with pf.quiesce() if pf is not None else contextlib.nullcontext():
            ckpt_lib.restore_any(plan.target_path, state)
        host_step = plan.target_step
        skip_save_step = host_step
        running, win_n = None, 0
        if sentinel is not None:
            sentinel.reset()
        timeline += 1
        recovery.committed(plan)
        recovery.coordinator.ack(plan.seq, plan.target_step)
        events["rollbacks"].append({**plan.record(), "timeline": timeline,
                                    "quarantined": quarantined, "windows_before": len(windows)})
        if heart is not None:
            heart.beat(host_step, timeline=timeline)
        if p0:
            print(f"rollback {plan.seq}/{recovery.max_rollbacks} ({plan.reason} at step "
                  f"{plan.anomaly_step}): restored {plan.target_path} at step "
                  f"{plan.target_step}, {plan.steps_lost} steps lost; input stream continues "
                  f"forward", flush=True)

    def try_rollback(reason: str, anomaly_step: int) -> bool:
        """A collective rollback: every rank plans from the shared directory
        (after the async write in flight has published, and a barrier);
        rank 0 publishes the decision, the others confirm theirs. False:
        escalate (tpukit :1292-1308)."""
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

    def on_window(epoch: int, avg: float) -> None:
        """A window's boundary: heartbeats, stragglers, the sentinel."""
        drain_side_events()
        if heart is not None:
            heart.beat(host_step, timeline=timeline)
            if p0:
                stragglers = heart.check(step_lag=PRINT_FREQ)
                if stragglers:
                    print(f"heartbeat: straggling processes {stragglers}", flush=True)
        event = sentinel.observe(avg, host_step) if sentinel is not None else None
        if event is None:
            return
        events["spikes"].append({**event.record(), "action": flags.spike_action})
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

    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        # a preempted epoch's resume drops the batches already trained on;
        # `i` starts at skip - 1, so the windows close where the
        # uninterrupted run's do
        skip = start_skip if epoch == start_epoch else 0
        running, win_n = None, 0
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
                if pf is not None:
                    try:
                        raw, host = next(pf)
                    except StopIteration:
                        break
                else:
                    try:
                        raw, host = host_pipeline(next(it))
                    except StopIteration:
                        break
                i += 1
                batch, targets = host_to_device(host, device)
                loss = train_step(state, cfg, strategy, batch, targets, seed=flags.seed)
                host_step += 1
                if chaos_engine is not None:
                    with (pf.quiesce() if pf is not None and chaos_engine.mutates_state_at(
                            host_step) else contextlib.nullcontext()):
                        _, loss, fired = chaos_engine.on_step(host_step, state, loss)
                    if fired:
                        check_preempt(i + 1, epoch)
                running = loss if running is None else running + loss
                win_n += 1
                if t_first is None:
                    _sync(device)
                    t_first = time.perf_counter()
                else:
                    train_tokens += raw["real_rows"] * targets.shape[1]
                if i > 0 and not i % PRINT_FREQ:
                    avg = float(running) / win_n  # one host sync per window
                    windows.append({"epoch": epoch, "step": host_step, "loss": avg})
                    if p0:
                        print(f"[training] Epoch {epoch + 1}/{epochs} | step {host_step} | "
                              f"loss: {avg:.3f}", flush=True)
                    running, win_n = None, 0
                    on_window(epoch, avg)
                if (flags.checkpoint_every and host_step % flags.checkpoint_every == 0
                        and host_step != skip_save_step):
                    checkpoint_path = save_checkpoint() or checkpoint_path
                    prune()
        finally:
            if pf is not None:
                pf.close()
            pf_live["pf"] = None
        if t_first is not None:
            _sync(device)
            t_last = time.perf_counter()

        # every rank runs every batch (a sharded forward is a collective);
        # the weighted sums are summed over the ranks before the division
        total_loss = total_acc = total_weight = 0.0
        eval_metrics = {"loss": float("nan"), "accuracy": float("nan")}
        for raw in validation_loader:
            check_preempt(None, epoch)  # the epoch's training is done
            batch, targets = on_device(raw)
            weight = float((targets != IGNORE_INDEX).sum())
            loss, acc = eval_step(state, cfg, strategy, batch, targets)
            if weight > 0.0:
                total_loss += float(loss) * weight
                total_acc += float(acc) * weight
                total_weight += weight
        total_loss, total_acc, total_weight = strategy.all_sum(
            [total_loss, total_acc, total_weight])
        if total_weight > 0.0:
            eval_metrics = {"loss": total_loss / total_weight,
                            "accuracy": total_acc / total_weight}

        gen_tokens = min(20, cfg.max_position_embeddings - 2)
        check_preempt(None, epoch)
        # every rank gathers; then the natural layer order for decoding
        full = strategy.inference_params(strategy.full_params(state.params), cfg)
        if p0:
            print(f"[validation] Epoch {epoch + 1}/{epochs} | loss: "
                  f"{eval_metrics['loss']:.3f}, accuracy: {eval_metrics['accuracy']:.2f}",
                  flush=True)
            texts = generate_samples(full, cfg, tokenizer, max_new_tokens=gen_tokens)
            print("Argmax sampling from model")
            for text in texts:
                print(text)
        del full
        if heart is not None:
            heart.beat(host_step, timeline=timeline)

    checkpoint_path = save_checkpoint()
    if async_saver is not None:
        async_saver.wait()  # fit returns with its last write durable
    prune()
    drain_side_events()
    train_tokens = int(strategy.all_sum([train_tokens])[0])
    train_s = t_last - t_first if t_first is not None else 0.0
    tokens_per_sec = train_tokens / train_s if train_s > 0 else 0.0
    if p0:
        print(f"throughput: {tokens_per_sec:,.0f} tok/s on {device}; checkpoint "
              f"{checkpoint_path}")
    metrics = {"eval": eval_metrics, "train_windows": windows, "samples": texts,
               "train_tokens": train_tokens, "tokens_per_sec": tokens_per_sec,
               "spike_events": len(events["spikes"]), "retries": retry_log.total,
               "events": events}
    return FitResult(state=state, tokenizer=tokenizer, config=cfg,
                     checkpoint_path=checkpoint_path, metrics=metrics)
