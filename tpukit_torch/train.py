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
place. Not carried (ROADMAP.md): the JSONL StepLogger records, the MFU
figure, the prefetch thread, and the obs, recovery and metrics planes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from tpukit_torch import random as tk_random
from tpukit_torch import resolve_device
from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch import mesh as mesh_lib
from tpukit_torch.batching import IGNORE_INDEX, prepare_batch
from tpukit_torch.data import get_dataset, get_tokenizer, transform_dataset
from tpukit_torch.flags import TrainFlags, check_carried
from tpukit_torch.loader import DataLoader
from tpukit_torch.model import gpt
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
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in model_batch.items()}
    return batch, torch.from_numpy(targets).to(device)


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


def fit(flags: TrainFlags, strategy: Strategy, num_epochs: int | None = None) -> FitResult:
    """The training entry point of the port's recipes: data, model, the
    epoch loop, samples and the final checkpoint. Runs on `flags.device`
    (cuda unless `cpu` is asked for)."""
    check_carried(flags)
    device = resolve_device(flags.device)
    tokenizer = get_tokenizer()
    tokenizer.pad_token_id = 2  # every recipe pins pad to 2
    pad_id = tokenizer.pad_token_id
    cfg = build_config(flags, tokenizer.vocab_size)
    strategy.validate_config(cfg)
    rank = shard_rank = 0
    if strategy.distributed:
        device = mesh_lib.initialize_runtime(device)
        rank, shard_rank = mesh_lib.rank(), strategy.row_shard()
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
    if flags.resume:
        ckpt_lib.restore_any(flags.resume, state)
        if p0:
            print(f"resumed from {flags.resume} at step {state.step}")

    epochs = flags.epochs if num_epochs is None else num_epochs
    windows, eval_metrics, texts = [], {}, []
    # tpukit's meter: the clock starts at the first step's return and stops
    # at the last one's; the first step's tokens are not counted
    train_tokens, t_first, t_last = 0, None, None
    checkpoint_path = None

    def save():
        return ckpt_lib.save_auto(state, flags.checkpoint_format, flags)

    # the strategy's host transform (ContextParallel's zigzag permutation),
    # applied to every train and eval batch before it moves to the device
    host_batch = strategy.host_batch_fn(cfg)

    def on_device(raw):
        model_batch, targets = prepare_batch(raw, pad_id)
        if host_batch is not None:
            model_batch, targets = host_batch(model_batch, targets)
        return to_device(model_batch, targets, device)

    for epoch in range(epochs):
        train_loader.set_epoch(epoch)
        running, win_n = None, 0
        for i, raw in enumerate(train_loader):
            batch, targets = on_device(raw)
            loss = train_step(state, cfg, strategy, batch, targets, seed=flags.seed)
            running = loss if running is None else running + loss
            win_n += 1
            if t_first is None:
                _sync(device)
                t_first = time.perf_counter()
            else:
                train_tokens += raw["real_rows"] * targets.shape[1]
            if i > 0 and not i % PRINT_FREQ:
                avg = float(running) / win_n  # one host sync per window
                windows.append({"epoch": epoch, "step": state.step, "loss": avg})
                if p0:
                    print(f"[training] Epoch {epoch + 1}/{epochs} | step {state.step} | "
                          f"loss: {avg:.3f}", flush=True)
                running, win_n = None, 0
            if flags.checkpoint_every and state.step % flags.checkpoint_every == 0:
                checkpoint_path = save()
        if t_first is not None:
            _sync(device)
            t_last = time.perf_counter()

        # every rank runs every batch (a sharded forward is a collective);
        # the weighted sums are summed over the ranks before the division
        total_loss = total_acc = total_weight = 0.0
        eval_metrics = {"loss": float("nan"), "accuracy": float("nan")}
        for raw in validation_loader:
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

    checkpoint_path = save()
    train_tokens = int(strategy.all_sum([train_tokens])[0])
    train_s = t_last - t_first if t_first is not None else 0.0
    tokens_per_sec = train_tokens / train_s if train_s > 0 else 0.0
    if p0:
        print(f"throughput: {tokens_per_sec:,.0f} tok/s on {device}; checkpoint "
              f"{checkpoint_path}")
    metrics = {"eval": eval_metrics, "train_windows": windows, "samples": texts,
               "train_tokens": train_tokens, "tokens_per_sec": tokens_per_sec}
    return FitResult(state=state, tokenizer=tokenizer, config=cfg,
                     checkpoint_path=checkpoint_path, metrics=metrics)
