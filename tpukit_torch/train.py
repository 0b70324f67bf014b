"""The trainer: train state, steps and the epoch loop (twin of the core of
`tpukit/train.py`: `make_optimizer` :116, the steps of `make_step_fns`
:156-183, `fit` :362 and `_fit_body` :444).

Loop surface, as tpukit's:
  - the running train loss printed every PRINT_FREQ = 8 steps (the first
    window closes at the 9th step, as tpukit's `i > 0 and not i % 8`);
  - per-epoch validation loss and masked accuracy, weighted by each
    batch's valid-token count, in bf16 whatever `--disable_amp` says;
  - three greedy samples of GENERATION_PROMPTS per epoch (20 new tokens,
    clamped to the position table), through the port's paged
    `ServeEngine` (tpukit decodes them with its ring cache, which is not
    ported, ROADMAP.md item 8: greedy tokens agree at f32). The config has
    no `moe_dispatch`, so MoE samples run the meshless "xla" dispatch, as
    tpukit's do, and each prompt prefills in one chunk from position 0, so
    the capacity windows are tpukit's too;
  - a checkpoint at the end (`checkpoint.save`, the port's own format).
The step runs eagerly: forward, loss, backward and `torch.optim.AdamW` in
place. Not carried (ROADMAP.md): the JSONL StepLogger records, the MFU
meter, the prefetch thread, and the obs, recovery and metrics planes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from tpukit_torch import resolve_device
from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch.batching import IGNORE_INDEX, prepare_batch
from tpukit_torch.data import get_dataset, get_tokenizer, transform_dataset
from tpukit_torch.flags import TrainFlags, check_carried
from tpukit_torch.loader import DataLoader
from tpukit_torch.model import gpt
from tpukit_torch.serve.engine import Request, ServeConfig, ServeEngine
from tpukit_torch.shardings import Strategy, leaves

PRINT_FREQ = 8
GENERATION_PROMPTS = ["The big brown cat ", "One day, ", "She said "]


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), their optimizer, and the
    number of steps taken."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: dict, learning_rate: float) -> torch.optim.AdamW:
    """`torch.optim.AdamW` over every leaf with tpukit's hyper-parameters
    (betas 0.9/0.999, eps 1e-8, weight decay 1e-2 on all leaves, as optax's
    adamw applies it). It updates the parameters in place; its rounding
    order differs from optax's by an ulp here and there."""
    return torch.optim.AdamW(leaves(params), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-2)


def create_train_state(params: dict, learning_rate: float) -> TrainState:
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, optimizer=make_optimizer(params, learning_rate))


def to_device(model_batch: dict, targets: np.ndarray, device) -> tuple[dict, torch.Tensor]:
    """`prepare_batch`'s numpy output as tensors on `device`."""
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in model_batch.items()}
    return batch, torch.from_numpy(targets).to(device)


def train_step(state: TrainState, cfg: gpt.GPTConfig, strategy: Strategy, batch: dict,
               targets) -> torch.Tensor:
    """One step: loss and gradients by the strategy, then AdamW in place.
    Returns the loss (a detached device scalar)."""
    loss, grads = strategy.value_and_grad(state.params, cfg, batch, targets)
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


def generate_samples(params: dict, cfg: gpt.GPTConfig, tokenizer, device,
                     prompts=GENERATION_PROMPTS, max_new_tokens: int = 20) -> list[str]:
    """Greedy continuations of `prompts` through the paged, fused-decode
    `ServeEngine`, decoded with special tokens skipped. Prompts are cut to
    `min(256, positions - max_new_tokens)` tokens, as tpukit's
    `generate_batch` cuts them."""
    max_prompt = min(256, cfg.max_position_embeddings - max_new_tokens)
    if max_prompt < 1:
        raise ValueError(f"max_new_tokens={max_new_tokens} leaves no room for a prompt "
                         f"within max_position_embeddings={cfg.max_position_embeddings}")
    encoded = tokenizer(list(prompts), truncation=True, max_length=max_prompt)["input_ids"]
    longest = max(len(ids) for ids in encoded)
    # one bucket of whole pages; pages of 1 where 8-token pages would not fit
    page = 8
    bucket = -(-longest // page) * page
    if -(-(bucket + max_new_tokens) // page) * page > cfg.max_position_embeddings:
        page, bucket = 1, longest
    # one prefill chunk per prompt, from position 0, as tpukit's generate_batch
    # prefills: an MoE buffer dispatch routes each chunk in its own capacity window
    serve = ServeConfig(slots=len(prompts), buckets=(bucket,), max_new_tokens=max_new_tokens,
                        page_size=page, prefill_chunk=bucket, fused_decode=True)
    reqs = [Request(rid=i, ids=tuple(ids), max_new_tokens=max_new_tokens)
            for i, ids in enumerate(encoded)]
    with torch.no_grad():
        engine = ServeEngine(params, cfg, serve, eos_id=tokenizer.eos_token_id, device=device)
        done = {c.rid: c.ids for c in engine.run(reqs)}
    return [tokenizer.decode(done[i], skip_special_tokens=True) for i in range(len(reqs))]


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

    train_ds, validation_ds = get_dataset(slice_size=flags.dataset_slice)
    train_ds = transform_dataset(train_ds, tokenizer, max_length=flags.sequence_length)
    validation_ds = transform_dataset(validation_ds, tokenizer,
                                      max_length=flags.sequence_length)
    # wrap-padding keeps every train step full-shape; validation pads with
    # all-ignore rows so its metrics are those of the exact partial batch
    train_loader = DataLoader(train_ds, flags.batch_size, shuffle=True, seed=flags.seed,
                              pad_to_batch=True)
    validation_loader = DataLoader(validation_ds, flags.batch_size, shuffle=False,
                                   pad_to_batch=True, pad_mode="empty", pad_fill=pad_id)

    state = create_train_state(gpt.init_params(cfg, seed=flags.seed, device=device),
                               flags.learning_rate)
    if flags.resume:
        ckpt_lib.restore(flags.resume, state)
        print(f"resumed from {flags.resume} at step {state.step}")

    epochs = flags.epochs if num_epochs is None else num_epochs
    windows, eval_metrics, texts = [], {}, []
    train_tokens, train_s = 0, 0.0
    checkpoint_path = None
    for epoch in range(epochs):
        train_loader.set_epoch(epoch)
        running, win_n = None, 0
        t0 = time.perf_counter()
        for i, raw in enumerate(train_loader):
            batch, targets = to_device(*prepare_batch(raw, pad_id), device)
            loss = train_step(state, cfg, strategy, batch, targets)
            running = loss if running is None else running + loss
            win_n += 1
            train_tokens += raw["real_rows"] * targets.shape[1]
            if i > 0 and not i % PRINT_FREQ:
                avg = float(running) / win_n  # one host sync per window
                windows.append({"epoch": epoch, "step": state.step, "loss": avg})
                print(f"[training] Epoch {epoch + 1}/{epochs} | step {state.step} | "
                      f"loss: {avg:.3f}", flush=True)
                running, win_n = None, 0
            if flags.checkpoint_every and state.step % flags.checkpoint_every == 0:
                checkpoint_path = ckpt_lib.save(state, flags)
        _sync(device)
        train_s += time.perf_counter() - t0

        total_loss = total_acc = total_weight = 0.0
        eval_metrics = {"loss": float("nan"), "accuracy": float("nan")}
        for raw in validation_loader:
            batch, targets = to_device(*prepare_batch(raw, pad_id), device)
            weight = float((targets != IGNORE_INDEX).sum())
            loss, acc = eval_step(state, cfg, strategy, batch, targets)
            if weight > 0.0:
                total_loss += float(loss) * weight
                total_acc += float(acc) * weight
                total_weight += weight
        if total_weight > 0.0:
            eval_metrics = {"loss": total_loss / total_weight,
                            "accuracy": total_acc / total_weight}
        print(f"[validation] Epoch {epoch + 1}/{epochs} | loss: {eval_metrics['loss']:.3f}, "
              f"accuracy: {eval_metrics['accuracy']:.2f}", flush=True)

        gen_tokens = min(20, cfg.max_position_embeddings - 2)
        texts = generate_samples(state.params, cfg, tokenizer, device,
                                 max_new_tokens=gen_tokens)
        print("Argmax sampling from model")
        for text in texts:
            print(text)

    checkpoint_path = ckpt_lib.save(state, flags)
    tokens_per_sec = train_tokens / train_s if train_s > 0 else 0.0
    print(f"throughput: {tokens_per_sec:,.0f} tok/s on {device}; checkpoint {checkpoint_path}")
    metrics = {"eval": eval_metrics, "train_windows": windows, "samples": texts,
               "train_tokens": train_tokens, "tokens_per_sec": tokens_per_sec}
    return FitResult(state=state, tokenizer=tokenizer, config=cfg,
                     checkpoint_path=checkpoint_path, metrics=metrics)
