"""Strategies (twin of `tpukit/shardings.py:261-508` and of
`ExpertParallel` :1094, on one device).

A strategy owns the loss: `loss_fn` runs the model and the masked
cross-entropy, `value_and_grad` differentiates it. With `fused_head` (the
default) the loss goes through `forward_hidden` and the fused head + CE
kernels, so no `[B, S, V]` logits exist; `TPUKIT_FUSED_HEAD=0` in the
environment, read at each call, routes back to `forward` +
`cross_entropy_loss` (tpukit's escape hatch, `shardings.py:55-58`). MoE
configs train on CE + moe_aux_weight x the summed load-balance aux and
report the pure CE. DataParallel, FSDP, the pipeline, tensor and context
parallelism, and expert parallelism over more than one rank are ROADMAP.md
items 5-7 and 13-15.
"""

from __future__ import annotations

import os

import torch

from tpukit_torch import NotPortedError
from tpukit_torch.model import gpt
from tpukit_torch.ops.fused_head_ce import fused_head_ce
from tpukit_torch.ops.layers import cross_entropy_loss, masked_accuracy
from tpukit_torch.ops.moe_dispatch import ExpertGrid


def fused_head_disabled() -> bool:
    return os.environ.get("TPUKIT_FUSED_HEAD", "1") == "0"


def leaves(tree: dict) -> list:
    """The tensors of a nested dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def unflatten(tree: dict, flat) -> dict:
    """A nested dict shaped like `tree` holding the values of `flat`, in
    `leaves` order."""
    it = iter(flat)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else next(it) for k, v in t.items()}

    return walk(tree)


class Strategy:
    """Base: one device."""

    name = "single"
    fused_head = True

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        """Raise before the first step when the config cannot run on this
        strategy."""

    def loss_fn(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                with_accuracy: bool = False, aux_out: list | None = None):
        """(mean masked CE, masked accuracy x 100 or 0) of one batch: `batch`
        holds `input_ids`, `position_ids` and `mask` (True = padding)
        tensors, `targets` uses -100 for ignored positions. MoE configs
        append the summed load-balance aux to `aux_out`."""
        if self.fused_head and not fused_head_disabled():
            h = gpt.forward_hidden(params, cfg, batch["input_ids"], batch["position_ids"],
                                   batch["mask"], aux_out=aux_out)
            loss_sum, count, correct = fused_head_ce(
                h.reshape(-1, h.shape[-1]), params["lm_head"]["kernel"],
                targets.reshape(-1), cfg.vocab_size, with_accuracy=with_accuracy)
            denom = torch.clamp(count, min=1.0)
            return loss_sum / denom, correct / denom * 100.0
        logits = gpt.forward(params, cfg, batch["input_ids"], batch["position_ids"],
                             batch["mask"], aux_out=aux_out)
        loss = cross_entropy_loss(logits, targets)
        accuracy = (masked_accuracy(logits, targets) if with_accuracy
                    else torch.zeros((), device=logits.device))
        return loss, accuracy

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets):
        """(loss, grads): the loss of `loss_fn` and the gradient of the
        training objective with respect to every parameter, as a tree shaped
        like `params`. The objective is the loss itself, plus, for MoE
        configs, moe_aux_weight x the summed load-balance aux (the Switch
        objective); the returned loss is the pure CE either way."""
        aux_list: list = []
        loss, _ = self.loss_fn(params, cfg, batch, targets, aux_out=aux_list)
        total = loss
        for aux in aux_list:
            total = total + cfg.moe_aux_weight * aux
        grads = torch.autograd.grad(total, leaves(params))
        return loss.detach(), unflatten(params, grads)


class SingleDevice(Strategy):
    name = "single"


class ExpertParallel(Strategy):
    """Expert parallelism for MoE configs (twin of tpukit
    `shardings.py:1094`) on a `(data, expert)` grid of one device: the
    port runs one process, so the grid is 1 x 1 and the exchange moves
    nothing; a larger grid raises `NotPortedError`. `dispatch` ("a2a" by
    default, "pallas", or "xla") is injected into the config at loss time
    with the grid, so training and the bf16 eval run the same dispatch;
    checkpoints, decoding and plain model calls never carry it."""

    name = "ep"

    def __init__(self, grid: ExpertGrid | None = None, dispatch: str = "a2a"):
        self.grid = grid if grid is not None else ExpertGrid()
        if dispatch not in ("xla", "a2a", "pallas"):
            raise ValueError(f"dispatch must be 'xla', 'a2a' or 'pallas', got {dispatch!r}")
        if self.grid.size > 1:
            raise NotPortedError(
                f"ExpertParallel over a {self.grid.data} x {self.grid.expert} (data, expert) "
                f"grid needs process groups and all_to_all_single, which are not in the "
                f"port yet (ROADMAP.md, queue A item 13 'EP over more than one rank', after item 5 'DDP')")
        self.dispatch = dispatch

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        if cfg.num_experts <= 0:
            raise ValueError("ExpertParallel requires an MoE config: pass --num_experts N "
                             "(N > 0); dense models belong on the other strategies")
        if cfg.num_experts % self.grid.expert:
            raise ValueError(f"--num_experts {cfg.num_experts} must divide over the "
                             f"{self.grid.expert}-way expert axis")

    def _dispatch_cfg(self, cfg: gpt.GPTConfig) -> gpt.GPTConfig:
        """The config the loss runs with: this dispatch and grid injected
        for MoE configs (tpukit `shardings.py:1251-1258`)."""
        if cfg.num_experts <= 0 or self.dispatch == "xla":
            return cfg
        return cfg.replace(moe_dispatch=self.dispatch, moe_mesh=self.grid)

    def loss_fn(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                with_accuracy: bool = False, aux_out: list | None = None):
        return super().loss_fn(params, self._dispatch_cfg(cfg), batch, targets,
                               with_accuracy=with_accuracy, aux_out=aux_out)
