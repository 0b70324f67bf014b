"""Strategies (twin of `tpukit/shardings.py:261-508`, the single-device part).

A strategy owns the loss: `loss_fn` runs the model and the masked
cross-entropy, `value_and_grad` differentiates it. With `fused_head` (the
default) the loss goes through `forward_hidden` and the fused head + CE
kernels, so no `[B, S, V]` logits exist; `TPUKIT_FUSED_HEAD=0` in the
environment, read at each call, routes back to `forward` +
`cross_entropy_loss` (tpukit's escape hatch, `shardings.py:55-58`).
DataParallel, FSDP, the pipeline, tensor, context and expert parallelism
are ROADMAP.md items 5-7 and 13-15.
"""

from __future__ import annotations

import os

import torch

from tpukit_torch.model import gpt
from tpukit_torch.ops.fused_head_ce import fused_head_ce
from tpukit_torch.ops.layers import cross_entropy_loss, masked_accuracy


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

    def loss_fn(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                with_accuracy: bool = False):
        """(mean masked CE, masked accuracy x 100 or 0) of one batch: `batch`
        holds `input_ids`, `position_ids` and `mask` (True = padding)
        tensors, `targets` uses -100 for ignored positions."""
        if self.fused_head and not fused_head_disabled():
            h = gpt.forward_hidden(params, cfg, batch["input_ids"], batch["position_ids"],
                                   batch["mask"])
            loss_sum, count, correct = fused_head_ce(
                h.reshape(-1, h.shape[-1]), params["lm_head"]["kernel"],
                targets.reshape(-1), cfg.vocab_size, with_accuracy=with_accuracy)
            denom = torch.clamp(count, min=1.0)
            return loss_sum / denom, correct / denom * 100.0
        logits = gpt.forward(params, cfg, batch["input_ids"], batch["position_ids"],
                             batch["mask"])
        loss = cross_entropy_loss(logits, targets)
        accuracy = (masked_accuracy(logits, targets) if with_accuracy
                    else torch.zeros((), device=logits.device))
        return loss, accuracy

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets):
        """(loss, grads): the loss of `loss_fn` and its gradient with
        respect to every parameter, as a tree shaped like `params`."""
        loss, _ = self.loss_fn(params, cfg, batch, targets)
        grads = torch.autograd.grad(loss, leaves(params))
        return loss.detach(), unflatten(params, grads)


class SingleDevice(Strategy):
    name = "single"
