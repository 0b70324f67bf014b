"""Strategies (twin of `tpukit/shardings.py:261-760` and of
`ExpertParallel` :1094-1368).

A strategy owns the loss: `loss_fn` runs the model and the masked
cross-entropy, `value_and_grad` differentiates it. With `fused_head` (the
default) the loss goes through `forward_hidden` and the fused head + CE
kernels, so no `[B, S, V]` logits exist; `TPUKIT_FUSED_HEAD=0` in the
environment, read at each call, routes back to `forward` +
`cross_entropy_sum` (tpukit's escape hatch, `shardings.py:55-58`). MoE
configs train on CE + moe_aux_weight x the summed load-balance aux and
report the pure CE.

`DataParallel` and `FSDP` run over the default c10d group
(`tpukit_torch.mesh`): `setup` puts the parameter tree into a `ParamTree`
module and wraps it in `DistributedDataParallel` or FSDP2's `fully_shard`,
and the loss runs through that module, which hands the model the
parameters as they stand at call time. Both train on tpukit's objective, the
mean CE over the valid tokens of the global batch. The pipeline strategies
(`Pipeline`, `Pipeline1F1B`) are in `tpukit_torch/pipeline.py`.
`TensorParallel` holds each rank's Megatron shards over a `(data, model)`
grid of c10d ranks and runs the model's functions on them.
`ContextParallel` splits each sequence over the `seq` ranks of a
`(data, seq)` grid and runs the ring or Ulysses attention
(`tpukit_torch/ring_attention.py`) over them. `ExpertParallel` holds each
rank's experts and trunk pieces over a `(data, expert)` grid of c10d ranks
and exchanges tokens with its expert peers (`ops/moe_dispatch.py`). MoE
configs also train under `DataParallel` and `FSDP`: routing is per row, and
the load-balance aux sums its statistics over the ranks.

`--comm_dtype bf16|int8` and `--grad_buckets N` (tpukit's `quantized_comm`
strategies) put `DataParallel` and `FSDP` on their hand-placed gradient
wire (`ops/quant_comm.py`) and set the payload of `ExpertParallel`'s
exchange; every other strategy refuses them (`_validate_comm_dtype`).
"""

from __future__ import annotations

import math
import os
import warnings

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
from torch.distributed.fsdp import CPUOffloadPolicy, OffloadPolicy, fully_shard
from torch.distributed.tensor import DTensor, Shard

from tpukit_torch import mesh as mesh_lib
from tpukit_torch import random as tk_random
from tpukit_torch.model import gpt
from tpukit_torch.ops.fused_head_ce import fused_head_ce
from tpukit_torch.ops.layers import (
    IGNORE_INDEX,
    ModelGroup,
    cross_entropy_sum,
    layer_norm,
    masked_correct,
    reduce_from_model,
    vocab_parallel_argmax,
    vocab_parallel_ce,
)
from tpukit_torch.ops import deferred, quant_comm
from tpukit_torch.ops.moe_dispatch import ExpertGrid, RowGroup
from tpukit_torch.ring_attention import SeqGroup, zigzag_order


def fused_head_disabled() -> bool:
    return os.environ.get("TPUKIT_FUSED_HEAD", "1") == "0"


def leaves(tree: dict) -> list:
    """The tensors of a nested dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def paths(tree: dict, prefix: str = "") -> list[str]:
    """The "/"-joined key path of every leaf, in `leaves` order."""
    out = []
    for k, v in tree.items():
        out.extend(paths(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])
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
    distributed = False  # runs over the default process group
    # strategies with hand-placed collectives carry --comm_dtype and
    # --grad_buckets (tpukit `shardings.py:279-283`); the rest refuse them
    quantized_comm = False

    @property
    def batch_divisor(self) -> int:
        """What the global batch must divide into (tpukit
        `shardings.py:411`): the data-parallel world, or under the pipeline
        micro-batches x data replicas."""
        return 1

    @property
    def data_replicas(self) -> int:
        """The data-parallel replicas: a global batch is `--batch_size` rows
        on each of them, each loading its own share. Every rank of one
        replica loads the same rows."""
        return 1

    def data_rank(self) -> int:
        """This rank's replica index, `[0, data_replicas)`."""
        return 0

    @property
    def row_shards(self) -> int:
        """The loaders a global batch's rows are split between: one a data
        replica, or (`ExpertParallel`) one a rank."""
        return self.data_replicas

    def row_shard(self) -> int:
        """This rank's loader, `[0, row_shards)`."""
        return self.data_rank()

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        """Raise before the first step when the config cannot run on this
        strategy."""
        self._validate_comm_dtype(cfg)

    def _validate_comm_dtype(self, cfg: gpt.GPTConfig) -> None:
        """tpukit's `--comm_dtype` / `--grad_buckets` gate (`shardings.py:
        336-365`), which every `validate_config` override of a strategy
        without hand-placed collectives calls: a flag that changed nothing
        would read as a wire cut that never happened."""
        if cfg.comm_dtype != "f32" and not self.quantized_comm:
            raise ValueError(
                f"--comm_dtype {cfg.comm_dtype}: the {self.name} strategy has no wired "
                f"quantized collectives — supported on ddp (grad all-reduce), fsdp (grad "
                f"reduce-scatter) and ep (a2a dispatch payload)")
        if cfg.grad_buckets > 0 and not self.quantized_comm:
            raise ValueError(
                f"--grad_buckets {cfg.grad_buckets}: the {self.name} strategy has no "
                f"hand-placed grad wire to bucket — supported on ddp (bucketed two-shot "
                f"all-reduce), fsdp (bucketed grad reduce-scatter) and ep (the per-layer "
                f"a2a pairs are already bucket-granular)")

    # the collective kinds a step of this strategy issues (tpukit
    # `shardings.py:278`, in the trace's names), for the `kind="xla"`
    # record's `expected_comm_ops`
    comm_ops: tuple[str, ...] = ()

    def comm_ops_for(self, cfg: gpt.GPTConfig) -> tuple[str, ...]:
        """`comm_ops` for this config (tpukit `shardings.py:392`): a config
        that reshapes the schedule (the hand-placed wires) names its own."""
        return self.comm_ops

    def overlap_comm(self, cfg: gpt.GPTConfig, params) -> dict | None:
        """The declared overlap of this strategy's train step (tpukit
        `shardings.py:381`): `{op: K}`, at least K calls of that kind must
        be issued with backward work left to hide behind (`analysis.rules`'
        `overlap` gate); None where the schedule is serial."""
        return None

    @staticmethod
    def _hand_placed(cfg: gpt.GPTConfig) -> bool:
        """Whether `DataParallel` / `FSDP` run their hand-placed gradient
        wire (tpukit `shardings.py:356-365`): a quantized payload, or any
        bucket schedule."""
        return cfg.comm_dtype != "f32" or cfg.grad_buckets > 0

    def prepare_params(self, params: dict, cfg: gpt.GPTConfig) -> dict:
        """The tree in this strategy's layout, before `setup` (tpukit
        `shardings.py:316`; the pipeline pads and permutes the layer stack)."""
        return params

    def inference_params(self, params: dict, cfg: gpt.GPTConfig) -> dict:
        """`full_params`' tree in the plain sequential forward's layout, for
        decoding (tpukit `shardings.py:401`)."""
        return params

    def setup(self, params: dict) -> dict:
        """The tree a train state holds, made from `params` (leaves that
        require grad); the optimizer is built over its leaves afterwards."""
        return params

    def host_batch_fn(self, cfg: gpt.GPTConfig):
        """A transform `(model_batch, targets) -> (model_batch, targets)` of
        numpy batches that `fit` applies to every host batch before it
        moves to the device (tpukit `shardings.py:323`), or None: every
        strategy but `ContextParallel`'s zigzag."""
        return None

    def full_params(self, params: dict) -> dict:
        """Every leaf as a plain, whole tensor on the compute device, for
        decoding. Every rank calls it."""
        return params

    def gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of the train state's leaf `name` (or of an
        optimizer state tensor shaped like it), for a checkpoint. A
        collective where the leaf is sharded."""
        return gather_full(t)

    def local_leaf(self, name: str, full: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """`full` (a whole tensor from a checkpoint) as the live tensor
        `live` of leaf `name` holds it: this rank's shard, as a DTensor,
        where `live` is one."""
        if not isinstance(live, DTensor):
            return full
        shard = local_shard(full, live).to(live.to_local().device)
        return DTensor.from_local(shard, live.device_mesh, live.placements, shape=live.shape,
                                  stride=live.stride())

    def leaf_block(self, name: str, t: torch.Tensor):
        """For a sharded checkpoint: (the global shape of leaf `name`, or of
        a state tensor shaped like it; the block of it this rank writes, or
        None where another rank writes it; the block's global start on each
        dimension). Every element is written once, as tpukit writes the
        blocks of replica 0: a DTensor's local block by its placements,
        FSDP2's padding stripped; a plain tensor by rank 0."""
        if isinstance(t, DTensor):
            block, starts = dtensor_block(t)
            return tuple(t.shape), block, starts
        return tuple(t.shape), t if mesh_lib.rank() == 0 else None, [0] * t.dim()

    def all_sum(self, values) -> list[float]:
        """`values` summed over the data-parallel ranks."""
        return [float(v) for v in values]

    def loss_sums(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                  with_accuracy: bool = False, aux_out: list | None = None, rng=None,
                  rng_row0: int = 0):
        """(CE summed over the valid tokens, their count, the correct
        argmaxes among them or 0) of one batch: `batch` holds `input_ids`,
        `position_ids` and `mask` (True = padding) tensors, `targets` uses
        -100 for ignored positions. MoE configs append the summed
        load-balance aux to `aux_out`. `rng` is the step's dropout key (None
        in eval), `rng_row0` the batch's first row within the global batch
        the masks are drawn over."""
        if self.fused_head and not fused_head_disabled():
            h = gpt.forward_hidden(params, cfg, batch["input_ids"], batch["position_ids"],
                                   batch["mask"], aux_out=aux_out, rng=rng, rng_row0=rng_row0)
            return fused_head_ce(h.reshape(-1, h.shape[-1]), params["lm_head"]["kernel"],
                                 targets.reshape(-1), cfg.vocab_size,
                                 with_accuracy=with_accuracy)
        logits = gpt.forward(params, cfg, batch["input_ids"], batch["position_ids"],
                             batch["mask"], aux_out=aux_out, rng=rng, rng_row0=rng_row0)
        loss_sum, count = cross_entropy_sum(logits, targets)
        correct = (masked_correct(logits, targets) if with_accuracy
                   else torch.zeros((), dtype=torch.float32, device=logits.device))
        return loss_sum, count, correct

    def loss_fn(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                with_accuracy: bool = False, aux_out: list | None = None, rng=None):
        """(mean masked CE, masked accuracy x 100 or 0) of one batch, from
        `loss_sums`."""
        loss_sum, count, correct = self.loss_sums(params, cfg, batch, targets,
                                                  with_accuracy=with_accuracy, aux_out=aux_out,
                                                  rng=rng)
        denom = torch.clamp(count, min=1.0)
        return loss_sum / denom, correct / denom * 100.0

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """(loss, grads): the loss of `loss_fn` and the gradient of the
        training objective with respect to every parameter, as a tree shaped
        like `params`. The objective is the loss itself, plus, for MoE
        configs, moe_aux_weight x the summed load-balance aux (the Switch
        objective); the returned loss is the pure CE either way. `rng` is
        the step's dropout key."""
        aux_list: list = []
        loss, _ = self.loss_fn(params, cfg, batch, targets, aux_out=aux_list, rng=rng)
        total = loss
        for aux in aux_list:
            total = total + cfg.moe_aux_weight * aux
        grads = torch.autograd.grad(total, leaves(params))
        return loss.detach(), unflatten(params, grads)


class SingleDevice(Strategy):
    name = "single"


MIN_SHARD_SIZE = 100  # tpukit FSDP's and ExpertParallel's default `min_shard_size`


def ep_placement(names: tuple, shape: tuple, data: int, expert: int) -> tuple | None:
    """Where tpukit's `ExpertParallel._spec_for` (`shardings.py:1307-1359`)
    puts a leaf (at path `names`, of global `shape`) on a `(data, expert)`
    grid: `("expert", 1)` for an expert-bank leaf (`[L, E, ...]`, its
    expert dimension split over `expert`, the same on every data replica);
    `("grid", dim)` for a trunk leaf split on `dim` over the whole grid, in
    rank order; None for a leaf whole on every rank. A trunk leaf under
    `MIN_SHARD_SIZE` elements stays whole; an embedding table splits its
    rows or stays whole; any other leaf splits the last dimension the grid
    divides, never a kernel's contraction dimension (-2): summed in pieces,
    its product would flip top-k routing."""
    if "experts" in names:
        return ("expert", 1)
    world = data * expert
    if world <= 1 or math.prod(shape) < MIN_SHARD_SIZE:
        return None
    if "embeddings" in names:
        dim = 0 if shape[0] % world == 0 else None
    else:
        candidates = [i for i, d in enumerate(shape)
                      if d % world == 0 and not (len(shape) >= 2 and i == len(shape) - 2)]
        dim = candidates[-1] if candidates else None
    return None if dim is None else ("grid", dim)


class ExpertParallel(Strategy):
    """Expert parallelism for MoE configs (twin of tpukit
    `shardings.py:1094-1368`) over a `(data, expert)` grid of the default
    group's ranks (`mesh.create_ep_mesh`, `expert` innermost). A 1 x 1
    grid is one device and needs no process group.

    Placement (`ep_placement`): each rank holds its `E / expert` experts of
    every expert-bank leaf (the same on every data replica) and its piece
    of each trunk leaf tpukit shards FSDP-style over the whole grid; AdamW's
    moments mirror the parameters. Rows of the global batch split over the
    whole grid in rank order (tpukit's `P(("data", "expert"))`).

    A step (`value_and_grad`): the sharded trunk gathered whole once, before
    the forward (one all-gather; summed in pieces, a trunk product would
    flip routing, tpukit `to_compute` :1216-1249); the forward on this
    rank's rows with `dispatch` ("a2a" by default, "pallas", or "xla")
    injected into the config with the grid and the row group: "a2a" and
    "pallas" exchange tokens with the expert group by `all_to_all_single`
    (`ops/moe_dispatch.py`), "xla" runs the meshless einsums on the whole
    bank, gathered over `expert`, as GSPMD runs them; the load-balance aux
    summed over the grid. tpukit's objective (the CE summed over the global
    batch's valid tokens over their count, plus `moe_aux_weight` x the
    global aux) differentiated on each rank over its rows; then the trunk's
    gradients summed and scattered back to their pieces (one
    reduce-scatter), the whole leaves' summed over the grid, the experts'
    summed over `data` (under "xla": the bank's summed over the grid and
    cut to this rank's experts). Checkpoints, decoding and plain model
    calls never carry the injected config."""

    name = "ep"
    # the a2a / pallas exchange's payload follows --comm_dtype; the trunk's
    # gather and reduce-scatter stay f32
    quantized_comm = True

    def comm_ops_for(self, cfg: gpt.GPTConfig) -> tuple[str, ...]:
        """tpukit `shardings.py:1170-1179` in the port's calls: the trunk's
        gather and reduce-scatter and the summed leaves' all-reduces on a
        grid, the exchange where the expert axis spans ranks."""
        ops = {"all-reduce"} if self.grid.size > 1 else set()
        if self.grid.expert > 1 and self.dispatch != "xla":
            ops.add("all-to-all")
        if self.grid.size > 1:
            ops.update({"all-gather", "reduce-scatter"})
        return tuple(sorted(ops))

    def dispatch_comm(self, cfg: gpt.GPTConfig, global_batch: int, seq: int) -> dict | None:
        """The exchange's calls of one step (tpukit `shardings.py:1269`):
        `moe_dispatch.expected_a2a` on this grid for the a2a and pallas
        dispatches (the pallas dispatch rides the same exchange); None for
        "xla" and dense configs. `global_batch` is the rows of the whole
        grid."""
        if self.dispatch == "xla" or cfg.num_experts <= 0:
            return None
        from tpukit_torch.ops.moe_dispatch import expected_a2a

        return expected_a2a(cfg, self.grid.data, self.grid.expert, global_batch, seq)

    def overlap_comm(self, cfg: gpt.GPTConfig, params) -> dict | None:
        """tpukit `shardings.py:1290`: the exchange is placed a layer at a
        time, so `--grad_buckets` >= 1 declares the backward's 2 L hops,
        each with the earlier layers' backward still to run."""
        if cfg.grad_buckets < 1 or self.grid.expert <= 1:
            return None
        if cfg.num_experts <= 0 or self.dispatch == "xla":
            return None
        return {"all-to-all": 2 * cfg.num_layers}

    def __init__(self, grid: ExpertGrid | None = None, dispatch: str = "a2a"):
        self.grid = grid if grid is not None else ExpertGrid()
        if dispatch not in ("xla", "a2a", "pallas"):
            raise ValueError(f"dispatch must be 'xla', 'a2a' or 'pallas', got {dispatch!r}")
        self.dispatch = dispatch
        self.mesh = None  # the (data, expert) mesh, once `setup` ran on a grid > 1 x 1
        self.params: dict | None = None
        self._place: dict = {}  # leaf path -> its `ep_placement`
        self._names: list = []  # the leaf paths of `params`, in `leaves` order

    @property
    def distributed(self) -> bool:
        return self.grid.size > 1

    @property
    def batch_divisor(self) -> int:
        return self.grid.size

    @property
    def data_replicas(self) -> int:
        return self.grid.data

    def data_rank(self) -> int:
        return mesh_lib.rank() // self.grid.expert

    @property
    def row_shards(self) -> int:
        return self.grid.size

    def row_shard(self) -> int:
        return mesh_lib.rank()

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        if cfg.num_experts <= 0:
            raise ValueError("ExpertParallel requires an MoE config: pass --num_experts N "
                             "(N > 0); dense models belong on the other strategies")
        if cfg.num_experts % self.grid.expert:
            raise ValueError(f"--num_experts {cfg.num_experts} must divide over the "
                             f"{self.grid.expert}-way expert axis")
        if cfg.comm_dtype != "f32" and self.dispatch == "xla":
            raise ValueError(
                f"--comm_dtype {cfg.comm_dtype} under ExpertParallel needs the hand-placed "
                f"exchange: use --moe_dispatch a2a or pallas (the xla dispatch leaves its "
                f"collectives to GSPMD, which cannot carry the packed int8 payload)")
        if cfg.grad_buckets > 0 and self.dispatch == "xla":
            raise ValueError(
                f"--grad_buckets {cfg.grad_buckets} under ExpertParallel needs the "
                f"hand-placed exchange: use --moe_dispatch a2a or pallas (the xla dispatch "
                f"leaves its collectives to GSPMD — there is no hand-placed schedule to "
                f"declare overlap for)")

    def setup(self, params: dict) -> dict:
        """The (data, expert) mesh and this rank's tree: its experts of each
        bank leaf and its piece of each sharded trunk leaf (leaves of their
        own), the rest as given. A 1 x 1 grid keeps the tree."""
        if self.grid.size == 1:
            return params
        device = leaves(params)[0].device
        self.mesh = mesh_lib.create_ep_mesh(self.grid.data, self.grid.expert, device.type)
        self.grid = ExpertGrid.of(self.mesh)
        out = []
        for name, p in zip(paths(params), leaves(params)):
            place = ep_placement(tuple(name.split("/")), tuple(p.shape), self.grid.data,
                                 self.grid.expert)
            self._place[name] = place
            if place is None:
                out.append(p)
                continue
            n, i = self._split(place)
            out.append(p.detach().chunk(n, dim=place[1])[i].clone().requires_grad_(True))
        self.params = unflatten(params, out)
        self._names = paths(self.params)
        # a first collective on each group, which NCCL wants from every rank
        dist.barrier()
        for axis in ("data", "expert"):
            group = self.mesh.get_group(axis)
            if dist.get_world_size(group) > 1:
                dist.barrier(group=group)
        return self.params

    def _split(self, place) -> tuple[int, int]:
        """(pieces, this rank's index) of a placement."""
        if place[0] == "grid":
            return self.grid.size, mesh_lib.rank()
        return self.grid.expert, self.grid.rank

    def _group(self, place):
        return None if place[0] == "grid" else self.mesh.get_group("expert")

    def _check(self, params) -> None:
        if self.grid.size > 1 and (self.mesh is None or params is not self.params):
            raise ValueError(f"{self.name}: pass the tree `setup` returned (the train "
                             f"state's params)")

    def _dispatch_cfg(self, cfg: gpt.GPTConfig) -> gpt.GPTConfig:
        """The config the loss runs with: this dispatch and grid injected
        for MoE configs (tpukit `shardings.py:1251-1258`), and the grid as
        the row group of the aux."""
        if cfg.num_experts <= 0:
            return cfg
        rows = RowGroup(size=self.grid.size) if self.grid.size > 1 else None  # the default group
        if self.dispatch == "xla":
            return cfg.replace(moe_rows=rows)
        return cfg.replace(moe_dispatch=self.dispatch, moe_mesh=self.grid, moe_rows=rows)

    def _bank_whole(self) -> bool:
        """Whether the forward runs on the whole bank ("xla" over an expert
        axis > 1, as GSPMD runs it)."""
        return self.dispatch == "xla" and self.grid.expert > 1

    def _gathered(self, flat: list, idx: list, group, n: int) -> list:
        """The leaves `flat[i]` (i in `idx`, each split over `group`'s `n`
        ranks on its placement's dimension) whole: one all-gather of every
        piece, in the group's rank order."""
        if not idx:
            return []
        bucket = torch.cat([flat[i].detach().reshape(-1) for i in idx])
        got = bucket.new_empty(n * bucket.numel())
        dist.all_gather_into_tensor(got, bucket, group=group)
        got = got.view(n, -1)
        out, offset = [], 0
        for i in idx:
            t = flat[i]
            parts = [got[r, offset:offset + t.numel()].view(t.shape) for r in range(n)]
            out.append(torch.cat(parts, dim=self._place_of(i)[1]))
            offset += t.numel()
        return out

    def _place_of(self, i: int):
        return self._place[self._names[i]]

    def compute_params(self, params) -> dict:
        """The tree the forward runs on: every trunk leaf whole (gathered
        ones as leaves of their own), this rank's experts (the whole bank
        under "xla" over an expert axis > 1)."""
        self._check(params)
        if self.grid.size == 1:
            return params
        flat = leaves(params)
        out = list(flat)
        kinds = [self._kind(i) for i in range(len(flat))]
        for kind, group, n in (("grid", None, self.grid.size),
                               ("bank", self.mesh.get_group("expert"), self.grid.expert)):
            idx = [i for i, k in enumerate(kinds) if k == kind]
            for i, whole in zip(idx, self._gathered(flat, idx, group, n)):
                out[i] = whole.requires_grad_(True)
        return unflatten(params, out)

    def _kind(self, i: int) -> str:
        """"grid" (a trunk piece), "bank" (experts gathered whole), "expert"
        (this rank's experts as they are) or "whole"."""
        place = self._place_of(i)
        if place is None:
            return "whole"
        if place[0] == "grid":
            return "grid"
        return "bank" if self._bank_whole() else "expert"

    def loss_sums(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                  with_accuracy: bool = False, aux_out: list | None = None, rng=None,
                  rng_row0: int | None = None):
        """This rank's sums over its rows, on `params` as the forward runs on
        them (`compute_params`). Dropout masks are this rank's rows of the
        global batch's, `[rank x B, (rank + 1) x B)`."""
        if rng_row0 is None:
            rng_row0 = mesh_lib.rank() * batch["input_ids"].shape[0] if self.distributed else 0
        return super().loss_sums(params, self._dispatch_cfg(cfg), batch, targets,
                                 with_accuracy, aux_out, rng, rng_row0)

    def loss_fn(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                with_accuracy: bool = False, aux_out: list | None = None, rng=None):
        """This rank's means over its rows (the trunk gathered first)."""
        return super().loss_fn(self.compute_params(params), cfg, batch, targets,
                               with_accuracy=with_accuracy, aux_out=aux_out, rng=rng)

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """(global loss, this rank's gradients, shaped as its tree)."""
        if self.grid.size == 1:
            return super().value_and_grad(params, cfg, batch, targets, rng=rng)
        tree = self.compute_params(params)
        aux_list: list = []
        loss_sum, count, _ = self.loss_sums(tree, cfg, batch, targets, aux_out=aux_list, rng=rng)
        totals = torch.stack([loss_sum.detach(), count])
        dist.all_reduce(totals)
        denom = torch.clamp(totals[1], min=1.0)
        total = loss_sum / denom
        for aux in aux_list:
            total = total + cfg.moe_aux_weight * aux
        inputs = leaves(tree)
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
        return totals[0] / denom, unflatten(params, self._reduce(grads))

    def _reduce(self, grads: list) -> list:
        """Each gradient summed over the ranks that share its leaf, in this
        rank's layout: the trunk's pieces by one reduce-scatter over the
        grid, the whole leaves (and a gathered bank) by one all-reduce over
        it, this rank's experts by one all-reduce over `data`."""
        kinds = [self._kind(i) for i in range(len(grads))]
        out = list(grads)
        world = self.grid.size
        idx = [i for i, k in enumerate(kinds) if k == "grid"]
        if idx:
            chunks = [grads[i].chunk(world, dim=self._place_of(i)[1]) for i in idx]
            send = torch.cat([c[r].reshape(-1) for r in range(world) for c in chunks])
            got = send.new_empty(send.numel() // world)
            dist.reduce_scatter_tensor(got, send)
            for i, c, part in zip(idx, chunks, got.split([c[0].numel() for c in chunks])):
                out[i] = part.view(c[0].shape)
        for kinds_of, group in ((("whole", "bank"), None),
                                (("expert",), self.mesh.get_group("data"))):
            idx = [i for i, k in enumerate(kinds) if k in kinds_of]
            if not idx or dist.get_world_size(group) == 1:
                continue
            bucket = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(bucket, group=group)
            for i, part in zip(idx, bucket.split([grads[i].numel() for i in idx])):
                out[i] = part.view(grads[i].shape)
        for i, k in enumerate(kinds):
            if k == "bank":
                out[i] = out[i].chunk(self.grid.expert, dim=1)[self.grid.rank].contiguous()
        return out

    def _piece(self, name: str, t: torch.Tensor):
        """The placement of this rank's leaf `name` (or of a state tensor
        shaped like it), or None where it is whole."""
        if self.mesh is None or t.dim() == 0:
            return None
        return self._place.get(name)

    def gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a local leaf (or of a state tensor shaped
        like it). A collective."""
        place = self._piece(name, t)
        if place is None:
            return t
        n, _ = self._split(place)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous(), group=self._group(place))
        return torch.cat(parts, dim=place[1])

    def local_leaf(self, name: str, full: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor `full`, as `live` holds it."""
        place = self._piece(name, live)
        if place is None:
            return full
        n, i = self._split(place)
        return full.chunk(n, dim=place[1])[i]

    def leaf_block(self, name: str, t: torch.Tensor):
        """Every rank writes its trunk pieces, the ranks of data replica 0
        their experts, rank 0 the leaves held whole (each element once)."""
        place = self._piece(name, t)
        if place is None:
            return super().leaf_block(name, t)
        n, i = self._split(place)
        shape, starts = list(t.shape), [0] * t.dim()
        starts[place[1]] = i * shape[place[1]]
        shape[place[1]] *= n
        writes = place[0] == "grid" or self.mesh.get_local_rank("data") == 0
        return tuple(shape), t if writes else None, starts

    def full_params(self, params: dict) -> dict:
        """Every leaf whole on every rank (a collective)."""
        return unflatten(params, [self.gather_leaf(n, p).detach()
                                  for n, p in zip(paths(params), leaves(params))])

    def all_sum(self, values) -> list[float]:
        """Summed over the grid: every rank holds rows of its own."""
        if self.mesh is None:
            return super().all_sum(values)
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=comm_device(self.mesh))
        dist.all_reduce(t)
        return t.tolist()


class ParamTree(nn.Module):
    """A parameter tree as a module: each dict a submodule, each leaf an
    `nn.Parameter` under its key. `tree()` reads the leaves as they stand
    when it is called, so under FSDP2, which swaps sharded and unsharded
    parameters on the module around each forward, the model sees the
    unsharded ones; `forward(fn, *args)` is `fn(tree(), *args)`, which lets
    DDP and FSDP2 hook the call."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, v if isinstance(v, nn.Parameter) else nn.Parameter(v))

    def tree(self) -> dict:
        return {k: self._modules[k].tree() if k in self._modules else self._parameters[k]
                for k in self._keys}

    def forward(self, fn, *args, **kwargs):
        return fn(self.tree(), *args, **kwargs)


def comm_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded DTensor (a collective: every rank of
    its mesh calls it), gathered on the mesh's device, wherever its shard
    lives (host memory under CPU offload); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    local, comm = t.to_local(), comm_device(t.device_mesh)
    if local.device != comm:
        t = DTensor.from_local(local.to(comm), t.device_mesh, t.placements,
                               shape=t.shape, stride=t.stride())
    return t.full_tensor()


def local_shard(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's piece of `full` as `like` holds its own: `torch.chunk`
    along each sharded dimension, as FSDP2 and DTensor split."""
    mesh, local = like.device_mesh, full
    for axis, placement in enumerate(like.placements):
        if isinstance(placement, Shard):
            parts = torch.chunk(local, mesh.size(axis), dim=placement.dim)
            local = parts[mesh.get_local_rank(axis)]
    return local


def dtensor_block(t: DTensor):
    """This rank's block of `t` (its local tensor cut to the `torch.chunk`
    piece its placements give it) and the block's global start on each
    dimension; (None, starts) where the rank's coordinate on a replicated
    mesh axis is not 0."""
    mesh, starts, sizes = t.device_mesh, [0] * t.dim(), list(t.shape)
    for axis, placement in enumerate(t.placements):
        r = mesh.get_local_rank(axis)
        if isinstance(placement, Shard):
            d = placement.dim
            chunk = -(-sizes[d] // mesh.size(axis))
            lo = min(r * chunk, sizes[d])
            starts[d] += lo
            sizes[d] = min(lo + chunk, sizes[d]) - lo
        elif r != 0:
            return None, starts
    return t.to_local()[tuple(slice(0, s) for s in sizes)], starts


def distinct_piece(strategy: "Strategy | None", name: str, t: torch.Tensor):
    """What this rank counts of leaf `name` (or of a state tensor shaped
    like it) when a reduction must see each element of the logical array
    once: (False, the local tensor) for a leaf held whole here, which every
    rank counts for itself; (True, the block `leaf_block` has this rank
    write, or None where another rank's covers it) for a piece of a leaf
    split over ranks, or a DTensor (its replicated placements counted by
    coordinate 0 alone)."""
    shape, block, _ = (strategy or Strategy()).leaf_block(name, t)
    if not isinstance(t, DTensor) and tuple(shape) == tuple(t.shape):
        return False, t
    return True, block


def fsdp_shard_dim(shape, world: int) -> int | None:
    """tpukit's FSDP placement (`shardings.py:724-738`): the dimension a
    leaf of `shape` shards over `world` ranks, or None to replicate it. A
    leaf under `MIN_SHARD_SIZE` elements, or with no dimension divisible
    by the world, is replicated; otherwise the largest divisible dimension
    shards (the last of equals)."""
    if math.prod(shape) < MIN_SHARD_SIZE:
        return None
    candidates = [(d, i) for i, d in enumerate(shape) if d % world == 0]
    return max(candidates)[1] if candidates else None


class _DataParallelBase(Strategy):
    """Rows of the global batch sharded over the `data` mesh, one slice per
    rank of the default group (or of `mesh`, a 1-D `DeviceMesh` over some
    of its ranks, as tpukit's strategies take a mesh: a sub-world); the
    loss and its gradient run through `self.module`, the wrapped
    `ParamTree`. `setup` builds both."""

    distributed = True

    def __init__(self, mesh=None):
        self._given_mesh = mesh
        self.mesh = mesh  # the `data` mesh (by default every rank's, made by `setup`)
        self.module = None  # the wrapped ParamTree, once `setup` ran
        self.params: dict | None = None

    @property
    def world(self) -> int:
        """The size of the `data` mesh: the default group's by default."""
        return self.mesh.size() if self.mesh is not None else mesh_lib.world_size()

    @property
    def batch_divisor(self) -> int:
        return self.world

    @property
    def data_replicas(self) -> int:
        return self.world

    def data_rank(self) -> int:
        return self.mesh.get_local_rank() if self.mesh is not None else mesh_lib.rank()

    def _wrap(self, module: ParamTree, device: torch.device):
        raise NotImplementedError

    def setup(self, params: dict) -> dict:
        device = leaves(params)[0].device
        self.mesh = self._given_mesh or mesh_lib.create_mesh({"data": -1}, device.type)
        tree = ParamTree(params)
        self.module = self._wrap(tree, device)
        self.params = tree.tree()
        return self.params

    def _check(self, params) -> None:
        if self.module is None or params is not self.params:
            raise ValueError(f"{self.name}: pass the tree `setup` returned (the train "
                             f"state's params)")

    def loss_sums(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                  with_accuracy: bool = False, aux_out: list | None = None, rng=None,
                  rng_row0: int | None = None):
        """This rank's sums over its rows, through the wrapped module (so
        `loss_fn` gives this rank's means). Dropout masks are this rank's
        rows of the global batch's (tpukit draws them over the global batch
        and shards them): rows `[rank * B, (rank + 1) * B)`."""
        self._check(params)
        if rng_row0 is None:
            rng_row0 = dist.get_rank(self.mesh.get_group()) * batch["input_ids"].shape[0]
        if cfg.num_experts > 0 and self.world > 1:
            cfg = cfg.replace(moe_rows=RowGroup(group=self.mesh.get_group(), size=self.world))
        return self.module(super().loss_sums, cfg, batch, targets, with_accuracy, aux_out,
                           rng, rng_row0)

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """(global loss, grads) by `.backward()`, so that DDP's and FSDP2's
        gradient hooks run. tpukit's objective is the CE summed over the
        global batch's valid tokens over their count
        (`tpukit/shardings.py:456-465`), plus for MoE configs
        moe_aux_weight x the load-balance aux of the global batch; the count
        is summed over the ranks before the backward, the aux's statistics
        in the forward (`cfg.moe_rows`), and each rank differentiates
        `world x (loss_sum_r / count + moe_aux_weight x aux)`, which the
        wrappers' average over ranks turns into that objective's gradient.
        Routing and capacity are per row, so each rank's forward is the
        global batch's on its rows."""
        aux_list: list = []
        loss_sum, count, _ = self.loss_sums(params, cfg, batch, targets, aux_out=aux_list,
                                            rng=rng)
        totals = torch.stack([loss_sum.detach(), count])
        dist.all_reduce(totals, group=self.mesh.get_group())
        denom = torch.clamp(totals[1], min=1.0)
        objective = loss_sum / denom
        for aux in aux_list:
            objective = objective + cfg.moe_aux_weight * aux
        (objective * self.world).backward()
        self._after_backward()
        flat = leaves(params)
        return totals[0] / denom, unflatten(params, [p.grad for p in flat])

    def _after_backward(self) -> None:
        pass

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        """tpukit's refusal (`shardings.py:532-539`, :621-628): the
        hand-placed wire with an MoE config."""
        if self._hand_placed(cfg) and cfg.num_experts > 0:
            raise ValueError(
                f"--comm_dtype {cfg.comm_dtype} / --grad_buckets {cfg.grad_buckets} under "
                f"{self._TK_NAME} requires a dense model: the MoE aux-loss statistics are "
                f"not psummed by the hand-placed grad block — use ExpertParallel "
                f"(main-moe.py) for MoE comm")

    _TK_NAME = ""

    def _local_objective(self, tree: dict, cfg: gpt.GPTConfig, batch: dict, targets, rng):
        """The hand-placed step's local objective (tpukit `_quantized_dp_grads`'
        block, `shardings.py:134-147`): this rank's CE sum over its rows on
        `tree` (not through the wrapper) over the valid-token count summed
        over the ranks in f32. Dropout draws this rank's own masks from
        `fold_in(rng, rank)` over its rows, as tpukit's block does. Returns
        (objective, that key)."""
        if cfg.num_experts > 0:
            raise ValueError(f"--comm_dtype bf16/int8 / --grad_buckets under {self._TK_NAME} "
                             f"requires a dense model (see {self._TK_NAME}.validate_config)")
        local_rng = None if rng is None else tk_random.fold_in(rng, self.data_rank())
        gcount = (targets != IGNORE_INDEX).sum().float()
        if self.world > 1:
            dist.all_reduce(gcount, group=self.mesh.get_group())
        loss_sum, _, _ = Strategy.loss_sums(self, tree, cfg, batch, targets, rng=local_rng,
                                            rng_row0=0)
        return loss_sum / torch.clamp(gcount, min=1.0), local_rng

    @staticmethod
    def _defers(cfg: gpt.GPTConfig) -> bool:
        """Whether the hand-placed step issues its bucket wires from the
        backward (`ops/deferred.py`) on a world with a wire: two buckets
        or more, without `--remat_layers` (a recomputed layer rebuilds its
        graph in the backward, where no product can be set aside)."""
        return cfg.grad_buckets >= 2 and not cfg.remat_layers

    def _deferral(self, params: dict, cfg: gpt.GPTConfig, buckets: list[list[int]],
                  tensors: list):
        """(the `Deferral` over `tensors`, the index of the bucket issued
        last): `deferred.late_bucket` of `buckets` (indices into `leaves`),
        a stacked `layers` leaf read once a layer, any other leaf once. The
        products it defers are those no other wire waits for: the last
        bucket's and those of the leaves in no bucket (FSDP's replicated
        leaves, all-reduced after the backward)."""
        reads = [cfg.num_layers if "layers" in name.split("/") else 1 for name in paths(params)]
        last = deferred.late_bucket([sum(reads[k] for k in idxs) for idxs in buckets])
        bucketed = {k for idxs in buckets for k in idxs}
        late = set(buckets[last]) | set(range(len(tensors))) - bucketed
        return deferred.Deferral(tensors, late), last

    @staticmethod
    def _declared(n_buckets: int) -> int | None:
        """The bucket wires an eager step can hide: B - 1 of each op.

        Every backward ATen op of the step feeds the gradient of some
        bucketed leaf (FSDP: or of a replicated leaf under 100 elements, a
        handful of ops). A bucket's wire can be issued only once its
        leaves' gradients are done, so whichever wire is issued last has no
        backward op left after it, in any eager order; the other B - 1 are
        issued while the weight products of the last bucket still have to
        run (`deferred.late_bucket` defers the products of the bucket the
        forward reads most). tpukit declares B: its gate counts the compute
        independent of a wire in the HLO's dataflow, which XLA's scheduler
        can run beside it."""
        return n_buckets - 1 if n_buckets >= 2 else None

    def _jax_order(self, params: dict) -> list[int]:
        """The `leaves` index of each leaf in tpukit's (sorted-key) order."""
        pos = {tuple(n.split("/")): k for k, n in enumerate(paths(params))}
        return [pos[path] for path, _ in quant_comm.sorted_items(params)]

    def _global_loss(self, objective: torch.Tensor) -> torch.Tensor:
        loss = objective.detach().clone()
        if self.world > 1:
            dist.all_reduce(loss, group=self.mesh.get_group())
        return loss

    def all_sum(self, values) -> list[float]:
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=comm_device(self.mesh))
        dist.all_reduce(t, group=self.mesh.get_group())
        return t.tolist()


class DataParallel(_DataParallelBase):
    """Twin of tpukit's `DataParallel` (`shardings.py:512`) and of the
    reference's DDP recipe: parameters replicated, rows sharded,
    `DistributedDataParallel` averaging the gradients in its backward
    hooks (the wrapper is built at the first such step; `release` drops it
    before the group goes).

    With `--comm_dtype bf16|int8` or `--grad_buckets N` the gradient wire
    is hand-placed instead (tpukit `_quantized_dp_grads`,
    `shardings.py:110-169`): each rank takes the exact f32 gradients of its
    local objective (`_local_objective`, differentiated by
    `torch.autograd.grad` on the unwrapped tree; no DDP wrapper is built),
    then one `quant_comm.quantized_psum_tree` of the whole tree, or
    one `bucket_all_reduce` a bucket of `grad_bucket_plan`. The loss and
    the count are summed in f32. The stochastic key of the int8 wire is
    `fold_in(fold_in(step key, rank), 0x5151)` (tpukit `_quant_rng`)."""

    name = "ddp"
    quantized_comm = True
    _TK_NAME = "DataParallel"
    comm_ops = ("all-reduce",)  # DDP's bucket all-reduces, the loss and count

    def comm_ops_for(self, cfg: gpt.GPTConfig) -> tuple[str, ...]:
        if self._hand_placed(cfg):
            return ("all-gather", "all-reduce", "all-to-all")  # the two-shot pairs
        return self.comm_ops

    def overlap_comm(self, cfg: gpt.GPTConfig, params) -> dict | None:
        """The bucket wire's declaration (tpukit `shardings.py:589`): all
        but the last issued bucket's two-shot pair (its all-to-all and its
        all-gather) must have backward work left around it (`_declared`:
        B - 1, where tpukit declares B); None under two buckets or with
        `--remat_layers`, where the wires are issued after the backward."""
        if not self._defers(cfg) or params is None:
            return None
        n = self._declared(len(quant_comm.grad_bucket_plan(params, cfg.grad_buckets)))
        return {"all-to-all": n, "all-gather": n} if n else None

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        if not self._hand_placed(cfg):
            self._check(params)
            self._ddp()
            return super().value_and_grad(params, cfg, batch, targets, rng=rng)
        self._check(params)
        if self._defers(cfg) and self.world > 1:
            return self._bucket_step(params, cfg, batch, targets, rng)
        objective, local_rng = self._local_objective(params, cfg, batch, targets, rng)
        flat = leaves(params)
        grads = unflatten(params, torch.autograd.grad(objective, flat))
        qrng = self._quant_rng(cfg, local_rng)
        group = self.mesh.get_group()
        if cfg.grad_buckets > 0:
            grads = quant_comm.bucketed_psum_tree(grads, group, self.world, cfg.grad_buckets,
                                                  cfg.comm_dtype, rng=qrng)
        else:
            grads = quant_comm.quantized_psum_tree(grads, group, self.world, cfg.comm_dtype,
                                                   rng=qrng)
        return self._global_loss(objective), grads

    @staticmethod
    def _quant_rng(cfg: gpt.GPTConfig, local_rng):
        if cfg.quant_stochastic and local_rng is not None:
            return tk_random.fold_in(local_rng, 0x5151)
        return None

    def _bucket_step(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng):
        """The bucket wire issued from the backward (`ops/deferred.py`): the
        activation-gradient chain with every weight product in place but
        those of the bucket the forward reads most, then every other
        bucket's two-shot all-to-all, half the deferred products, those
        all-to-alls taken on to their all-gathers, the other half, and the
        last bucket's pair. The gradients and the wire are
        `bucketed_psum_tree`'s, bit for bit."""
        order = self._jax_order(params)
        buckets = [[order[j] for j in idxs]
                   for idxs in quant_comm.grad_bucket_plan(params, cfg.grad_buckets)]
        defer, last = self._deferral(params, cfg, buckets, leaves(params))
        with defer.active():
            objective, local_rng = self._local_objective(defer.capture(params), cfg, batch,
                                                         targets, rng)
        wire = quant_comm.BucketAllReduce(self.mesh.get_group(), self.world, cfg.comm_dtype,
                                          rng=self._quant_rng(cfg, local_rng))
        grads = defer.backward(
            objective, buckets, last,
            on_bucket=lambda b, got: wire.issue(b, [got[k] for k in buckets[b]]),
            on_midway=lambda: defer.wire(wire.advance))
        for b, idxs in enumerate(buckets):
            for k, g in zip(idxs, wire.result(b)):
                grads[k] = g
        return self._global_loss(objective), unflatten(params, grads)

    def grad_comm(self, cfg: gpt.GPTConfig, params: dict) -> dict | None:
        """The hand-placed wire's `{op: {count, bytes}}` a step (tpukit
        `DataParallel.grad_comm`, `shardings.py:559-587`, at `backend=None`:
        c10d moves bf16 as 2 bytes): one two-shot pair, or one a bucket;
        None where nothing is hand-placed."""
        world = self.world
        if cfg.grad_buckets > 0:
            items = quant_comm.sorted_items(params)
            sizes = [sum(items[i][1].numel() for i in idxs)
                     for idxs in quant_comm.grad_bucket_plan(params, cfg.grad_buckets)]
            return quant_comm.expected_bucketed_all_reduce(sizes, world, cfg.comm_dtype)
        if cfg.comm_dtype == "f32":
            return None
        return quant_comm.expected_all_reduce(sum(p.numel() for p in leaves(params)), world,
                                              cfg.comm_dtype)

    def _wrap(self, module: ParamTree, device: torch.device):
        return module  # `_ddp` wraps it at the first f32 step

    def _ddp(self) -> None:
        """Wrap the tree in `DistributedDataParallel` (first f32 step
        only), so a run on the hand-placed wire never builds DDP's reducer
        and its f32 gradient buckets."""
        if isinstance(self.module, nn.parallel.DistributedDataParallel):
            return
        device = leaves(self.params)[0].device
        ids = [device.index] if device.type == "cuda" else None
        self.module = nn.parallel.DistributedDataParallel(
            self.module, device_ids=ids, process_group=self.mesh.get_group())
        # the default hook's arithmetic (each bucket divided by the world,
        # then summed), issued through `torch.distributed.all_reduce`, where
        # the comm audit's trace sees it; the reducer's own calls are C++
        self.module.register_comm_hook(self.mesh.get_group(), default_hooks.allreduce_hook)

    def release(self) -> None:
        """Unwrap the tree before the group is destroyed: DDP's reducer
        holds the group, and freed after it (as a run's result is dropped)
        it can hang the process's exit over gloo once the peer has gone."""
        if isinstance(self.module, nn.parallel.DistributedDataParallel):
            self.module = self.module.module


class FSDP(_DataParallelBase):
    """Twin of tpukit's `FSDP` (`shardings.py:603`): FSDP2 `fully_shard`
    on the whole tree (its stacked `layers` leaves make one group),
    parameters, gradients and AdamW state sharded by `fsdp_shard_dim`.
    One group gathers the whole tree at once and, as FSDP2's root, keeps
    it unsharded from the forward to the end of the backward (FSDP2's
    default for a root), so the step holds a full copy of the parameters
    beside their shards: FSDP saves memory on gradients and AdamW state.
    Leaves it replicates are left out of FSDP2 (`ignored_params`) and
    their gradients averaged here after the backward. Parameters are
    gathered in f32, as tpukit gathers them; the model casts at use.

    `cpu_offload` (tpukit `state_sharding` :740-760): on `cuda`, FSDP2's
    `CPUOffloadPolicy` keeps the sharded parameters, their gradients and
    the AdamW state in host memory, and the optimizer steps there; on any
    other device it warns and runs plain FSDP, as tpukit degrades off-TPU."""

    name = "fsdp"
    quantized_comm = True
    _TK_NAME = "FSDP"
    # FSDP2's gather and reduce-scatter, the replicated leaves' all-reduces
    comm_ops = ("all-gather", "reduce-scatter", "all-reduce")

    def comm_ops_for(self, cfg: gpt.GPTConfig) -> tuple[str, ...]:
        if self._hand_placed(cfg):
            return ("all-gather", "all-reduce", "all-to-all")  # the packed reduce-scatter
        return self.comm_ops

    def overlap_comm(self, cfg: gpt.GPTConfig, params) -> dict | None:
        """The bucket wire's declaration (tpukit `shardings.py:709`): all
        but the last issued bucket's reduce-scatter all-to-all (`_declared`:
        B - 1, where tpukit declares B); the forward gathers are at use by
        design and not declared. None under two buckets or with
        `--remat_layers`."""
        if not self._defers(cfg) or params is None:
            return None
        n = self._declared(len(self._buckets(params, cfg, self._dims(params))))
        return {"all-to-all": n} if n else None

    def __init__(self, cpu_offload: bool = False, mesh=None):
        super().__init__(mesh)
        self.cpu_offload = cpu_offload
        self.replicated: list = []
        if cpu_offload:
            self.name = "fsdp-offload"

    def shard_dim(self, shape) -> int | None:
        return fsdp_shard_dim(shape, self.world)

    @staticmethod
    def _offload_supported(device: torch.device) -> bool:
        return device.type == "cuda"

    def _wrap(self, module: ParamTree, device: torch.device):
        self.replicated = [p for p in module.parameters() if self.shard_dim(p.shape) is None]
        policy = OffloadPolicy()
        if self.cpu_offload:
            if self._offload_supported(device):
                policy = CPUOffloadPolicy()
            else:
                warnings.warn(f"--cpu_offload needs a CUDA device, got {device.type}; running "
                              f"plain FSDP instead", stacklevel=3)
        fully_shard(module, mesh=self.mesh,
                    shard_placement_fn=lambda p: Shard(self.shard_dim(p.shape)),
                    offload_policy=policy, ignored_params=set(self.replicated) or None)
        return module

    def _after_backward(self) -> None:
        if self.world == 1:
            return
        group = self.mesh.get_group()
        for p in self.replicated:
            dist.all_reduce(p.grad, group=group)
            p.grad.div_(self.world)

    def _buckets(self, params: dict, cfg: gpt.GPTConfig, dims: list) -> list[list[int]]:
        """`grad_bucket_plan` of the sharded leaves, as `leaves` indices."""
        order = self._jax_order(params)
        sharded = {j for j, k in enumerate(order) if dims[k] is not None}
        plan = quant_comm.grad_bucket_plan(params, cfg.grad_buckets, include=sharded)
        return [[order[j] for j in idxs] for idxs in plan]

    def _dims(self, params: dict) -> list:
        """The dimension each leaf of the tree is sharded on, or None."""
        return [self.shard_dim(p.shape) if isinstance(p, DTensor) else None
                for p in leaves(params)]

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """FSDP2's step, or with `--comm_dtype bf16|int8` or `--grad_buckets
        N` the hand-placed one (tpukit `_quantized_fsdp_grads`,
        `shardings.py:172-260`). FSDP2's reduce-scatter cannot carry that
        payload (its bf16 `reduce_dtype` accumulates in bf16; tpukit
        accumulates in f32), so this step runs its own collectives, as
        `ExpertParallel` does: every sharded leaf gathered at use at full
        precision along its `fsdp_shard_dim` through `all_gather_qgrad`
        (or one `bucket_gather_qgrad` a bucket), whose backward is the
        quantized reduce-scatter; the replicated leaves through `psum_grad`
        (f32). Gradients land in the shard layout, as DTensors like their
        parameters. FSDP2's own hooks never run on this path."""
        if not self._hand_placed(cfg):
            return super().value_and_grad(params, cfg, batch, targets, rng=rng)
        self._check(params)
        if self._defers(cfg) and self.world > 1:
            return self._bucket_step(params, cfg, batch, targets, rng)
        group, world = self.mesh.get_group(), self.world
        flat, dims = leaves(params), self._dims(params)
        device = comm_device(self.mesh)
        local = [p.to_local() if isinstance(p, DTensor) else p for p in flat]
        xs = [t.detach().to(device).requires_grad_(True) for t in local]
        full: list = [None] * len(flat)
        for k, (x, dim) in enumerate(zip(xs, dims)):
            if dim is None:
                full[k] = quant_comm.psum_grad(x, group, world)
        if cfg.grad_buckets > 0:
            for idxs in self._buckets(params, cfg, dims):
                gathered = quant_comm.bucket_gather_qgrad(
                    tuple(xs[k] for k in idxs), group, world, tuple(dims[k] for k in idxs),
                    cfg.comm_dtype, quant_comm.DEFAULT_BLOCK, cfg.quant_stochastic)
                for k, g in zip(idxs, gathered):
                    full[k] = g
        else:
            for k, (x, dim) in enumerate(zip(xs, dims)):
                if dim is not None:
                    full[k] = quant_comm.all_gather_qgrad(
                        x, group, world, dim, cfg.comm_dtype, quant_comm.DEFAULT_BLOCK,
                        cfg.quant_stochastic)
        objective, _ = self._local_objective(unflatten(params, full), cfg, batch, targets, rng)
        gs = torch.autograd.grad(objective, xs)
        return self._global_loss(objective), self._shard_grads(params, local, gs)

    @staticmethod
    def _shard_grads(params: dict, local: list, gs) -> dict:
        """The shards' gradients in the shard layout, as DTensors like their
        parameters."""
        grads = []
        for p, t, g in zip(leaves(params), local, gs):
            if isinstance(p, DTensor):
                g = DTensor.from_local(g.to(t.device), p.device_mesh, p.placements,
                                       shape=p.shape, stride=p.stride())
            grads.append(g)
        return unflatten(params, grads)

    def _bucket_step(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng):
        """The bucket wire issued from the backward (`ops/deferred.py`): the
        sharded leaves gathered at use in bucket order, as `_BucketGatherQGrad`
        gathers them; the activation-gradient chain with every weight
        product in place but those of the bucket the forward reads most,
        then every other bucket's packed reduce-scatter (`BucketScatter`),
        the deferred products, and the last bucket's, each waited on where
        it is unpacked, after the backward; the replicated leaves' f32
        all-reduces last. The gradients are the blocking step's, bit for
        bit."""
        group, world = self.mesh.get_group(), self.world
        dims, device = self._dims(params), comm_device(self.mesh)
        local = [p.to_local() if isinstance(p, DTensor) else p for p in leaves(params)]
        full = [t.detach().to(device) for t in local]
        buckets = self._buckets(params, cfg, dims)
        for idxs in buckets:
            for k in idxs:
                full[k] = quant_comm.gather_dim(full[k], group, world, dims[k])
        defer, last = self._deferral(params, cfg, buckets, full)
        with defer.active():
            objective, _ = self._local_objective(defer.capture(unflatten(params, full)), cfg,
                                                 batch, targets, rng)
        shots: dict = {}

        def on_bucket(b, got):
            idxs = buckets[b]
            shots[b] = quant_comm.BucketScatter(
                [got[k] for k in idxs], group, world, [dims[k] for k in idxs],
                cfg.comm_dtype, quant_comm.DEFAULT_BLOCK, cfg.quant_stochastic, async_op=True)

        gs = defer.backward(objective, buckets, last, on_bucket)
        for b, shot in sorted(shots.items()):
            for k, g in zip(buckets[b], shot.finish()):
                gs[k] = g
        for k, dim in enumerate(dims):
            if dim is None:  # `psum_grad`'s backward
                gs[k] = gs[k].clone()
                dist.all_reduce(gs[k], group=group)
        return self._global_loss(objective), self._shard_grads(params, local, gs)

    def grad_comm(self, cfg: gpt.GPTConfig, params: dict) -> dict | None:
        """The hand-placed wire's `{op: {count, bytes}}` a step (tpukit
        `FSDP.grad_comm`, `shardings.py:663-705`, at `backend=None`): the
        f32 forward gathers of the sharded leaves, one packed reduce-scatter
        all-to-all a sharded leaf or a bucket; None where nothing is
        hand-placed or at a world of one."""
        if not self._hand_placed(cfg) or self.world <= 1:
            return None
        world, flat, dims = self.world, leaves(params), self._dims(params)
        sharded = [k for k, d in enumerate(dims) if d is not None]
        gather = {"count": len(sharded), "bytes": sum(flat[k].numel() * 4 for k in sharded)}
        if cfg.grad_buckets > 0:
            sizes = [sum(flat[k].numel() for k in idxs)
                     for idxs in self._buckets(params, cfg, dims)]
            exp = quant_comm.expected_bucketed_reduce_scatter(sizes, world, cfg.comm_dtype)
            return {"all-to-all": exp["all-to-all"], "all-gather": gather}
        a2a = {"count": 0, "bytes": 0}
        for k in sharded:
            exp = quant_comm.expected_reduce_scatter(flat[k].numel(), world, cfg.comm_dtype)
            a2a["count"] += exp["all-to-all"]["count"]
            a2a["bytes"] += exp["all-to-all"]["bytes"]
        return {"all-to-all": a2a, "all-gather": gather}

    def full_params(self, params: dict) -> dict:
        device = comm_device(self.mesh)
        return unflatten(params, [gather_full(p).detach().to(device) for p in leaves(params)])


class GridStrategy(Strategy):
    """A strategy over a 2-D `(data, <axis>)` mesh (`self.mesh`, made by
    `setup`) whose rank holds an even piece of some leaves along one
    dimension each (`self._dims`, leaf path -> that dimension or None),
    split over `split_axis` and the same on every data replica: the
    pipeline's stages, tensor parallelism's model ranks. Checkpoints
    gather, place and write those pieces here."""

    distributed = True
    split_axis = ""  # the mesh axis the pieces are split over

    @property
    def split_size(self) -> int:
        raise NotImplementedError

    def _split_dim(self, name: str, t: torch.Tensor) -> int | None:
        """The dimension this rank's leaf `name` (or a state tensor shaped
        like it) is a piece of, decided on the whole shapes in `setup`."""
        if self.split_size == 1 or t.dim() == 0:
            return None
        return self._dims[name]

    def _check(self, params) -> None:
        if self.mesh is None or params is not self.params:
            raise ValueError(f"{self.name}: pass the tree `setup` returned (the train "
                             f"state's params)")

    def gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a local leaf (or of a state tensor shaped
        like it): the split group's pieces, concatenated. A collective."""
        dim = self._split_dim(name, t)
        if dim is None:
            return t
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self.split_size)]
        dist.all_gather(parts, t, group=self.mesh.get_group(self.split_axis))
        return torch.cat(parts, dim=dim)

    def local_leaf(self, name: str, full: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor `full`, as `live` holds it."""
        dim = self._split_dim(name, live)
        if dim is None:
            return full
        return full.chunk(self.split_size, dim=dim)[self.mesh.get_local_rank(self.split_axis)]

    def leaf_block(self, name: str, t: torch.Tensor):
        """The split ranks of data replica 0 write their pieces (each at
        its start on the split dimension), rank 0 the leaves held whole."""
        dim = self._split_dim(name, t)
        if dim is None:
            return super().leaf_block(name, t)
        shape, starts = list(t.shape), [0] * t.dim()
        starts[dim] = self.mesh.get_local_rank(self.split_axis) * shape[dim]
        shape[dim] *= self.split_size
        return tuple(shape), t if self.mesh.get_local_rank("data") == 0 else None, starts

    def full_params(self, params: dict) -> dict:
        """Every leaf whole on every rank (a collective). Gradients too."""
        return unflatten(params, [self.gather_leaf(n, p).detach()
                                  for n, p in zip(paths(params), leaves(params))])

    def all_sum(self, values) -> list[float]:
        """Summed over the data replicas (every rank of a split group holds
        the same values)."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=comm_device(self.mesh))
        if self.data_size > 1:
            dist.all_reduce(t, group=self.mesh.get_group("data"))
        return t.tolist()


TP_MOE_ERROR = ("TensorParallel does not support MoE configs (the Megatron column/row rules "
                "assume dense FFN kernels) — use ExpertParallel (main-moe.py) for "
                "num_experts > 0")


class TensorParallel(GridStrategy):
    """Megatron tensor parallelism (twin of tpukit `shardings.py:998`,
    which states it as GSPMD shardings) over a `(data, model)` grid of the
    default group's ranks (`mesh.create_tp_mesh`, `model` innermost).
    `model` defaults to world / data.

    Each rank holds its shard of every leaf that tpukit's `_spec_for`
    shards over `model` (q/k/v and `ffn/up` by output columns, `attn/out`
    and `ffn/down` kernels by input rows, the head kernel by vocab
    columns, the token table by vocab rows; a dimension the degree does
    not divide stays whole) and runs the model's functions on them under
    `cfg.tp` (`model/gpt.py`). The loss is the vocab-parallel CE with
    every rank differentiating the same replicated loss ("replicated"
    cotangent), and eval's accuracy takes the vocab-parallel argmax. As
    in tpukit: no fused head, three q/k/v products instead of the fused
    one, MoE refused. Rows of the global batch are split over `data`;
    tpukit's objective (the CE summed over the global batch's valid
    tokens over their count) is differentiated on each rank over its
    rows, and the gradients are summed over the `data` group. Dropout
    masks are drawn over the global batch: every rank of a model group
    draws its replica's rows alike. A `mesh` from `mesh.create_tp_mesh`
    may be given in place of the degrees (the serving grid's)."""

    name = "tp"
    comm_ops = ("all-reduce",)  # the Megatron pairs, the vocab-parallel head and CE
    split_axis = "model"
    fused_head = False  # the vocab-sharded head is the vocab-parallel CE
    ce_cotangent = "replicated"  # every model rank differentiates the whole loss

    def __init__(self, data: int = 1, model: int | None = None, mesh=None):
        if mesh is not None:
            data, model = mesh.size(0), mesh.size(1)
        self.data_size = data
        self._model = model
        self.mesh = mesh  # the (data, model) mesh: given, or made by `setup`
        self.params: dict | None = None
        self._dims: dict = {}  # leaf path -> the dimension split over `model`

    @property
    def model_size(self) -> int:
        if self._model is not None:
            return self._model
        if not dist.is_initialized():
            raise RuntimeError("the model degree defaults to world / data: bring up the "
                               "runtime first (mesh.initialize_runtime) or pass model=")
        return mesh_lib.world_size() // self.data_size

    @property
    def split_size(self) -> int:
        return self.model_size

    @property
    def batch_divisor(self) -> int:
        return self.data_size

    @property
    def data_replicas(self) -> int:
        return self.data_size

    def data_rank(self) -> int:
        return mesh_lib.rank() // self.model_size

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        self._validate_comm_dtype(cfg)
        if cfg.num_experts > 0:
            raise ValueError(TP_MOE_ERROR)

    def spec_dim(self, names: tuple, shape: tuple) -> int | None:
        """The dimension of a leaf (at path `names`, of global `shape`)
        split over `model`, or None where it is whole: tpukit's `_spec_for`
        (`shardings.py:1045-1073`), rule for rule."""
        def shard(dim: int) -> int | None:
            return None if shape[dim] % self.model_size else dim

        if "attn" in names and names[-1] == "kernel":
            if any(k in names for k in ("q", "k", "v")):
                return shard(len(shape) - 1)  # column parallel
            if "out" in names:
                return shard(len(shape) - 2)  # row parallel
        if "attn" in names and names[-1] == "bias" and any(k in names for k in ("q", "k", "v")):
            return shard(len(shape) - 1)
        if "ffn" in names:
            if "up" in names:
                return shard(len(shape) - 1)  # column (kernel and bias)
            if "down" in names and names[-1] == "kernel":
                return shard(len(shape) - 2)  # row
        if "lm_head" in names and names[-1] == "kernel":
            return shard(len(shape) - 1)
        if "token" in names:
            return shard(0)  # vocab rows
        return None

    def setup(self, params: dict) -> dict:
        """The (data, model) mesh (unless one was given), and this rank's
        tree: its shard of each split leaf (a leaf of its own), the rest
        as given."""
        device = leaves(params)[0].device
        if self.mesh is None:
            self.mesh = mesh_lib.create_tp_mesh(self.data_size, self.model_size, device.type)
        m, r = self.model_size, self.mesh.get_local_rank("model")
        out = []
        for name, p in zip(paths(params), leaves(params)):
            dim = self.spec_dim(tuple(name.split("/")), tuple(p.shape))
            self._dims[name] = dim
            if dim is None or m == 1:
                out.append(p)
                continue
            out.append(p.detach().chunk(m, dim=dim)[r].clone().requires_grad_(True))
        self.params = unflatten(params, out)
        # a first collective on each group, which NCCL wants from every rank
        for group in (self.mesh.get_group("model"), self.mesh.get_group("data")):
            if dist.get_world_size(group) > 1:
                dist.barrier(group=group)
        return self.params

    def _cfg(self, cfg: gpt.GPTConfig) -> gpt.GPTConfig:
        """The config the loss runs with: the grid's `ModelGroup`, and
        three column-parallel q/k/v products (tpukit `:1041-1043`: the fused
        product would concatenate kernels along their sharded axis)."""
        return cfg.replace(fuse_qkv=False, tp=ModelGroup.of(self.mesh))

    def loss_sums(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                  with_accuracy: bool = False, aux_out: list | None = None, rng=None,
                  rng_row0: int | None = None):
        """This replica's sums over its rows, the same on every rank of its
        model group. Dropout masks are the replica's rows of the global
        batch's, `[data index x B, (data index + 1) x B)`."""
        self._check(params)
        self.validate_config(cfg)
        tcfg = self._cfg(cfg)
        if rng_row0 is None:
            rng_row0 = self.mesh.get_local_rank("data") * batch["input_ids"].shape[0]
        h = gpt.apply_decoder_layers(
            params["layers"], tcfg,
            gpt.apply_embeddings(params, tcfg, batch["input_ids"], batch["position_ids"]),
            batch["mask"], rng=rng, rng_row0=rng_row0)
        logits, offset, tp = gpt.head_logits(params, tcfg, h)
        group = None if tp is None else tp.group
        loss_sum, count = vocab_parallel_ce(logits, targets, offset, group,
                                            cotangent=self.ce_cotangent)
        correct = torch.zeros((), dtype=torch.float32, device=logits.device)
        if with_accuracy:
            preds = vocab_parallel_argmax(logits, offset, cfg.padded_vocab_size, group)
            correct = ((targets != IGNORE_INDEX) & (preds == targets)).sum().float()
        return loss_sum, count, correct

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """(global loss, this rank's gradients): the valid-token count
        summed over the data replicas first, `loss_sum / count` through
        `.backward()` on every rank, then each gradient summed over the
        `data` group (one bucket)."""
        for p in leaves(params):
            p.grad = None
        loss_sum, count, _ = self.loss_sums(params, cfg, batch, targets, rng=rng)
        totals = torch.stack([loss_sum.detach(), count])
        if self.data_size > 1:
            dist.all_reduce(totals, group=self.mesh.get_group("data"))
        denom = torch.clamp(totals[1], min=1.0)
        (loss_sum / denom).backward()
        flat = leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in flat]
        if self.data_size > 1:
            bucket = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(bucket, group=self.mesh.get_group("data"))
            for g, part in zip(grads, bucket.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        for p in flat:
            p.grad = None
        return totals[0] / denom, unflatten(params, grads)


CP_MOE_ERROR = ("ContextParallel does not support MoE configs (the routed "
                "dispatch is token-global, the CP loss is seq-sharded) — "
                "use ExpertParallel (main-moe.py) for num_experts > 0")


class ContextParallel(Strategy):
    """Context parallelism (twin of tpukit `shardings.py:785`) over a
    `(data, seq)` grid of the default group's ranks
    (`mesh.create_cp_mesh`, `seq` innermost; `seq` defaults to world /
    data). Parameters are replicated. Each data replica loads its
    `--batch_size` rows, and each of its `seq` ranks takes columns
    `[r S/P, (r+1) S/P)` of them; the embeddings, LayerNorms, FFNs and the
    head are token-local, and attention runs over the `seq` group
    (`cfg.cp`): `attention="ring"` (the zigzag layout when 2P divides S and
    P > 1, else the contiguous one) or "ulysses" (heads must divide P).
    The loss goes through the fused head + CE kernels on each rank's
    tokens (`TPUKIT_FUSED_HEAD=0`: `cross_entropy_sum`). With
    `host_permute` the caller permutes batches into the zigzag order (`fit`
    through `host_batch_fn`), else the loss does. tpukit's objective (the
    CE summed over the global batch's valid tokens over their count) is
    differentiated on each rank over its tokens, and the gradients are
    summed over the whole grid. Dropout masks are drawn over each rank's
    shard, from `fold_in(rng, data index x seq + seq index)`. A `mesh`
    from `create_cp_mesh` may be given in place of the degrees."""

    name = "cp"
    distributed = True

    def __init__(self, data: int = 1, seq: int | None = None, attention: str = "ring",
                 host_permute: bool = False, mesh=None):
        if attention not in ("ring", "ulysses"):
            raise ValueError(f"attention must be 'ring' or 'ulysses', got {attention!r}")
        if mesh is not None:
            data, seq = mesh.size(0), mesh.size(1)
        self.data_size, self._seq = data, seq
        self.attention, self.host_permute = attention, host_permute
        self.mesh = mesh  # the (data, seq) mesh: given, or made by `setup`
        self.params: dict | None = None
        # tpukit `shardings.py:825-830`: the head re-partitions or the K/V
        # hops, and the gradients' all-reduce
        self.comm_ops = ("collective-permute", "all-reduce")
        if attention == "ulysses":
            self.name = "cp-ulysses"
            self.comm_ops = ("all-to-all", "all-reduce")

    @property
    def seq_size(self) -> int:
        if self._seq is not None:
            return self._seq
        if not dist.is_initialized():
            raise RuntimeError("the seq degree defaults to world / data: bring up the "
                               "runtime first (mesh.initialize_runtime) or pass seq=")
        return mesh_lib.world_size() // self.data_size

    @property
    def batch_divisor(self) -> int:
        return self.data_size

    @property
    def data_replicas(self) -> int:
        return self.data_size

    def data_rank(self) -> int:
        return mesh_lib.rank() // self.seq_size

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        self._validate_comm_dtype(cfg)
        if cfg.num_experts > 0:
            raise ValueError(CP_MOE_ERROR)
        # the model consumes sequence_length - 1 tokens after the LM shift
        seq = cfg.max_position_embeddings - 1
        if seq % self.seq_size:
            raise ValueError(
                f"--sequence_length {cfg.max_position_embeddings}: the model "
                f"sequence {seq} must divide over {self.seq_size} sequence "
                f"shards; pick sequence_length = k*{self.seq_size} + 1")
        if self.attention == "ulysses" and cfg.heads % self.seq_size:
            raise ValueError(
                f"ulysses attention re-partitions heads over the seq axis: "
                f"--heads {cfg.heads} must divide by {self.seq_size} "
                f"sequence shards (or use attention='ring')")

    def _use_zigzag(self, seq_len: int) -> bool:
        """The ring's zigzag layout (tpukit `:862`): when 2P divides the
        sequence and P > 1; Ulysses keeps the contiguous one."""
        return self.attention == "ring" and seq_len % (2 * self.seq_size) == 0 and \
            self.seq_size > 1

    def host_batch_fn(self, cfg: gpt.GPTConfig):
        """The zigzag permutation of numpy batches, with `host_permute` and
        where the zigzag layout applies; else None."""
        seq_len = cfg.max_position_embeddings - 1  # the model's sequence after the shift
        if not (self.host_permute and self._use_zigzag(seq_len)):
            return None
        order = zigzag_order(seq_len, self.seq_size)

        def permute(model_batch, targets):
            return {k: v[:, order] for k, v in model_batch.items()}, targets[:, order]

        return permute

    def setup(self, params: dict) -> dict:
        """The (data, seq) mesh (unless one was given); the tree as given."""
        if self.mesh is None:
            device = leaves(params)[0].device
            self.mesh = mesh_lib.create_cp_mesh(self.data_size, self.seq_size, device.type)
        # a first collective on each group, which NCCL wants from every rank
        for group in (self.mesh.get_group("seq"), self.mesh.get_group("data")):
            if dist.get_world_size(group) > 1:
                dist.barrier(group=group)
        self.params = params
        return params

    def _check(self, params) -> None:
        if self.mesh is None or params is not self.params:
            raise ValueError(f"{self.name}: pass the tree `setup` returned (the train "
                             f"state's params)")

    def loss_sums(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                  with_accuracy: bool = False, aux_out: list | None = None, rng=None,
                  rng_row0: int | None = None):
        """This replica's sums, the same on every rank of its `seq` group:
        this rank's columns of the replica's rows through the model, summed
        over the group (the loss sum with an identity backward, so that
        each rank differentiates its own tokens' terms)."""
        if cfg.num_experts > 0:
            raise ValueError(CP_MOE_ERROR)
        seq_len, ring = batch["input_ids"].shape[1], self.seq_size
        if seq_len % ring:
            raise ValueError(f"sequence length {seq_len} must divide over {ring} sequence "
                             f"shards (pick a dividing --sequence_length)")
        self._check(params)
        zigzag = self._use_zigzag(seq_len)
        if zigzag and not self.host_permute:
            order = torch.from_numpy(zigzag_order(seq_len, ring)).to(targets.device)
            batch = {k: v[:, order] for k, v in batch.items()}
            targets = targets[:, order]
        sg = SeqGroup.of(self.mesh)
        cols = slice(sg.rank * (seq_len // ring), (sg.rank + 1) * (seq_len // ring))
        ids, pos, mask, tgts = (t[:, cols].contiguous() for t in (
            batch["input_ids"], batch["position_ids"], batch["mask"], targets))
        lcfg = cfg.replace(attention_impl=self.attention, cp=sg,
                           ring_layout="zigzag" if zigzag else "contiguous")
        if rng is not None:  # a mask of its own for each shard of the grid
            rng = tk_random.fold_in(rng, self.mesh.get_local_rank("data") * ring + sg.rank)
        x = gpt.apply_decoder_layers(params["layers"], lcfg,
                                     gpt.apply_embeddings(params, lcfg, ids, pos), mask,
                                     rng=rng)
        if self.fused_head and not fused_head_disabled():
            h = layer_norm(x, params["norm_out"]).to(cfg.compute_dtype)
            loss_sum, count, correct = fused_head_ce(
                h.reshape(-1, h.shape[-1]), params["lm_head"]["kernel"], tgts.reshape(-1),
                cfg.vocab_size, with_accuracy=with_accuracy)
        else:
            logits = gpt.apply_head(params, lcfg, x)
            loss_sum, count = cross_entropy_sum(logits, tgts)
            correct = (masked_correct(logits, tgts) if with_accuracy
                       else torch.zeros((), dtype=torch.float32, device=logits.device))
        if ring == 1:
            return loss_sum, count, correct
        sums = torch.stack([count, correct])
        dist.all_reduce(sums, group=sg.group)
        loss_sum = reduce_from_model(loss_sum, ModelGroup(group=sg.group, size=ring))
        return loss_sum, sums[0], sums[1]

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """(global loss, gradients): the replica's sums summed over the data
        replicas, `loss_sum / count` through `.backward()` on every rank,
        then the gradients summed over the whole grid (one bucket): the
        transpose of tpukit's replicated in-spec."""
        for p in leaves(params):
            p.grad = None
        loss_sum, count, _ = self.loss_sums(params, cfg, batch, targets, rng=rng)
        totals = torch.stack([loss_sum.detach(), count])
        if self.data_size > 1:
            dist.all_reduce(totals, group=self.mesh.get_group("data"))
        denom = torch.clamp(totals[1], min=1.0)
        (loss_sum / denom).backward()
        flat = leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in flat]
        if self.data_size * self.seq_size > 1:
            bucket = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(bucket)
            for g, part in zip(grads, bucket.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        for p in flat:
            p.grad = None
        return totals[0] / denom, unflatten(params, grads)

    def all_sum(self, values) -> list[float]:
        """Summed over the data replicas (every rank of a `seq` group holds
        the same values)."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=comm_device(self.mesh))
        if self.data_size > 1:
            dist.all_reduce(t, group=self.mesh.get_group("data"))
        return t.tolist()
