"""Pipeline parallelism over c10d stage ranks (twin of `tpukit/pipeline.py`):
GPipe (`Pipeline`), 1F1B, flat and interleaved (`Pipeline1F1B`), and the
`(data, stage)` grid of pipeline x DDP.

tpukit runs its schedules as one SPMD program (`shard_map` over a `stage`
mesh axis, `ppermute` between stages). The port runs one process a stage,
as tpukit's recipes run one device a stage: the default c10d group is a
`(data, stage)` grid (`mesh.create_pipeline_mesh`, stages innermost), and
every rank of a stage group walks the SAME list of ticks. A tick runs, in
this order:

  1. the ingest collective (micro `t` of GPipe, the table's `ingest`):
     every stage looks up its vocab slice of the token table and one
     all-reduce (`psum_bcast`) assembles stage 0's embedding;
  2. the rank's own forward job, if it has one: its layer block (or
     chunk) on a micro-batch, with `active` gating identity-padded slots;
  3. the head collective (micro `t - (S - 1)`, the table's `head`): the
     last stage's output is broadcast (`psum_bcast`), each stage computes
     its vocab slice of the logits and the collective cross-entropy
     (`vocab_parallel_ce`);
  4. the rank's own backward job (1F1B);
  5. the table-transpose collective (1F1B: the table's `emb`): stage 0's
     input cotangent is the embedding's, and the backward of step 1's
     all-reduce hands every stage its vocab slice of it;
  6. the tick's point-to-point sends and receives, posted together with
     `dist.batch_isend_irecv`: activations to the next stage, cotangents
     to the previous one.

Since every collective sits at a tick-level point whose micro-batch is a
function of the tick alone, the stages enter them in the same order and
no stage blocks in an all-reduce while its neighbour waits on a receive.
When the padded vocab does not divide the stage count, the token table and
the head are replicated (tpukit's fallback, `_vocab_spec`): the ingest
runs on stage 0 alone and the head on the last stage, with no collective.

Unlike tpukit's SPMD machine, a rank computes no masked dummy work: it runs
only its own jobs. GPipe keeps the autograd graph of every micro-batch of
the step and runs the backward as the forward's mirror, tick by tick in
reverse. `Pipeline1F1B` walks the schedule authority's tables
(`pipeline_schedule.cached_schedule`: at one virtual stage the flat 1F1B
order, at V > 1 the interleaved one) and, in PyTorch's idiom, keeps the
autograd graph of each micro-chunk in flight instead of tpukit's remat
vjp (a replay of the trunk from its saved input): the gradients are the
same, and the graphs alive at once are bounded by the table's depth,
which grows with the stage count, not with the micro-batch count. Each
piece (the ingest, a stage's block, the head) is a graph of its own
between detached tensors, and its backward runs through autograd when its
cotangent is there. Masks and targets are not sent along with the
activations, as tpukit's GPipe threads them: every rank of a data replica
holds the replica's rows, and reads the micro-batch's own.

The objective is tpukit's: the CE summed over the valid tokens of the
global batch over their count, known before the first tick (the count is
all-reduced over the data replicas), plus, for MoE configs, moe_aux_weight
x the mean over micro-batches and data replicas of each micro's summed
load-balance aux (gated to real jobs). The collective CE's backward sums
its cotangent over the stages (tpukit's treatment, the CE's "shared"
contract): stage 0 hands it the loss's cotangent and the other stages 0.
Gradients of the layer blocks and vocab slices are summed over the data
replicas; those of replicated leaves (the position table, the final norm, and the fallback's table and
head) over every rank.

Dropout keys fold in tpukit's indices, so the masks are bit-equal to its
own: GPipe `stage * (M + S) + tick`, 1F1B `global chunk * M + micro`, each
then `x data + data index`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpukit_torch import mesh as mesh_lib
from tpukit_torch import random as tk_random
from tpukit_torch.model import gpt
from tpukit_torch.ops.layers import (
    IGNORE_INDEX,
    cross_entropy_sum,
    layer_norm,
    linear,
    masked_correct,
    psum_bcast,
    vocab_parallel_argmax,
    vocab_parallel_ce,
)
from tpukit_torch.pipeline_schedule import cached_schedule
from tpukit_torch.shardings import GridStrategy, leaves, paths, unflatten

NEG_INF = -1e9


def _vocab_slice_ce(norm_p, lm_kernel, y, targets, offset, v_local, cfg, group):
    """The vocab-parallel head (tpukit `pipeline.py:80`): layer_norm, this
    stage's `v_local` logit columns, the pad columns masked to -1e9 on
    their own slice, the collective CE. Returns ((loss_sum, count),
    local_logits)."""
    h = layer_norm(y, norm_p).to(cfg.compute_dtype)
    local_logits = linear(h, {"kernel": lm_kernel}, cfg.compute_dtype)
    col = offset + torch.arange(v_local, device=y.device)
    local_logits = torch.where(col < cfg.vocab_size, local_logits,
                               torch.tensor(NEG_INF, dtype=local_logits.dtype, device=y.device))
    return (vocab_parallel_ce(local_logits, targets, offset, group, cotangent="shared"),
            local_logits)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _backward(outputs: list, cotangents: list) -> None:
    """`torch.autograd.backward` over the outputs that carry a graph."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o is not None and o.requires_grad]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])


class _Run:
    """One rank's view of one call of a schedule: the micro-batches, its
    stage's layer chunks and vocab slice, the groups and the key rule."""

    def __init__(self, strategy: "Pipeline", params, cfg, batch, targets, virtual: int, rng,
                 key_rule: str):
        S, M, D = strategy.num_stages, strategy.num_microbatches, strategy.data_size
        self.cfg, self.params = cfg, params
        self.S, self.M, self.D, self.G = S, M, D, S * virtual
        mesh = strategy.mesh
        self.stage = mesh.get_local_rank("stage")
        self.data_index = mesh.get_local_rank("data")
        self.sg = mesh.get_group("stage") if S > 1 else None
        self.dg = mesh.get_group("data") if D > 1 else None
        self.world = dist.group.WORLD if S * D > 1 else None
        self.prev, self.next = mesh_lib.stage_neighbours(mesh)
        v_pad = cfg.padded_vocab_size
        self.shard_vocab = strategy._vocab_spec(("embeddings", "token"), (v_pad, cfg.dim)) is not None
        self.v_pad = v_pad
        self.v_local = v_pad // S if self.shard_vocab else v_pad
        self.offset = self.stage * self.v_local if self.shard_vocab else 0
        rows = batch["input_ids"].shape[0]
        self.mb = rows // M
        split = lambda x: x.reshape(M, self.mb, *x.shape[1:])
        self.inputs, self.positions = split(batch["input_ids"]), split(batch["position_ids"])
        self.masks, self.tgts = split(batch["mask"]), split(targets)
        self.seq = batch["input_ids"].shape[1]
        self.device = targets.device
        padded = strategy.padded_layers(cfg.num_layers, virtual)
        pc = padded // (S * virtual)
        self.chunks = [_tree_map(lambda t, c=c: t[c * pc:(c + 1) * pc], params["layers"])
                       for c in range(virtual)]
        self.active = [None if padded == cfg.num_layers else
                       [((c * S + self.stage) * pc + j) < cfg.num_layers for j in range(pc)]
                       for c in range(virtual)]
        self.rng, self.key_rule = rng, key_rule
        self.moe = cfg.num_experts > 0
        # the stage whose CE totals count (the collective CE gives every
        # stage the same ones; the fallback computes them on the last)
        self.owner = 0 if self.shard_vocab else S - 1

    # -- pieces --------------------------------------------------------

    def key(self, tick: int, c: int, m: int):
        """The dropout key of a job: GPipe's `stage * (M + S) + tick`, or
        1F1B's `(c * S + stage) * M + m`, then `x D + data index`."""
        if self.rng is None:
            return None
        if self.key_rule == "gpipe":
            lin = self.stage * (self.M + self.S) + tick
        else:
            lin = (c * self.S + self.stage) * self.M + m
        return tk_random.fold_in(self.rng, lin * self.D + self.data_index)

    def ingest(self, m: int):
        """Micro `m`'s embedding: (the graph node each stage keeps for the
        table transpose, stage 0's embedding in the compute dtype or None)."""
        params, cfg = self.params, self.cfg
        ids = self.inputs[m].long()
        if not self.shard_vocab:
            if self.stage != 0:
                return None, None
            emb = gpt.apply_embeddings(params, cfg, ids, self.positions[m])
            return emb, emb
        rel = ids - self.offset
        ok = (rel >= 0) & (rel < self.v_local)
        tok = params["embeddings"]["token"]
        part = torch.where(ok[..., None], tok[torch.where(ok, rel, 0)], 0.0)
        summed = psum_bcast(part, self.sg)
        if self.stage != 0:
            return summed, None
        emb = (summed + params["embeddings"]["position"][self.positions[m].long()]).to(
            cfg.compute_dtype)
        return emb, emb

    def chunk(self, c: int, x, m: int, key):
        """Local chunk `c` on micro `m`: (y, summed aux or None)."""
        al = [] if self.moe else None
        y = gpt.apply_decoder_layers(self.chunks[c], self.cfg, x, self.masks[m], aux_out=al,
                                     rng=key, active=self.active[c])
        return y, (al[0] if self.moe else None)

    def head(self, m: int, y, with_accuracy: bool = False):
        """The head collective for micro `m` (the last stage's `y`): (the
        leaf the head differentiates into, (loss_sum, count, correct))."""
        cfg, params, S = self.cfg, self.params, self.S
        last = self.stage == S - 1
        tgt = self.tgts[m]
        if not self.shard_vocab:
            if not last:
                return None, None
            leaf = y.detach().requires_grad_(torch.is_grad_enabled())
            logits = gpt.apply_head(params, cfg, leaf)
            loss_sum, count = cross_entropy_sum(logits, tgt)
            correct = masked_correct(logits, tgt) if with_accuracy else None
            return leaf, (loss_sum, count, correct)
        src = y.detach() if last else torch.zeros((self.mb, self.seq, cfg.dim),
                                                  dtype=cfg.compute_dtype, device=self.device)
        leaf = src.requires_grad_(torch.is_grad_enabled())
        y_b = psum_bcast(leaf, self.sg)
        (loss_sum, count), local = _vocab_slice_ce(params["norm_out"],
                                                   params["lm_head"]["kernel"], y_b, tgt,
                                                   self.offset, self.v_local, cfg, self.sg)
        correct = None
        if with_accuracy:
            # the global argmax, first index of a tie (tpukit :573-587)
            preds = vocab_parallel_argmax(local, self.offset, self.v_pad, self.sg)
            correct = ((tgt != IGNORE_INDEX) & (preds == tgt)).sum().float()
        return leaf, (loss_sum, count, correct)

    def loss_cotangent(self, denom):
        """The cotangent a stage hands its head's loss_sum: the collective CE
        sums it over the stages, so stage 0 gives 1 / denom and the rest 0;
        the fallback's head (the last stage) gives 1 / denom."""
        give = (not self.shard_vocab) or self.stage == 0
        return (1.0 / denom) if give else torch.zeros_like(denom)

    def exchange(self, sends: list, recvs: list) -> list:
        """Post the tick's sends (tensor, peer) and receives (peer) together
        with `batch_isend_irecv`; returns the received tensors. With one
        stage the peer is this rank, and a send is handed over in place."""
        shape = (self.mb, self.seq, self.cfg.dim)
        if self.S == 1:
            return [t.detach() for t, _ in sends]
        bufs = [torch.empty(shape, dtype=self.cfg.compute_dtype, device=self.device)
                for _ in recvs]
        ops = [dist.P2POp(dist.isend, t.detach().contiguous(), peer, group=self.sg)
               for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, b, peer, group=self.sg) for b, peer in zip(bufs, recvs)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return bufs


class Pipeline(GridStrategy):
    """GPipe over stage ranks (twin of tpukit `pipeline.py:106`). The
    default group is a `(data, stage)` grid: `data` replicas (1 by
    default) of a pipeline of `stages` ranks (world / data by default).
    `num_microbatches`: an int, None (= the stage count, the reference's
    `chunks=num_stages`) or "<k>x" (k x the stage count; the recipes use
    "4x"). `moe_dispatch` is injected into MoE configs at loss time; only
    the meshless dropless "pallas" dispatch runs inside the stages."""

    name = "pipe"
    comm_ops = ("collective-permute", "all-reduce")  # the stage hops, ingest, head and grads
    split_axis = "stage"
    fused_head = False  # the head is the vocab-parallel CE (tpukit's jnp head)
    supports_interleave = False

    def __init__(self, num_microbatches: int | str | None = None,
                 moe_dispatch: str | None = None, data: int = 1, stages: int | None = None):
        if isinstance(num_microbatches, str):
            if not num_microbatches.endswith("x") or not num_microbatches[:-1].isdigit():
                raise ValueError(
                    f"num_microbatches: int, None, or '<k>x', got {num_microbatches!r}")
            if int(num_microbatches[:-1]) < 1:
                raise ValueError(f"num_microbatches must be positive, got {num_microbatches!r}")
        elif num_microbatches is not None and num_microbatches < 0:
            raise ValueError(f"num_microbatches must be positive, got {num_microbatches!r}")
        self._micro = num_microbatches
        self.data_size = data
        self._stages = stages
        self.moe_dispatch = moe_dispatch
        self.mesh = None  # the (data, stage) mesh, once `setup` ran
        self.params: dict | None = None
        self._dims: dict = {}  # leaf path -> the dimension split over the stages

    # -- sizes ----------------------------------------------------------

    @property
    def num_stages(self) -> int:
        if self._stages is not None:
            return self._stages
        if not dist.is_initialized():
            raise RuntimeError("the stage count defaults to world / data: bring up the "
                               "runtime first (mesh.initialize_runtime) or pass stages=")
        return mesh_lib.world_size() // self.data_size

    @property
    def split_size(self) -> int:
        return self.num_stages

    @property
    def num_microbatches(self) -> int:
        if isinstance(self._micro, str):
            return int(self._micro[:-1]) * self.num_stages
        return self._micro or self.num_stages

    @property
    def batch_divisor(self) -> int:
        return self.num_microbatches * self.data_size

    @property
    def data_replicas(self) -> int:
        return self.data_size

    def data_rank(self) -> int:
        return mesh_lib.rank() // self.num_stages

    def padded_layers(self, num_layers: int, virtual_stages: int = 1) -> int:
        """`ceil(L / (S V)) * S V`: every one of the S V chunks holds the
        same number of layers."""
        blocks = self.num_stages * virtual_stages
        return -(-num_layers // blocks) * blocks

    # -- validation (tpukit's checks and messages) ------------------------

    def _check_moe(self, cfg: gpt.GPTConfig) -> None:
        if cfg.num_experts == 0:
            return
        dispatch = self.moe_dispatch or cfg.moe_dispatch
        if dispatch != "pallas":
            raise ValueError(
                f"the pipeline schedules support MoE only through the meshless dropless "
                f"dispatch — pass --moe_dispatch pallas (got moe_dispatch={dispatch!r}: "
                f"'xla'/'a2a' need an 'expert' mesh axis the pipeline mesh does not carry) — "
                f"or use ExpertParallel (recipe 8)")

    def _moe_cfg(self, cfg: gpt.GPTConfig) -> gpt.GPTConfig:
        """The strategy's dispatch injected at loss time; meshless."""
        if cfg.num_experts == 0:
            return cfg
        return cfg.replace(moe_dispatch=self.moe_dispatch or cfg.moe_dispatch, moe_mesh=None)

    def _check_interleave(self, cfg: gpt.GPTConfig) -> None:
        v = cfg.virtual_stages
        if v == 1:
            return
        if not self.supports_interleave:
            raise ValueError(
                f"virtual_stages={v} needs the 1f1b schedule (--pipeline_schedule 1f1b / "
                f"Pipeline1F1B) — the GPipe schedule runs one contiguous layer block per "
                f"stage and cannot interleave chunks")
        if v * self.num_stages > cfg.num_layers:
            raise ValueError(
                f"virtual_stages={v} x {self.num_stages} stages = {v * self.num_stages} "
                f"chunks exceeds num_layers={cfg.num_layers} — every chunk needs at least "
                f"one real layer, so the maximum virtual_stages here is "
                f"{cfg.num_layers // self.num_stages}")

    def validate_config(self, cfg: gpt.GPTConfig) -> None:
        """tpukit's checks. The interleave check needs the stage count: when
        it comes from a world that is not up yet, `prepare_params` and the
        schedules make it."""
        self._validate_comm_dtype(cfg)
        if cfg.num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {cfg.num_layers}")
        self._check_moe(cfg)
        if self._stages is not None or dist.is_initialized():
            self._check_interleave(cfg)

    # -- layout -----------------------------------------------------------

    def _vocab_spec(self, names: tuple, shape: tuple) -> int | None:
        """The dimension of a leaf its stage slices over the vocab: the
        token table's rows, the head kernel's columns, when the padded
        vocab divides the stage count; None for a replicated leaf."""
        if "token" in names and len(shape) == 2 and shape[0] % self.num_stages == 0:
            return 0
        if "lm_head" in names and names[-1] == "kernel" and shape[-1] % self.num_stages == 0:
            return len(shape) - 1
        return None

    def prepare_params(self, params: dict, cfg: gpt.GPTConfig) -> dict:
        """tpukit's layout (`pipeline.py:247`): the stacked layers padded to
        `padded_layers` with all-zero identity layers, and at V > 1
        permuted so stage d's V chunks d, d + S, ... are one contiguous
        block. The identity at V = 1 on an even split."""
        self._check_interleave(cfg)
        v = cfg.virtual_stages
        padded = self.padded_layers(cfg.num_layers, v)
        pad = padded - cfg.num_layers
        if pad == 0 and v == 1:
            return params
        layers = params["layers"]
        if pad:
            layers = _tree_map(lambda t: torch.cat(
                [t.detach(), torch.zeros((pad, *t.shape[1:]), dtype=t.dtype, device=t.device)]),
                layers)
        if v > 1:
            perm = torch.tensor(self._chunk_perm(padded, v), device=leaves(layers)[0].device)
            layers = _tree_map(lambda t: t.detach()[perm], layers)
        return {**params, "layers": layers}

    def _chunk_perm(self, padded: int, virtual_stages: int) -> list:
        """Stacked row (d V + c) p + j <- natural layer (c S + d) p + j."""
        per_chunk = padded // (self.num_stages * virtual_stages)
        perm = []
        for d in range(self.num_stages):
            for c in range(virtual_stages):
                g = c * self.num_stages + d
                perm.extend(range(g * per_chunk, (g + 1) * per_chunk))
        return perm

    def inference_params(self, params: dict, cfg: gpt.GPTConfig) -> dict:
        """The chunk permutation undone (natural layer order) for the plain
        sequential forward; the identity-padded layers stay."""
        v = cfg.virtual_stages
        if v == 1:
            return params
        stack = leaves(params["layers"])[0].shape[0]
        inv = [0] * stack
        for i, k in enumerate(self._chunk_perm(stack, v)):
            inv[k] = i
        inv = torch.tensor(inv, device=leaves(params["layers"])[0].device)
        return {**params, "layers": _tree_map(lambda t: t[inv], params["layers"])}

    def setup(self, params: dict) -> dict:
        """The (data, stage) mesh, and this rank's tree: its block of the
        (prepared) layer stack and its vocab slices, leaves of their own."""
        device = leaves(params)[0].device
        self.mesh = mesh_lib.create_pipeline_mesh(self.data_size, self.num_stages, device.type)
        S, stage = self.num_stages, self.mesh.get_local_rank("stage")
        stack = leaves(params["layers"])[0].shape[0]
        if stack % S:
            raise ValueError(
                f"stacked layer axis {stack} must be a multiple of {S} stages — initialize "
                f"through create_train_state(..., strategy=pipeline, cfg=...) (or "
                f"pipeline.prepare_params) so uneven layer counts are identity-padded")
        out = []
        for name, p in zip(paths(params), leaves(params)):
            names = tuple(name.split("/"))
            dim = 0 if names[0] == "layers" else self._vocab_spec(names, tuple(p.shape))
            self._dims[name] = dim
            if dim is None or S == 1:
                out.append(p)
                continue
            part = p.detach().chunk(S, dim=dim)[stage].clone()
            out.append(part.requires_grad_(True))
        self.params = unflatten(params, out)
        # a first collective on each group, which NCCL wants from every rank
        for group in (self.mesh.get_group("stage"), self.mesh.get_group("data")):
            if dist.get_world_size(group) > 1:
                dist.barrier(group=group)
        return self.params

    # -- the schedules -----------------------------------------------------

    def _prelude(self, params, cfg: gpt.GPTConfig, batch: dict, virtual: int) -> None:
        """tpukit's checks of the stack and the batch, before any collective."""
        S, M = self.num_stages, self.num_microbatches
        padded = self.padded_layers(cfg.num_layers, virtual)
        stack = leaves(params["layers"])[0].shape[0] * S
        if stack != padded:
            raise ValueError(
                f"stacked layer axis is {stack} over {S} stages but num_layers="
                f"{cfg.num_layers} with virtual_stages={virtual} needs {padded} "
                f"(identity-padded) — initialize through create_train_state(..., "
                f"strategy=pipeline, cfg=...) or pass params through "
                f"pipeline.prepare_params")
        rows = batch["input_ids"].shape[0]
        if rows % M:
            raise ValueError(f"batch {rows * self.data_size} must divide into {M} "
                             f"microbatches x {self.data_size} data shards")
        self._check(params)

    def _forward(self, run: _Run, ticks, keep: bool, with_accuracy: bool = False):
        """Walk a forward-only tick table: per tick the ingest, this stage's
        job, the head, the sends. Returns the totals on the owner stage
        (loss_sum, count, correct, aux) and, with `keep`, each tick's
        (ingest node, job (x, y, aux), head (leaf, loss_sum))."""
        S, G, stage = run.S, run.G, run.stage
        zero = torch.zeros((), dtype=torch.float32, device=run.device)
        totals = [zero, zero, zero, zero]
        xs: dict = {}  # (global chunk, micro) -> its input
        records = []
        for t, tk in enumerate(ticks):
            rec = {}
            if tk.ingest >= 0:
                node, emb = run.ingest(tk.ingest)
                if emb is not None:
                    x = emb.detach().requires_grad_(keep)
                    xs[(0, tk.ingest)] = x
                    rec["ingest"] = (node, x)
                elif node is not None:
                    rec["ingest"] = (node, None)
            job, y = tk.fwd[stage], None
            if job is not None:
                c, m, _ = job
                x = xs.pop((c * S + stage, m))
                y, aux = run.chunk(c, x, m, run.key(t, c, m))
                rec["job"] = (x, y, aux)
                if aux is not None:
                    totals[3] = totals[3] + aux.detach()
            if tk.head >= 0:
                leaf, out = run.head(tk.head, y, with_accuracy)
                if out is not None:
                    rec["head"] = (leaf, out[0])
                    if stage == run.owner:
                        totals[0] = totals[0] + out[0].detach()
                        totals[1] = totals[1] + out[1]
                        if with_accuracy:
                            totals[2] = totals[2] + out[2]
            sends, recvs, into = [], [], []
            if job is not None and c * S + stage < G - 1:
                sends.append((y, run.next))
            src = tk.fwd[(stage - 1) % S]
            if src is not None and src[0] * S + (stage - 1) % S < G - 1:
                recvs.append(run.prev)
                into.append((src[0] * S + (stage - 1) % S + 1, src[1]))
            for key, got in zip(into, run.exchange(sends, recvs)):
                xs[key] = got.requires_grad_(keep)
            if keep:
                records.append(rec)
        return totals, records

    def pipe_comm(self, cfg: gpt.GPTConfig, *, global_batch: int, seq: int,
                  phase: str = "train", stage: int | None = None) -> dict:
        """The stage hops of one step on this rank (or on `stage`), `{op:
        {count, bytes}}` (twin of `tpukit/pipeline.py:1910`): one
        `collective-permute` a received activation or cotangent, of
        `[global_batch / (M data), seq, dim]` in the compute dtype, walked
        off the same tick tables the step walks (GPipe's forward and its
        mirror; 1F1B's table, interleaved at V > 1; `phase="eval"` the
        forward-only table). tpukit counts one `ppermute` instance a
        shipping tick for every stage at once; a tick that ships on
        tpukit's machine is a tick where some stage here receives. MoE
        configs on a stage-only grid pin `all-to-all` to zero: the meshless
        dispatch in the stages exchanges nothing."""
        S, M, D, V = self.num_stages, self.num_microbatches, self.data_size, \
            cfg.virtual_stages
        if stage is None:
            stage = self.mesh.get_local_rank("stage") if self.mesh is not None else 0
        train = phase == "train"
        recvs = 0
        if S > 1:
            G = S * V
            prev, nxt = (stage - 1) % S, (stage + 1) % S
            one_f_one_b = train and isinstance(self, Pipeline1F1B)
            ticks = cached_schedule(S, V if (one_f_one_b or not train) else 1, M,
                                    one_f_one_b).ticks
            for tk in ticks:
                src = tk.fwd[prev]
                recvs += src is not None and src[0] * S + prev < G - 1
                if one_f_one_b:
                    src = tk.bwd[nxt]
                    recvs += src is not None and src[0] * S + nxt > 0
                elif train:  # GPipe's backward mirror of this tick
                    recvs += tk.fwd[nxt] is not None and stage < S - 1
        mb = global_batch // (M * D)
        payload = mb * seq * cfg.dim * torch.empty((), dtype=cfg.compute_dtype).element_size()
        ops = {"collective-permute": {"count": recvs, "bytes": recvs * payload}}
        if cfg.num_experts > 0 and D == 1:
            ops["all-to-all"] = {"count": 0, "bytes": 0}
        return ops

    def _reduce_grads(self, run: _Run, params: dict) -> dict:
        """Each leaf's gradient summed as its placement needs: replicated
        leaves over every rank, split ones over the data replicas."""
        names, flat = paths(params), leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in flat]
        split = [self._split_dim(n, p) is not None for n, p in zip(names, flat)]
        for group, pick in ((run.world, [not s for s in split]), (run.dg, split)):
            chosen = [g for g, keep in zip(grads, pick) if keep]
            if group is None or not chosen:
                continue
            bucket = torch.cat([g.reshape(-1) for g in chosen])
            dist.all_reduce(bucket, group=group)
            for g, part in zip(chosen, bucket.split([g.numel() for g in chosen])):
                g.copy_(part.view_as(g))
        for p in flat:
            p.grad = None
        return unflatten(params, grads)

    def _denominator(self, run: _Run, targets):
        """The global batch's valid-token count, clamped to 1 (tpukit's
        denominator), before the first tick."""
        count = (targets != IGNORE_INDEX).sum().float()
        if run.dg is not None:
            dist.all_reduce(count, group=run.dg)
        return torch.clamp(count, min=1.0)

    def _finish(self, run: _Run, loss_sum, denom):
        """The global loss from the owner stages' CE sums."""
        loss_sum = loss_sum.clone()
        if run.world is not None:
            dist.all_reduce(loss_sum, group=run.world)
        return loss_sum / denom

    def loss_fn(self, params, cfg: gpt.GPTConfig, batch: dict, targets,
                with_accuracy: bool = False, aux_out: list | None = None, rng=None):
        """(mean masked CE, masked accuracy x 100 or 0) of this data
        replica's rows, through the forward-only schedule (eval; no graph).
        MoE configs append this replica's mean over micro-batches of the
        summed aux to `aux_out`."""
        self._check_moe(cfg)
        self._check_interleave(cfg)
        cfg = self._moe_cfg(cfg)
        v = cfg.virtual_stages
        self._prelude(params, cfg, batch, v)
        run = _Run(self, params, cfg, batch, targets, v, rng, "gpipe" if v == 1 else "1f1b")
        with torch.no_grad():
            totals, _ = self._forward(run, cached_schedule(run.S, v, run.M, False).ticks,
                                      keep=False, with_accuracy=with_accuracy)
            t = torch.stack(totals)
            if run.sg is not None:
                dist.all_reduce(t, group=run.sg)
        if aux_out is not None and run.moe:
            aux_out.append(t[3] / run.M)
        denom = torch.clamp(t[1], min=1.0)
        return t[0] / denom, t[2] / denom * 100.0

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        """(global loss, this rank's gradients) of GPipe: the forward ticks
        keep every micro-batch's graphs, then the backward mirrors them
        tick by tick in reverse (head, block, table transpose, then the
        cotangents to the previous stage)."""
        self._check_moe(cfg)
        self._check_interleave(cfg)
        cfg = self._moe_cfg(cfg)
        self._prelude(params, cfg, batch, 1)
        for p in leaves(params):
            p.grad = None
        run = _Run(self, params, cfg, batch, targets, 1, rng, "gpipe")
        denom = self._denominator(run, targets)
        ticks = cached_schedule(run.S, 1, run.M, False).ticks
        totals, records = self._forward(run, ticks, keep=True)
        S, stage = run.S, run.stage
        alpha = torch.tensor(cfg.moe_aux_weight / (run.M * run.D), device=run.device)
        dys: dict = {}
        for t in reversed(range(len(ticks))):
            tk, rec = ticks[t], records[t]
            job = tk.fwd[stage]
            if "head" in rec:
                leaf, loss_sum = rec.pop("head")
                _backward([loss_sum], [run.loss_cotangent(denom)])
                if stage == S - 1:
                    dys[(S - 1, tk.head)] = leaf.grad
            dx = None
            if job is not None:
                x, y, aux = rec.pop("job")
                _backward([y, aux], [dys.pop((stage, job[1])), alpha])
                dx = x.grad
            if "ingest" in rec:
                node, x0 = rec.pop("ingest")
                _backward([node], [dx if x0 is not None else torch.zeros_like(node)])
            sends, recvs, into = [], [], []
            if job is not None and stage > 0:
                sends.append((dx, run.prev))
            src = tk.fwd[(stage + 1) % S]
            if src is not None and stage < S - 1:
                recvs.append(run.next)
                into.append((stage, src[1]))
            for key, got in zip(into, run.exchange(sends, recvs)):
                dys[key] = got
        loss = self._finish(run, totals[0], denom)
        return loss, self._reduce_grads(run, params)


class Pipeline1F1B(Pipeline):
    """1F1B over stage ranks (twin of tpukit `pipeline.py:671`): every rank
    walks the schedule authority's tick table (`cached_schedule(S, V, M)`:
    the flat order at V = 1, interleaved virtual stages at
    `cfg.virtual_stages` V > 1, where stage d owns chunks d, d + S, ...).
    Each tick runs the ingest collective, this stage's forward job, the
    head collective with its backward at once (the last stage's
    self-trigger), this stage's backward job, the table transpose and the
    tick's sends and receives. Eval at V > 1 walks the forward-only
    table; at V = 1 it is GPipe's forward."""

    name = "pipe-1f1b"
    supports_interleave = True

    def value_and_grad(self, params, cfg: gpt.GPTConfig, batch: dict, targets, rng=None):
        self._check_moe(cfg)
        self._check_interleave(cfg)
        cfg = self._moe_cfg(cfg)
        v = cfg.virtual_stages
        self._prelude(params, cfg, batch, v)
        for p in leaves(params):
            p.grad = None
        run = _Run(self, params, cfg, batch, targets, v, rng, "1f1b")
        denom = self._denominator(run, targets)
        S, G, stage = run.S, run.G, run.stage
        alpha = torch.tensor(cfg.moe_aux_weight / (run.M * run.D), device=run.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=run.device)
        xs: dict = {}  # (global chunk, micro) -> its input, a leaf
        dys: dict = {}  # (global chunk, micro) -> the cotangent of its output
        inflight: dict = {}  # (global chunk, micro) -> (x, y, aux): graphs alive
        ingests: dict = {}  # micro -> the ingest node kept for the transpose
        for tk in cached_schedule(S, v, run.M).ticks:
            # 1. the ingest collective
            if tk.ingest >= 0:
                node, emb = run.ingest(tk.ingest)
                if node is not None:
                    ingests[tk.ingest] = node
                if emb is not None:
                    xs[(0, tk.ingest)] = emb.detach().requires_grad_(True)
            # 2. this stage's forward job
            fjob, y = tk.fwd[stage], None
            if fjob is not None:
                c, m, _ = fjob
                g = c * S + stage
                x = xs.pop((g, m))
                y, aux = run.chunk(c, x, m, run.key(0, c, m))
                inflight[(g, m)] = (x, y, aux)
            # 3. the head collective and its backward (the self-trigger)
            if tk.head >= 0:
                leaf, out = run.head(tk.head, y)
                if out is not None:
                    _backward([out[0]], [run.loss_cotangent(denom)])
                    if stage == run.owner:
                        loss_sum = loss_sum + out[0].detach()
                    if stage == S - 1:
                        dys[(G - 1, tk.head)] = leaf.grad
            # 4. this stage's backward job
            bjob, dx = tk.bwd[stage], None
            if bjob is not None:
                c, m, _ = bjob
                g = c * S + stage
                x, y_b, aux = inflight.pop((g, m))
                _backward([y_b, aux], [dys.pop((g, m)), alpha])
                dx = x.grad
            # 5. the table transpose
            if tk.emb >= 0 and tk.emb in ingests:
                node = ingests.pop(tk.emb)
                _backward([node], [dx if stage == 0 else torch.zeros_like(node)])
            # 6. the sends and receives
            sends, recvs, into = [], [], []
            if fjob is not None and fjob[0] * S + stage < G - 1:
                sends.append((y, run.next))
            if bjob is not None and bjob[0] * S + stage > 0:
                sends.append((dx, run.prev))
            src = tk.fwd[(stage - 1) % S]
            if src is not None and src[0] * S + (stage - 1) % S < G - 1:
                recvs.append(run.prev)
                into.append((xs, src[0] * S + (stage - 1) % S + 1, src[1]))
            src = tk.bwd[(stage + 1) % S]
            if src is not None and src[0] * S + (stage + 1) % S > 0:
                recvs.append(run.next)
                into.append((dys, src[0] * S + (stage + 1) % S - 1, src[1]))
            for (store, g, m), got in zip(into, run.exchange(sends, recvs)):
                store[(g, m)] = got.requires_grad_(True) if store is xs else got
        loss = self._finish(run, loss_sum, denom)
        return loss, self._reduce_grads(run, params)
