"""The GPT decoder of the port, as functions on a parameter tree (twin of
`tpukit/model/gpt.py`): the config, seeded initialisation, the full-sequence
forward training runs (`forward`, `forward_hidden`, with dropout when a
key is given), and the KV-cached forward the serving engine and the
samplers run, over the ring cache (`init_kv_cache`) or the paged one. With
`num_experts > 0` every layer's FFN is a routed expert bank
(`_apply_moe_ffn`).

The parameter tree is tpukit's: nested dicts, `layers` leaves stacked on a
leading `num_layers` axis, linear kernels `[in, out]`. A tpukit tree
therefore bridges over as a plain copy (`tpukit_torch.bridge`).

Numerics follow the JAX model's cast points: parameters in f32, matmuls in
`compute_dtype`, LayerNorm and softmax in f32, the residual stream in the
compute dtype, logits widened to f32 only where a caller samples them.

Under tensor parallelism (`cfg.tp`, a `ModelGroup` that `TensorParallel`
and the serving grid set) the tree holds this rank's shards by tpukit's
rules (`shardings.TensorParallel`), and every function here runs on them
with the Megatron operators of `ops/layers.py`. Which leaves are shards
is read from their shapes: q/k/v and `ffn/up` column-parallel behind
`copy_to_model`, `attn/out` and `ffn/down` row-parallel before
`reduce_from_model` (their replicated biases added once, after it), the
token table's vocab rows through `vocab_parallel_embedding`, the head's
vocab columns gathered for logits (`apply_head`) or kept local for the
vocab-parallel CE (`head_logits`). Attention runs on the rank's heads,
`cfg.local_heads`, and so do the KV caches; where the heads do not
divide the group but the q/k/v columns do, the attention's weights are
gathered and it runs on every head, replicated.

Under context parallelism (`cfg.cp`, a `ring_attention.SeqGroup` that
`ContextParallel` injects with `attention_impl` "ring" or "ulysses") the
tensors hold this rank's shard of the sequence; the attention runs over
the group, and everything else is token-local.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from tpukit_torch import random as tk_random
from tpukit_torch import resolve_device
from tpukit_torch.ops import paged_attention
from tpukit_torch.ops import deferred
from tpukit_torch.ops.attention import causal_attention
from tpukit_torch.ops.layers import (
    copy_to_model,
    dropout,
    gather_from_model,
    layer_norm,
    linear,
    reduce_from_model,
    vocab_parallel_embedding,
)
from tpukit_torch.ops.moe_dispatch import moe_ffn_a2a, moe_ffn_xla
from tpukit_torch.ops.moe_gemm import moe_ffn_pallas
from tpukit_torch.serve import paged as paged_lib

NEG_INF = paged_attention.NEG_INF
FFN_MULT = 4  # the reference FeedForward's mult (tpukit GPTConfig.ffn_mult)
PARAM_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyper-parameters (twin of `tpukit/model/gpt.py:57-250`, the
    fields the serving and training slices read). Defaults mirror
    tpukit's: dim 256, head_dim 32, heads 8, num_layers 8, GPT-2 vocab,
    bf16 compute, fused q/k/v, unrolled layers without remat."""

    dim: int = 256
    head_dim: int = 32
    heads: int = 8
    num_layers: int = 8
    vocab_size: int = 50257
    max_position_embeddings: int = 256
    compute_dtype: torch.dtype = torch.bfloat16
    # vocab dims padded to a multiple of this (50257 -> 50304); pad logits
    # are -1e9, so argmax is that of the logical vocab
    vocab_pad_multiple: int = 128
    # decode ticks (T == 1) of the paged forward run the paged-attention
    # kernel instead of the gathered view; prefill chunks stay unfused
    fused_decode: bool = False
    # inverted dropout after the attention output projection and after the
    # FFN, in training steps that pass a key (`forward(..., rng=)`); masks
    # are threefry draws, the same bits as tpukit's (`tpukit_torch.random`)
    dropout: float = 0.0
    # "auto": the flash kernels on CUDA from S = 32 up, the eager XLA-twin
    # path otherwise (ops/attention.py); "xla" or "flash" force one
    attention_impl: str = "auto"
    # the trunk is a Python loop either way; scan_layers only mirrors
    # tpukit's flag (its scan and unrolled paths are numerically identical)
    scan_layers: bool = False
    # recompute each decoder layer in the backward (torch.utils.checkpoint)
    remat_layers: bool = False
    # q/k/v as one [dim, 3 * inner] product (column blocks of the wider
    # product are the three narrow ones)
    fuse_qkv: bool = True
    # Mixture of experts (tpukit `gpt.py:108-158`): num_experts > 0 replaces
    # every layer's FFN with a router and a stacked expert bank; each token
    # routes to router_top_k experts (1 = Switch, 2 = GShard top-2), the
    # gates are the raw router probabilities, and the Switch load-balance aux
    # weighs moe_aux_weight in the training objective (over real tokens only
    # with moe_aux_mask_pads). moe_dispatch: "xla" (one-hot einsums), "a2a"
    # (the expert-parallel exchange block) or "pallas" (the grouped-expert
    # kernels; dropless unless moe_capacity > 0). moe_mesh is the
    # ExpertGrid ExpertParallel injects at loss time; moe_rows the RowGroup
    # (the ranks that hold the batch's rows) that ExpertParallel,
    # DataParallel and FSDP inject, over which every dispatch sums the
    # load-balance statistics; moe_capacity > 0 overrides the per-row
    # capacity of every dispatch.
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_aux_mask_pads: bool = True
    router_top_k: int = 1
    moe_dispatch: str = "xla"
    moe_mesh: Any = None
    moe_rows: Any = None
    moe_capacity: int = 0
    # interleaved pipeline stages (tpukit `gpt.py:198`): each stage rank of
    # `Pipeline1F1B` runs V non-contiguous chunks of the layer stack
    virtual_stages: int = 1
    # tensor parallelism: this rank's `ops.layers.ModelGroup`, which
    # `TensorParallel` and the serving grid inject; None is one device
    tp: Any = None
    # context parallelism (attention_impl "ring" or "ulysses"): the
    # `ring_attention.SeqGroup` `ContextParallel` injects (None: a world of
    # one), and the ring's layout, "contiguous" or "zigzag"
    cp: Any = None
    ring_layout: str = "contiguous"
    # the payload of the hand-placed collectives (tpukit `gpt.py:160-187`):
    # "f32", "bf16" or block-scaled "int8" gradients under DataParallel and
    # FSDP and the token exchange under ExpertParallel, f32 accumulation;
    # quant_stochastic rounds the int8 quantizer stochastically; grad_buckets
    # N > 0 splits the DataParallel / FSDP gradient wire into N buckets
    # (ops/quant_comm.py). The other strategies refuse them.
    comm_dtype: str = "f32"
    quant_stochastic: bool = False
    grad_buckets: int = 0

    def __post_init__(self):
        if self.comm_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(f"comm_dtype={self.comm_dtype!r} must be 'f32', 'bf16' or "
                             f"'int8'")
        if self.grad_buckets < 0:
            raise ValueError(f"grad_buckets={self.grad_buckets} must be >= 0 (0 = the "
                             f"serial schedule, N = bucket count)")
        if self.virtual_stages < 1:
            raise ValueError(f"virtual_stages={self.virtual_stages} must be >= 1 (1 = "
                             f"one contiguous layer block per pipeline stage)")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must be in [0, 1)")
        if self.num_experts > 0 and not 1 <= self.router_top_k <= self.num_experts:
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in [1, num_experts="
                f"{self.num_experts}] - silently clamping would train a different "
                f"routing than the one requested"
            )
        if self.moe_dispatch not in ("xla", "a2a", "pallas"):
            raise ValueError(f"moe_dispatch={self.moe_dispatch!r} must be 'xla', 'a2a' "
                             f"or 'pallas'")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be torch.float32 or torch.bfloat16, got "
                f"{self.compute_dtype}"
            )

    @property
    def inner_dim(self) -> int:
        return self.head_dim * self.heads

    @property
    def tp_size(self) -> int:
        """The degree of the `model` group (1 without tensor parallelism)."""
        return 1 if self.tp is None else self.tp.size

    @property
    def heads_split(self) -> bool:
        """Whether each rank attends over its own heads (heads / model of
        them): the heads divide a model group larger than one."""
        return self.tp_size > 1 and self.heads % self.tp_size == 0

    @property
    def local_heads(self) -> int:
        """The heads this rank attends over and its KV caches hold."""
        return self.heads // self.tp_size if self.heads_split else self.heads

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    def replace(self, **kw) -> "GPTConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Initialization: torch's own defaults, as tpukit twins them —
# linear kernel and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), embeddings
# N(0, 1), LayerNorm scale 1 and bias 0. Same tree and distributions as
# tpukit's init_params; the values differ (torch.Generator, not jax.random).
# --------------------------------------------------------------------------


def _uniform(shape, bound, gen, device, dtype):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(-bound, bound, generator=gen)


def _linear_params(lead, fan_in, fan_out, bias, gen, device, dtype) -> dict:
    bound = 1.0 / fan_in**0.5
    p = {"kernel": _uniform((*lead, fan_in, fan_out), bound, gen, device, dtype)}
    if bias:
        p["bias"] = _uniform((*lead, fan_out), bound, gen, device, dtype)
    return p


def _layer_norm_params(lead, dim, device, dtype) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """The parameter tree, drawn from a `torch.Generator` seeded with
    `seed` on `device`. Every leaf under `layers` has a leading
    `num_layers` axis. `device="meta"` gives the tree's shapes alone, with
    no memory and no draw (the twin of `jax.eval_shape` of tpukit's)."""
    meta = str(device) == "meta"
    device = torch.device("meta") if meta else resolve_device(device)
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    dt, lead, dim, inner = PARAM_DTYPE, (cfg.num_layers,), cfg.dim, cfg.inner_dim
    lin = lambda fi, fo, bias: _linear_params(lead, fi, fo, bias, gen, device, dt)
    if cfg.num_experts > 0:
        # router without bias; the bank's leaves lead with [layers, experts]
        bank = lambda fi, fo: _linear_params((*lead, cfg.num_experts), fi, fo, True, gen,
                                             device, dt)
        ffn = {"router": lin(dim, cfg.num_experts, False),
               "experts": {"up": bank(dim, dim * FFN_MULT), "down": bank(dim * FFN_MULT, dim)}}
    else:
        ffn = {"up": lin(dim, dim * FFN_MULT, True), "down": lin(dim * FFN_MULT, dim, True)}
    layers = {
        "norm1": _layer_norm_params(lead, dim, device, dt),
        "attn": {"q": lin(dim, inner, False), "k": lin(dim, inner, False),
                 "v": lin(dim, inner, False), "out": lin(inner, dim, True)},
        "norm2": _layer_norm_params(lead, dim, device, dt),
        "ffn": ffn,
    }
    vp = cfg.padded_vocab_size
    return {
        "embeddings": {
            "token": torch.randn((vp, dim), generator=gen, dtype=dt, device=device),
            "position": torch.randn((cfg.max_position_embeddings, dim),
                                    generator=gen, dtype=dt, device=device),
        },
        "layers": layers,
        "norm_out": _layer_norm_params((), dim, device, dt),
        "lm_head": _linear_params((), dim, vp, False, gen, device, dt),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer `i` of the stacked `layers` tree (views, no copies)."""
    return _take(params["layers"], i)


def _take(tree: dict, i: int) -> dict:
    return {k: _take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unbind(tree: dict) -> list[dict]:
    """Every layer of a stacked tree, each leaf split once by
    `torch.unbind`: its backward stacks the layers' gradients in one write,
    where indexing layer by layer would give each index a zero-filled
    gradient of the whole stack and sum them."""
    parts = {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# --------------------------------------------------------------------------
# Forward pieces.
# --------------------------------------------------------------------------


def _model_group(cfg: GPTConfig, leaf: torch.Tensor, dim: int, full: int):
    """`cfg.tp` where `leaf` is a shard (its `dim` is not `full` long),
    else None: the leaf is whole on every rank."""
    return cfg.tp if cfg.tp_size > 1 and leaf.shape[dim] != full else None


def apply_embeddings(params: dict, cfg: GPTConfig, input_ids, position_ids):
    """Token + position embedding sum, cast to the compute dtype (the token
    table's vocab rows split over `cfg.tp` when it is a shard)."""
    emb = params["embeddings"]
    tp = _model_group(cfg, emb["token"], 0, cfg.padded_vocab_size)
    return deferred.run(_embed, None, emb, input_ids, position_ids, tp).to(cfg.compute_dtype)


def _embed(_, emb: dict, input_ids, position_ids, tp):
    return (vocab_parallel_embedding(emb["token"], input_ids, tp)
            + emb["position"][position_ids.long()])


def _row_parallel(x, params: dict, compute_dtype, tp):
    """`linear` of a row-parallel product: this rank's partial product,
    summed over `tp` (None: whole), then the replicated bias, once."""
    return deferred.run(_row_product, x, params, compute_dtype, tp)


def _row_product(x, params: dict, compute_dtype, tp):
    y = reduce_from_model(torch.matmul(x.to(compute_dtype),
                                       params["kernel"].to(compute_dtype)), tp)
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def _attention_params(layer: dict, cfg: GPTConfig):
    """(the attention's parameters, the model group its products split
    over or None). On the rank's heads they are its shards; where the
    shards do not fall on head boundaries (heads % model != 0, tpukit's
    `inner_dim % model == 0` rule still sharding them) the q/k/v columns
    and the out rows are gathered, and the attention is replicated."""
    attn = layer["attn"]
    tp = _model_group(cfg, attn["q"]["kernel"], -1, cfg.inner_dim)
    if tp is None or cfg.heads_split:
        return attn, tp
    whole = lambda p, dim: {**p, "kernel": gather_from_model(p["kernel"], dim, tp)}
    return {**{n: whole(attn[n], -1) for n in ("q", "k", "v")},
            "out": whole(attn["out"], -2)}, None


def _apply_attention(layer, cfg: GPTConfig, x, pad_mask, rng=None, rng_row0: int = 0):
    """Self-attention over a full sequence `x [B, S, dim]` (twin of
    `tpukit/model/gpt.py:428`): q/k/v projections (one fused product with
    `cfg.fuse_qkv`), causal attention by `cfg.attention_impl`, output
    projection, then dropout under `rng` (never inside the attention). On
    the rank's heads under `cfg.tp`: the output is summed over the model
    group before the bias and the dropout, whose mask every rank of the
    group draws alike."""
    batch, seq = x.shape[0], x.shape[1]
    cdt, heads = cfg.compute_dtype, cfg.local_heads
    attn, tp = _attention_params(layer, cfg)
    x = copy_to_model(x, tp)
    if cfg.fuse_qkv:
        kernels = {n: attn[n]["kernel"] for n in ("q", "k", "v")}
        q, k, v = deferred.run(_fused_qkv, x, kernels, cdt).split(heads * cfg.head_dim, dim=-1)
    else:
        q, k, v = (linear(x, attn[n], cdt) for n in ("q", "k", "v"))
    split = lambda t: t.reshape(batch, seq, heads, cfg.head_dim).transpose(1, 2).contiguous()
    out = causal_attention(split(q), split(k), split(v), scale=1.0 / cfg.head_dim**0.5,
                           pad_mask=pad_mask, impl=cfg.attention_impl, seq=cfg.cp,
                           ring_layout=cfg.ring_layout)
    out = out.transpose(1, 2).reshape(batch, seq, heads * cfg.head_dim)
    out = _row_parallel(out, attn["out"], cdt, tp)
    return dropout(out, cfg.dropout, rng, rng_row0)


def _fused_qkv(x, kernels: dict, cdt):
    """The q/k/v projections as one product of the concatenated kernels
    (one weight-gradient product serves the three leaves)."""
    kernel = torch.cat([kernels[n] for n in ("q", "k", "v")], dim=1)
    return linear(x, {"kernel": kernel}, cdt)


def apply_decoder_layer(layer: dict, cfg: GPTConfig, x, pad_mask, rng=None,
                        rng_row0: int = 0):
    """Pre-LN block (twin of `tpukit/model/gpt.py:464`): `x + attn(norm1(x))`,
    then `x + ffn(norm2(x))`; `pad_mask [B, S]` bool, True = padding. With
    `cfg.num_experts > 0` the FFN is the expert bank and the block returns
    `(x, aux)`. A key `rng [2]` splits into the attention's and the FFN's
    dropout keys; `rng_row0` is the first row of `x` within the batch the
    masks are drawn over (a data-parallel rank's share of the global
    batch)."""
    attn_rng = ffn_rng = None
    if rng is not None:
        attn_rng, ffn_rng = tk_random.split(rng)
    h = layer_norm(x, layer["norm1"]).to(cfg.compute_dtype)
    x = x + _apply_attention(layer, cfg, h, pad_mask, attn_rng, rng_row0)
    h = layer_norm(x, layer["norm2"]).to(cfg.compute_dtype)
    if cfg.num_experts > 0:
        out, aux = _apply_moe_ffn(layer, cfg, h, pad_mask)
        return x + dropout(out, cfg.dropout, ffn_rng, rng_row0), aux
    return x + dropout(_apply_feed_forward(layer, cfg, h), cfg.dropout, ffn_rng, rng_row0)


def apply_decoder_layers(stacked_layers: dict, cfg: GPTConfig, x, pad_mask,
                         aux_out: list | None = None, rng=None, rng_row0: int = 0,
                         active=None):
    """The layer stack over stacked parameters (twin of
    `tpukit/model/gpt.py:485`), any leading stack size. With
    `cfg.remat_layers` each layer is recomputed in the backward (its
    dropout masks drawn again from the same key). MoE configs append the
    layers' summed load-balance aux to `aux_out`. A dropout key `rng`
    splits into one key a layer. `active` (a sequence of bools, one a
    slot) gates the identity-padded slots of an uneven pipeline layout: an
    inactive slot passes `x` through, adds no aux and gets a zero
    gradient."""
    moe = cfg.num_experts > 0
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unbind(stacked_layers)
    rngs = tk_random.split(rng, len(layers)) if rng is not None else [None] * len(layers)
    for i, (layer, layer_rng) in enumerate(zip(layers, rngs)):
        if active is not None and not active[i]:
            continue
        if cfg.remat_layers:
            y = checkpoint(apply_decoder_layer, layer, cfg, x, pad_mask, layer_rng, rng_row0,
                           use_reentrant=False)
        else:
            y = apply_decoder_layer(layer, cfg, x, pad_mask, layer_rng, rng_row0)
        if moe:
            y, aux = y
            aux_total = aux_total + aux
        x = y
    if moe and aux_out is not None:
        aux_out.append(aux_total)
    return x


def forward_hidden(params: dict, cfg: GPTConfig, input_ids, position_ids, mask=None,
                   aux_out: list | None = None, rng=None, rng_row0: int = 0):
    """Embeddings, the layer stack and the final LayerNorm: the hidden
    states the LM head consumes, in the compute dtype (twin of
    `tpukit/model/gpt.py:781`). `mask [B, S]` bool, True = padding. `rng`
    (a `[2]` key, or None for no dropout) is the training step's dropout
    key."""
    x = apply_embeddings(params, cfg, input_ids, position_ids)
    x = apply_decoder_layers(params["layers"], cfg, x, mask, aux_out=aux_out, rng=rng,
                             rng_row0=rng_row0)
    return layer_norm(x, params["norm_out"]).to(cfg.compute_dtype)


def forward(params: dict, cfg: GPTConfig, input_ids, position_ids, mask=None,
            aux_out: list | None = None, rng=None, rng_row0: int = 0):
    """Logits `[B, S, padded_vocab]` in the compute dtype, pad columns -1e9
    (twin of `tpukit/model/gpt.py:819`); `rng` as in `forward_hidden`."""
    x = apply_embeddings(params, cfg, input_ids, position_ids)
    x = apply_decoder_layers(params["layers"], cfg, x, mask, aux_out=aux_out, rng=rng,
                             rng_row0=rng_row0)
    return apply_head(params, cfg, x)


def _apply_feed_forward(layer, cfg: GPTConfig, x):
    """up -> relu -> down -> relu (the reference's double ReLU); under
    `cfg.tp` `up` column- and `down` row-parallel, summed before `down`'s
    bias and the second relu."""
    up, down = layer["ffn"]["up"], layer["ffn"]["down"]
    tp = _model_group(cfg, up["kernel"], -1, cfg.dim * FFN_MULT)
    h = torch.relu(linear(copy_to_model(x, tp), up, cfg.compute_dtype))
    return torch.relu(_row_parallel(h, down, cfg.compute_dtype, tp))


_MOE_DISPATCH = {"xla": moe_ffn_xla, "a2a": moe_ffn_a2a, "pallas": moe_ffn_pallas}


def _apply_moe_ffn(layer, cfg: GPTConfig, x, pad_mask=None):
    """The routed expert FFN (twin of `tpukit/model/gpt.py:365`) by
    `cfg.moe_dispatch`; returns `(out, aux)`. `pad_mask` only changes the
    load-balance statistics: every position routes."""
    return _MOE_DISPATCH[cfg.moe_dispatch](layer, cfg, x, pad_mask=pad_mask)


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int, device=None) -> dict:
    """The ring KV cache (twin of `tpukit/model/gpt.py:574`): per-layer
    stacked K/V buffers `[num_layers, B, heads, max_len, head_dim]` in the
    compute dtype, zeroed; the rank's heads (`cfg.local_heads`) under
    tensor parallelism."""
    shape = (cfg.num_layers, batch, cfg.local_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def _apply_attention_cached(layer, cfg: GPTConfig, x, k_cache, v_cache, start):
    """Attention over the ring cache for a chunk `x [B, T, dim]` (twin of
    `tpukit/model/gpt.py:583`): the chunk's K/V are written into the
    caches `[B, H, W, D]` (in place) at `start`, then every position up to
    each query's own is attended. `start` is an int (every row at the same
    offset: a serial decode, a full-width prefill) or a `[B]` tensor of
    per-row offsets (each slot at its own cursor). The write position
    clamps to `[0, W - T]` as `lax.dynamic_update_slice` clamps it; the
    query positions do not."""
    batch, t = x.shape[0], x.shape[1]
    cdt, h, d = cfg.compute_dtype, cfg.local_heads, cfg.head_dim
    attn, tp = _attention_params(layer, cfg)
    x = copy_to_model(x, tp)
    split = lambda z: z.view(batch, t, h, d).permute(0, 2, 1, 3)
    q = split(linear(x, attn["q"], cdt))
    k = split(linear(x, attn["k"], cdt))
    v = split(linear(x, attn["v"], cdt))
    w = k_cache.shape[2]
    steps = torch.arange(t, device=x.device)
    if isinstance(start, torch.Tensor) and start.dim() == 1:
        first = start.long().clamp(0, w - t)
        cols = first[:, None] + steps
        rows = torch.arange(batch, device=x.device)[:, None]
        k_cache[rows, :, cols] = k.permute(0, 2, 1, 3)
        v_cache[rows, :, cols] = v.permute(0, 2, 1, 3)
        q_pos = (start.long()[:, None] + steps)[:, None, :, None]
    else:
        s0 = int(start)
        first = min(max(s0, 0), w - t)
        k_cache[:, :, first:first + t] = k
        v_cache[:, :, first:first + t] = v
        q_pos = (s0 + steps)[None, None, :, None]
    return _attend_over_cache(attn, tp, cfg, q, k_cache, v_cache, q_pos)


def _attend_over_cache(attn, tp, cfg: GPTConfig, q, k_cache, v_cache, q_pos):
    """Scores over every cache position, causal window, softmax, value mix,
    output projection (row-parallel over `tp`). `q [B, H, T, D]`, caches
    `[B, H, W, D]`."""
    batch, h, t = q.shape[0], q.shape[1], q.shape[2]
    out = paged_attention.attend_core(q, k_cache, v_cache, q_pos)
    out = out.permute(0, 2, 1, 3).reshape(batch, t, h * cfg.head_dim)
    return _row_parallel(out, attn["out"], cfg.compute_dtype, tp)


def _apply_attention_paged(layer, cfg: GPTConfig, x, pool_k, pool_v, scale_k,
                           scale_v, bt, start, write_mask):
    """Attention over the paged cache for a chunk `x [B, T, dim]` at per-row
    offsets `start [B]`. Decode ticks (T == 1) with `cfg.fused_decode` run
    the paged-attention kernel; otherwise the block tables are gathered into
    a `[B, H, MP*P, D]` view, the chunk's K/V written into it at `start`,
    and `_attend_over_cache` attends. Then the fresh K/V go to the pools,
    in place (`write_token` for T == 1, whole pages for a prefill chunk)."""
    batch, t = x.shape[0], x.shape[1]
    cdt, h, d = cfg.compute_dtype, cfg.local_heads, cfg.head_dim
    attn, tp = _attention_params(layer, cfg)
    x = copy_to_model(x, tp)
    q = linear(x, attn["q"], cdt)
    k = linear(x, attn["k"], cdt)
    v = linear(x, attn["v"], cdt)

    if cfg.fused_decode and t == 1:
        k_tok, v_tok = k.view(batch, h, d), v.view(batch, h, d)
        out = paged_attention.fused_paged_attention(
            pool_k, pool_v, scale_k, scale_v, bt, start, q.view(batch, h, d),
            k_tok, v_tok, tp=cfg.tp, heads=cfg.heads,
        )
        out = _row_parallel(out.reshape(batch, 1, h * d), attn["out"], cdt, tp)
    else:
        split = lambda z: z.view(batch, t, h, d).permute(0, 2, 1, 3)
        q, k, v = split(q), split(k), split(v)
        view_k = paged_lib.gather_view(pool_k, scale_k, bt, cdt)
        view_v = paged_lib.gather_view(pool_v, scale_v, bt, cdt)
        # the write position clamps as lax.dynamic_update_slice clamps
        w = view_k.shape[2]
        first = start.long().clamp(0, w - t)
        cols = first[:, None] + torch.arange(t, device=x.device)
        rows = torch.arange(batch, device=x.device)[:, None]
        view_k[rows, :, cols] = k.permute(0, 2, 1, 3)
        view_v[rows, :, cols] = v.permute(0, 2, 1, 3)
        q_pos = (start.long()[:, None] + torch.arange(t, device=x.device))[:, None, :, None]
        out = _attend_over_cache(attn, tp, cfg, q, view_k, view_v, q_pos)
        k_tok, v_tok = (k[:, :, 0, :], v[:, :, 0, :]) if t == 1 else (k, v)

    if t == 1:
        paged_lib.write_token(pool_k, scale_k, bt, start, k_tok, write_mask)
        paged_lib.write_token(pool_v, scale_v, bt, start, v_tok, write_mask)
    else:
        paged_lib.write_pages(pool_k, scale_k, bt, start, k_tok, write_mask)
        paged_lib.write_pages(pool_v, scale_v, bt, start, v_tok, write_mask)
    return out


def forward_cached(params: dict, cfg: GPTConfig, input_ids, position_ids,
                   cache: dict, start, write_mask=None):
    """Forward a chunk `input_ids [B, T]` against the KV cache (twin of
    `tpukit/model/gpt.py:712`): writes K/V for positions `[start, start +
    T)` (in place) and returns `(logits [B, T, padded_vocab], cache)`.

    `cache` is the ring of `init_kv_cache` or the paged dict of
    `serve.paged.init_paged_cache` (told apart by its block tables, "bt").
    On the ring `start` is an int or a `[B]` vector of per-row offsets and
    `write_mask` is ignored (each slot owns its ring rows). The paged cache
    needs a `[B]` vector; `write_mask [B]` (default all True) gates which
    rows' K/V reach the pool."""
    paged = "bt" in cache
    if paged:
        if not (isinstance(start, torch.Tensor) and start.dim() == 1):
            raise ValueError(
                "paged forward_cached requires a [B] vector `start` (each row "
                "sits at its own cursor through its block table)"
            )
        bt = cache["bt"]
        if write_mask is None:
            write_mask = torch.ones((bt.shape[0],), dtype=torch.bool, device=bt.device)
        quant = "ks" in cache
    x = apply_embeddings(params, cfg, input_ids, position_ids)
    for i in range(cfg.num_layers):
        layer = layer_params(params, i)
        h = layer_norm(x, layer["norm1"]).to(cfg.compute_dtype)
        if paged:
            x = x + _apply_attention_paged(
                layer, cfg, h, cache["k"][i], cache["v"][i],
                cache["ks"][i] if quant else None, cache["vs"][i] if quant else None,
                bt, start, write_mask,
            )
        else:
            x = x + _apply_attention_cached(layer, cfg, h, cache["k"][i], cache["v"][i],
                                            start)
        h = layer_norm(x, layer["norm2"]).to(cfg.compute_dtype)
        if cfg.num_experts > 0:
            x = x + _apply_moe_ffn(layer, cfg, h)[0]
        else:
            x = x + _apply_feed_forward(layer, cfg, h)
    return apply_head(params, cfg, x), cache


def head_logits(params: dict, cfg: GPTConfig, x):
    """Final LayerNorm and the untied LM head on this rank's vocab columns:
    (logits `[B, S, V']` in the compute dtype, pad columns -1e9, their
    first global column, the model group they split over or None). V' is
    the padded vocab unless the head kernel is a vocab shard."""
    x = layer_norm(x, params["norm_out"]).to(cfg.compute_dtype)
    kernel = params["lm_head"]["kernel"]
    tp = _model_group(cfg, kernel, -1, cfg.padded_vocab_size)
    offset = tp.rank * kernel.shape[-1] if tp is not None else 0
    logits = linear(copy_to_model(x, tp), params["lm_head"], cfg.compute_dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        col = offset + torch.arange(kernel.shape[-1], device=x.device)
        logits = torch.where(col < cfg.vocab_size, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype, device=x.device))
    return logits, offset, tp


def apply_head(params: dict, cfg: GPTConfig, x):
    """Final LayerNorm and the untied LM head. Returns `[B, S,
    padded_vocab]` in the compute dtype; pad columns are -1e9. A
    vocab-sharded head's columns are gathered over the model group."""
    logits, _, tp = head_logits(params, cfg, x)
    return gather_from_model(logits, -1, tp)
