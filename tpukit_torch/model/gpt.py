"""The GPT decoder of the port, as functions on a parameter tree (twin of
`tpukit/model/gpt.py`): the config, seeded initialisation, the full-sequence
forward training runs (`forward`, `forward_hidden`), and the paged
KV-cached forward the serving engine runs. With `num_experts > 0` every
layer's FFN is a routed expert bank (`_apply_moe_ffn`).

The parameter tree is tpukit's: nested dicts, `layers` leaves stacked on a
leading `num_layers` axis, linear kernels `[in, out]`. A tpukit tree
therefore bridges over as a plain copy (`tpukit_torch.bridge`).

Numerics follow the JAX model's cast points: parameters in f32, matmuls in
`compute_dtype`, LayerNorm and softmax in f32, the residual stream in the
compute dtype, logits widened to f32 only where a caller samples them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from tpukit_torch import NotPortedError, resolve_device
from tpukit_torch.ops import paged_attention
from tpukit_torch.ops.attention import causal_attention
from tpukit_torch.ops.layers import layer_norm, linear
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
    # ExpertGrid ExpertParallel injects at loss time; moe_capacity > 0
    # overrides the per-row capacity of every dispatch.
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_aux_mask_pads: bool = True
    router_top_k: int = 1
    moe_dispatch: str = "xla"
    moe_mesh: Any = None
    moe_capacity: int = 0

    def __post_init__(self):
        if self.dropout > 0:
            raise NotPortedError(
                f"dropout={self.dropout}: tpukit draws its dropout masks from "
                f"jax.random's threefry, which the port cannot match yet "
                f"(ROADMAP.md, queue A item 9 'Seeded sampling')"
            )
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
    `num_layers` axis."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
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


# --------------------------------------------------------------------------
# Forward pieces.
# --------------------------------------------------------------------------


def apply_embeddings(params: dict, cfg: GPTConfig, input_ids, position_ids):
    """Token + position embedding sum, cast to the compute dtype."""
    emb = params["embeddings"]
    x = emb["token"][input_ids.long()] + emb["position"][position_ids.long()]
    return x.to(cfg.compute_dtype)


def _apply_attention(layer, cfg: GPTConfig, x, pad_mask):
    """Self-attention over a full sequence `x [B, S, dim]` (twin of
    `tpukit/model/gpt.py:428`): q/k/v projections (one fused product with
    `cfg.fuse_qkv`), causal attention by `cfg.attention_impl`, output
    projection."""
    batch, seq = x.shape[0], x.shape[1]
    cdt = cfg.compute_dtype
    if cfg.fuse_qkv:
        kernel = torch.cat([layer["attn"][n]["kernel"] for n in ("q", "k", "v")], dim=1)
        q, k, v = linear(x, {"kernel": kernel}, cdt).split(cfg.inner_dim, dim=-1)
    else:
        q, k, v = (linear(x, layer["attn"][n], cdt) for n in ("q", "k", "v"))
    split = lambda t: t.reshape(batch, seq, cfg.heads, cfg.head_dim).transpose(1, 2).contiguous()
    out = causal_attention(split(q), split(k), split(v), scale=1.0 / cfg.head_dim**0.5,
                           pad_mask=pad_mask, impl=cfg.attention_impl)
    out = out.transpose(1, 2).reshape(batch, seq, cfg.inner_dim)
    return linear(out, layer["attn"]["out"], cdt)


def apply_decoder_layer(layer: dict, cfg: GPTConfig, x, pad_mask):
    """Pre-LN block (twin of `tpukit/model/gpt.py:464`): `x + attn(norm1(x))`,
    then `x + ffn(norm2(x))`; `pad_mask [B, S]` bool, True = padding. With
    `cfg.num_experts > 0` the FFN is the expert bank and the block returns
    `(x, aux)`."""
    h = layer_norm(x, layer["norm1"]).to(cfg.compute_dtype)
    x = x + _apply_attention(layer, cfg, h, pad_mask)
    h = layer_norm(x, layer["norm2"]).to(cfg.compute_dtype)
    if cfg.num_experts > 0:
        out, aux = _apply_moe_ffn(layer, cfg, h, pad_mask)
        return x + out, aux
    return x + _apply_feed_forward(layer, cfg, h)


def apply_decoder_layers(stacked_layers: dict, cfg: GPTConfig, x, pad_mask,
                         aux_out: list | None = None):
    """The layer stack over stacked parameters (twin of
    `tpukit/model/gpt.py:485`), any leading stack size. With
    `cfg.remat_layers` each layer is recomputed in the backward. MoE
    configs append the layers' summed load-balance aux to `aux_out`."""
    leaf = stacked_layers
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    moe = cfg.num_experts > 0
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(leaf.shape[0]):
        layer = _take(stacked_layers, i)
        if cfg.remat_layers:
            y = checkpoint(apply_decoder_layer, layer, cfg, x, pad_mask, use_reentrant=False)
        else:
            y = apply_decoder_layer(layer, cfg, x, pad_mask)
        if moe:
            y, aux = y
            aux_total = aux_total + aux
        x = y
    if moe and aux_out is not None:
        aux_out.append(aux_total)
    return x


def forward_hidden(params: dict, cfg: GPTConfig, input_ids, position_ids, mask=None,
                   aux_out: list | None = None):
    """Embeddings, the layer stack and the final LayerNorm: the hidden
    states the LM head consumes, in the compute dtype (twin of
    `tpukit/model/gpt.py:781`). `mask [B, S]` bool, True = padding."""
    x = apply_embeddings(params, cfg, input_ids, position_ids)
    x = apply_decoder_layers(params["layers"], cfg, x, mask, aux_out=aux_out)
    return layer_norm(x, params["norm_out"]).to(cfg.compute_dtype)


def forward(params: dict, cfg: GPTConfig, input_ids, position_ids, mask=None,
            aux_out: list | None = None):
    """Logits `[B, S, padded_vocab]` in the compute dtype, pad columns -1e9
    (twin of `tpukit/model/gpt.py:819`)."""
    x = apply_embeddings(params, cfg, input_ids, position_ids)
    x = apply_decoder_layers(params["layers"], cfg, x, mask, aux_out=aux_out)
    return apply_head(params, cfg, x)


def _apply_feed_forward(layer, cfg: GPTConfig, x):
    """up -> relu -> down -> relu (the reference's double ReLU)."""
    h = torch.relu(linear(x, layer["ffn"]["up"], cfg.compute_dtype))
    return torch.relu(linear(h, layer["ffn"]["down"], cfg.compute_dtype))


_MOE_DISPATCH = {"xla": moe_ffn_xla, "a2a": moe_ffn_a2a, "pallas": moe_ffn_pallas}


def _apply_moe_ffn(layer, cfg: GPTConfig, x, pad_mask=None):
    """The routed expert FFN (twin of `tpukit/model/gpt.py:365`) by
    `cfg.moe_dispatch`; returns `(out, aux)`. `pad_mask` only changes the
    load-balance statistics: every position routes."""
    return _MOE_DISPATCH[cfg.moe_dispatch](layer, cfg, x, pad_mask=pad_mask)


def _attend_over_cache(layer, cfg: GPTConfig, q, k_cache, v_cache, q_pos):
    """Scores over every cache position, causal window, softmax, value mix,
    output projection. `q [B, H, T, D]`, caches `[B, H, W, D]`."""
    batch, t = q.shape[0], q.shape[2]
    out = paged_attention.attend_core(q, k_cache, v_cache, q_pos)
    out = out.permute(0, 2, 1, 3).reshape(batch, t, cfg.inner_dim)
    return linear(out, layer["attn"]["out"], cfg.compute_dtype)


def _apply_attention_paged(layer, cfg: GPTConfig, x, pool_k, pool_v, scale_k,
                           scale_v, bt, start, write_mask):
    """Attention over the paged cache for a chunk `x [B, T, dim]` at per-row
    offsets `start [B]`. Decode ticks (T == 1) with `cfg.fused_decode` run
    the paged-attention kernel; otherwise the block tables are gathered into
    a `[B, H, MP*P, D]` view, the chunk's K/V written into it at `start`,
    and `_attend_over_cache` attends. Then the fresh K/V go to the pools,
    in place (`write_token` for T == 1, whole pages for a prefill chunk)."""
    batch, t = x.shape[0], x.shape[1]
    cdt, h, d = cfg.compute_dtype, cfg.heads, cfg.head_dim
    q = linear(x, layer["attn"]["q"], cdt)
    k = linear(x, layer["attn"]["k"], cdt)
    v = linear(x, layer["attn"]["v"], cdt)

    if cfg.fused_decode and t == 1:
        k_tok, v_tok = k.view(batch, h, d), v.view(batch, h, d)
        attn = paged_attention.paged_attend(
            pool_k, pool_v, scale_k, scale_v, bt, start, q.view(batch, h, d),
            k_tok, v_tok,
        )
        out = linear(attn.reshape(batch, 1, cfg.inner_dim), layer["attn"]["out"], cdt)
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
        out = _attend_over_cache(layer, cfg, q, view_k, view_v, q_pos)
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
    """Forward a chunk `input_ids [B, T]` against the paged cache: writes
    K/V for positions `[start[b], start[b] + T)` into the pools (in place)
    and returns `(logits [B, T, padded_vocab], cache)`.

    `cache` is the paged dict of `serve.paged.init_paged_cache`; `start` is
    a `[B]` int32 vector of per-row offsets; `write_mask [B]` (default all
    True) gates which rows' K/V reach the pool. The ring cache is not in
    the port yet."""
    if not (isinstance(cache, dict) and "bt" in cache):
        raise NotPortedError(
            "forward_cached on the ring KV cache is not in the port yet "
            "(ROADMAP.md, queue A item 'Ring-cache serving'); pass the paged "
            "cache of serve.paged.init_paged_cache"
        )
    if start.dim() != 1:
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
        x = x + _apply_attention_paged(
            layer, cfg, h, cache["k"][i], cache["v"][i],
            cache["ks"][i] if quant else None, cache["vs"][i] if quant else None,
            bt, start, write_mask,
        )
        h = layer_norm(x, layer["norm2"]).to(cfg.compute_dtype)
        if cfg.num_experts > 0:
            x = x + _apply_moe_ffn(layer, cfg, h)[0]
        else:
            x = x + _apply_feed_forward(layer, cfg, h)
    return apply_head(params, cfg, x), cache


def apply_head(params: dict, cfg: GPTConfig, x):
    """Final LayerNorm and the untied LM head. Returns `[B, S,
    padded_vocab]` in the compute dtype; pad columns are -1e9."""
    x = layer_norm(x, params["norm_out"]).to(cfg.compute_dtype)
    logits = linear(x, params["lm_head"], cfg.compute_dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab_size, device=x.device)
        logits = torch.where(col < cfg.vocab_size, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype, device=x.device))
    return logits
