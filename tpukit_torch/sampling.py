"""Text generation (twin of `tpukit/sampling.py`): greedy argmax, or
temperature / top-k sampling reproducible under a seed.

`_sample_next` is the one sampling spelling every decode loop shares, the
serial loops here, the serving engine's batched tick and the draft model
of speculative decoding: greedy is `argmax(last)`; sampled is
`categorical(fold_in(rng, cur), top_k(last / temperature))`, drawn with
the port's threefry (`tpukit_torch.random`), so a seed gives tpukit's
tokens. Keys and cursors may carry leading batch axes (one key a row), as
tpukit's `jax.vmap` over slots.

  - `generate`: one prompt, through the naive loop (the whole buffer
    re-forwarded per token, `_decode_loop`) or the ring-cached one
    (`_decode_loop_cached`), which give the same tokens;
  - `generate_batch`: every prompt in one batched ring-cached decode
    (`serve.decode.decode_loop`), each row the tokens `generate` gives it.

The loops run eagerly, with one host read of the new token a step.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukit_torch import random as tk_random
from tpukit_torch.model import gpt


def _adjust_logits(last: torch.Tensor, temperature: float, top_k: int) -> torch.Tensor:
    """The temperature / top-k transform every sampler draws from (twin of
    `tpukit/sampling.py:135`): `last / temperature`, then everything below
    the k-th largest value set to -inf. The mask compares values, so every
    element tied with the k-th largest is kept, as tpukit's `scaled < kth`
    keeps them. `last` is f32 `[..., V]`; only `temperature > 0` callers
    use it."""
    # divide by a tensor: a Python scalar divisor may run as a multiply by
    # its reciprocal on cuda, an ulp away from jnp's quotient
    scaled = last / torch.full_like(last, temperature)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, float("-inf")), scaled)
    return scaled


def _sample_next(last: torch.Tensor, cur, rng, temperature: float = 0.0,
                 top_k: int = 0) -> torch.Tensor:
    """One token from f32 logits `last [..., V]` at cursor `cur` (twin of
    `tpukit/sampling.py:150`): greedy argmax at `temperature == 0` (`rng`
    untouched); otherwise `categorical(fold_in(rng, cur),
    _adjust_logits(last))`. `cur` and `rng [..., 2]` share `last`'s
    leading axes."""
    if temperature > 0.0:
        scaled = _adjust_logits(last, temperature, top_k)
        return tk_random.categorical(tk_random.fold_in(rng, cur), scaled)
    return torch.argmax(last, dim=-1)


def _cached_decode_exact(cfg: gpt.GPTConfig) -> bool:
    """True when the KV-cached decode gives the full re-forward's tokens:
    dense models, and MoE under the dropless pallas dispatch (a capacity
    dispatch routes each cached chunk in its own capacity window)."""
    return cfg.num_experts == 0 or (cfg.moe_dispatch == "pallas" and cfg.moe_capacity == 0)


@torch.no_grad()
def _decode_loop(params, cfg: gpt.GPTConfig, buf: torch.Tensor, prompt_len: int,
                 eos_id: int, temperature: float = 0.0, top_k: int = 0, rng=None):
    """The naive loop (twin of `tpukit/sampling.py:51`): each step forwards
    the whole `[1, prompt_len + max_new_tokens]` buffer and samples the
    token after position `cur - 1`; stops before appending EOS. Returns
    `(buf, length)`."""
    total = buf.shape[1]
    pos = torch.arange(total, dtype=torch.int32, device=buf.device)[None, :]
    cur = prompt_len
    while cur < total:
        logits = gpt.forward(params, cfg, buf, pos)
        last = logits[0, cur - 1].float()
        nxt = int(_sample_next(last, cur, rng, temperature, top_k))
        if nxt == eos_id:
            break
        buf[0, cur] = nxt
        cur += 1
    return buf, cur


@torch.no_grad()
def _decode_loop_cached(params, cfg: gpt.GPTConfig, buf: torch.Tensor, prompt_len: int,
                        eos_id: int, temperature: float = 0.0, top_k: int = 0, rng=None):
    """The ring-cached loop (twin of `tpukit/sampling.py:89`): the prompt
    but its last token is prefilled once, then each step forwards one
    token against the cache, with `_decode_loop`'s key fold and stopping
    rule. Returns `(buf, length)`."""
    total = buf.shape[1]
    dev = buf.device
    cache = gpt.init_kv_cache(cfg, 1, total, device=dev)
    if prompt_len > 1:
        pos = torch.arange(prompt_len - 1, dtype=torch.int32, device=dev)[None, :]
        gpt.forward_cached(params, cfg, buf[:, : prompt_len - 1], pos, cache, 0)
    cur = prompt_len
    while cur < total:
        pos = torch.full((1, 1), cur - 1, dtype=torch.int32, device=dev)
        logits, _ = gpt.forward_cached(params, cfg, buf[:, cur - 1: cur], pos, cache, cur - 1)
        last = logits[0, -1].float()
        nxt = int(_sample_next(last, cur, rng, temperature, top_k))
        if nxt == eos_id:
            break
        buf[0, cur] = nxt
        cur += 1
    return buf, cur


def _params_device(params) -> torch.device:
    return params["lm_head"]["kernel"].device


def _max_prompt(cfg: gpt.GPTConfig, max_new_tokens: int) -> int:
    """Prompts are cut to 256 tokens and to what the position table leaves
    after the new tokens (tpukit `sampling.py:223-229`)."""
    max_prompt = min(256, cfg.max_position_embeddings - max_new_tokens)
    if max_prompt < 1:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} leaves no room for a prompt "
            f"within max_position_embeddings={cfg.max_position_embeddings}"
        )
    return max_prompt


def generate(params, cfg: gpt.GPTConfig, prompt: str, tokenizer, max_new_tokens: int = 20,
             use_cache: bool | None = None, temperature: float = 0.0, top_k: int = 0,
             seed: int = 0) -> str:
    """A continuation of `prompt` (twin of `tpukit/sampling.py:202`), on
    the device the parameters are on. Greedy by default; `temperature > 0`
    samples (optionally `top_k`-truncated) under `seed`. `use_cache` None
    picks the cached loop for buffers of 512 positions and up where it is
    exact, as tpukit does."""
    dev = _params_device(params)
    encoded = tokenizer([prompt], truncation=True,
                        max_length=_max_prompt(cfg, max_new_tokens))
    ids = np.asarray(encoded["input_ids"][0], dtype=np.int32)
    prompt_len = int(ids.shape[0])
    buf = torch.zeros((1, prompt_len + max_new_tokens), dtype=torch.int32, device=dev)
    buf[0, :prompt_len] = torch.from_numpy(ids).to(dev)
    if use_cache is None:
        use_cache = buf.shape[1] >= 512 and _cached_decode_exact(cfg)
    rng = tk_random.PRNGKey(seed, device=dev) if temperature > 0.0 else None
    loop = _decode_loop_cached if use_cache else _decode_loop
    # top_k beyond the logits width is clamped, as tpukit clamps it
    buf, length = loop(params, cfg, buf, prompt_len, int(tokenizer.eos_token_id),
                       temperature=float(temperature),
                       top_k=min(int(top_k), cfg.padded_vocab_size), rng=rng)
    return tokenizer.decode(buf[0, :length].cpu().numpy(), skip_special_tokens=True)


def generate_batch(params, cfg: gpt.GPTConfig, prompts: list[str], tokenizer,
                   max_new_tokens: int = 20, temperature: float = 0.0, top_k: int = 0,
                   seed: int = 0) -> list[str]:
    """Continuations of every prompt in one batched decode (twin of
    `tpukit/sampling.py:271`): prompts right-padded into `[N, max_prompt +
    max_new_tokens]`, one full-width prefill, then one-token ring-cached
    steps (`serve.decode.decode_loop`). Every row shares the key of `seed`
    and folds its own cursor, so each decodes as `generate(...,
    seed=seed)` would."""
    from tpukit_torch.serve.decode import decode_loop

    if not prompts:
        return []
    dev = _params_device(params)
    encoded = tokenizer(list(prompts), truncation=True,
                        max_length=_max_prompt(cfg, max_new_tokens))
    ids = [np.asarray(row, dtype=np.int32) for row in encoded["input_ids"]]
    lens = np.asarray([r.shape[0] for r in ids], dtype=np.int32)
    host = np.zeros((len(ids), int(lens.max()) + max_new_tokens), dtype=np.int32)
    for r, row in enumerate(ids):
        host[r, : row.shape[0]] = row
    rng = tk_random.PRNGKey(seed, device=dev) if temperature > 0.0 else None
    buf, lengths = decode_loop(
        params, cfg, torch.from_numpy(host).to(dev), torch.from_numpy(lens).to(dev),
        max_new_tokens, int(tokenizer.eos_token_id), temperature=float(temperature),
        top_k=min(int(top_k), cfg.padded_vocab_size), rng=rng,
    )
    buf, lengths = buf.cpu().numpy(), lengths.cpu().numpy()
    return [tokenizer.decode(buf[r, : int(lengths[r])], skip_special_tokens=True)
            for r in range(buf.shape[0])]
