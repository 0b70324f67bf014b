"""Speculative decoding on the ring engine (twin of `tpukit/serve/spec.py`).

A proposer guesses up to k tokens a slot, either a small draft GPT with
its own KV ring (`draft_propose`) or the slot's own history
(`_ngram_propose_row`, prompt lookup: the longest recurring suffix and
what followed it). The target then scores the k + 1 positions `[last
emitted, d_0 .. d_{k-1}]` in one forward (`verify_step`), the chunked
shape the ring's per-row cursors already take, and keeps a per-slot
prefix:

  - greedy: a draft token is accepted iff it is the target's argmax; the
    first mismatch is replaced by that argmax, so the tokens are vanilla
    decoding's;
  - sampled: rejection sampling, accept d with probability min(1,
    p(d)/q(d)) (p the target's distribution through
    `sampling._adjust_logits`, the one vanilla sampling draws from; q the
    proposal's, one-hot for the n-gram proposer), the first rejection
    resampled from norm(max(p - q, 0)), a bonus token from p when every
    draft survives. Each emitted token is an exact p-sample.

`_accept_prefix` is that acceptance, one spelling for the engine's batch
and for the serial reference (`reference_spec_decode`). Its draws are
position-keyed off the request's key and salted *after* the position,
`fold_in(fold_in(key, pos), _SALT_ACCEPT)` for the accept uniforms and
`_SALT_FIX` for the correction, so they never meet `_sample_next`'s
unsalted `fold_in(key, pos)`, which the draft model samples with.

Rollback costs nothing on the ring: the verify writes K/V for positions
`[cur - 1, cur - 1 + k]` before it attends, and attention reads only
`key_pos <= q_pos`, so rejected positions hold stale K/V above the new
cursor that nothing reads before the next verify rewrites them. The ring
carries `spec_k` scratch positions past the slot width
(`ServeConfig.kv_width`) so a window near the end is written whole. The
draft's ring can miss the K/V of the two last emitted tokens after a
quantum (the k-th proposal and the bonus), so `draft_propose` starts with
a two-token catch-up window.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukit_torch import random as tk_random
from tpukit_torch.model import gpt
from tpukit_torch.sampling import _adjust_logits, _sample_next
from tpukit_torch.serve import decode as serve_decode

# salts of the accept uniforms and of the correction draw (tpukit
# spec.py:102-103), folded in after the position
_SALT_ACCEPT = 0x5AC
_SALT_FIX = 0x5AF

_TINY = 1e-30  # guards p/q ratios and log(0); never changes an accept


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`x[..., idx]` along the last axis, one index a row."""
    return x.gather(-1, idx.long()[..., None])[..., 0]


def _accept_prefix(logits, draft, q_probs, draft_len, key, cursor, temperature: float,
                   top_k: int):
    """The acceptance of one verify window a slot (twin of
    `tpukit/serve/spec.py:108`), batched over slots: `logits [N, k+1, V]`
    f32 target logits (position j predicts the token at `cursor + j`),
    `draft [N, k]`, `q_probs [N, k, V]` the proposal distribution (one-hot
    rows for a deterministic proposer), `draft_len [N]` in `[0, k]`
    (positions from it on are padding, never accepted), `key [N, 2]`,
    `cursor [N]`.

    Returns `(accepted [N], tokens [N, k+1])`: `tokens` holds the accepted
    draft tokens in `[0, accepted)` and the corrected or bonus target
    sample at `accepted`. With `draft_len` 0 it emits one target sample, a
    vanilla step."""
    n, k = draft.shape
    dev = logits.device
    i = torch.arange(k, dtype=torch.int64, device=dev)
    cursor = cursor.long()
    if temperature > 0.0:
        p = torch.softmax(_adjust_logits(logits, temperature, top_k), dim=-1)
        pos = cursor[:, None] + i  # [N, k]
        u_key = tk_random.fold_in(tk_random.fold_in(key[:, None, :], pos), _SALT_ACCEPT)
        u = tk_random.uniform(u_key)  # [N, k]
        p_d = _gather_last(p[:, :k], draft)
        q_d = _gather_last(q_probs, draft)
        # accept iff u < min(1, p/q)  <=>  u * q < p
        ok = (i < draft_len[:, None]) & (u * torch.clamp(q_d, min=_TINY) < p_d)
        accepted = torch.cumprod(ok.long(), dim=1).sum(1)
        rows = torch.arange(n, device=dev)
        p_next = p[rows, accepted]  # [N, V], the target at the correction slot
        rejected = accepted < draft_len
        q_row = q_probs[rows, torch.clamp(accepted, max=k - 1)] if k else torch.zeros_like(
            p_next)
        resid = torch.clamp(p_next - q_row, min=0.0)
        rsum = resid.sum(-1, keepdim=True)
        # an empty residual (p == q to the ulp) falls back to p itself
        use_resid = (rejected[:, None] & (rsum > 0.0))
        dist = torch.where(use_resid, resid / torch.clamp(rsum, min=_TINY), p_next)
        fix_key = tk_random.fold_in(tk_random.fold_in(key, cursor + accepted), _SALT_FIX)
        fix_logits = torch.where(dist > 0.0, torch.log(torch.clamp(dist, min=_TINY)),
                                 torch.full_like(dist, float("-inf")))
        fix = tk_random.categorical(fix_key, fix_logits)
    else:
        am = torch.argmax(logits, dim=-1)  # [N, k+1]
        ok = (i < draft_len[:, None]) & (draft.long() == am[:, :k])
        accepted = torch.cumprod(ok.long(), dim=1).sum(1)
        fix = _gather_last(am, accepted)
    dpad = torch.cat([draft.long(), draft[:, -1:].long()], dim=1) if k else fix[:, None]
    j = torch.arange(k + 1, device=dev)
    tokens = torch.where(j < accepted[:, None], dpad, fix[:, None])
    return accepted, tokens.to(torch.int32)


def _verify_body(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits, keys,
                 draft, draft_q, draft_len, eos_id: int, temperature: float, top_k: int,
                 k: int):
    """The verify quantum (twin of `tpukit/serve/spec.py:171`), shared by
    `verify_step` and `spec_ngram_step`: forward the window, accept a
    prefix a slot, and append under the vanilla per-token gates (stop
    before appending EOS, stop at the limit, inactive lanes frozen).
    `draft_q` None means one-hot proposals. Returns `(buf, cache, cursors,
    active, accepted, appended)`; the state tensors change in place."""
    n, total = buf.shape
    dev = buf.device
    read = (cursors - 1).clamp(0, total - 1)
    last_tok = buf.gather(1, read[:, None].long())
    toks = torch.cat([last_tok, draft.to(buf.dtype)], dim=1)
    pos = read[:, None] + torch.arange(k + 1, dtype=read.dtype, device=dev)
    logits = serve_decode.forward_slots(params, cfg, toks, pos, cache, read)
    lg = logits.float()  # [N, k+1, V]
    q = (torch.nn.functional.one_hot(draft.long(), lg.shape[-1]).float()
         if draft_q is None else draft_q)
    accepted, cand = _accept_prefix(lg, draft, q, draft_len.long(), keys, cursors,
                                    temperature, top_k)
    j = torch.arange(k + 1, device=dev)[None, :]
    can = active[:, None] & (j <= accepted[:, None])
    fits = (cursors.long()[:, None] + j) < limits.long()[:, None]
    is_eos = cand == eos_id
    eos_before = torch.cumsum(is_eos.long(), dim=1) - is_eos.long()
    append = can & fits & (eos_before == 0) & ~is_eos
    eos_hit = (can & fits & (eos_before == 0) & is_eos).any(1)
    n_app = append.long().sum(1)
    # `append` is a prefix of the window: write [cursor, cursor + n_app)
    col = torch.arange(total, device=dev)[None, :]
    rel = col - cursors.long()[:, None]
    sel = (rel >= 0) & (rel < n_app[:, None])
    vals = cand.gather(1, rel.clamp(0, k))
    buf.copy_(torch.where(sel, vals.to(buf.dtype), buf))
    cursors.add_(n_app.to(cursors.dtype))
    active.copy_(active & ~eos_hit & (cursors < limits))
    return buf, cache, cursors, active, accepted, n_app


@torch.no_grad()
def verify_step(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits, keys,
                draft, draft_q, draft_len, eos_id: int, temperature: float = 0.0,
                top_k: int = 0, *, k: int):
    """One speculative quantum for every slot with an external proposal
    (twin of `tpukit/serve/spec.py:239`): `draft [N, k]`, `draft_len [N]`,
    `draft_q [N, k, V]` (None for one-hot). Returns `(buf, cache, cursors,
    active, accepted, appended)`."""
    return _verify_body(params, cfg, buf, cache, cursors, active, limits, keys, draft,
                        draft_q, draft_len, eos_id, temperature, top_k, k)


def _ngram_propose_row(h: torch.Tensor, cur: torch.Tensor, *, k: int, max_ngram: int):
    """The n-gram proposal of every slot (twin of `tpukit/serve/spec.py:269`,
    batched over rows `h [N, W]` at cursors `cur [N]`), the same proposal
    as `NGramProposer.propose`: the longest suffix first (`max_ngram` down
    to 1), its most recent earlier occurrence, then the continuation
    wrapping with the implied period `s`, `h[cur - s + (i mod s)]`. Returns
    `(draft [N, k] int32, dlen [N] int32)`, dlen 0 where no n-gram
    recurs."""
    n, w = h.shape
    dev = h.device
    h = h.long()
    cur = cur.long()[:, None]  # [N, 1]
    pos = torch.arange(w, device=dev)[None, :]
    # shifts[i][:, j] == h[:, j + i], zero past the end (never consulted)
    shifts = [h if i == 0 else torch.cat([h[:, i:], torch.zeros_like(h[:, :i])], dim=1)
              for i in range(max_ngram)]
    found_n = torch.zeros((n, 1), dtype=torch.long, device=dev)
    found_j = torch.full((n, 1), -1, dtype=torch.long, device=dev)
    for m in range(max_ngram, 0, -1):  # longest first
        # an earlier occurrence, j < cur - m, and a suffix that fits, m < cur
        ok = (pos < cur - m) & (m <= cur - 1)
        for i in range(m):
            sfx_i = h.gather(1, (cur - m + i).clamp(0, w - 1))
            ok = ok & (shifts[i] == sfx_i)
        j_m = torch.where(ok, pos, torch.full_like(pos, -1)).amax(1, keepdim=True)
        take = (found_j < 0) & (j_m >= 0)
        found_n = torch.where(take, torch.full_like(found_n, m), found_n)
        found_j = torch.where(take, j_m, found_j)
    s = torch.clamp((cur - found_n) - found_j, min=1)  # the implied period
    idx = cur - s + (torch.arange(k, device=dev)[None, :] % s)  # all < cur
    # an index outside the row (no match) proposes 0, as tpukit's masked
    # sum does: the padding is forwarded in the verify window, and under a
    # capacity MoE dispatch what a forward sees sets its capacity windows
    inside = (idx >= 0) & (idx < w)
    draft = torch.where(inside, h.gather(1, idx.clamp(0, w - 1)), torch.zeros_like(idx))
    dlen = torch.where(found_j[:, 0] >= 0, k, 0)
    return draft.to(torch.int32), dlen.to(torch.int32)


@torch.no_grad()
def spec_ngram_step(params, cfg: gpt.GPTConfig, buf, cache, cursors, active, limits, keys,
                    eos_id: int, temperature: float = 0.0, top_k: int = 0, *, k: int,
                    max_ngram: int = 3):
    """Self-speculation (twin of `tpukit/serve/spec.py:320`): the n-gram
    proposal of every slot from its buffer row, then the verify with
    one-hot proposals. Returns `verify_step`'s tuple plus `dlen [N]`."""
    draft, dlen = _ngram_propose_row(buf, cursors, k=k, max_ngram=max_ngram)
    out = _verify_body(params, cfg, buf, cache, cursors, active, limits, keys, draft, None,
                       dlen, eos_id, temperature, top_k, k)
    return out + (dlen,)


@torch.no_grad()
def draft_propose(params, cfg: gpt.GPTConfig, buf, cache, cursors, keys, *, k: int,
                  temperature: float = 0.0, top_k: int = 0):
    """The draft model's proposal (twin of `tpukit/serve/spec.py:351`): k
    tokens a slot from the draft's own ring, each sampled with
    `_sample_next` under the slot's key at its position (the unsalted
    fold: what a vanilla decode of the draft would emit). It opens with the
    two-token catch-up window `buf[cur - 2], buf[cur - 1]`, which rewrites
    the K/V a previous quantum may have left missing. Returns `(draft [N,
    k] int32, q_probs [N, k, V] f32, cache)`: q rows are
    `softmax(_adjust_logits(.))` when sampling, one-hot at the argmax when
    greedy."""
    n, total = buf.shape
    dev = buf.device
    read = (cursors - 1).clamp(0, total - 1)
    prev = (cursors - 2).clamp(0, total - 1)
    t2 = torch.stack([buf.gather(1, prev[:, None].long())[:, 0],
                      buf.gather(1, read[:, None].long())[:, 0]], dim=1)
    pos2 = torch.stack([prev, read], dim=1)
    logits, _ = gpt.forward_cached(params, cfg, t2, pos2, cache, prev)
    v = cfg.padded_vocab_size
    toks = torch.zeros((n, k), dtype=torch.int32, device=dev)
    qs = torch.zeros((n, k, v), dtype=torch.float32, device=dev)

    def sample(last, i):
        if temperature > 0.0:
            qp = torch.softmax(_adjust_logits(last, temperature, top_k), dim=-1)
            nxt = _sample_next(last, cursors.long() + i, keys, temperature, top_k)
        else:
            nxt = torch.argmax(last, dim=-1)
            qp = torch.nn.functional.one_hot(nxt, v).float()
        return nxt.to(torch.int32), qp

    toks[:, 0], qs[:, 0] = sample(logits[:, -1].float(), 0)
    for i in range(1, k):
        p = read + i
        logits, _ = gpt.forward_cached(params, cfg, toks[:, i - 1: i], p[:, None], cache, p)
        toks[:, i], qs[:, i] = sample(logits[:, -1].float(), i)
    return toks, qs, cache


class NGramProposer:
    """Self-speculation on the host (twin of `tpukit/serve/spec.py:419`):
    for a history `h`, the most recent earlier occurrence of the longest
    current suffix (length `max_ngram` down to 1) and the `k` tokens that
    followed it, wrapping back by the implied period past the end. Its
    proposals are one-hot."""

    def __init__(self, k: int, max_ngram: int = 3):
        if k < 1 or max_ngram < 1:
            raise ValueError(
                f"NGramProposer needs k >= 1 and max_ngram >= 1 "
                f"(got k={k}, max_ngram={max_ngram})"
            )
        self.k = k
        self.max_ngram = max_ngram

    def propose(self, history) -> list[int]:
        """Up to `k` proposed tokens (empty when no n-gram recurs)."""
        h = np.asarray(history)
        m = len(h)
        for n in range(min(self.max_ngram, m - 1), 0, -1):
            suffix = h[m - n:]
            starts = np.flatnonzero(h[: m - n] == suffix[0])
            for j in starts[::-1]:  # most recent first
                if j + n < m and np.array_equal(h[j : j + n], suffix):
                    s = (m - n) - j  # the implied repetition period
                    out = []
                    for i in range(self.k):
                        pos = j + n + i
                        while pos >= m:
                            pos -= s
                        out.append(int(h[pos]))
                    return out
        return []


@torch.no_grad()
def reference_spec_decode(params, cfg: gpt.GPTConfig, ids, max_new: int, eos_id: int, *,
                          k: int, draft: str = "ngram", draft_params=None, draft_cfg=None,
                          temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                          max_ngram: int = 3, device=None):
    """Serial speculative decoding of one request (twin of
    `tpukit/serve/spec.py:476`): a host loop over scalar-start ring
    forwards, the host `NGramProposer` or a serial draft model, and the
    same `_accept_prefix` and key streams. The engine's batched output
    must equal it token for token. Returns prompt + generated ids."""
    dev = params["lm_head"]["kernel"].device if device is None else torch.device(device)
    ids = np.asarray(ids, np.int32)
    plen = len(ids)
    total = plen + max_new + k  # + the verify scratch tail
    buf = np.zeros((total,), np.int32)
    buf[:plen] = ids
    key = tk_random.PRNGKey(seed, device=dev)[None]
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)

    def prefill(p, c, pcfg):
        if plen > 1:
            pos = torch.arange(plen - 1, dtype=torch.int32, device=dev)[None, :]
            gpt.forward_cached(p, pcfg, t(buf[None, : plen - 1]), pos, c, 0)
        return c

    cache = prefill(params, gpt.init_kv_cache(cfg, 1, total, device=dev), cfg)
    if draft == "ngram":
        proposer = NGramProposer(k, max_ngram=max_ngram)
    elif draft == "model":
        d_cache = prefill(draft_params, gpt.init_kv_cache(draft_cfg, 1, total, device=dev),
                          draft_cfg)
    else:
        raise ValueError(f"draft must be 'ngram' or 'model', got {draft!r}")
    v = cfg.padded_vocab_size
    cur = plen
    limit = plen + max_new
    active = cur < limit
    while active:
        if draft == "ngram":
            prop = proposer.propose(buf[:cur])
            dlen = len(prop)
            d = np.zeros((k,), np.int32)
            d[:dlen] = prop
            q = None
        else:
            # the two-token catch-up window, then one tick a proposal
            d_list, q_list = [], []
            pv = max(cur - 2, 0)
            lg, _ = gpt.forward_cached(
                draft_params, draft_cfg, t([[buf[pv], buf[cur - 1]]]),
                t(np.asarray([[pv, cur - 1]], np.int32)), d_cache, pv)
            for i in range(k):
                if i > 0:
                    p = cur - 1 + i
                    lg, _ = gpt.forward_cached(
                        draft_params, draft_cfg, t(np.asarray([[d_list[-1]]], np.int32)),
                        t(np.asarray([[p]], np.int32)), d_cache, p)
                last = lg[0, -1].float()
                if temperature > 0.0:
                    qp = torch.softmax(_adjust_logits(last, temperature, top_k), dim=-1)
                    nxt = int(_sample_next(last, cur + i, key[0], temperature, top_k))
                else:
                    nxt = int(torch.argmax(last))
                    qp = torch.nn.functional.one_hot(torch.tensor(nxt, device=dev), v).float()
                d_list.append(nxt)
                q_list.append(qp)
            dlen = k
            d = np.asarray(d_list, np.int32)
            q = torch.stack(q_list)[None]
        window = np.concatenate([[buf[cur - 1]], d]).astype(np.int32)
        pos = torch.arange(cur - 1, cur + k, dtype=torch.int32, device=dev)[None, :]
        lg, _ = gpt.forward_cached(params, cfg, t(window[None, :]), pos, cache, cur - 1)
        dt = t(d[None, :].astype(np.int64))
        if q is None:
            q = torch.nn.functional.one_hot(dt, v).float()
        accepted, cand = _accept_prefix(
            lg.float(), dt, q, t(np.asarray([dlen])), key, t(np.asarray([cur])),
            temperature, top_k)
        accepted, cand = int(accepted[0]), cand[0].cpu().numpy()
        for j in range(accepted + 1):  # the vanilla per-token gates
            if cur >= limit:
                active = False
                break
            tok = int(cand[j])
            if tok == eos_id:  # stop before appending
                active = False
                break
            buf[cur] = tok
            cur += 1
        if cur >= limit:
            active = False
    return buf[:cur]
