"""The port's speculative decoding (`tpukit_torch/serve/spec.py`) against
tpukit's, on the CPU, at f32 on tpukit's weights (bridged).

Bars: `_accept_prefix` gives tpukit's accepted count and correction token
on the same logits, drafts and keys (greedy and sampled; a zero-length
draft, every draft rejected, every draft accepted); the n-gram proposals
equal tpukit's host `NGramProposer` at every cursor; the speculative
engines' token streams equal tpukit's engine's, and greedy speculation
equals vanilla decoding; the port's serial `reference_spec_decode` equals
its engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.data import WordTokenizer as JaxWordTokenizer
from tpukit.data import synthetic_stories as jax_synthetic_stories
from tpukit.model import GPTConfig as JaxConfig
from tpukit.model import gpt as jax_gpt
from tpukit.serve import ServeConfig as JaxServeConfig
from tpukit.serve import ServeEngine as JaxServeEngine
from tpukit.serve import spec as jax_spec
from tpukit.serve import synthetic_request_stream as jax_stream
from tpukit_torch import bridge
from tpukit_torch import random as tr
from tpukit_torch.model import GPTConfig
from tpukit_torch.serve import spec
from tpukit_torch.serve.engine import ServeConfig, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

K = 4
V = 50


def _accept_inputs(case, temperature, seed=0):
    rng = np.random.RandomState(seed)
    n = 6
    logits = (rng.randn(n, K + 1, V) * 2).astype(np.float32)
    q_logits = logits[:, :K] + rng.randn(n, K, V).astype(np.float32)
    q = np.exp(q_logits - q_logits.max(-1, keepdims=True))
    q = (q / q.sum(-1, keepdims=True)).astype(np.float32)
    draft = q.argmax(-1).astype(np.int32)
    dlen = rng.randint(0, K + 1, n).astype(np.int32)
    if case == "no_draft":
        dlen[:] = 0
    elif case == "all_accept":
        draft = logits[:, :K].argmax(-1).astype(np.int32)
        dlen[:] = K
        if temperature > 0:
            q = np.eye(V, dtype=np.float32)[draft]
            logits[np.arange(n)[:, None], np.arange(K)[None, :], draft] += 50.0
    elif case == "all_reject":
        # drafts outside the target's top 5: p(d) is 0 after the top-k mask,
        # and never the argmax
        draft = logits[:, :K].argsort(-1)[..., 0].astype(np.int32)
        dlen[:] = K
    keys = np.stack([np.asarray(jax.random.PRNGKey(100 + i)) for i in range(n)])
    cursor = rng.randint(1, 40, n).astype(np.int32)
    return logits, draft, q, dlen, keys, cursor


@pytest.mark.parametrize("case", ["mixed", "no_draft", "all_accept", "all_reject"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
def test_accept_prefix_matches_tpukit(case, temperature):
    logits, draft, q, dlen, keys, cursor = _accept_inputs(case, temperature)
    top_k = 5 if temperature > 0 else 0
    fn = lambda *a: jax_spec._accept_prefix(*a, temperature=temperature, top_k=top_k)
    ja, jt = jax.vmap(fn)(jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(q),
                          jnp.asarray(dlen), jnp.asarray(keys), jnp.asarray(cursor))
    t = torch.from_numpy
    ta, tt = spec._accept_prefix(t(logits), t(draft), t(q), t(dlen).long(), tr.as_key(keys),
                                 t(cursor), temperature, top_k)
    ja, jt = np.asarray(ja), np.asarray(jt)
    np.testing.assert_array_equal(ta.numpy(), ja)
    for r in range(len(ja)):  # tokens up to and including the correction
        np.testing.assert_array_equal(tt[r, : ja[r] + 1].numpy(), jt[r, : ja[r] + 1])
    if case == "all_accept":
        assert (ja == K).all()
    if case in ("no_draft", "all_reject"):
        assert (ja == 0).all()


def test_ngram_proposals_match_tpukit():
    """The batched device proposal against tpukit's host proposer (and the
    port's copy of it) at every cursor of random small-vocabulary rows and
    of crafted periodic ones."""
    rng = np.random.RandomState(0)
    rows = [rng.randint(0, 4, 40) for _ in range(6)]
    rows += [np.tile([5, 6, 7], 14)[:40], np.tile([9], 40), np.arange(40)]
    h = np.stack(rows).astype(np.int32)
    for max_ngram in (1, 3):
        ref = jax_spec.NGramProposer(K, max_ngram)
        ours = spec.NGramProposer(K, max_ngram)
        for cur in range(1, 41):
            curs = torch.full((len(h),), cur, dtype=torch.int32)
            draft, dlen = spec._ngram_propose_row(torch.from_numpy(h), curs, k=K,
                                                  max_ngram=max_ngram)
            for r in range(len(h)):
                want = ref.propose(h[r, :cur])
                assert ours.propose(h[r, :cur]) == want
                assert int(dlen[r]) == len(want), (r, cur)
                assert draft[r, : len(want)].tolist() == want, (r, cur)


@pytest.fixture(scope="module")
def setup():
    tok = JaxWordTokenizer(jax_synthetic_stories(64))
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=96)
    jcfg = JaxConfig(dim=32, head_dim=8, heads=4, num_layers=2, compute_dtype=jnp.float32, **kw)
    tcfg = GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2, compute_dtype=torch.float32,
                     **kw)
    djcfg = JaxConfig(dim=16, head_dim=8, heads=2, num_layers=1, compute_dtype=jnp.float32, **kw)
    dtcfg = GPTConfig(dim=16, head_dim=8, heads=2, num_layers=1, compute_dtype=torch.float32,
                      **kw)
    jp = jax_gpt.init_params(jax.random.PRNGKey(1), jcfg)
    djp = jax_gpt.init_params(jax.random.PRNGKey(9), djcfg)
    to_t = lambda p: bridge.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    reqs = jax_stream(tok, 6, seed=3, max_new_tokens=10, buckets=(8, 16),
                      stream_profile="repetitive")
    return dict(tok=tok, jcfg=jcfg, tcfg=tcfg, djcfg=djcfg, dtcfg=dtcfg, jp=jp, tp=to_t(jp),
                djp=djp, dtp=to_t(djp), reqs=reqs, eos=int(tok.eos_token_id))


def _serve_kw(draft, temperature):
    return dict(slots=3, buckets=(8, 16), max_new_tokens=10, draft=draft, spec_k=3,
                temperature=temperature, top_k=5 if temperature else 0)


def _port_run(s, serve_kw, draft_params=None, draft_cfg=None):
    eng = ServeEngine(s["tp"], s["tcfg"], ServeConfig(**serve_kw), eos_id=s["eos"],
                      device="cpu", draft_params=draft_params, draft_cfg=draft_cfg)
    return eng, {c.rid: np.asarray(c.ids) for c in eng.run(list(s["reqs"]))}


@pytest.mark.parametrize("draft", ["ngram", "model"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
def test_spec_engine_matches_tpukit(setup, draft, temperature):
    """The speculative engines on the repetitive stream: tokens and the
    proposal counters equal tpukit's; greedy, the tokens equal the port's
    vanilla ring decoding too."""
    s = setup
    kw = _serve_kw(draft, temperature)
    dj = dict(draft_params=s["djp"], draft_cfg=s["djcfg"]) if draft == "model" else {}
    dt = dict(draft_params=s["dtp"], draft_cfg=s["dtcfg"]) if draft == "model" else {}
    jeng = JaxServeEngine(s["jp"], s["jcfg"], JaxServeConfig(window_steps=8, **kw),
                          eos_id=s["eos"], **dj)
    want = {c.rid: np.asarray(c.ids) for c in jeng.run(list(s["reqs"]), max_wall_s=300)}
    teng, got = _port_run(s, kw, **dt)
    assert got.keys() == want.keys() == set(range(6))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")
    assert teng.last_summary["spec"] == jeng.last_summary["spec"]
    if temperature == 0.0:
        _, vanilla = _port_run(s, _serve_kw("", 0.0))
        for rid in want:
            np.testing.assert_array_equal(got[rid], vanilla[rid], err_msg=f"rid {rid}")


def test_self_draft_accepts_everything_and_matches_vanilla(setup):
    """The target as its own draft model, greedy: every proposal is accepted
    (each verify appends spec_k + 1 tokens until a limit), which runs the
    bonus token and the draft ring's two-token catch-up every quantum; the
    tokens equal vanilla decoding's."""
    s = setup
    eng, got = _port_run(s, _serve_kw("model", 0.0), draft_params=s["tp"], draft_cfg=s["tcfg"])
    _, vanilla = _port_run(s, _serve_kw("", 0.0))
    for rid in vanilla:
        np.testing.assert_array_equal(got[rid], vanilla[rid], err_msg=f"rid {rid}")
    sp = eng.last_summary["spec"]
    assert sp["accept_rate"] == 1.0 and sp["accepted_hist"][-1] > 0


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_reference_spec_decode_matches_engine(setup, draft):
    """The serial reference equals the batched engine per request, sampled
    (temperature 0.8, top-k 5)."""
    s = setup
    dt = dict(draft_params=s["dtp"], draft_cfg=s["dtcfg"]) if draft == "model" else {}
    _, got = _port_run(s, _serve_kw(draft, 0.8), **dt)
    for req in s["reqs"][:3]:
        ref = spec.reference_spec_decode(s["tp"], s["tcfg"], req.ids, 10, s["eos"], k=3,
                                         draft=draft, temperature=0.8, top_k=5, seed=req.seed,
                                         **dt)
        np.testing.assert_array_equal(ref, got[req.rid], err_msg=f"rid {req.rid}")
