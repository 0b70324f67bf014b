"""The port's samplers (`tpukit_torch/sampling.py`) and the ring KV cache
against tpukit's, on the CPU, at f32 on tpukit's weights (bridged).

Bars: the ring `forward_cached` logits within atol 1e-5 (XLA and torch
sum in other orders); token streams identical, greedy and sampled
(`temperature` 0.8, `top_k` 0 and 5): `generate` through the naive and the
ring-cached loop, `generate_batch`, and the ring's `prefill_slots` +
`decode_step` and `decode_loop`. Sampled tokens come from the same
threefry bits; the Gumbel noise agrees to ~1e-6 (tests/test_torch_random.py),
far inside the margins these seeds draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit import sampling as tk_sampling
from tpukit.data import WordTokenizer as JaxWordTokenizer
from tpukit.data import synthetic_stories as jax_synthetic_stories
from tpukit.model import GPTConfig as JaxConfig
from tpukit.model import gpt as jax_gpt
from tpukit.serve import decode as jax_decode
from tpukit_torch import bridge, sampling
from tpukit_torch import random as tr
from tpukit_torch.data import WordTokenizer, synthetic_stories
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.serve import decode
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PROMPTS = ["The big brown cat ", "One day, ", "She said "]
SAMPLED = [(0.0, 0), (0.8, 0), (0.8, 5)]
IDS = ["greedy", "t0.8", "t0.8-top5"]


@pytest.fixture(scope="module")
def setup():
    jtok, ttok = JaxWordTokenizer(jax_synthetic_stories(64)), WordTokenizer(synthetic_stories(64))
    kw = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=jtok.vocab_size,
              max_position_embeddings=64)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **kw)
    tcfg = GPTConfig(compute_dtype=torch.float32, **kw)
    jp = jax_gpt.init_params(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jtok, ttok, jcfg, tcfg, jp, tp


@pytest.mark.parametrize("start", ["scalar", "vector"])
def test_ring_forward_cached_matches_tpukit(setup, start):
    """A 5-token prefill then a 3-token chunk on a ring of width 16 (the
    vector case puts each row at its own offset, one of them clamped at the
    ring's end): logits and the ring within atol 1e-5."""
    _, _, jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(1)
    ids = rng.randint(3, jcfg.vocab_size, (3, 8)).astype(np.int32)
    jc = jax_gpt.init_kv_cache(jcfg, 3, 16)
    tc = gpt.init_kv_cache(tcfg, 3, 16, device="cpu")
    t = torch.from_numpy
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (3, 5)).copy()
    _, jc = jax_gpt.forward_cached(jp, jcfg, ids[:, :5], pos, jc, 0)
    gpt.forward_cached(tp, tcfg, t(ids[:, :5]), t(pos), tc, 0)
    if start == "scalar":
        s = 5
        pos2 = np.broadcast_to(np.arange(5, 8, dtype=np.int32), (3, 3)).copy()
        js, ts = 5, 5
    else:
        s = np.asarray([5, 2, 14], np.int32)
        pos2 = s[:, None] + np.arange(3, dtype=np.int32)
        js, ts = jnp.asarray(s), t(s)
    jl, jc = jax_gpt.forward_cached(jp, jcfg, ids[:, 5:], pos2, jc, js)
    tl, tc = gpt.forward_cached(tp, tcfg, t(ids[:, 5:].copy()), t(pos2), tc, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_cache", [False, True], ids=["naive", "cached"])
@pytest.mark.parametrize("temperature,top_k", SAMPLED, ids=IDS)
def test_generate_matches_tpukit(setup, use_cache, temperature, top_k):
    jtok, ttok, jcfg, tcfg, jp, tp = setup
    kw = dict(max_new_tokens=12, use_cache=use_cache, temperature=temperature, top_k=top_k,
              seed=3)
    want = tk_sampling.generate(jp, jcfg, PROMPTS[0], jtok, **kw)
    assert sampling.generate(tp, tcfg, PROMPTS[0], ttok, **kw) == want


@pytest.mark.parametrize("temperature,top_k", SAMPLED, ids=IDS)
def test_generate_batch_matches_tpukit_and_serial(setup, temperature, top_k):
    """`generate_batch` equals tpukit's, and each row equals the port's own
    serial cached `generate` of that prompt under the same seed."""
    jtok, ttok, jcfg, tcfg, jp, tp = setup
    kw = dict(max_new_tokens=12, temperature=temperature, top_k=top_k, seed=5)
    want = tk_sampling.generate_batch(jp, jcfg, PROMPTS, jtok, **kw)
    got = sampling.generate_batch(tp, tcfg, PROMPTS, ttok, **kw)
    assert got == want
    serial = [sampling.generate(tp, tcfg, p, ttok, use_cache=True, **kw) for p in PROMPTS]
    assert got == serial


@pytest.mark.parametrize("temperature,top_k", SAMPLED[::2], ids=IDS[::2])
def test_ring_prefill_and_decode_step_match_tpukit(setup, temperature, top_k):
    """`prefill_slots` admits two requests into slots 2 and 0 of a 3-slot
    ring (padded to an admit batch of 2), then `decode_step` runs quanta of
    3 ticks, a third request joining slot 1 after the first: buffers,
    cursors and `active` equal tpukit's after every dispatch."""
    _, _, jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(2)
    n, w, bucket = 3, 24, 8
    state_j = [jnp.zeros((n, w), jnp.int32), jax_gpt.init_kv_cache(jcfg, n, w),
               jnp.zeros((n,), jnp.int32), jnp.zeros((n,), bool), jnp.zeros((n,), jnp.int32),
               jnp.zeros((n, 2), jnp.uint32)]
    state_t = [torch.zeros((n, w), dtype=torch.int32), gpt.init_kv_cache(tcfg, n, w, "cpu"),
               torch.zeros((n,), dtype=torch.int32), torch.zeros((n,), dtype=torch.bool),
               torch.zeros((n,), dtype=torch.int32), torch.zeros((n, 2), dtype=torch.int64)]

    def admit(slots, plens, seeds):
        rows = np.zeros((len(slots), bucket), np.int32)
        for i, p in enumerate(plens):
            rows[i, :p] = rng.randint(3, jcfg.vocab_size, p)
        lims = np.asarray(plens, np.int32) + 10
        keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])
        args = [np.asarray(slots, np.int32), rows, np.asarray(plens, np.int32), lims]
        state_j[:] = jax_decode.prefill_slots(jp, jcfg, *state_j, *map(jnp.asarray, args),
                                              jnp.asarray(keys))
        decode.prefill_slots(tp, tcfg, *state_t, *map(torch.from_numpy, args),
                             tr.as_key(keys))

    def step():
        state_j[:4] = jax_decode.decode_step(jp, jcfg, *state_j, eos_id=1,
                                             temperature=temperature, top_k=top_k, steps=3)
        state_t[:4] = decode.decode_step(tp, tcfg, *state_t, eos_id=1,
                                         temperature=temperature, top_k=top_k, steps=3)

    def check():
        for i in (0, 2, 3):
            np.testing.assert_array_equal(state_t[i].numpy(), np.asarray(state_j[i]))

    admit([2, 0], [5, 7], [11, 12])
    check()
    step()
    check()
    admit([1, 1], [3, 3], [13, 13])  # one request, repeated to a batch of 2
    for _ in range(3):
        step()
        check()


@pytest.mark.parametrize("temperature,top_k", SAMPLED[1:], ids=IDS[1:])
def test_decode_loop_matches_tpukit(setup, temperature, top_k):
    """`decode_loop` over ragged prompts with a shared key: buffer and
    lengths equal tpukit's."""
    _, _, jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(3)
    lens = np.asarray([3, 9, 6, 1], np.int32)
    buf = np.zeros((4, 9 + 10), np.int32)
    for r, p in enumerate(lens):
        buf[r, :p] = rng.randint(3, jcfg.vocab_size, p)
    jb, jl = jax_decode.decode_loop(jp, jcfg, jnp.asarray(buf), jnp.asarray(lens), 10, 1,
                                    temperature=temperature, top_k=top_k,
                                    rng=jax.random.PRNGKey(8))
    tb, tl = decode.decode_loop(tp, tcfg, torch.from_numpy(buf.copy()), torch.from_numpy(lens),
                                10, 1, temperature=temperature, top_k=top_k,
                                rng=tr.PRNGKey(8))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_adjust_logits_keeps_ties_with_the_kth():
    """The top-k mask compares values: every logit tied with the k-th
    largest survives, as tpukit's `scaled < kth` keeps it."""
    last = np.asarray([[1.0, 3.0, 2.0, 2.0, 0.5, 2.0]], np.float32)
    want = np.asarray(tk_sampling._adjust_logits(jnp.asarray(last), 0.5, 2))
    got = sampling._adjust_logits(torch.from_numpy(last), 0.5, 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum() == 4
