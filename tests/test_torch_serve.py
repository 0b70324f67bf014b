"""The port's serving path against tpukit's, on the CPU.

tpukit's parameters go into the port through `bridge.params_from_numpy`,
so both sides serve the same weights. The bar: paged `forward_cached`
logits within atol 1e-5 in f32 (XLA and torch sum in other orders), and
greedy token streams through the two `ServeEngine`s identical per request
in f32, fused and unfused, on a pool tight enough to recycle pages and a
stream whose shared system prompt gives prefix hits. int8 pages are lossy
by construction and agree on >= 90% of tokens (tpukit's own gate,
tests/test_paged.py).
"""

import dataclasses

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
from tpukit.serve import paged as jax_paged
from tpukit.serve import synthetic_request_stream as jax_stream
from tpukit_torch import NotPortedError, bridge
from tpukit_torch.data import WordTokenizer, synthetic_stories
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.ops.moe_dispatch import ExpertGrid
from tpukit_torch.serve import paged
from tpukit_torch.serve.engine import ServeConfig, ServeEngine, synthetic_request_stream
from tpukit_torch.shardings import ExpertParallel

MAX_NEW = 10


@pytest.fixture(scope="module")
def tok():
    return JaxWordTokenizer(jax_synthetic_stories(64))


def _cfgs(vocab, head_dim=8):
    kw = dict(dim=32, head_dim=head_dim, heads=4, num_layers=2, vocab_size=vocab,
              max_position_embeddings=96)
    return JaxConfig(compute_dtype=jnp.float32, **kw), GPTConfig(compute_dtype=torch.float32, **kw)


def _params(jcfg, seed=1):
    jp = jax_gpt.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models(tok):
    jcfg, tcfg = _cfgs(tok.vocab_size)
    jp, tp = _params(jcfg)
    return jcfg, tcfg, jp, tp


def test_bridge_round_trips_tpukit_params(tiny_config, tiny_params):
    tree = jax.tree.map(np.asarray, tiny_params)
    tp = bridge.params_from_numpy(tree, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [k for k, _ in flat_j] == [k for k, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the port's own init draws the same tree, shapes and dtypes
    own = gpt.init_params(GPTConfig(
        dim=tiny_config.dim, head_dim=tiny_config.head_dim, heads=tiny_config.heads,
        num_layers=tiny_config.num_layers, vocab_size=tiny_config.vocab_size,
        max_position_embeddings=tiny_config.max_position_embeddings,
        compute_dtype=torch.float32), seed=0, device="cpu")
    flat_o = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), own))[0]
    assert [(k, v.shape) for k, v in flat_o] == [(k, v.shape) for k, v in flat_j]


def _filled_caches(jcfg, tcfg, kv, slots=4, page=8, mp=3, seed=3):
    """The same random pool contents on both sides (int8 via tpukit's
    quantizer), block tables 1..slots*mp."""
    num_pages = slots * mp + 1
    jc = jax_paged.init_paged_cache(jcfg, num_pages, page, mp, slots, kv)
    rng = np.random.RandomState(seed)
    bt = np.arange(1, num_pages, dtype=np.int32).reshape(slots, mp)
    jc["bt"] = jnp.asarray(bt)
    shape = jc["k"].shape
    for nm, snm in (("k", "ks"), ("v", "vs")):
        raw = (rng.randn(*shape) * 0.3).astype(np.float32)
        if kv == "int8":
            from tpukit.ops import quant_comm as jax_qc
            q, s = jax_qc.quantize_blocks(jnp.asarray(raw.reshape(*shape[:3], -1)))
            jc[nm], jc[snm] = q.reshape(shape), s
        else:
            jc[nm] = jnp.asarray(raw)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    return jc, tc


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("cdt,atol", [("f32", 1e-5), ("bf16", 6.25e-2)], ids=["f32", "bf16"])
def test_forward_cached_matches_tpukit(models, fused, cdt, atol):
    """One decode tick (T == 1) and one two-page prefill chunk through the
    paged forward: logits within 1e-5 in f32, pools (without the null page)
    too. bf16 compute (the serving default) keeps tpukit's cast points, so
    it is held to a few bf16 ulps at the logits' magnitude."""
    jcfg, tcfg, jp, tp = models
    jcfg = jcfg.replace(fused_decode=fused, compute_dtype={"f32": jnp.float32,
                                                           "bf16": jnp.bfloat16}[cdt])
    tcfg = tcfg.replace(fused_decode=fused, compute_dtype={"f32": torch.float32,
                                                           "bf16": torch.bfloat16}[cdt])
    jc, tc = _filled_caches(jcfg, tcfg, "f32")
    rng = np.random.RandomState(0)
    tok = rng.randint(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
    start = np.asarray([5, 1, 17, 23], np.int32)
    wm = np.asarray([True, True, True, False])  # one frozen lane
    lj, cj = jax_gpt.forward_cached(jp, jcfg, jnp.asarray(tok), jnp.asarray(start[:, None]),
                                    jc, jnp.asarray(start), write_mask=jnp.asarray(wm))
    lt, ct = gpt.forward_cached(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(start[:, None]),
                                tc, torch.from_numpy(start), write_mask=torch.from_numpy(wm))
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32),
                               atol=atol, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key][:, 1:].numpy(), np.asarray(cj[key])[:, 1:],
                                   atol=atol, rtol=0)
    # a prefill chunk of two pages at page-aligned starts (the unfused path)
    rows = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    starts = np.asarray([0, 8], np.int32)
    pos = starts[:, None] + np.arange(16, dtype=np.int32)
    sub_j = dict(cj, bt=cj["bt"][:2])
    sub_t = dict(ct, bt=ct["bt"][:2])
    lj, cj = jax_gpt.forward_cached(jp, jcfg, jnp.asarray(rows), jnp.asarray(pos), sub_j,
                                    jnp.asarray(starts))
    lt, ct = gpt.forward_cached(tp, tcfg, torch.from_numpy(rows), torch.from_numpy(pos),
                                sub_t, torch.from_numpy(starts))
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32),
                               atol=atol, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key][:, 1:].numpy(), np.asarray(cj[key])[:, 1:],
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("stop_when_freed", [3, 1 << 30], ids=["early_exit", "no_exit"])
def test_decode_loop_window_matches_tpukit(models, stop_when_freed):
    """The fused window's exit rules: lanes with limits 2..5 ticks away
    finish one after another; with `stop_when_freed` 3 the window stops
    once finished lanes hold 3 pages, else it runs until every lane is
    done. Ticks, freed pages and the buffers equal tpukit's on-device
    loop's."""
    from tpukit.serve import decode as jax_decode
    from tpukit_torch.serve import decode

    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = jcfg.replace(fused_decode=True), tcfg.replace(fused_decode=True)
    jc, tc = _filled_caches(jcfg, tcfg, "f32")
    rng = np.random.RandomState(5)
    buf = np.zeros((4, 24), np.int32)
    buf[:, :8] = rng.randint(3, jcfg.vocab_size, (4, 8))
    cursors = np.full((4,), 8, np.int32)
    limits = cursors + np.asarray([2, 5, 3, 4], np.int32)
    active = np.ones((4,), bool)
    held = np.asarray([1, 2, 2, 3], np.int32)
    out_j = jax_decode.decode_loop_window(
        jp, jcfg, jnp.asarray(buf), jc, jnp.asarray(cursors), jnp.asarray(active),
        jnp.asarray(limits), jnp.zeros((4, 2), jnp.uint32), jnp.asarray(held),
        jnp.asarray(8, jnp.int32), jnp.asarray(min(stop_when_freed, 1 << 30), jnp.int32),
        eos_id=1)
    t = lambda a: torch.from_numpy(a.copy())
    out_t = decode.decode_loop_window(
        tp, tcfg, t(buf), tc, t(cursors), t(active), t(limits), t(held), 8,
        stop_when_freed, eos_id=1)
    ticks, freed = int(out_j[4]), int(out_j[5])
    assert (out_t[4], out_t[5]) == (ticks, freed)
    assert ticks == (3 if stop_when_freed == 3 else 5)
    for i in (0, 2, 3):  # buf, cursors, active
        np.testing.assert_array_equal(out_t[i].numpy(), np.asarray(out_j[i]))


def test_page_allocator_matches_tpukit():
    """One seeded sequence of alloc / lookup / claim / register / release,
    with reclaim under pressure: both allocators hand out the same ids and
    keep the same counters."""
    rng = np.random.RandomState(7)
    ja, ta = jax_paged.PageAllocator(12, 2), paged.PageAllocator(12, 2)
    held, matched = [], 0
    prompts = [tuple(rng.randint(0, 5, 6)) for _ in range(4)]
    for step in range(80):
        op = rng.randint(3)
        if op == 0 or not held:
            ids = prompts[rng.randint(len(prompts))]
            mj, mt = ja.lookup_prefix(ids, 2), ta.lookup_prefix(ids, 2)
            assert mj == mt, step
            matched += bool(mj)
            ja.claim(mj)
            ta.claim(mt)
            n = int(rng.randint(1, 4))
            fj, ft = ja.alloc(n), ta.alloc(n)
            assert fj == ft, step
            if fj is None:
                ja.release(mj)
                ta.release(mt)
                continue
            ja.register(ids, mj + fj)
            ta.register(ids, mt + ft)
            held.append(mj + fj)
        else:
            pages = held.pop(int(rng.randint(len(held))))
            ja.release(pages)
            ta.release(pages)
        assert (ja.free_pages, ja.available_pages, ja.live_pages) == \
            (ta.free_pages, ta.available_pages, ta.live_pages), step
        assert ja.refcount == ta.refcount, step
    assert dataclasses.asdict(ja.stats) == dataclasses.asdict(ta.stats)
    assert ja.stats.reclaimed > 0 and matched > 0
    assert ja.registered_pages() == ta.registered_pages()


def _run_both(tok, jcfg, tcfg, jp, tp, reqs, **serve_kw):
    jeng = JaxServeEngine(jp, jcfg, JaxServeConfig(window_steps=8, **serve_kw),
                          eos_id=int(tok.eos_token_id))
    teng = ServeEngine(tp, tcfg, ServeConfig(**serve_kw), eos_id=int(tok.eos_token_id),
                       device="cpu")
    outs_j = {c.rid: np.asarray(c.ids) for c in jeng.run(list(reqs), max_wall_s=300)}
    outs_t = {c.rid: np.asarray(c.ids) for c in teng.run(list(reqs), max_wall_s=300)}
    return jeng, teng, outs_j, outs_t


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_engine_tokens_match_tpukit(tok, models, fused):
    """8 requests, 3 slots, a 9-page pool (two worst-case requests): lanes
    wait for pages, freed and retained pages are re-issued, and the shared
    8-token system prompt makes later admissions prefix hits."""
    jcfg, tcfg, jp, tp = models
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16),
                      stream_profile="shared_prefix")
    jeng, teng, outs_j, outs_t = _run_both(
        tok, jcfg, tcfg, jp, tp, reqs, slots=3, buckets=(8, 16), max_new_tokens=MAX_NEW,
        page_size=8, num_pages=9, prefill_chunk=8, decode_quantum=3, fused_decode=fused)
    assert outs_t.keys() == outs_j.keys() == set(range(8))
    for rid in outs_j:
        np.testing.assert_array_equal(outs_t[rid], outs_j[rid], err_msg=f"rid {rid}")
    sj, st = jeng.last_summary, teng.last_summary
    assert st["prefix_hits"] == sj["prefix_hits"] > 0
    assert st["generated_tokens"] == sj["generated_tokens"]
    assert st["kv_bytes"] == sj["kv_bytes"]
    assert st["max_live_slots"] == sj["max_live_slots"]


def test_engine_int8_pages_agree_with_tpukit(tok):
    """int8 pages (page 8 x head_dim 32 = one quant block per row), fused:
    the port's tokens agree with tpukit's int8 engine and with its own f32
    engine on >= 90% of tokens."""
    jcfg, tcfg = _cfgs(tok.vocab_size, head_dim=32)
    jp, tp = _params(jcfg)
    reqs = jax_stream(tok, 6, seed=4, max_new_tokens=MAX_NEW, buckets=(8, 16))
    kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, page_size=8,
              fused_decode=True)
    _, teng, outs_j, outs_t = _run_both(tok, jcfg, tcfg, jp, tp, reqs, kv_dtype="int8", **kw)
    f32 = {c.rid: np.asarray(c.ids)
           for c in ServeEngine(tp, tcfg, ServeConfig(**kw), eos_id=int(tok.eos_token_id),
                                device="cpu").run(list(reqs))}

    def agreement(a, b):
        return np.mean([np.mean(a[r][:min(len(a[r]), len(b[r]))]
                                == b[r][:min(len(a[r]), len(b[r]))]) for r in a])

    assert agreement(outs_t, outs_j) >= 0.9
    assert agreement(outs_t, f32) >= 0.9
    assert teng.kv_bytes < paged.pool_bytes(tcfg, teng.num_pages, 8, "f32") / 3.5


@pytest.mark.parametrize("seed,kw", [
    (0, dict(qps=20.0)),
    (5, dict(stream_profile="shared_prefix")),
], ids=["uniform_qps", "shared_prefix"])
def test_tokenizer_and_stream_match_tpukit(seed, kw):
    corpus = synthetic_stories(64)
    assert corpus == jax_synthetic_stories(64)
    jt, tt = JaxWordTokenizer(corpus), WordTokenizer(corpus)
    assert tt.vocab_size == jt.vocab_size and tt.eos_token_id == jt.eos_token_id
    text = corpus[3] + " Zebra~"
    assert tt([text])["input_ids"] == jt([text])["input_ids"]
    assert tt.decode(tt([text])["input_ids"][0]) == text
    rj = jax_stream(jt, 12, seed=seed, max_new_tokens=7, buckets=(8, 16), **kw)
    rt = synthetic_request_stream(tt, 12, seed=seed, max_new_tokens=7, buckets=(8, 16), **kw)
    assert [(r.rid, r.ids, r.max_new_tokens, r.seed, r.arrival_s) for r in rj] == \
        [(r.rid, r.ids, r.max_new_tokens, r.seed, r.arrival_s) for r in rt]


def test_unported_paths_raise_named_errors():
    with pytest.raises(NotPortedError, match="ROADMAP"):
        ServeConfig(page_size=0)
    with pytest.raises(NotPortedError, match="ROADMAP"):  # MoE serves; EP over ranks waits
        ExpertParallel(ExpertGrid(data=1, expert=2))
    with pytest.raises(ValueError, match="divide every bucket"):
        ServeConfig(page_size=8, buckets=(12,))
