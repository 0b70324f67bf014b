"""The port's serving path against tpukit's, on the CPU.

tpukit's parameters go into the port through `bridge.params_from_numpy`,
so both sides serve the same weights. The bar: paged `forward_cached`
logits within atol 1e-5 in f32 (XLA and torch sum in other orders), and
greedy token streams through the two `ServeEngine`s identical per request
in f32, fused and unfused, on a pool tight enough to recycle pages and a
stream whose shared system prompt gives prefix hits. int8 pages are lossy
by construction and agree on >= 90% of tokens (tpukit's own gate,
tests/test_paged.py).

Tensor-parallel serving runs in one 2-rank gloo world
(`tests/torch_dist_worker.py`'s `serve_main`): the ring and the paged
engine (fused and unfused) over `TensorParallel`'s shards on a model-2
grid, greedy and sampled (t 0.8, top-k 40), the ring with its slots over a
data-2 grid, MoE replicated over data 2, a served checkpoint, and the
serving CLI. Each case's tokens must equal the port's single-device
engine's, and the greedy ones tpukit's meshless engine's on the settings
of tpukit's green TP parity tests (`tests/test_serve.py:326`,
`tests/test_paged.py:497`).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

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
from tpukit_torch.serve import paged
from tpukit_torch.serve.engine import ServeConfig, ServeEngine, synthetic_request_stream
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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
        tp, tcfg, t(buf), tc, t(cursors), t(active), t(limits),
        torch.zeros((4, 2), dtype=torch.int64), t(held), 8, stop_when_freed, eos_id=1)
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


@pytest.mark.parametrize("kind,temperature", [
    ("ring", 0.0), ("ring", 0.8), ("paged_unfused", 0.8), ("paged_fused", 0.8),
], ids=["ring-greedy", "ring-sampled", "paged-unfused-sampled", "paged-fused-sampled"])
def test_engine_ring_and_sampled_tokens_match_tpukit(tok, models, kind, temperature):
    """tpukit's default ring engine (8 requests, 3 slots: admit batches
    padded with repeats, slots reused) and sampled decoding (temperature
    0.8, top-k 5, each request's key from its seed) on the ring and on
    pages, fused and unfused: tokens identical to tpukit's engine."""
    jcfg, tcfg, jp, tp = models
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    kw = dict(slots=3, buckets=(8, 16), max_new_tokens=MAX_NEW, decode_quantum=3,
              temperature=temperature, top_k=5 if temperature else 0)
    if kind != "ring":
        kw.update(page_size=8, fused_decode=kind == "paged_fused")
    jeng, teng, outs_j, outs_t = _run_both(tok, jcfg, tcfg, jp, tp, reqs, **kw)
    assert outs_t.keys() == outs_j.keys() == set(range(8))
    for rid in outs_j:
        np.testing.assert_array_equal(outs_t[rid], outs_j[rid], err_msg=f"rid {rid}")
    assert teng.last_summary["kv_bytes"] == jeng.last_summary["kv_bytes"]
    assert teng.steps == jeng.steps


@pytest.mark.parametrize("argv", [
    ["--temperature", "0.8", "--top_k", "5"],
    ["--page_size", "8", "--fused_decode", "--temperature", "0.8"],
    ["--draft", "ngram", "--stream_profile", "repetitive"],
    ["--draft", "model", "--draft_dim", "16", "--draft_head_dim", "8", "--draft_heads", "2",
     "--draft_num_layers", "1", "--temperature", "0.8"],
], ids=["ring-sampled", "paged-sampled", "ngram", "model"])
def test_serve_entry_point_runs_the_new_paths(argv, capsys):
    from tpukit_torch.serve import __main__ as serve_main

    assert serve_main.main([
        "--device", "cpu", "--num_layers", "1", "--dim", "32", "--head_dim", "8",
        "--heads", "4", "--sequence_length", "48", "--requests", "3", "--slots", "2",
        "--buckets", "8,16", "--max_new_tokens", "6"] + argv) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert ("speculative decoding" in out) == ("--draft" in argv)


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
    """What the port does not carry raises, naming its ROADMAP item: the
    compilation cache, which the eager port has no programs for (item 18).
    `ServeConfig()` is tpukit's ring default."""
    from tpukit_torch.serve import __main__ as serve_main

    with pytest.raises(NotPortedError, match="item 18"):
        serve_main.main(["--compilation_cache_dir", "x", "--device", "cpu"])
    with pytest.raises(ValueError, match="divide every bucket"):
        ServeConfig(page_size=8, buckets=(12,))
    assert ServeConfig().page_size == JaxServeConfig().page_size == 0
    with pytest.raises(ValueError, match="ring cache"):
        ServeConfig(page_size=8, draft="ngram")
    with pytest.raises(ValueError, match="paged cache"):
        ServeConfig(fused_decode=True)


def test_speculation_times_verify_apart_from_decode_as_tpukit(tok, models):
    """C8: under n-gram speculation each quantum is a `verify` span, as
    tpukit's (`tpukit/serve/engine.py:932-958`): the summary's `decode_s`
    is 0.0, with `draft_s` and `verify_s` beside it."""
    jcfg, tcfg, jp, tp = models
    reqs = jax_stream(tok, 6, seed=2, max_new_tokens=MAX_NEW, buckets=(8, 16),
                      stream_profile="repetitive")
    kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, draft="ngram", spec_k=2)
    jeng = JaxServeEngine(jp, jcfg, JaxServeConfig(**kw), eos_id=int(tok.eos_token_id))
    jeng.run(list(reqs), max_wall_s=300)
    teng = ServeEngine(tp, tcfg, ServeConfig(**kw), eos_id=int(tok.eos_token_id), device="cpu")
    teng.run(list(reqs), max_wall_s=300)
    for side, s in (("tpukit", jeng.last_summary), ("port", teng.last_summary)):
        assert s["decode_s"] == 0.0 and s["draft_s"] == 0.0 and s["verify_s"] > 0, (side, s)
        assert s["dispatch_overhead_s"] == s["verify_s"], side


# ------------------------------------------- main-serve.py's every flag ----


def _main_serve_parser():
    """`main-serve.py`'s own parser: the script loaded by path (its name has
    a hyphen), `parse_serve_flags` run once with `ArgumentParser.parse_args`
    recording the parser it was called on."""
    import argparse
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "main_serve", Path(__file__).resolve().parent.parent / "main-serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    seen, real = [], argparse.ArgumentParser.parse_args

    def spy(self, *args, **kwargs):
        seen.append(self)
        return real(self, *args, **kwargs)

    argparse.ArgumentParser.parse_args = spy
    try:
        module.parse_serve_flags([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return {a.dest: a for a in seen[0]._actions if a.dest != "help"}


MAIN_SERVE = _main_serve_parser()
_BASE = ["--device", "cpu", "--num_layers", "1", "--dim", "32", "--head_dim", "8", "--heads",
         "4", "--sequence_length", "64", "--requests", "2", "--slots", "2", "--buckets", "8,16",
         "--max_new_tokens", "2"]
# a non-default value of each carried flag that runs on `_BASE`, with the
# flags it needs beside it; every other flag takes the generic one
_VALUES = {
    "buckets": ["--buckets", "8"], "requests": ["--requests", "3"],
    "qps": ["--qps", "1000"], "num_pages": ["--page_size", "8", "--num_pages", "16"],
    "kv_dtype": ["--page_size", "8", "--kv_dtype", "bf16"],
    "prefill_chunk": ["--page_size", "8", "--prefill_chunk", "8"],
    "fused_decode": ["--page_size", "8", "--fused_decode"], "page_size": ["--page_size", "8"],
    "spec_k": ["--draft", "ngram", "--spec_k", "2"],
    "ngram_max": ["--draft", "ngram", "--ngram_max", "2"],
    "draft": ["--draft", "model", "--draft_dim", "16", "--draft_head_dim", "4",
              "--draft_heads", "4", "--draft_num_layers", "1"],
    "num_experts": ["--num_experts", "2"],
    "moe_dispatch": ["--num_experts", "2", "--moe_dispatch", "pallas"],
    "moe_top_k": ["--num_experts", "2", "--moe_top_k", "2"],
    "slo": ["--slo", "e2e<=1000s@p99"],
    # the fleet flags, each in a fleet it runs in
    "replicas": ["--replicas", "2"],
    "devices_per_replica": ["--replicas", "1", "--devices_per_replica", "1"],
    "min_replicas": ["--replicas", "2", "--min_replicas", "2"],
    "max_replicas": ["--replicas", "1", "--max_replicas", "2"],
    "scale_up_occupancy": ["--replicas", "1", "--max_replicas", "2",
                           "--scale_up_occupancy", "0.5", "--fleet_window_steps", "1"],
    "scale_down_occupancy": ["--replicas", "2", "--scale_down_occupancy", "0.5",
                             "--fleet_window_steps", "1"],
    "fleet_window_steps": ["--replicas", "2", "--fleet_window_steps", "2"],
    "disagg_prefill": ["--replicas", "2", "--page_size", "8", "--disagg_prefill"],
    "prefill_slots": ["--replicas", "2", "--page_size", "8", "--disagg_prefill",
                      "--prefill_slots", "1"],
    "prefill_pages": ["--replicas", "2", "--page_size", "8", "--disagg_prefill",
                      "--prefill_pages", "8"],
    "fleet_kill": ["--replicas", "2", "--fleet_kill", "replica_kill@1:1"],
    "fleet_dir": ["--replicas", "2", "--fleet_dir", "fleet"],
    "replica_timeout": ["--replicas", "2", "--fleet_dir", "fleet", "--replica_timeout", "30"],
    "request_retries": ["--replicas", "2", "--request_retries", "1"],
    "max_queue_depth": ["--replicas", "2", "--max_queue_depth", "1"],
    "deadline_ms": ["--replicas", "2", "--deadline_ms", "60000"],
    "fleet_procs": ["--replicas", "1", "--fleet_procs", "--fleet_dir", "fleet",
                    "--replica_timeout", "60"],
    "fleet_worker": ["--replicas", "1", "--fleet_dir", "fleet", "--fleet_worker", "0"],
}


def _generic(action) -> list:
    opt = action.option_strings[0]
    if action.nargs == 0:
        return [opt]
    if action.choices:
        return [opt, next(c for c in action.choices if c != action.default)]
    if action.type in (int, float):
        return [opt, str(action.default + action.type(1))]
    return [opt, "x"]


@pytest.mark.parametrize("dest", sorted(MAIN_SERVE))
def test_every_main_serve_flag_parses_with_tpukit_default(dest, tmp_path, monkeypatch):
    """Each option of `main-serve.py` (`parse_serve_flags` with
    `add_serve_flags` and `add_fleet_flags`): the port's parser has its
    dest and tpukit's default, and a non-default value either serves (a
    tiny model, 2 requests, on the CPU; a checkpoint flag given a real
    checkpoint of that shape) or raises `NotPortedError` naming a ROADMAP
    item."""
    from tpukit_torch import checkpoint as ckpt
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.serve import __main__ as serve_main
    from tpukit_torch.train import create_train_state

    ours = {a.dest: a for a in serve_main.build_parser()._actions}
    assert dest in ours and ours[dest].default == MAIN_SERVE[dest].default, dest
    argv = _VALUES.get(dest) or _generic(MAIN_SERVE[dest])
    if dest in ("checkpoint", "draft_checkpoint"):
        shape = (dict(dim=32, head_dim=8, heads=4, num_layers=1) if dest == "checkpoint" else
                 dict(dim=16, head_dim=4, heads=4, num_layers=1))
        cfg = GPTConfig(**shape, vocab_size=get_tokenizer().vocab_size,
                        max_position_embeddings=64)
        path = ckpt.save_consolidated(create_train_state(
            gpt.init_params(cfg, seed=1, device="cpu"), 1e-3), tmp_path)
        argv = [f"--{dest}", str(path)] + (_VALUES["draft"] if dest == "draft_checkpoint"
                                           else [])
    monkeypatch.chdir(tmp_path)
    if dest == "fleet_worker":
        # the worker serves the leases a supervisor wrote: here both
        # requests of the stream, to replica 0, and the stop record
        from tpukit_torch.serve.engine import synthetic_request_stream
        from tpukit_torch.serve.ledger import RequestLedger

        led = RequestLedger(tmp_path / "fleet")
        reqs = synthetic_request_stream(get_tokenizer(), 2, max_new_tokens=2, buckets=(8, 16))
        led.open_stream(reqs)
        for r in reqs:
            led.assign(r.rid, 0, 1, 0.0)
        led.request_stop()
    if dest in serve_main.NOT_CARRIED:
        with pytest.raises(NotPortedError, match=r"ROADMAP.md, queue A item \d+"):
            serve_main.main(_BASE + argv)
    else:
        assert serve_main.main(_BASE + argv) == 0


# ------------------------------------------- tensor-parallel serving ----

WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
TP_SERVE = dict(slots=2, buckets=(8, 16), max_new_tokens=6)  # tpukit's TP parity settings
TP_CLI = ["--device", "cpu", "--num_layers", "1", "--dim", "32", "--head_dim", "8",
          "--heads", "4", "--sequence_length", "48", "--requests", "3", "--slots", "2",
          "--buckets", "8,16", "--max_new_tokens", "6", "--page_size", "8", "--fused_decode",
          "--disable_amp"]
# one head: the paged grid is model 1 of 2 ranks, and rank 1 waits
_HEADS = TP_CLI.index("--heads") + 1
TP_CLI_IDLE = TP_CLI[:_HEADS] + ["1"] + TP_CLI[_HEADS + 1:]
# the telemetry flags, paths relative to each rank's own directory
OBS_FLAGS = ["--metrics_log", "serve.jsonl", "--metrics_dir", "md", "--slo",
             "e2e<=1000s@p99;ttft<=1us@p95", "--window_steps", "4"]
TP_CLI_OBS = TP_CLI + OBS_FLAGS  # paged, fused: model 2
# the ring with one head: model 1, its 2 slots over data 2
_PAGED = TP_CLI_IDLE.index("--page_size")
TP_CLI_OBS_RING = [a for a in TP_CLI_IDLE[:_PAGED] + TP_CLI_IDLE[_PAGED + 2:]
                   if a != "--fused_decode"] + OBS_FLAGS


def _tp_serve_cases():
    sys.path.insert(0, str(WORKER.parent))
    try:
        import torch_dist_worker
    finally:
        sys.path.pop(0)
    return torch_dist_worker.SERVE_CASES


TP_SERVE_CASES = _tp_serve_cases()


def _serve_cfgs(tok):
    kw = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tok.vocab_size,
              max_position_embeddings=64)
    return JaxConfig(compute_dtype=jnp.float32, **kw), kw


@pytest.fixture(scope="module")
def tp_world(tok, tmp_path_factory):
    """One spawn of 2 gloo ranks serving every case of `SERVE_CASES`; the
    references are computed while the ranks run: the port's single-device
    engine on each case, tpukit's meshless engine on the greedy ring and
    paged ones, and the serving CLI in a world of one."""
    from tpukit_torch import checkpoint as ckpt
    from tpukit_torch.train import create_train_state

    work = tmp_path_factory.mktemp("tp_serve")
    jcfg, kw = _serve_cfgs(tok)
    jp = jax_gpt.init_params(jax.random.PRNGKey(1), jcfg)
    dense = jax.tree.map(np.asarray, jp)
    jmoe = jcfg.replace(num_experts=4)
    moe = jax.tree.map(np.asarray, jax_gpt.init_params(jax.random.PRNGKey(2), jmoe))
    tcfg = GPTConfig(**kw, compute_dtype=torch.float32)
    single_ckpt = ckpt.save_sharded(create_train_state(bridge.params_from_numpy(dense, "cpu"),
                                                       1e-3), work / "single")
    reqs = jax_stream(tok, 4, seed=4, max_new_tokens=6, buckets=(8, 16))
    flat = lambda prefix, tree: {f"serve/{prefix}/{n}": v for n, v in _flat(tree).items()}
    np.savez(work / "inputs.npz", **{"serve/config": json.dumps(kw),
                                     "serve/serve": json.dumps(TP_SERVE),
                                     "serve/eos": np.int64(tok.eos_token_id),
                                     "serve/checkpoint": str(single_ckpt),
                                     "serve/cli": np.array(TP_CLI),
                                     "serve/cli_idle": np.array(TP_CLI_IDLE),
                                     "serve/cli_obs": np.array(TP_CLI_OBS),
                                     "serve/cli_obs_ring": np.array(TP_CLI_OBS_RING)},
             **{f"serve/ids/{r.rid}": np.asarray(r.ids, np.int64) for r in reqs},
             **{f"serve/seed/{r.rid}": np.int64(r.seed) for r in reqs},
             **flat("dense", dense), **flat("moe", moe))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(work / "inputs.npz"), str(work),
                               "2", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(2)]
    try:
        refs = {}
        for case, (_, ekw, which) in TP_SERVE_CASES.items():
            cfg = tcfg.replace(num_experts=4, moe_dispatch="pallas") if which == "moe" else tcfg
            params = bridge.params_from_numpy(moe if which == "moe" else dense, "cpu")
            eng = ServeEngine(params, cfg, ServeConfig(**TP_SERVE, **ekw),
                              eos_id=int(tok.eos_token_id), device="cpu")
            refs[case] = {c.rid: np.asarray(c.ids) for c in eng.run(list(reqs), max_wall_s=300)}
            refs[f"{case}/kv_bytes"] = eng.kv_bytes
        tk = {}
        for case in ("ring", "paged"):
            ekw = TP_SERVE_CASES[case][1]
            jeng = JaxServeEngine(jp, jcfg, JaxServeConfig(window_steps=8, **TP_SERVE, **ekw),
                                  eos_id=int(tok.eos_token_id))
            tk[case] = {c.rid: np.asarray(c.ids) for c in jeng.run(list(reqs), max_wall_s=300)}
        from tpukit_torch.serve import __main__ as serve_main
        import contextlib
        import io
        cli = {}
        for key, argv in (("cli", TP_CLI), ("cli_idle", TP_CLI_IDLE), ("cli_obs", TP_CLI_OBS),
                          ("cli_obs_ring", TP_CLI_OBS_RING)):
            one = work / "one" / key
            one.mkdir(parents=True)
            cwd = os.getcwd()
            os.chdir(one)
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    serve_main.main(argv)
            finally:
                os.chdir(cwd)
            cli[key] = out.getvalue()
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return dict(got=dict(np.load(work / "result.npz")), refs=refs, tk=tk, cli=cli,
                rids=[r.rid for r in reqs], work=work)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("case", sorted(TP_SERVE_CASES))
def test_tp_serving_tokens_match_single_device(tp_world, case):
    """On 2 gloo ranks, each case's tokens equal the port's single-device
    engine's on the same stream (f32); greedy ring and paged tokens equal
    tpukit's meshless engine's too (tpukit's TP parity settings: 2 slots,
    buckets 8/16, 6 new tokens, pages of 4). Under model 2 each rank's
    pools and ring hold half the heads, under data 2 half the ring's
    slots: half the single device's cache bytes."""
    got, refs = tp_world["got"], tp_world["refs"]
    (d, m), _, _ = TP_SERVE_CASES[case]
    for rid in tp_world["rids"]:
        np.testing.assert_array_equal(got[f"{case}/{rid}"], refs[case][rid],
                                      err_msg=f"rid {rid}")
        if case in tp_world["tk"]:
            np.testing.assert_array_equal(got[f"{case}/{rid}"], tp_world["tk"][case][rid],
                                          err_msg=f"rid {rid}")
    assert int(got[f"{case}/kv_bytes"]) * d * m == refs[f"{case}/kv_bytes"]


@pytest.mark.parametrize("key,grid", [("cli", "model 2"), ("cli_idle", "model 1")],
                         ids=["model2", "idle_rank"])
def test_tp_serving_cli_on_two_ranks_matches_world_of_one(tp_world, key, grid):
    """`python -m tpukit_torch.serve` run by both ranks of the world (paged,
    fused): tpukit's grid is picked (4 heads: model 2; 1 head: model 1 of
    the 2 ranks, announced, the other rank waiting), and rank 0 alone
    prints the world of one's completions."""
    got = str(tp_world["got"][f"{key}/stdout"])
    assert f"serving grid: data 1 x {grid} (TensorParallel)" in got
    assert "serving grid: data 1 x model 1 (TensorParallel)" in tp_world["cli"][key]
    assert ("model=1 of 2 devices" in got) == (key == "cli_idle")
    pick = lambda text: [l for l in text.splitlines() if l.startswith("  [")]
    assert len(pick(got)) == 3 and pick(got) == pick(tp_world["cli"][key])


WINDOW_COUNTS = ("window", "steps", "new_tokens", "occupancy", "admitted", "completed",
                 "queue_depth", "slots", "page_occupancy", "prefix_hit_rate",
                 "pages_per_request")


@pytest.mark.parametrize("key,grid", [("cli_obs", "data 1 x model 2"),
                                      ("cli_obs_ring", "data 2 x model 1")],
                         ids=["paged_model2", "ring_data2"])
def test_tp_serving_telemetry_only_rank_0_writes(tp_world, key, grid):
    """`python -m tpukit_torch.serve` with `--metrics_log`, `--metrics_dir`,
    `--slo` and `--window_steps` on both ranks of the world: rank 0's
    completions and its records' `(kind, window)` sequence, serve windows'
    and summary's count fields equal the world of one's; its metrics
    directory holds one snapshot (process 0's) and the merge; rank 1 writes
    nothing."""
    got = str(tp_world["got"][f"{key}/stdout"])
    assert f"serving grid: {grid} (TensorParallel)" in got
    pick = lambda text: [l for l in text.splitlines() if l.startswith("  [")]
    assert len(pick(got)) == 3 and pick(got) == pick(tp_world["cli"][key])
    rank0, rank1 = (tp_world["work"] / key / f"rank{r}" for r in (0, 1))
    assert list(rank1.iterdir()) == []
    assert sorted(p.name for p in (rank0 / "md").iterdir()) == [
        "metrics-merged.json", "metrics-p00000.json", "metrics.prom"]
    read = lambda path: [json.loads(line) for line in open(path)]
    mine, one = read(rank0 / "serve.jsonl"), read(tp_world["work"] / "one" / key / "serve.jsonl")
    seq = lambda recs: [(r["kind"], r.get("window")) for r in recs
                        if r["kind"] not in ("trace_event", "trace")]
    assert seq(mine) == seq(one) and ("serve", 1) in seq(mine)
    of = lambda recs, kind: [r for r in recs if r["kind"] == kind]
    for a, b in zip(of(mine, "serve"), of(one, "serve")):
        assert {k: a.get(k) for k in WINDOW_COUNTS} == {k: b.get(k) for k in WINDOW_COUNTS}
    [a], [b] = of(mine, "serve_summary"), of(one, "serve_summary")
    counts = ("requests", "generated_tokens", "decode_steps", "admitted", "evicted_eos",
              "evicted_length", "trace_complete", "trace_dropped", "slo_overall_compliance")
    assert {k: a[k] for k in counts} == {k: b[k] for k in counts}
    assert a["trace_complete"] == 1.0
