"""The bench twin's serving records and its induction trainer
(`tpukit_torch/bench/serving.py`, `bench/induction.py`) against tpukit's
`bench.py` and `tools/train_induction.py`, on the CPU at the bench's tiny
shape (dim 32, 2 layers, f32; head_dim 32, so that a page of 8 holds
whole int8 quant blocks), with the fixture tokenizer in both packages.

  - Each engine record (all but `spec_decode`) at 4 requests, 2 slots and
    4 new tokens, on tpukit's `init_params(PRNGKey(0))` (the port's bridged
    through the record's `params`): tpukit's keys, key for key, in rows and
    nested dicts too, and the twin's key lists (`RECORD_KEYS`, `ROW_KEYS`);
    both records' parity bits true; the fields that tokens and scheduling
    decide, not the clock, equal.
  - `_induction_train` from tpukit's initial parameters: the final loss
    within rtol 1e-5 of tpukit's after the same steps under the cosine
    schedule, which holds the schedule's step count.
  - `spec_decode`: tpukit's record costs 2400 training steps, so its keys
    are read off `bench.py`'s source; the port's record runs at a few
    training steps, with every rung's tokens at temperature 0 the vanilla
    engine's count.
  - `python -m tpukit_torch.bench.induction` writes tpukit's consolidated
    checkpoint, optimizer schedule count included: tpukit's full restore
    (an optax cosine-schedule AdamW state as its template) and its
    params-only reader both take it, and the port's serving entry point
    serves it with n-gram speculation.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as tk_bench
from tpukit import checkpoint as tk_ckpt
from tpukit.data import get_tokenizer as tk_get_tokenizer
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.model import init_params as tk_init_params
from tpukit.train import create_train_state as tk_create_train_state
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit_torch.bench import __main__ as bench_main
from tpukit_torch.bench import induction, serving
from tpukit_torch.data import get_tokenizer
from tpukit_torch.serve import __main__ as serve_main
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
SERVE_TINY = dict(dim=32, head_dim=32, heads=1, num_layers=2, vocab_size=211,
                  max_position_embeddings=64)
SIZE = dict(requests=4, slots=2, max_new=4)


def _same_keys(mine, theirs, path="record"):
    if isinstance(theirs, dict) and isinstance(mine, dict):
        assert list(mine) == list(theirs), (path, list(mine), list(theirs))
        for k in theirs:
            if isinstance(theirs[k], (dict, list)) or isinstance(mine[k], (dict, list)):
                if theirs[k] is not None and mine[k] is not None:
                    _same_keys(mine[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, list) and isinstance(mine, list):
        assert len(mine) == len(theirs), path
        for i, (a, b) in enumerate(zip(mine, theirs)):
            _same_keys(a, b, f"{path}[{i}]")


def _tk_cfg():
    return TkGPTConfig(**SERVE_TINY, compute_dtype=jnp.float32)


def _port_cfg():
    return bench_main.bench_config(**SERVE_TINY, compute_dtype=torch.float32)


def _tk_params(cfg):
    """tpukit's initial parameters of `cfg` at the fixture's vocabulary, in
    numpy, as every serving record of tpukit's draws them."""
    cfg = cfg.replace(vocab_size=tk_get_tokenizer().vocab_size)
    return jax.tree.map(np.asarray, jax.device_get(tk_init_params(jax.random.PRNGKey(0), cfg)))


ENGINE_RECORDS = {
    # name: (tpukit's function, the port's, extra arguments, (parity bits), decided fields)
    "serving": (tk_bench.bench_serving, serving.bench_serving, {}, (),
                lambda r: (r["generated_tokens"], r["decode_quantum"],
                           [r[k]["generated_tokens"]
                            for k in ("continuous", "serial", "serial_cached")])),
    "serve_trace_overhead": (tk_bench.bench_serve_trace_overhead,
                             serving.bench_serve_trace_overhead, {},
                             ("tokens_bit_identical",),
                             lambda r: (r["events_emitted"], r["events_dropped"])),
    "metrics_overhead": (tk_bench.bench_metrics_overhead, serving.bench_metrics_overhead, {},
                         ("tokens_bit_identical",), lambda r: r["series"]),
    "serve_dispatch_attribution": (tk_bench.bench_serve_dispatch_attribution,
                                   serving.bench_serve_dispatch_attribution, {}, (),
                                   lambda r: (r["quanta"], r["completed"],
                                              r["trace_complete"], r["decode_quantum"])),
    "paged_kv": (tk_bench.bench_paged_kv, serving.bench_paged_kv, {}, ("parity_ok",),
                 lambda r: ([{k: r[rung][k] for k in ("generated_tokens", "slots",
                                                       "max_live_slots", "kv_bytes")}
                             for rung in ("ring", "paged", "paged_int8")],
                            r["int8_token_agreement"], r["slots_at_equal_hbm_ratio"],
                            {k: r["prefix"][k] for k in ("hits", "hit_rate",
                                                         "pages_reused")})),
    "decode_fused": (tk_bench.bench_decode_fused, serving.bench_decode_fused,
                     {"window": 4}, ("parity_ok",),
                     lambda r: [{k: r[rung][k] for k in ("generated_tokens", "quanta",
                                                         "decode_steps", "trace_complete")}
                                for rung in ("unfused_q1", "fused_q1", "fused_loop")]),
    "fleet_serving": (tk_bench.bench_fleet_serving, serving.bench_fleet_serving, {},
                      ("parity_ok",),
                      lambda r: ([{k: row[k] for k in ("replicas", "devices_per_replica",
                                                       "generated_tokens")}
                                  for row in r["rungs"]],
                                 r["total_devices"], r["meshed"],
                                 {k: r["disagg_prefill"][k] for k in ("handoffs",
                                                                      "worker_prefix_hits")})),
}


def check_record_keys(name: str, rec: dict) -> None:
    """`rec` has the twin's key lists, rows and nested records too."""
    assert serving.key_mismatches(name, rec) == [], rec


def test_key_mismatches_names_what_departs():
    """The key check that `chip_smoke.py` phase 45 applies finds a missing
    record key, a row's missing key and a fleet rung's, and passes a
    fleet rung's or the disaggregated half's failure, which tpukit lands
    in the record too."""
    assert serving.key_mismatches("serving", {}) == [
        ("serving", []), ("serving.continuous", None), ("serving.serial", None),
        ("serving.serial_cached", None)]
    paged = dict.fromkeys(serving.RECORD_KEYS["paged_kv"], {})
    assert [w for w, _ in serving.key_mismatches("paged_kv", paged)] == [
        "paged_kv.ring", "paged_kv.paged", "paged_kv.paged_int8", "paged_kv.prefix"]
    fleet = dict.fromkeys(serving.RECORD_KEYS["fleet_serving"])
    fleet["rungs"] = [{"replicas": 1, "error": "NotPortedError()"}, {"replicas": 2}]
    fleet["disagg_prefill"] = {"error": "NotPortedError()"}
    assert serving.key_mismatches("fleet_serving", fleet) == [
        ("fleet_serving.rungs[1]", ["replicas"])]


@pytest.mark.parametrize("name", list(ENGINE_RECORDS))
def test_engine_record_matches_tpukit(name):
    """The port's record on tpukit's parameters against tpukit's record at
    the same arguments: the same keys in the same order, the parity bits
    true in both, the token- and schedule-decided fields equal."""
    tk_fn, port_fn, extra, bits, decided = ENGINE_RECORDS[name]
    tk_cfg = _tk_cfg()
    theirs = tk_fn(tk_cfg, 1, **SIZE, **extra)
    mine = port_fn(_port_cfg(), 1, **SIZE, **extra, params=_tk_params(tk_cfg), device="cpu")
    _same_keys(mine, theirs, name)
    check_record_keys(name, mine)
    for bit in bits:
        assert mine[bit] is True and theirs[bit] is True, (bit, mine, theirs)
    if name == "serve_dispatch_attribution":
        assert mine["trace_complete"] == theirs["trace_complete"] == 1.0
    if name == "fleet_serving":
        assert mine["meshed"] is False and all("error" not in r for r in mine["rungs"])
        assert "error" not in mine["disagg_prefill"]
    assert decided(mine) == decided(theirs), (decided(mine), decided(theirs))


def test_induction_train_matches_tpukit():
    """Six steps of `_induction_train` from tpukit's initial parameters
    (dim 32, 2 layers, rows of 12): the final loss within rtol 1e-5 of
    tpukit's. The loss of the sixth step follows five updates at the
    schedule's counts 0..4; a schedule read from count 1 moves it."""
    cfg = TkGPTConfig(dim=32, head_dim=8, heads=4, num_layers=2,
                      vocab_size=tk_get_tokenizer().vocab_size, max_position_embeddings=16,
                      compute_dtype=jnp.float32)
    init = jax.tree.map(np.asarray, jax.device_get(tk_init_params(jax.random.PRNGKey(0), cfg)))
    tk_tok = tk_get_tokenizer()
    tk_tok.pad_token_id = 2
    _, tk_loss = tk_bench._induction_train(cfg, tk_tok, 6, 12)
    port_cfg = bench_main.bench_config(dim=32, head_dim=8, heads=4, num_layers=2,
                                       vocab_size=cfg.vocab_size, max_position_embeddings=16,
                                       compute_dtype=torch.float32)
    tok = get_tokenizer()
    tok.pad_token_id = 2
    state, loss = serving._induction_train(port_cfg, tok, 6, 12, params=init, device="cpu")
    np.testing.assert_allclose(loss, tk_loss, rtol=1e-5)
    assert state.step == 6
    assert [round(state.lr_schedule(c), 9) for c in (0, 3, 6, 7)] == [
        round(float(optax.cosine_decay_schedule(3e-3, 6)(c)), 9) for c in (0, 3, 6, 7)]


def _tk_spec_keys() -> tuple:
    """tpukit's `bench_spec_decode` keys, read off `bench.py`'s source: the
    record's, its `train` block's, a vanilla rung's and a proposer rung's."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_spec_decode")
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    rec = next(n.value for n in assigns if getattr(n.targets[0], "id", None) == "rec")
    keys = [k.value for k in rec.keys]
    train = [k.value for k in rec.values[keys.index("train")].keys]
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For)
                and isinstance(n.target, ast.Tuple) and n.target.elts[0].id == "label")
    keys += [e.elts[0].value for e in loop.iter.elts]
    keys += [n.targets[0].slice.value for n in assigns
             if isinstance(n.targets[0], ast.Subscript)
             and getattr(n.targets[0].value, "id", None) == "rec"
             and isinstance(n.targets[0].slice, ast.Constant)]
    out = next(n.value for n in assigns if getattr(n.targets[0], "id", None) == "out")
    vanilla = [k.arg for k in out.keywords]
    update = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                  and getattr(n.func, "attr", None) == "update"
                  and getattr(n.func.value, "id", None) == "out")
    draft = vanilla + [k.arg for k in update.keywords] + [
        n.targets[0].slice.value for n in assigns if isinstance(n.targets[0], ast.Subscript)
        and getattr(n.targets[0].value, "id", None) == "r"]
    return keys, train, vanilla, draft


def test_spec_decode_has_tpukits_keys():
    """The port's `spec_decode` at 2 and 2 training steps, 4 requests of 8
    new tokens, k 4: tpukit's keys (read off its source) and the twin's;
    at temperature 0 speculation changes no token, so each proposer's
    rung generates the vanilla engine's tokens."""
    rec = serving.bench_spec_decode(_port_cfg(), 1, requests=4, slots=2, max_new=8, k=4,
                                    train_steps=(2, 2), device="cpu")
    keys, train, vanilla, draft = _tk_spec_keys()
    assert list(rec) == keys and list(rec["train"]) == train
    assert serving.ROW_KEYS["spec_decode.vanilla"] == vanilla
    assert serving.ROW_KEYS["spec_decode.draft"] == draft
    check_record_keys("spec_decode", rec)
    t0 = rec["t0"]
    assert t0["ngram"]["generated_tokens"] == t0["model"]["generated_tokens"] == \
        t0["vanilla"]["generated_tokens"] > 0
    assert rec["speedup_ngram_t0"] == t0["ngram"]["speedup"]
    assert rec["train"]["target_loss"] > 0 and rec["train"]["draft_loss"] > 0


def test_induction_checkpoint_round_trip(tmp_path, capsys):
    """`python -m tpukit_torch.bench.induction` at dim 32 (3 steps) writes
    tpukit's consolidated msgpack: tpukit's full restore into an optax
    cosine-schedule AdamW state takes it (the schedule's count 3 beside
    Adam's), its params-only reader gives the port's parameters, and the
    port's serving entry point restores it and serves the repetitive
    stream with n-gram speculation."""
    shape = ["--dim", "32", "--head_dim", "8", "--heads", "4", "--num_layers", "2",
             "--sequence_length", "64"]
    out = tmp_path / "ckpt"
    assert induction.main(shape + ["--steps", "3", "--row_len", "20", "--out", str(out),
                                   "--device", "cpu"]) == 0
    (path,) = out.glob("checkpoint-step*.msgpack")
    assert "induction target: loss" in capsys.readouterr().out
    cfg = TkGPTConfig(dim=32, head_dim=8, heads=4, num_layers=2,
                      vocab_size=tk_get_tokenizer().vocab_size, max_position_embeddings=64,
                      compute_dtype=jnp.float32)
    template = tk_create_train_state(jax.random.PRNGKey(0), cfg, tk_make_optimizer(
        optax.cosine_decay_schedule(3e-3, 3)))
    state = tk_ckpt.restore(template, path)
    assert int(state.step) == 3
    assert int(state.opt_state[0].count) == int(state.opt_state[2].count) == 3
    params, info = tk_ckpt.restore_params(path, template.params)
    assert info["format"] == "consolidated"
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert serve_main.main(shape + ["--device", "cpu", "--disable_amp", "--checkpoint",
                                    str(path), "--draft", "ngram", "--stream_profile",
                                    "repetitive", "--requests", "4", "--slots", "2",
                                    "--buckets", "8,16", "--max_new_tokens", "4"]) == 0
