"""The port's serving telemetry against tpukit's, on the CPU.

tpukit's `ServeEngine` and the port's serve the same stream
(`synthetic_request_stream` at qps 0) with the same parameters (tpukit's,
bridged by `bridge.params_from_numpy`) and the same settings, each with
its package's `StepLogger`, `FlightRecorder`, `TraceRecorder`,
`MetricRegistry`, a lax and a strict SLO clause and a `metrics_dir`, at
`window_steps` 8, in four configurations: paged + fused greedy on a
shared-prefix stream, the ring sampled (t 0.8, top-k 40), the ring with
n-gram speculation on the repetitive stream, and MoE (pallas) paged +
fused. Each record the two runs write must agree wherever it does not read
a clock: the `(kind, window)` sequence, the count fields of every
`kind="serve"` window and of `kind="serve_summary"` (tpukit's key sets),
each request's trace events and span tree, the ordered quantum events, the
metric counters, sample counts and OpenMetrics names, and the per-window
SLO compliances. Times are only held to their own invariants (the window's
seconds sum to its wall; every tree is complete). A control holds the same
record comparison against tpukit's run at `window_steps` 9, which must
fail. tpukit's own `build_trees` cases (`tests/test_trace.py:251-300`) run
through the port's copy, whose trees must serialize to the same bytes.
"""

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
from tpukit.obs import FlightRecorder as TkFlightRecorder
from tpukit.obs import MetricRegistry as TkMetricRegistry
from tpukit.obs import StepLogger as TkStepLogger
from tpukit.obs import TraceRecorder as TkTraceRecorder
from tpukit.obs import parse_slo as tk_parse_slo
from tpukit.obs import trace as tk_trace
from tpukit.serve import ServeConfig as JaxServeConfig
from tpukit.serve import ServeEngine as JaxServeEngine
from tpukit.serve import synthetic_request_stream as jax_stream
from tpukit_torch import bridge
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.obs import (FlightRecorder, MetricRegistry, StepLogger, TraceRecorder,
                              parse_slo, to_openmetrics)
from tpukit_torch.obs import trace as trace_lib
from tpukit_torch.serve.engine import ServeConfig, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
WINDOW = 8
SLO = "e2e<=1000s@p99;ttft<=1us@p95"  # every request meets the first, none the second
BASE = dict(slots=2, buckets=(8, 16), max_new_tokens=6)
# name -> (engine settings, stream settings, model)
CONFIGS = {
    "paged_fused": (dict(page_size=4, fused_decode=True), dict(stream_profile="shared_prefix"),
                    "dense"),
    "ring_sampled": (dict(temperature=0.8, top_k=40), {}, "dense"),
    "ring_ngram": (dict(draft="ngram", spec_k=2), dict(stream_profile="repetitive"), "dense"),
    "moe_paged_fused": (dict(page_size=4, fused_decode=True), {}, "moe"),
}
TIME_KEYS = {"t", "t0", "t1", "s0", "s1", "time", "kind"}
# the count fields of a serve window and of the summary: what no clock moves
WINDOW_COUNTS = ("window", "steps", "new_tokens", "occupancy", "admitted", "completed",
                 "queue_depth", "slots", "page_occupancy", "prefix_hit_rate",
                 "pages_per_request", "spec")
SUMMARY_COUNTS = ("requests", "slots", "buckets", "buckets_used", "generated_tokens",
                  "decode_steps", "mean_occupancy", "admitted", "evicted_eos",
                  "evicted_length", "evicted_deadline", "max_live_slots", "kv_bytes", "spec",
                  "page_size", "num_pages", "kv_dtype", "prefix_hits", "prefix_hit_rate",
                  "prefix_pages_reused", "reclaimed_pages", "page_occupancy",
                  "pages_per_request", "trace_complete", "trace_dropped")
TREE_COUNTS = ("trace", "rid", "closed", "complete", "attempts", "quanta", "replicas",
               "reason", "generated")


def _read(path) -> list[dict]:
    return [json.loads(line) for line in open(path)]


class _Tk:
    """tpukit's half of one configuration."""

    logger, recorder, tracer, registry, parse_slo = (TkStepLogger, TkFlightRecorder,
                                                     TkTraceRecorder, TkMetricRegistry,
                                                     tk_parse_slo)


class _Port:
    logger, recorder, tracer, registry, parse_slo = (StepLogger, FlightRecorder, TraceRecorder,
                                                     MetricRegistry, parse_slo)


def _serve(side, make_engine, reqs, work, capacity=8192):
    """Run one engine with every telemetry plane on; returns its records,
    completions, summary and registry."""
    work.mkdir(parents=True, exist_ok=True)
    logger = side.logger(str(work / "serve.jsonl"))
    registry = side.registry()
    engine = make_engine(dict(logger=logger, recorder=side.recorder(),
                              tracer=side.tracer(capacity=capacity), metrics=registry,
                              slo=side.parse_slo(SLO), metrics_dir=str(work / "metrics")))
    comps = engine.run(list(reqs), max_wall_s=300)
    logger.close()
    return dict(records=_read(work / "serve.jsonl"), summary=engine.last_summary,
                tokens={c.rid: np.asarray(c.ids) for c in comps}, registry=registry,
                dir=work)


@pytest.fixture(scope="module")
def setup():
    tok = JaxWordTokenizer(jax_synthetic_stories(64))
    kw = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tok.vocab_size,
              max_position_embeddings=96)
    models = {}
    for name, extra, seed in (("dense", {}, 1), ("moe", dict(num_experts=4,
                                                            moe_dispatch="pallas"), 2)):
        jcfg = JaxConfig(compute_dtype=jnp.float32, **kw, **extra)
        jp = jax_gpt.init_params(jax.random.PRNGKey(seed), jcfg)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        models[name] = (jcfg, jp, GPTConfig(compute_dtype=torch.float32, **kw, **extra), tp)
    return tok, models


def _stream(tok, stream_kw):
    return jax_stream(tok, 8, seed=3, max_new_tokens=BASE["max_new_tokens"],
                      buckets=BASE["buckets"], **stream_kw)


def _engines(setup, name, window=WINDOW):
    tok, models = setup
    serve_kw, stream_kw, model = CONFIGS[name]
    jcfg, jp, tcfg, tp = models[model]
    eos = int(tok.eos_token_id)
    tk = lambda kw: JaxServeEngine(jp, jcfg, JaxServeConfig(window_steps=window, **BASE,
                                                            **serve_kw), eos_id=eos, **kw)
    port = lambda kw: ServeEngine(tp, tcfg, ServeConfig(window_steps=window, **BASE, **serve_kw),
                                  eos_id=eos, device="cpu", **kw)
    return tk, port, _stream(tok, stream_kw)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Every configuration once through each package, telemetry on."""
    out = {}
    for name in CONFIGS:
        tk, port, reqs = _engines(setup, name)
        work = tmp_path_factory.mktemp(name)
        out[name] = dict(tk=_serve(_Tk, tk, reqs, work / "tk"),
                         port=_serve(_Port, port, reqs, work / "port"), reqs=reqs)
    return out


def _of(records, kind):
    return [r for r in records if r["kind"] == kind]


def _mismatch(tk_records, port_records) -> str | None:
    """Where the port's records part from tpukit's: the `(kind, window)`
    sequence of the records a clock does not order, and every serve
    window's count fields and key sets. None when they agree."""
    seq = lambda recs: [(r["kind"], r.get("window")) for r in recs
                        if r["kind"] not in ("trace_event", "trace")]
    if seq(tk_records) != seq(port_records):
        return f"(kind, window) {seq(port_records)} != tpukit's {seq(tk_records)}"
    for a, b in zip(_of(tk_records, "serve"), _of(port_records, "serve")):
        if set(a) != set(b) or set(a["seconds"]) != set(b["seconds"]) \
                or set(a["fractions"]) != set(b["fractions"]):
            return f"window {a['window']} keys {sorted(b)} != tpukit's {sorted(a)}"
        for key in WINDOW_COUNTS:
            if a.get(key) != b.get(key):
                return f"window {a['window']} {key} {b.get(key)} != tpukit's {a.get(key)}"
    return None


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tokens_equal_tpukit_s(runs, name):
    run = runs[name]
    assert run["port"]["tokens"].keys() == run["tk"]["tokens"].keys() == \
        {r.rid for r in run["reqs"]}
    for rid, ids in run["tk"]["tokens"].items():
        np.testing.assert_array_equal(run["port"]["tokens"][rid], ids, err_msg=f"rid {rid}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_window_sequence_and_counts_equal_tpukit_s(runs, name):
    """The `(kind, window)` sequence (serve, slo, ..., serve_summary,
    metrics) and each serve window's count fields; each window's named
    seconds sum to its wall."""
    tk, port = runs[name]["tk"]["records"], runs[name]["port"]["records"]
    assert len(_of(port, "serve")) >= 2
    assert _mismatch(tk, port) is None, _mismatch(tk, port)
    for w in _of(port, "serve"):
        assert sum(w["seconds"].values()) == pytest.approx(w["window_s"], abs=1e-6)
        assert w["other_s"] == w["seconds"]["other"]
        assert w["device_s"] == w["seconds"].get("sync", 0.0)


def test_window_comparison_fails_against_another_window_size(setup, runs, tmp_path):
    """The control: tpukit's run at window_steps 9 is not the port's at 8
    (on the ring, whose quanta are all of 4 steps; the fused paged windows
    stop early, and close at 10 steps under either size)."""
    tk, _, reqs = _engines(setup, "ring_sampled", window=9)
    other = _serve(_Tk, tk, reqs, tmp_path)
    assert _mismatch(other["records"], runs["ring_sampled"]["port"]["records"]) is not None


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_summary_keys_and_counts_equal_tpukit_s(runs, name):
    """tpukit's `serve_summary` keys (the port adds `prefill_dispatches`),
    its count fields, complete traces, and the named walls within the run's
    wall."""
    tk, port = runs[name]["tk"]["summary"], runs[name]["port"]["summary"]
    assert set(port) - set(tk) == {"prefill_dispatches"} and set(tk) <= set(port)
    assert set(port["phase_p50"]) == set(tk["phase_p50"]) == set(trace_lib.PHASES)
    for key in SUMMARY_COUNTS:
        assert port.get(key) == tk.get(key), key
    assert port["trace_complete"] == 1.0 and port["trace_dropped"] == 0
    assert port["slo_overall_compliance"] == tk["slo_overall_compliance"] == 0.0
    named = port["prefill_s"] + port["decode_s"] + port["sync_s"] + port.get("verify_s", 0.0)
    assert named + port["other_s"] == pytest.approx(port["wall_s"], abs=1e-3)
    [row] = _of(runs[name]["port"]["records"], "serve_summary")
    assert set(row) - {"time"} == set(port)


def _events(records):
    return [{k: v for k, v in r.items() if k not in TIME_KEYS}
            for r in _of(records, "trace_event")]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trace_events_and_trees_equal_tpukit_s(runs, name):
    """Per trace id, the same event sequence with the same non-time fields;
    the ordered quantum events' `(steps, lanes)`; each span tree's count
    fields; every tree closed and complete."""
    tk, port = runs[name]["tk"]["records"], runs[name]["port"]["records"]
    per_trace = lambda evs: {t: [e for e in evs if e["trace"] == t]
                             for t in sorted({e["trace"] for e in evs if e["ev"] != "quantum"})}
    assert per_trace(_events(port)) == per_trace(_events(tk))
    quanta = lambda evs: [(e["steps"], e["lanes"]) for e in evs if e["ev"] == "quantum"]
    assert quanta(_events(port)) == quanta(_events(tk)) and quanta(_events(port))
    trees = lambda recs: [{k: t[k] for k in TREE_COUNTS} for t in _of(recs, "trace")]
    assert trees(port) == trees(tk)
    assert all(t["closed"] and t["complete"] for t in _of(port, "trace"))


def test_dropped_trace_events_equal_tpukit_s(setup, tmp_path):
    """A ring of 16 events drops as many as tpukit's."""
    tk, port, reqs = _engines(setup, "paged_fused")
    a = _serve(_Tk, tk, reqs, tmp_path / "tk", capacity=16)["summary"]
    b = _serve(_Port, port, reqs, tmp_path / "port", capacity=16)["summary"]
    assert b["trace_dropped"] == a["trace_dropped"] > 0
    assert b["trace_complete"] == a["trace_complete"] < 1.0


def _metric_rows(registry):
    s = registry.summary()
    return dict(
        counters=s["counters"],
        samples=[(h["name"], h["labels"], h["count"]) for h in s["hists"]],
        gauges=[(g["name"], g["labels"], None if g["name"] == "serve_tokens_per_sec"
                 else g["value"]) for g in s["gauges"]],
        tokens=[h for h in registry.snapshot()["hists"]
                if h["name"] == "serve_tokens_per_request"],
        names=sorted({line.split("{")[0].split(" ")[0] for line in
                      to_openmetrics(registry).splitlines() if not line.startswith("#")}),
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_metrics_equal_tpukit_s(runs, name):
    """Counters, histogram sample counts by series and label, the
    tokens-per-request histogram whole, the gauges a clock does not set,
    the OpenMetrics series names; a single snapshot file and its merge."""
    tk, port = runs[name]["tk"], runs[name]["port"]
    assert _metric_rows(port["registry"]) == _metric_rows(tk["registry"])
    files = sorted(p.name for p in (port["dir"] / "metrics").iterdir())
    assert files == sorted(p.name for p in (tk["dir"] / "metrics").iterdir())
    assert files == ["metrics-merged.json", "metrics-p00000.json", "metrics.prom"]
    [row] = _of(port["records"], "metrics")
    assert row["source"] == "serve" and row["counters"] == _of(tk["records"], "metrics")[0][
        "counters"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slo_compliances_equal_tpukit_s(runs, name):
    """Each window's compliance of the lax and the strict clause: 1.0 and
    0.0 (or None, in a window without completions) on both."""
    rows = lambda recs: [[(t["slo"], t["n"], t["violations"], t["compliance"])
                          for t in r["targets"]] for r in _of(recs, "slo")]
    port = rows(runs[name]["port"]["records"])
    assert port == rows(runs[name]["tk"]["records"])
    seen = {(slo, c) for window in port for slo, _, _, c in window if c is not None}
    assert seen == {("e2e<=1000s@p99", 1.0), ("ttft<=1us@p95", 0.0)}


# name -> engine settings of the paths whose tokens telemetry must not move
# beyond the four configurations above
EXTRA_PATHS = {
    "ring": {}, "paged_unfused": dict(page_size=4),
    "draft_model": dict(draft="model", spec_k=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS) + sorted(EXTRA_PATHS))
def test_tokens_and_schedule_equal_with_telemetry_off(setup, runs, tmp_path, name):
    """Tokens, decode steps and prefill dispatches with every plane off
    equal the run with every plane on, bit for bit."""
    tok, models = setup
    if name in CONFIGS:
        _, port, reqs = _engines(setup, name)
        on = runs[name]["port"]
        on_steps = on["summary"]["decode_steps"], on["summary"]["prefill_dispatches"]
    else:
        jcfg, jp, tcfg, tp = models["dense"]
        reqs = _stream(tok, {})
        draft = {}
        if name == "draft_model":
            dcfg = tcfg.replace(dim=16, head_dim=4, num_layers=1)
            draft = dict(draft_cfg=dcfg, draft_params=gpt.init_params(dcfg, seed=5,
                                                                       device="cpu"))
        port = lambda kw: ServeEngine(tp, tcfg, ServeConfig(window_steps=WINDOW, **BASE,
                                                             **EXTRA_PATHS[name]),
                                      eos_id=int(tok.eos_token_id), device="cpu", **draft,
                                      **kw)
        on = _serve(_Port, port, reqs, tmp_path)
        on_steps = on["summary"]["decode_steps"], on["summary"]["prefill_dispatches"]
    off = port({})
    tokens = {c.rid: np.asarray(c.ids) for c in off.run(list(reqs), max_wall_s=300)}
    assert tokens.keys() == on["tokens"].keys()
    for rid, ids in tokens.items():
        np.testing.assert_array_equal(ids, on["tokens"][rid], err_msg=f"rid {rid}")
    assert (off.last_summary["decode_steps"], off.last_summary["prefill_dispatches"]) == \
        on_steps
    assert "trace_complete" not in off.last_summary


# ---- tpukit's build_trees cases (tests/test_trace.py:251-300) -----------

REQUEUE = [
    dict(ev="enqueue", trace=7, rid=7, t=0.0, replica=None),
    dict(ev="admit", trace=7, rid=7, t=1.0, slot=0, replica=0),
    dict(ev="prefill_done", trace=7, rid=7, t=1.5, replica=0),
    dict(ev="quantum", trace=-1, t0=1.5, t1=1.6, s0=1.6, s1=1.8, steps=4, lanes=[7],
         replica=0),
    dict(ev="requeue", trace=7, rid=7, t=2.0, from_replica=0, replica="router"),
    dict(ev="admit", trace=7, rid=7, t=3.0, slot=1, replica=1),
    dict(ev="prefill_done", trace=7, rid=7, t=3.25, replica=1),
    dict(ev="quantum", trace=-1, t0=3.25, t1=3.3, s0=3.3, s1=3.5, steps=4, lanes=[7],
         replica=1),
    dict(ev="finish", trace=7, rid=7, t=3.5, reason="eos", generated=8, replica=1),
]
OPEN = [dict(ev="enqueue", trace=1, rid=1, t=0.0), dict(ev="admit", trace=1, rid=1, t=0.5,
                                                        slot=0)]
OVERRUN = [
    dict(ev="enqueue", trace=2, rid=2, t=0.0),
    dict(ev="admit", trace=2, rid=2, t=0.5, slot=0),
    dict(ev="prefill_done", trace=2, rid=2, t=0.6),
    dict(ev="quantum", trace=-1, t0=0.0, t1=5.0, s0=5.0, s1=5.0, steps=1, lanes=[2]),
    dict(ev="finish", trace=2, rid=2, t=1.0, reason="eos", generated=1),
]


@pytest.mark.parametrize("events", [REQUEUE, OPEN, OVERRUN, REQUEUE + OPEN + OVERRUN],
                         ids=["requeue", "open", "overrun", "all"])
def test_build_trees_are_tpukit_s_byte_for_byte(events):
    got = trace_lib.build_trees(events)
    assert json.dumps(got, sort_keys=True) == json.dumps(tk_trace.build_trees(events),
                                                         sort_keys=True)
    assert json.dumps(trace_lib.to_chrome(events), sort_keys=True) == \
        json.dumps(tk_trace.to_chrome(events), sort_keys=True)
    by = {t["trace"]: t for t in got}
    if 7 in by:
        t = by[7]
        assert t["closed"] and t["complete"] and t["attempts"] == 2
        assert t["phases"]["queue_wait"] == pytest.approx(2.0)
        assert t["phases"]["prefill"] == pytest.approx(0.75)
        assert t["phases"]["sync_stall"] == pytest.approx(0.4)
        assert t["replicas"] == ["0", "1"] and t["quanta"] == 2 and t["generated"] == 8
    if 1 in by:
        assert not by[1]["closed"] and not by[1]["complete"]
    if 2 in by:
        assert by[2]["closed"] and not by[2]["complete"] and by[2]["residual_s"] > 1.0


def test_trace_recorder_rings_are_tpukit_s():
    """Per-replica rings, drops counted per ring, time-sorted snapshots,
    `percentile` as numpy's, as tpukit's recorder."""
    for make in (TraceRecorder, TkTraceRecorder):
        rec = make(capacity=3)
        for i in range(5):
            rec.emit("admit", i, t=5.0 - i, replica=None)
        rec.emit("admit", 9, t=0.5, replica=1)
        assert len(rec) == 4 and rec.total_emitted == 6 and rec.dropped == 2
        assert rec.dropped_by_replica == {None: 2}
        assert [e["t"] for e in rec.snapshot()] == [0.5, 1.0, 2.0, 3.0]
        with pytest.raises(ValueError):
            make(capacity=0)
    vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3]
    for q in (0, 25, 50, 99, 100):
        assert trace_lib.percentile(vals, q) == pytest.approx(float(np.percentile(vals, q)))


# ---- the entry point's records through tpukit's tools ---------------------

CLI = ["--device", "cpu", "--num_layers", "2", "--dim", "64", "--head_dim", "16", "--heads", "4",
       "--page_size", "8", "--fused_decode", "--requests", "16", "--metrics_log", "X.jsonl",
       "--metrics_dir", "D", "--slo", "e2e<=1000s@p99"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`python -m tpukit_torch.serve` with the telemetry flags, on the CPU."""
    work = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "tpukit_torch.serve", *CLI], cwd=work,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "traces: 100% complete span trees" in proc.stdout
    assert "SLO compliance 100.00%" in proc.stdout
    return work, env


@pytest.mark.parametrize("tool,args", [
    ("report", ["X.jsonl", "--min_trace_complete", "1.0"]),
    ("traceview", ["X.jsonl", "--out", "trace.json"]),
    ("top", ["D", "--log", "X.jsonl", "--once"]),
], ids=["report", "traceview", "top"])
def test_tools_read_the_entry_point_s_records(cli_run, tool, args):
    """`tools/report.py --min_trace_complete 1.0`, `tools/traceview.py` and
    `tools/top.py` read a port run's JSONL and metrics directory and exit 0."""
    work, env = cli_run
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / f"{tool}.py"), *args], cwd=work,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    if tool == "report":
        assert "--min_trace_complete OK: 16/16 span trees complete" in proc.stdout
    if tool == "traceview":
        events = json.loads((work / "trace.json").read_text())["traceEvents"]
        assert {e["cat"] for e in events if "cat" in e} >= {"quantum", "prefill", "phase"}
    if tool == "top":
        assert "serve_requests=16" in proc.stdout


def test_entry_point_logs_its_checkpoint_restores(tmp_path, monkeypatch):
    """`--checkpoint` and `--draft_checkpoint` each write tpukit's
    `kind="ckpt_restore"` row (`main-serve.py:316-320, 390-393`): the
    restore's I/O ledger, and for the target the serving world and its
    mismatch with the saving one."""
    from tpukit_torch import checkpoint as ckpt
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.serve import __main__ as serve_main
    from tpukit_torch.train import create_train_state

    vocab = get_tokenizer().vocab_size
    paths = {}
    for name, shape in (("target", dict(dim=32, head_dim=8, heads=4, num_layers=1)),
                        ("draft", dict(dim=16, head_dim=4, heads=4, num_layers=1))):
        cfg = GPTConfig(**shape, vocab_size=vocab, max_position_embeddings=64)
        paths[name] = ckpt.save_consolidated(create_train_state(
            gpt.init_params(cfg, seed=1, device="cpu"), 1e-3), tmp_path / name)
    monkeypatch.chdir(tmp_path)
    assert serve_main.main([
        "--device", "cpu", "--num_layers", "1", "--dim", "32", "--head_dim", "8", "--heads", "4",
        "--sequence_length", "64", "--requests", "2", "--slots", "2", "--buckets", "8,16",
        "--max_new_tokens", "2", "--checkpoint", str(paths["target"]), "--draft", "model",
        "--draft_dim", "16", "--draft_head_dim", "4", "--draft_heads", "4",
        "--draft_num_layers", "1", "--draft_checkpoint", str(paths["draft"]),
        "--metrics_log", "serve.jsonl"]) == 0
    target, draft = _of(_read(tmp_path / "serve.jsonl"), "ckpt_restore")
    ledger = {"format", "bytes_read", "bytes_skipped", "leaves_read", "leaves_skipped"}
    assert set(target) == {"kind", "time", "params_only", "checkpoint", "mismatch", "world"} | ledger
    assert target["checkpoint"] == str(paths["target"]) and target["params_only"] is True
    assert target["world"]["strategy"] == "tp" and target["world"]["nprocs"] == 1
    assert set(draft) == {"kind", "time", "params_only", "draft", "checkpoint"} | ledger
    assert draft["draft"] is True and draft["checkpoint"] == str(paths["draft"])
