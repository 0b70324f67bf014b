"""The port's serving fleet against tpukit's, on the CPU
(`tpukit_torch/serve/fleet.py`, `serve/ledger.py`, `chaos.ServingChaos`
against `tpukit/serve/fleet.py`, `ledger.py`, `chaos.py`).

The fixture is `tests/test_fleet.py`'s: dim 32, head dim 8, 4 heads, 2
layers, 64 positions, f32, tpukit's `init_params(PRNGKey(1))` carried into
the port by `bridge.params_from_numpy`, the fixture tokenizer and its
seeded streams. The bars:
  - the port's `FleetRouter` gives tpukit's `FleetRouter` tokens, and the
    port's single engine's, on the same stream: greedy and sampled, at
    once and at 50 qps, with a kill, with disaggregated prefill;
  - a kill requeues each in-flight request once, and the fleet's
    `(event, replica)` sequences (kill, autoscale), shed rids and
    `fleet_summary` key set equal tpukit's;
  - every `FleetConfig` and router `ValueError` is tpukit's, by message;
  - the process fleet survives a real SIGKILL, liveness tells a slow
    replica from a dead one, deadlines evict, the ledger replays, each
    as tpukit's tests hold it;
  - `ServingChaos` plans and I/O occurrences, and the page handoff's
    `extract_pages`/`insert_pages` on f32, bf16 and int8 pools with
    scales, equal tpukit's.
A router that re-seeds a requeued request fails the kill test (the
negative control).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit import chaos as jax_chaos
from tpukit.data import WordTokenizer as JaxWordTokenizer
from tpukit.data import synthetic_stories
from tpukit.model import GPTConfig as JaxConfig
from tpukit.model import init_params as jax_init_params
from tpukit.serve import FleetConfig as JaxFleetConfig
from tpukit.serve import FleetRouter as JaxFleetRouter
from tpukit.serve import Request as JaxRequest
from tpukit.serve import ServeConfig as JaxServeConfig
from tpukit.serve import ServeEngine as JaxServeEngine
from tpukit.serve import paged as jax_paged
from tpukit.serve import synthetic_request_stream as jax_stream
from tpukit_torch import bridge
from tpukit_torch import chaos as chaos_lib
from tpukit_torch.model import GPTConfig
from tpukit_torch.obs import FlightRecorder, MetricRegistry, StepLogger, TraceRecorder, parse_slo
from tpukit_torch.serve import paged
from tpukit_torch.serve.engine import Request, ServeConfig, ServeEngine
from tpukit_torch.serve.fleet import FleetConfig, FleetRouter
from tpukit_torch.serve.ledger import ProcessFleet
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_NEW = 10
ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_fleet_worker.py"


@pytest.fixture(scope="module")
def tok():
    return JaxWordTokenizer(synthetic_stories(64))


@pytest.fixture(scope="module")
def models(tok):
    kw = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tok.vocab_size,
              max_position_embeddings=64)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **kw)
    tcfg = GPTConfig(compute_dtype=torch.float32, **kw)
    jp = jax_init_params(jax.random.PRNGKey(1), jcfg)
    host = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), jp)
    return jcfg, tcfg, jp, host, bridge.params_from_numpy(host, device="cpu")


def _port(reqs):
    """tpukit's requests as the port's, field for field."""
    return [Request(**dataclasses.asdict(r)) for r in reqs]


def _tokens(comps):
    return {c.rid: list(map(int, c.ids)) for c in comps}


def _same(got: dict, want: dict, what: str, rids=None) -> None:
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for rid in rids if rids is not None else want:
        assert got[rid] == want[rid], f"{what}: rid {rid}"


def _single(models, tok, serve_kw, reqs) -> dict:
    _, tcfg, _, _, tp = models
    eng = ServeEngine(tp, tcfg, ServeConfig(**serve_kw), eos_id=int(tok.eos_token_id),
                      device="cpu")
    return _tokens(eng.run(_port(reqs), max_wall_s=300))


def _jax_single(models, tok, serve_kw, reqs) -> dict:
    jcfg, _, jp, _, _ = models
    eng = JaxServeEngine(jp, jcfg, JaxServeConfig(**serve_kw), eos_id=int(tok.eos_token_id))
    return _tokens(eng.run(list(reqs), max_wall_s=300))


class ListLogger:
    """A logger keeping its records in memory (`log(**record)`)."""

    def __init__(self):
        self.recs = []

    def log(self, **rec):
        self.recs.append(rec)

    def events(self):
        return [(r["event"], r.get("replica")) for r in self.recs if r["kind"] == "fleet_event"]


def _routers(models, tok, serve_kw, fleet_kw, reqs, port_cls=FleetRouter, **run):
    """The port's router and tpukit's on the same stream and weights, each
    with a `ListLogger`: (port router, port tokens, port logger, tpukit
    router, tpukit tokens, tpukit logger)."""
    jcfg, tcfg, _, host, tp = models
    eos = int(tok.eos_token_id)
    tlog, jlog = ListLogger(), ListLogger()
    trouter = port_cls(tp, tcfg, ServeConfig(**serve_kw), FleetConfig(**fleet_kw), eos_id=eos,
                       device="cpu", logger=tlog, **run)
    got = _tokens(trouter.run(_port(reqs), max_wall_s=300))
    jrouter = JaxFleetRouter(host, jcfg, JaxServeConfig(**serve_kw),
                             JaxFleetConfig(**fleet_kw), eos_id=eos, logger=jlog, **run)
    jgot = _tokens(jrouter.run(list(reqs), max_wall_s=300))
    return trouter, got, tlog, jrouter, jgot, jlog


# --------------------------------------------------------------- parity ----


@pytest.mark.parametrize("temperature,top_k,qps", [
    (0.0, 0, 0.0), (0.9, 5, 0.0), (0.9, 5, 50.0), (0.0, 0, 50.0),
], ids=["greedy", "sampled", "sampled_qps", "greedy_qps"])
def test_fleet_matches_tpukit_fleet_and_single_engine(tok, models, temperature, top_k, qps):
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, temperature=temperature,
                    top_k=top_k, window_steps=8)
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16), qps=qps)
    want = _single(models, tok, serve_kw, reqs)
    router, got, _, jrouter, jgot, _ = _routers(models, tok, serve_kw,
                                                dict(replicas=2, window_steps=4), reqs)
    _same(got, want, "port fleet vs port single engine")
    _same(got, jgot, "port fleet vs tpukit fleet")
    s = router.last_summary
    assert s["requests"] == 8 and s["duplicate_completions"] == 0
    assert s["kills"] == 0 and s["requeued"] == 0
    assert set(s) == set(jrouter.last_summary)


class ReseedingRouter(FleetRouter):
    """A broken router: a requeued request comes back with another seed."""

    def _requeue(self, victims, idx, now):
        victims = [dataclasses.replace(r, seed=r.seed + 1000) for r in victims]
        return super()._requeue(victims, idx, now)


def _kill_case(tok, models, temperature, top_k, port_cls=FleetRouter):
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, temperature=temperature,
                    top_k=top_k, window_steps=8)
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, reqs)
    out = _routers(models, tok, serve_kw,
                   dict(replicas=2, window_steps=4, kill_spec="replica_kill@1:1"), reqs,
                   port_cls=port_cls)
    return want, out


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.9, 5)], ids=["greedy", "sampled"])
def test_fleet_kill_requeues_exactly_once_as_tpukit(tok, models, temperature, top_k):
    want, (router, got, tlog, jrouter, jgot, jlog) = _kill_case(tok, models, temperature,
                                                                top_k)
    _same(got, want, "killed fleet vs single engine")
    _same(got, jgot, "killed fleet vs tpukit's")
    s = router.last_summary
    assert s["requests"] == 8 and s["duplicate_completions"] == 0
    assert s["kills"] == 1 and s["requeued"] >= 1
    assert s["per_replica"][1]["fate"] == "killed"
    assert tlog.events() == jlog.events() == [("replica_kill", 1)]
    kill = [r for r in tlog.recs if r["kind"] == "fleet_event"][0]
    jkill = [r for r in jlog.recs if r["kind"] == "fleet_event"][0]
    assert kill["requeued_rids"] == jkill["requeued_rids"] and kill["requeued_rids"]


def test_reseeding_router_fails_the_kill_test(tok, models):
    """The negative control: re-seeding a requeued request changes its
    sampled tokens, so the kill test's parity check catches it."""
    want, (router, got, tlog, *_) = _kill_case(tok, models, 0.9, 5, port_cls=ReseedingRouter)
    requeued = [r for r in tlog.recs if r["kind"] == "fleet_event"][0]["requeued_rids"]
    assert requeued and any(got[rid] != want[rid] for rid in requeued)
    with pytest.raises(AssertionError):
        _same(got, want, "re-seeded")


def test_fleet_never_kills_its_last_replica(tok, models):
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=8, window_steps=8)
    reqs = jax_stream(tok, 4, seed=2, max_new_tokens=8, buckets=(8, 16))
    router, got, tlog, jrouter, jgot, jlog = _routers(
        models, tok, serve_kw,
        dict(replicas=2, window_steps=4, kill_spec="replica_kill@0:1,replica_kill@1:0"), reqs)
    assert len(got) == 4 and router.last_summary["kills"] == jrouter.last_summary["kills"] == 1
    assert tlog.events() == jlog.events()
    _same(got, jgot, "fleet vs tpukit's")


def test_replicas_on_their_own_devices_match(tok, models):
    """`devices_per_replica` 1 puts replica i on devices[i]: one placement a
    device (here two CPU entries, one placement), the same tokens."""
    _, tcfg, _, _, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=6, window_steps=8)
    reqs = jax_stream(tok, 6, seed=5, max_new_tokens=6, buckets=(8, 16))
    want = _single(models, tok, serve_kw, reqs)
    router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                         FleetConfig(replicas=2, devices_per_replica=1, window_steps=4),
                         eos_id=int(tok.eos_token_id), device="cpu", devices=["cpu", "cpu"])
    assert [str(e.device) for e in router._replicas.values()] == ["cpu", "cpu"]
    _same(_tokens(router.run(_port(reqs), max_wall_s=300)), want, "one device a replica")
    assert router.last_summary["params_placements"] == 1


def test_grid_per_replica_raises_item_19b(tok, monkeypatch):
    """Item 19b, a grid a replica, is ported (`tests/test_torch_fleet_grid.py`
    serves it): `FleetConfig(devices_per_replica=2)` constructs, and the
    entry point's grid fleet no longer raises `NotPortedError` but tpukit's
    named error where the device list is too short (one CPU entry without
    `TPUKIT_CPU_DEVICES`). `--fleet_procs` keeps tpukit's meshless worker
    on the entry point's device whatever the grid (`main-serve.py:540-562`)."""
    from tpukit_torch.serve import __main__ as serve_main

    monkeypatch.delenv("TPUKIT_CPU_DEVICES", raising=False)
    assert FleetConfig(replicas=2, devices_per_replica=2).devices_per_replica == 2
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        serve_main.main(["--device", "cpu", "--replicas", "2", "--devices_per_replica", "4",
                         "--num_layers", "1", "--dim", "32", "--head_dim", "8", "--heads", "4"])
    flags = serve_main.parse_flags(["--replicas", "2", "--devices_per_replica", "2",
                                    "--fleet_procs", "--fleet_dir", "fleet"])
    for idx in (0, 1):
        assert serve_main._replica_device(flags, torch.device("cuda", 0), idx) == \
            torch.device("cuda", 0)


# ------------------------------------------------ disaggregated prefill ----


def test_disagg_prefill_matches_tpukit_without_decode_side_prefill(tok, models):
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8,
                    page_size=8)
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16), shared_prefix=8)
    want = _single(models, tok, serve_kw, reqs)
    _, tcfg, _, _, tp = models
    router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                         FleetConfig(replicas=2, window_steps=4, disagg_prefill=True),
                         eos_id=int(tok.eos_token_id), device="cpu")
    replicas = list(router._replicas.values())
    got = _tokens(router.run(_port(reqs), max_wall_s=300))
    _same(got, want, "disaggregated fleet vs single engine")
    jcfg, _, _, host, _ = models
    jrouter = JaxFleetRouter(host, jcfg, JaxServeConfig(**serve_kw),
                             JaxFleetConfig(replicas=2, window_steps=4, disagg_prefill=True),
                             eos_id=int(tok.eos_token_id))
    _same(got, _tokens(jrouter.run(list(reqs), max_wall_s=300)), "vs tpukit's")
    dp = router.last_summary["disagg_prefill"]
    assert dp == jrouter.last_summary["disagg_prefill"]
    assert dp["handoffs"] == 8 and dp["worker_admitted"] == 8 and dp["worker_prefix_hits"] > 0
    for eng in replicas:  # decode replicas never prefill
        assert eng.prefill_dispatches == 0
        assert eng.spans.epoch()["seconds"].get("prefill", 0.0) == 0.0
    assert router.prefill.prefill_dispatches > 0


def test_disagg_claims_survive_prefill_pool_pressure(tok, models):
    """Decode-side pages backing live lanes are refcounted and never
    reclaimed, however hard the worker's pool is pressed (tpukit's test;
    its own expected tokens were not green at the seed, so these come from
    the port's single engine, held against tpukit's elsewhere)."""
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8,
                    page_size=8)
    min_pages = -(-(16 + MAX_NEW) // 8) + 1
    shared = jax_stream(tok, 6, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16),
                        shared_prefix=8)
    unique = jax_stream(tok, 4, seed=11, max_new_tokens=MAX_NEW, buckets=(8, 16))
    reqs = list(shared)
    for i, r in enumerate(unique):
        reqs.insert(2 * i + 1, JaxRequest(rid=100 + i, ids=r.ids, max_new_tokens=MAX_NEW,
                                          seed=11 + i))
    want = _single(models, tok, serve_kw, reqs)
    _, tcfg, _, _, tp = models
    router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                         FleetConfig(replicas=2, window_steps=4, disagg_prefill=True,
                                     prefill_pages=min_pages),
                         eos_id=int(tok.eos_token_id), device="cpu")
    replicas = list(router._replicas.values())
    _same(_tokens(router.run(_port(reqs), max_wall_s=300)), want, "under pool pressure")
    assert router.prefill.allocator.stats.reclaimed > 0
    assert sum(e.allocator.stats.prefix_hits for e in replicas) > 0


def test_claimed_pages_never_reclaimed_unit():
    alloc = paged.PageAllocator(num_pages=6, page_size=4)
    ids = tuple(range(8))
    own = alloc.alloc(2)
    alloc.register(ids, own)
    alloc.claim(own)
    alloc.release(own)
    assert alloc.refcount[own[0]] == 1
    assert alloc.alloc(4) is None  # refuses rather than steal from a reader
    assert alloc.lookup_prefix(ids, 2) == own
    alloc.release(own)
    assert alloc.alloc(4) is not None


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_page_handoff_matches_tpukit(kv_dtype):
    """`extract_pages`/`insert_pages` against tpukit's on the K/V pools
    (and, int8, the scale sidecars): the extracted block and the written
    pool equal bit for bit; `insert_pages` casts to the pool's dtype."""
    rng = np.random.RandomState(7)
    shape, sshape = (2, 9, 4, 8, 8), (2, 9, 4, 1)
    pools = {"k": shape, "v": shape}
    if kv_dtype == "int8":
        pools.update(ks=sshape, vs=sshape)
    src_ids, dst_ids = [3, 1, 7], [2, 8, 5]
    for name, shp in pools.items():
        if kv_dtype == "int8" and name in ("k", "v"):
            src = rng.randint(-127, 128, shp).astype(np.int8)
            dst = rng.randint(-127, 128, shp).astype(np.int8)
        else:
            src = rng.randn(*shp).astype(np.float32)
            dst = rng.randn(*shp).astype(np.float32)
        jdt = {"bf16": jnp.bfloat16}.get(kv_dtype) if name in ("k", "v") else None
        jsrc, jdst = jnp.asarray(src, dtype=jdt), jnp.asarray(dst, dtype=jdt)
        tdt = {"bf16": torch.bfloat16}.get(kv_dtype) if name in ("k", "v") else None
        tsrc = torch.from_numpy(src).to(tdt) if tdt else torch.from_numpy(src.copy())
        tdst = torch.from_numpy(dst).to(tdt) if tdt else torch.from_numpy(dst.copy())
        jblock = jax_paged.extract_pages(jsrc, jnp.asarray(src_ids, jnp.int32))
        tblock = paged.extract_pages(tsrc, torch.tensor(src_ids))
        assert tblock.dtype == tsrc.dtype and tuple(tblock.shape) == jblock.shape
        # an f32 block goes in: insert casts it to the pool's dtype
        jout = jax_paged.insert_pages(jdst, jnp.asarray(dst_ids, jnp.int32),
                                      jblock.astype(jnp.float32))
        ptr = tdst.data_ptr()
        tout = paged.insert_pages(tdst, torch.tensor(dst_ids), tblock.float())
        assert tout.dtype == tdst.dtype and tout.data_ptr() == ptr  # in place
        for j, t in ((jblock, tblock), (jout, tout)):
            np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                          t.float().numpy(), err_msg=name)


# ------------------------------------------------------------ autoscale ----


def test_autoscale_events_match_tpukit(tok, models):
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=8, window_steps=8)
    burst = jax_stream(tok, 10, seed=7, max_new_tokens=8, buckets=(8, 16))
    trickle = [JaxRequest(rid=100 + i, ids=burst[i].ids, max_new_tokens=8, seed=7 + i,
                          arrival_s=1.5 + 0.4 * i) for i in range(4)]
    reqs = burst + trickle
    want = _single(models, tok, serve_kw, reqs)
    _jax_single(models, tok, serve_kw, reqs)  # tpukit's programs compiled before its fleet runs
    router, got, tlog, jrouter, jgot, jlog = _routers(
        models, tok, serve_kw,
        dict(replicas=1, max_replicas=2, window_steps=2, scale_up_occupancy=0.9,
             scale_down_occupancy=0.45), reqs)
    _same(got, want, "autoscaled fleet vs single engine")
    _same(got, jgot, "vs tpukit's")
    s = router.last_summary
    assert s["scale_ups"] >= 1 and s["scale_downs"] >= 1 and s["replicas_peak"] == 2
    assert s["duplicate_completions"] == 0
    assert tlog.events() == jlog.events()
    assert tlog.events()[:3] == [("scale_up", 1), ("scale_down", 1),
                                 ("scale_down_complete", 1)]


# ------------------------------------------------------------ telemetry ----


def test_fleet_jsonl_kinds_and_summary_keys_match_tpukit(tok, models, tmp_path):
    from tpukit.obs import FlightRecorder as JaxRecorder
    from tpukit.obs import MetricRegistry as JaxRegistry
    from tpukit.obs import StepLogger as JaxLogger
    from tpukit.obs import TraceRecorder as JaxTracer
    from tpukit.obs import parse_slo as jax_parse_slo

    jcfg, tcfg, _, host, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=8, window_steps=4)
    fleet_kw = dict(replicas=2, window_steps=2, kill_spec="replica_kill@1:1")
    reqs = jax_stream(tok, 8, seed=8, max_new_tokens=8, buckets=(8, 16))
    slo = "e2e<=1000s@p99;ttft<=1us@p95"
    logs = {}
    for side in ("port", "tpukit"):
        log = tmp_path / f"{side}.jsonl"
        if side == "port":
            logger = StepLogger(str(log))
            router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw), FleetConfig(**fleet_kw),
                                 eos_id=int(tok.eos_token_id), device="cpu", logger=logger,
                                 recorder=FlightRecorder(), tracer=TraceRecorder(),
                                 metrics=MetricRegistry(), slo=parse_slo(slo),
                                 metrics_dir=str(tmp_path / "metrics"))
            router.run(_port(reqs), max_wall_s=300)
        else:
            logger = JaxLogger(str(log))
            router = JaxFleetRouter(host, jcfg, JaxServeConfig(**serve_kw),
                                    JaxFleetConfig(**fleet_kw), eos_id=int(tok.eos_token_id),
                                    logger=logger, recorder=JaxRecorder(), tracer=JaxTracer(),
                                    metrics=JaxRegistry(), slo=jax_parse_slo(slo))
            router.run(list(reqs), max_wall_s=300)
        logger.close()
        logs[side] = [json.loads(l) for l in log.read_text().splitlines()]
    kinds = {side: {r["kind"] for r in recs} for side, recs in logs.items()}
    assert kinds["port"] == kinds["tpukit"]
    assert {"fleet", "fleet_event", "fleet_summary", "serve", "serve_summary", "trace",
            "trace_event", "metrics", "slo"} <= kinds["port"]
    summaries = {side: [r for r in recs if r["kind"] == "fleet_summary"]
                 for side, recs in logs.items()}
    assert len(summaries["port"]) == 1
    assert set(summaries["port"][0]) == set(summaries["tpukit"][0])
    s = summaries["port"][0]
    assert s["requests"] == 8 and s["requeued"] >= 1 and s["trace_complete"] == 1.0
    assert all("replica" in r for r in logs["port"] if r["kind"] in ("serve", "serve_summary"))
    assert (tmp_path / "metrics" / "metrics-merged.json").exists()
    for gate in (["--min_fleet_tps", "1"], ["--min_trace_complete", "1.0"]):
        proc = subprocess.run([sys.executable, str(ROOT / "tools" / "report.py"),
                               str(tmp_path / "port.jsonl"), *gate], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "== fleet ==" in proc.stdout


# ----------------------------------------------------------- validation ----


def _ring(**kw):
    return dict(slots=2, buckets=(8,), max_new_tokens=4, **kw)


CONFIG_ERRORS = {
    "replicas": (dict(replicas=0), None),
    "min_replicas": (dict(replicas=2, min_replicas=3), None),
    "max_replicas": (dict(replicas=4, max_replicas=2), None),
    "devices_per_replica": (dict(devices_per_replica=-1), None),
    "occupancy_range": (dict(scale_up_occupancy=1.5), None),
    "oscillate": (dict(scale_up_occupancy=0.5, scale_down_occupancy=0.5), None),
    "window_steps": (dict(window_steps=0), None),
    "prefill_slots": (dict(prefill_slots=-1, disagg_prefill=True), None),
    "prefill_worker": (dict(prefill_slots=4), None),
    "kill_spec_kind": (dict(kill_spec="nan_loss@5"), None),
    "kill_spec_stall": (dict(replicas=2, kill_spec="slow_replica@2"), None),
    "replica_timeout": (dict(replicas=2, replica_timeout=-1.0), None),
    "replica_timeout_dir": (dict(replicas=2, replica_timeout=1.0), None),
    "request_retries": (dict(replicas=2, request_retries=-1), None),
    "max_queue_depth": (dict(replicas=2, max_queue_depth=-1), None),
    "disagg_on_ring": (dict(replicas=2, disagg_prefill=True), dict(serve=_ring())),
    "devices": (dict(replicas=2, devices_per_replica=1), dict(serve=_ring(), devices=1)),
    "devices_grid": (dict(replicas=2, devices_per_replica=8), dict(serve=_ring(), devices=8)),
    "moe_meshless": (dict(replicas=2, devices_per_replica=1),
                     dict(serve=_ring(), moe=True, devices=2)),
    "moe_grid": (dict(replicas=2, devices_per_replica=2),
                 dict(serve=_ring(), moe=True, devices=4)),
}


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_fleet_config_errors_are_tpukits(case, tok, models):
    """Each named construction error of `FleetConfig` and `FleetRouter`:
    the port raises tpukit's exception type with tpukit's message."""
    fleet_kw, router = CONFIG_ERRORS[case]
    jcfg, tcfg, _, host, tp = models
    errors = []
    for side in ("tpukit", "port"):
        try:
            if side == "tpukit":
                fc = JaxFleetConfig(**fleet_kw)
                if router:
                    cfg = jcfg.replace(num_experts=2, moe_dispatch="pallas") \
                        if router.get("moe") else jcfg
                    JaxFleetRouter(host, cfg, JaxServeConfig(**router["serve"]), fc, eos_id=1,
                                   devices=jax.devices()[: router.get("devices", 8)])
            else:
                fc = FleetConfig(**fleet_kw)
                if router:
                    cfg = tcfg.replace(num_experts=2, moe_dispatch="pallas") \
                        if router.get("moe") else tcfg
                    FleetRouter(tp, cfg, ServeConfig(**router["serve"]), fc, eos_id=1,
                                device="cpu", devices=["cpu"] * router.get("devices", 8))
        except ValueError as exc:
            errors.append((type(exc).__name__, str(exc)))
        else:
            errors.append(None)
    assert errors[0] is not None and errors[0] == errors[1], errors


@pytest.mark.parametrize("spec", [
    "replica_kill@3,replica_sigkill@4:1,slow_replica@2:50,stuck_request@7,ledger_io_fail@2:3",
    "replica_kill@1:1,replica_kill@1,replica_sigkill@6",
    "slow_replica@2:60000,stuck_request@1,ledger_io_fail@7:9",
    "",
])
def test_serving_chaos_plan_matches_tpukit(spec):
    j, t = jax_chaos.ServingChaos(spec), chaos_lib.ServingChaos(spec)
    for attr in ("kills", "sigkills", "stalls", "stuck", "_io_plan", "_io_seen"):
        assert getattr(t, attr) == getattr(j, attr), attr


def test_serving_chaos_io_occurrences_match_tpukit():
    """A count of c fails the first c attempts of its occurrence, then it
    completes; other sites pass. The port raises where tpukit raises and
    records the same fired events."""
    spec = "ledger_io_fail@2:2,ledger_io_fail@4:1"
    pattern = {}
    for side, mod in (("tpukit", jax_chaos), ("port", chaos_lib)):
        ch = mod.ServingChaos(spec)
        raised = []
        for _ in range(8):
            try:
                ch.io_fault("ledger")
                raised.append(False)
            except IOError as exc:
                raised.append(str(exc))
        ch.io_fault("checkpoint")  # not this plan's site
        pattern[side] = (raised, ch.drain_fired())
    assert pattern["port"] == pattern["tpukit"]
    assert sum(1 for r in pattern["port"][0] if r) == 3


def test_training_engine_refuses_fleet_kinds():
    with pytest.raises(chaos_lib.ChaosSpecError, match="fleet-scoped"):
        chaos_lib.ChaosEngine("replica_kill@5")
    with pytest.raises(chaos_lib.ChaosSpecError, match="integer replica id"):
        chaos_lib.validate_fleet_spec("replica_sigkill@5:-1")


# ----------------------------------------------------- crash tolerance ----


def test_process_fleet_sigkill_requeues_with_tpukits_tokens(tok, models, tmp_path):
    """A worker process SIGKILLed mid-stream loses nothing: its leases are
    revoked and requeued onto the survivor, the durable completions are
    tpukit's single engine's tokens, and no rid completes twice."""
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _jax_single(models, tok, serve_kw, reqs)
    params_pt = tmp_path / "params.pt"
    torch.save(models[4], params_pt)
    log = tmp_path / "procs.jsonl"
    logger = StepLogger(str(log))

    def spawn(idx):
        return subprocess.Popen([sys.executable, str(WORKER), str(tmp_path / "fleet"),
                                 str(idx), str(params_pt), "120"], cwd=str(ROOT),
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    fleet = ProcessFleet(tmp_path / "fleet", spawn=spawn, replicas=2, replica_timeout=60.0,
                         request_retries=3,
                         chaos=chaos_lib.ServingChaos("replica_sigkill@3:1"), logger=logger)
    s = fleet.run(_port(reqs), max_wall_s=120.0)
    logger.close()
    got = {rid: list(map(int, rec["ids"])) for rid, rec in fleet.ledger.completions().items()}
    _same(got, want, "process fleet vs tpukit's single engine")
    assert s["kills"] == 1 and s["replicas_dead"] >= 1
    assert s["requeued"] >= 1 and s["leases_revoked"] >= 1
    assert s["duplicate_completions"] == 0 and s["ledger"]["duplicates"] == 0
    assert s["request_failures"] == 0
    assert any(d["reason"] == "exit" and d.get("code") == -9 for d in s["deaths"])
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    events = {r["event"] for r in recs if r["kind"] == "fleet_event"}
    assert "replica_sigkill" in events and "replica_dead" in events
    assert any(r["kind"] == "lease_requeue" for r in recs)
    assert any(r["kind"] == "chaos" and r.get("fault") == "replica_sigkill" for r in recs)


def test_liveness_tells_slow_from_dead(tok, models, tmp_path):
    """slow_replica@R:ms against replica_timeout (tpukit's test): a stall
    shorter than the timeout is a straggler, not dead; the same fault
    outliving it is a death, whose pinned request requeues, meets its
    deadline on the survivor, and is the one `deadline` completion."""
    _, tcfg, _, _, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    base = jax_stream(tok, 16, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, base)
    eos = int(tok.eos_token_id)
    slow = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                       FleetConfig(replicas=2, window_steps=4, fleet_dir=str(tmp_path / "slow"),
                                   replica_timeout=5.0, kill_spec="slow_replica@2:30"),
                       eos_id=eos, device="cpu")
    _same(_tokens(slow.run(_port(base), max_wall_s=300)), want, "slow replica")
    s = slow.last_summary
    assert s["replicas_dead"] == 0 and s["kills"] == 0 and s["requeued"] == 0
    reqs = [dataclasses.replace(r, deadline_ms=800.0) if r.rid == 1 else r for r in base]
    dead = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                       FleetConfig(replicas=2, window_steps=4, fleet_dir=str(tmp_path / "dead"),
                                   replica_timeout=0.15,
                                   kill_spec="slow_replica@2:60000,stuck_request@1"),
                       eos_id=eos, device="cpu")
    comps = dead.run(_port(reqs), max_wall_s=300)
    got = _tokens(comps)
    _same(got, want, "dead replica", rids=[r for r in want if r != 1])
    assert {c.rid: c for c in comps}[1].reason == "deadline"
    s = dead.last_summary
    assert s["replicas_dead"] == 1 and s["requeued"] >= 1 and s["leases_revoked"] >= 1
    assert s["duplicate_completions"] == 0 and s["ledger"]["duplicates"] == 0
    assert s["per_replica"][1]["fate"] == "dead" and s["deadline_misses"] == 1


def test_deadline_evicts_stuck_request(tok, models, tmp_path):
    """stuck_request@RID with a deadline: the pinned request is evicted at
    its deadline with reason "deadline" and a `deadline_miss` row, its
    tokens a prefix of the run without it; every other request's tokens
    are untouched; tools/report.py's deadline gate reads the miss."""
    import importlib

    report = importlib.import_module("tools.report")
    _, tcfg, _, _, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    base = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, base)
    stuck = base[2].rid
    reqs = [dataclasses.replace(r, deadline_ms=600.0) if r.rid == stuck else r for r in base]
    log = tmp_path / "deadline.jsonl"
    logger = StepLogger(str(log))
    metrics = MetricRegistry()
    router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                         FleetConfig(replicas=2, window_steps=4,
                                     kill_spec=f"stuck_request@{stuck}"),
                         eos_id=int(tok.eos_token_id), device="cpu", logger=logger,
                         metrics=metrics)
    comps = router.run(_port(reqs), max_wall_s=120)
    logger.close()
    got = _tokens(comps)
    assert got.keys() == want.keys()
    by_rid = {c.rid: c for c in comps}
    assert by_rid[stuck].reason == "deadline"
    assert got[stuck] == want[stuck][: len(got[stuck])]
    _same(got, want, "deadline", rids=[r for r in want if r != stuck])
    s = router.last_summary
    assert s["deadline_misses"] == 1 and s["duplicate_completions"] == 0
    assert metrics.sum_counter("serve_deadline_miss") == 1
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    misses = [r for r in recs if r["kind"] == "deadline_miss"]
    assert len(misses) == 1 and misses[0]["rid"] == stuck and misses[0]["over_ms"] > 0
    assert "replica" in misses[0]
    assert report.check_max_deadline_miss_pct(recs, 50.0)[0]
    assert not report.check_max_deadline_miss_pct(recs, 5.0)[0]


def test_single_engine_deadline_evicts_as_tpukits(tok, models):
    """The engine's own deadline eviction, standalone: the port and tpukit
    evict the same pinned request with the same reason, and the other
    requests' tokens are each other's."""
    jcfg, tcfg, jp, _, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    base = jax_stream(tok, 6, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    reqs = [dataclasses.replace(r, deadline_ms=400.0) if r.rid == 1 else r for r in base]
    out = {}
    for side in ("port", "tpukit"):
        if side == "port":
            eng = ServeEngine(tp, tcfg, ServeConfig(**serve_kw), eos_id=int(tok.eos_token_id),
                              device="cpu")
            eng.stuck_rids = {1}
            comps = eng.run(_port(reqs), max_wall_s=120)
        else:
            eng = JaxServeEngine(jp, jcfg, JaxServeConfig(**serve_kw),
                                 eos_id=int(tok.eos_token_id))
            eng.stuck_rids = {1}
            comps = eng.run(list(reqs), max_wall_s=120)
        out[side] = ({c.rid: c.reason for c in comps}, _tokens(comps),
                     eng.last_summary["evicted_deadline"])
    assert out["port"][0] == out["tpukit"][0] and out["port"][0][1] == "deadline"
    assert out["port"][2] == out["tpukit"][2] == 1
    _same(out["port"][1], out["tpukit"][1], "engine deadline", rids=[0, 2, 3, 4, 5])


def test_backpressure_sheds_tpukits_rids(tok, models, tmp_path):
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    base = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, base)
    keep = {base[0].rid, base[5].rid}
    reqs = [dataclasses.replace(r, priority=1) if r.rid in keep else r for r in base]
    router, got, tlog, jrouter, jgot, jlog = _routers(
        models, tok, serve_kw, dict(replicas=2, window_steps=4, max_queue_depth=2), reqs)
    assert got.keys() == jgot.keys() == keep
    for rid in keep:
        assert got[rid] == want[rid] == jgot[rid], rid
    shed = lambda log: [r["rid"] for r in log.recs  # noqa: E731
                        if r["kind"] == "fleet_event" and r["event"] == "request_rejected"]
    assert shed(tlog) == shed(jlog) and set(shed(tlog)) == {r.rid for r in base} - keep
    assert router.last_summary["rejected"] == jrouter.last_summary["rejected"] == 6
    # with a ledger each shed rid is a terminal backpressure record
    _, tcfg, _, _, tp = models
    led = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                      FleetConfig(replicas=2, window_steps=4, max_queue_depth=2,
                                  fleet_dir=str(tmp_path / "fleet")),
                      eos_id=int(tok.eos_token_id), device="cpu")
    led.run(_port(reqs), max_wall_s=120)
    fails = led.ledger.failures()
    assert set(fails) == {r.rid for r in base} - keep
    assert all(f["reason"] == "backpressure" for f in fails.values())


def test_ledger_replay_resumes_at_the_frontier(tok, models, tmp_path):
    """A router that dies mid-stream (a ledger I/O fault past the retry
    budget) leaves its completed frontier durable; a router restarted on
    the same directory serves only the rest; the union is the single
    engine's tokens with no duplicate."""
    _, tcfg, _, _, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, reqs)
    fdir = str(tmp_path / "fleet")
    eos = int(tok.eos_token_id)
    crashed = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                          FleetConfig(replicas=2, window_steps=4, fleet_dir=fdir,
                                      kill_spec="ledger_io_fail@7:9"),
                          eos_id=eos, device="cpu")
    with pytest.raises(IOError, match="chaos: injected"):
        crashed.run(_port(reqs), max_wall_s=300)
    assert chaos_lib.installed() is None  # the plan does not outlive the run
    durable = crashed.ledger.completions()
    assert 1 <= len(durable) < 8
    restarted = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                            FleetConfig(replicas=2, window_steps=4, fleet_dir=fdir),
                            eos_id=eos, device="cpu")
    comps = restarted.run(_port(reqs), max_wall_s=300)
    assert {c.rid for c in comps} == set(want) - set(durable)
    s = restarted.last_summary
    assert s["ledger"] == dict(completed=8, replayed=len(durable), duplicates=0)
    got = {rid: list(map(int, rec["ids"]))
           for rid, rec in restarted.ledger.completions().items()}
    _same(got, want, "ledger union")


def test_ledger_io_fault_absorbed_by_retry(tok, models, tmp_path):
    _, tcfg, _, _, tp = models
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, reqs)
    log = tmp_path / "iofault.jsonl"
    logger = StepLogger(str(log))
    router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw),
                         FleetConfig(replicas=2, window_steps=4,
                                     fleet_dir=str(tmp_path / "fleet"),
                                     kill_spec="ledger_io_fail@2:2"),
                         eos_id=int(tok.eos_token_id), device="cpu", logger=logger)
    _same(_tokens(router.run(_port(reqs), max_wall_s=300)), want, "I/O faults absorbed")
    logger.close()
    s = router.last_summary
    assert s["duplicate_completions"] == 0 and s["ledger"]["duplicates"] == 0
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    assert sum(1 for r in recs if r["kind"] == "chaos" and r.get("fault") == "ledger_io") == 2
