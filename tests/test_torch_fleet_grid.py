"""Fleet replicas over a model-parallel grid (`FleetConfig.devices_per_replica`
above 1: `tpukit_torch/serve/replica_world.py`, `serve/fleet.py`) against
tpukit's router on subset meshes, on the CPU.

The port's router carves `devices=["cpu"] * N` into subsets, and each
replica is a gloo world of its own, one rank process a subset entry,
serving on `pick_serve_grid`'s grid; tpukit's router serves the same
stream on subset meshes of the suite's forced CPU devices. The fixture,
parameters and streams are `tests/test_torch_fleet.py`'s (dim 32, 4 heads
x 8, 2 layers, f32, tpukit's `PRNGKey(1)` parameters bridged). The bars:
  - the two routers' tokens are equal, and equal to the port's single
    engine's: greedy and sampled, on the ring and paged with fused decode,
    each under a replica kill (each in-flight request requeued once, the
    `(event, replica)` sequence tpukit's); under autoscale onto a free
    subset; under disaggregated prefill with the worker meshless, and on a
    spare subset with an int8 page handoff into a model-2 pool;
  - `params_placements` and each replica's grid axes are tpukit's (its
    engines' `mesh.shape`), at 2 and 4 devices a replica;
  - the entry point's JSONL kinds and `fleet_summary` keys are tpukit's
    router's, and `tools/report.py`'s fleet and trace gates pass on it;
  - no rank process outlives its router's run, a kill, or its router; a
    dead rank makes the router raise with the rank's log, not hang.
tpukit's tensor-parallel fused decode does not run under this container's
jax (`shard_map(check_rep=...)`, ROADMAP.md §C "Not faults"), so tpukit's
paged grids decode unfused: the same tokens by design (fused, unfused and
ring engines agree, `serve/engine.py`). The port's ranks inherit MKL's
reproducible path (`tests/torch_threads.py`) and this process's one torch
thread.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpukit.obs import MetricRegistry as JaxRegistry
from tpukit.obs import StepLogger as JaxLogger
from tpukit.obs import TraceRecorder as JaxTracer
from tpukit.serve import FleetConfig as JaxFleetConfig
from tpukit.serve import FleetRouter as JaxFleetRouter
from tpukit.serve import Request as JaxRequest
from tpukit.serve import ServeConfig as JaxServeConfig
from tpukit.serve import synthetic_request_stream as jax_stream
from tpukit_torch.model import GPTConfig
from tpukit_torch.serve import replica_world
from tpukit_torch.serve.engine import Completion, ServeConfig, ServeEngine
from tpukit_torch.serve.fleet import FleetConfig, FleetRouter
from tpukit_torch.serve.replica_world import GridReplica, ReplicaWorldError
from test_torch_fleet import (MAX_NEW, ROOT, ListLogger, _port, _same, _single,  # noqa: F401
                              _tokens, models, tok)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOUND_S = 120.0  # every wait on a world: a hung collective fails the test
ROUTER_SCRIPT = Path(__file__).resolve().parent / "torch_grid_router.py"


def _alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie no longer does)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


class Built(list):
    """The grid worlds a test built; `unreaped` lists ranks found running
    after their world closed."""

    def __init__(self):
        super().__init__()
        self.unreaped = []


@pytest.fixture
def worlds(monkeypatch):
    """Every grid world built in the test, in build order, each with its
    waits bounded by BOUND_S; `unreaped` lists a rank still running right
    after its world's `close` (a kill or a retirement)."""
    monkeypatch.setattr(replica_world, "REPLY_TIMEOUT_S", BOUND_S)
    built = Built()
    init, close = GridReplica.__init__, GridReplica.close

    def track_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    def track_close(self):
        close(self)
        built.unreaped.extend(p for p in self.pids() if _alive(p))

    monkeypatch.setattr(GridReplica, "__init__", track_init)
    monkeypatch.setattr(GridReplica, "close", track_close)
    yield built
    for w in built:
        close(w)


def _reaped(built) -> None:
    """No rank process of any world built is left, nor was one left running
    when its world closed."""
    assert not built.unreaped, built.unreaped
    assert not [p for w in built for p in w.pids() if _alive(p)]


def _grid_routers(models, tok, serve_kw, fleet_kw, reqs, n_dev: int, tk_serve_kw=None):
    """The port's grid router on `n_dev` CPU entries and tpukit's on as many
    forced CPU devices, on the same stream and weights, each with a
    `ListLogger`: (port router, its grid axes before the run, tokens,
    logger; tpukit's router, its engines' mesh axes, tokens, logger)."""
    jcfg, tcfg, _, host, tp = models
    eos = int(tok.eos_token_id)
    tlog, jlog = ListLogger(), ListLogger()
    router = FleetRouter(tp, tcfg, ServeConfig(**serve_kw), FleetConfig(**fleet_kw),
                         eos_id=eos, device="cpu", devices=["cpu"] * n_dev, logger=tlog)
    axes = [e.grid for e in router._replicas.values()]
    got = _tokens(router.run(_port(reqs), max_wall_s=BOUND_S))
    jrouter = JaxFleetRouter(host, jcfg, JaxServeConfig(**(tk_serve_kw or serve_kw)),
                             JaxFleetConfig(**fleet_kw), eos_id=eos,
                             devices=jax.devices()[:n_dev], logger=jlog)
    jaxes = [dict(e.mesh.shape) for e in jrouter._replicas.values()]
    jgot = _tokens(jrouter.run(list(reqs), max_wall_s=BOUND_S))
    return router, axes, got, tlog, jrouter, jaxes, jgot, jlog


def _unfused(serve_kw: dict) -> dict:
    """tpukit's side of a paged case: unfused (see the module docstring)."""
    return {k: v for k, v in serve_kw.items() if k != "fused_decode"}


# --------------------------------------------------------------- parity ----

GRID_CASES = {
    "ring_greedy": dict(),
    "ring_sampled": dict(temperature=0.9, top_k=5),
    "paged_fused_greedy": dict(page_size=8, fused_decode=True),
    "paged_fused_sampled": dict(page_size=8, fused_decode=True, temperature=0.9, top_k=5),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_fleet_with_a_kill_matches_tpukit_and_single_engine(case, tok, models, worlds):
    """Two replicas of 2 devices (model 2, 2 heads a rank), replica 1 killed
    at round 1: the tokens are tpukit's grid fleet's and the single
    engine's, each request completes once, the kill's event and requeued
    rids are tpukit's, and the killed world is reaped at once."""
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8,
                    **GRID_CASES[case])
    reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, reqs)
    router, axes, got, tlog, jrouter, jaxes, jgot, jlog = _grid_routers(
        models, tok, serve_kw,
        dict(replicas=2, devices_per_replica=2, window_steps=4, kill_spec="replica_kill@1:1"),
        reqs, 4, _unfused(serve_kw))
    _same(got, want, "grid fleet vs single engine")
    _same(got, jgot, "grid fleet vs tpukit's")
    assert axes == jaxes == [{"data": 1, "model": 2}] * 2
    s, js = router.last_summary, jrouter.last_summary
    assert s["requests"] == 8 and s["duplicate_completions"] == 0
    assert s["kills"] == 1 and s["requeued"] >= 1 and s["per_replica"][1]["fate"] == "killed"
    assert s["params_placements"] == js["params_placements"] == 2
    assert set(s) == set(js)
    assert tlog.events() == jlog.events() == [("replica_kill", 1)]
    kill = [r for r in tlog.recs if r["kind"] == "fleet_event"][0]
    jkill = [r for r in jlog.recs if r["kind"] == "fleet_event"][0]
    assert kill["requeued_rids"] == jkill["requeued_rids"] and kill["requeued_rids"]
    assert len(worlds) == 2 and all(len(w.pids()) == 2 for w in worlds)
    _reaped(worlds)


def test_grid_autoscale_onto_a_free_subset_matches_tpukit(tok, models, worlds):
    """One replica of 2 devices grows onto the free subset and drains back:
    tpukit's event sequence, its tokens, the second world built at the
    scale-up and reaped at its retirement. The router waits for a world it
    builds to start, as tpukit's waits for its new replica's compiles; a
    world takes seconds (its processes import torch), so the trickle that
    lets the fleet drain comes later and sparser than tpukit's `test_fleet.py`
    one (from 1.5 s, 0.4 s apart): one request a second from 4 s, so that
    however long the world took, the last ones decode alone."""
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=8, window_steps=8)
    burst = jax_stream(tok, 10, seed=7, max_new_tokens=8, buckets=(8, 16))
    trickle = [JaxRequest(rid=100 + i, ids=burst[i].ids, max_new_tokens=8, seed=7 + i,
                          arrival_s=4.0 + 1.0 * i) for i in range(4)]
    reqs = burst + trickle
    want = _single(models, tok, serve_kw, reqs)
    router, _, got, tlog, jrouter, _, jgot, jlog = _grid_routers(
        models, tok, serve_kw,
        dict(replicas=1, max_replicas=2, devices_per_replica=2, window_steps=2,
             scale_up_occupancy=0.9, scale_down_occupancy=0.45), reqs, 4)
    _same(got, want, "autoscaled grid fleet vs single engine")
    _same(got, jgot, "vs tpukit's")
    s = router.last_summary
    assert s["scale_ups"] >= 1 and s["scale_downs"] >= 1 and s["replicas_peak"] == 2
    assert s["duplicate_completions"] == 0
    assert tlog.events() == jlog.events()
    assert tlog.events()[:3] == [("scale_up", 1), ("scale_down", 1), ("scale_down_complete", 1)]
    up = [r for r in tlog.recs if r["kind"] == "fleet_event" and r["event"] == "scale_up"]
    assert up[0]["devices"] == 2
    assert [w.devices for w in worlds[:2]] == [[torch.device("cpu")] * 2] * 2
    _reaped(worlds)


@pytest.mark.parametrize("where", ["meshless_worker", "spare_subset_int8"])
def test_grid_disagg_prefill_matches_tpukit(where, tok, models, worlds):
    """Disaggregated prefill into grid replicas: the worker meshless on the
    router's device (4 devices, f32 pages of 8 over a shared prefix), or a
    world of its own on the spare subset (6 devices, int8 pages of 32, so
    each handoff writes a rank's 2 heads of quantized rows and scales into
    a model-2 pool). Tokens are the single engine's and tpukit's; decode
    replicas run no prefill; the handoff record is tpukit's."""
    spare = where == "spare_subset_int8"
    if spare:
        serve_kw = dict(slots=2, buckets=(32,), max_new_tokens=MAX_NEW, window_steps=8,
                        page_size=32, kv_dtype="int8", fused_decode=True)
        reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(32,))
    else:
        serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8,
                        page_size=8, fused_decode=True)
        reqs = jax_stream(tok, 8, seed=3, max_new_tokens=MAX_NEW, buckets=(8, 16),
                          shared_prefix=8)
    want = _single(models, tok, serve_kw, reqs)
    router, axes, got, _, jrouter, jaxes, jgot, _ = _grid_routers(
        models, tok, serve_kw,
        dict(replicas=2, devices_per_replica=2, window_steps=4, disagg_prefill=True),
        reqs, 6 if spare else 4, _unfused(serve_kw))
    _same(got, want, "disaggregated grid fleet vs single engine")
    _same(got, jgot, "vs tpukit's")
    assert axes == jaxes == [{"data": 1, "model": 2}] * 2
    dp = router.last_summary["disagg_prefill"]
    assert dp == jrouter.last_summary["disagg_prefill"]
    assert dp["handoffs"] == 8 and dp["worker_admitted"] == 8
    assert router.last_summary["params_placements"] == jrouter.last_summary["params_placements"] \
        == 3
    decode = worlds[:2]
    assert all(w.prefill_dispatches == 0 for w in decode)
    assert sum(w.admitted for w in decode) == 8
    assert router.prefill.prefill_dispatches > 0
    if spare:
        assert isinstance(router.prefill, GridReplica) and len(worlds) == 3
        assert router.prefill.grid == {"data": 1, "model": 2}
    else:
        assert isinstance(router.prefill, ServeEngine) and len(worlds) == 2
        assert dp["worker_prefix_hits"] > 0
    _reaped(worlds)


def test_grid_axes_at_four_devices_match_tpukit(tok, models, worlds):
    """One replica over 4 devices: model 4 (one head a rank) on the ring,
    as tpukit's engine's mesh; the tokens are the single engine's."""
    serve_kw = dict(slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW, window_steps=8)
    reqs = jax_stream(tok, 6, seed=5, max_new_tokens=MAX_NEW, buckets=(8, 16))
    want = _single(models, tok, serve_kw, reqs)
    router, axes, got, _, jrouter, jaxes, jgot, _ = _grid_routers(
        models, tok, serve_kw, dict(replicas=1, devices_per_replica=4, window_steps=4), reqs, 4)
    assert axes == jaxes == [{"data": 1, "model": 4}]
    _same(got, want, "model-4 replica vs single engine")
    _same(got, jgot, "vs tpukit's")
    assert router.last_summary["params_placements"] == 1
    assert len(worlds[0].pids()) == 4
    _reaped(worlds)


# ---------------------------------------------------------- entry point ----

CLI = ["--device", "cpu", "--replicas", "2", "--devices_per_replica", "2", "--page_size", "8",
       "--fused_decode", "--num_layers", "2", "--dim", "32", "--head_dim", "8", "--heads", "4",
       "--sequence_length", "64", "--requests", "8", "--slots", "2", "--buckets", "8,16",
       "--max_new_tokens", "8", "--fleet_window_steps", "4", "--window_steps", "8"]


def test_grid_fleet_entry_point_writes_tpukits_records(tok, models, tmp_path):
    """`TPUKIT_CPU_DEVICES=4 python -m tpukit_torch.serve --replicas 2
    --devices_per_replica 2 ...`: the JSONL kinds and `fleet_summary` keys
    of tpukit's router on the same shapes with main-serve.py's planes (the
    tracer and the metrics registry), and tools/report.py's fleet and trace
    gates pass on it."""
    log = tmp_path / "fleet.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "tpukit_torch.serve", *CLI, "--metrics_log", str(log)],
        cwd=tmp_path, capture_output=True, text=True, timeout=2 * BOUND_S,
        env={**os.environ, "TPUKIT_CPU_DEVICES": "4", "PYTHONPATH": str(ROOT),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "fleet served 8 requests" in proc.stdout
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    jcfg, _, _, host, _ = models
    jlog_path = tmp_path / "tpukit.jsonl"
    jlog = JaxLogger(str(jlog_path))
    JaxFleetRouter(host, jcfg,
                   JaxServeConfig(slots=2, buckets=(8, 16), max_new_tokens=8, page_size=8,
                                  window_steps=8),
                   JaxFleetConfig(replicas=2, devices_per_replica=2, window_steps=4),
                   eos_id=int(tok.eos_token_id), devices=jax.devices()[:4], logger=jlog,
                   tracer=JaxTracer(), metrics=JaxRegistry()).run(
        list(jax_stream(tok, 8, seed=0, max_new_tokens=8, buckets=(8, 16))),
        max_wall_s=BOUND_S)
    jlog.close()
    jrecs = [json.loads(line) for line in jlog_path.read_text().splitlines()]
    assert {r["kind"] for r in recs} == {r["kind"] for r in jrecs}
    [s] = [r for r in recs if r["kind"] == "fleet_summary"]
    [js] = [r for r in jrecs if r["kind"] == "fleet_summary"]
    assert set(s) == set(js)
    assert s["requests"] == 8 and s["params_placements"] == 2 and s["trace_complete"] == 1.0
    assert {r["replica"] for r in recs if r["kind"] == "serve_summary"} == {0, 1}
    for gate in (["--min_fleet_tps", "1"], ["--min_trace_complete", "1.0"]):
        rep = subprocess.run([sys.executable, str(ROOT / "tools" / "report.py"), str(log),
                              *gate], cwd=ROOT, capture_output=True, text=True, timeout=BOUND_S)
        assert rep.returncode == 0, rep.stdout[-2000:] + rep.stderr[-2000:]


# ------------------------------------------------------------- failures ----


def test_a_dead_rank_makes_the_router_raise_with_its_log(tok, models, worlds):
    """A rank that raises, and a rank killed outright: the router raises
    `ReplicaWorldError` naming the replica, the rank and what happened,
    with the rank's log (its traceback), and reaps the world; it never
    serves the replica meshless."""
    _, tcfg, _, _, tp = models
    serve = ServeConfig(slots=2, buckets=(8, 16), max_new_tokens=4)
    router = FleetRouter(tp, tcfg, serve, FleetConfig(replicas=2, devices_per_replica=2),
                         eos_id=int(tok.eos_token_id), device="cpu", devices=["cpu"] * 4)
    with pytest.raises(ReplicaWorldError,
                       match=r"(?s)replica 1 .*rank 0 failed on 'no_such_op'.*KeyError"):
        router._replicas[1]._call("no_such_op")
    victim = worlds[0]._procs[1]
    os.kill(victim.pid, signal.SIGKILL)
    victim.wait(timeout=BOUND_S)
    reqs = jax_stream(tok, 4, seed=3, max_new_tokens=4, buckets=(8, 16))
    with pytest.raises(ReplicaWorldError, match=r"(?s)replica 0 .*rank 1 exited with code -9"):
        router.run(_port(reqs), max_wall_s=BOUND_S)
    _reaped(worlds)


def test_a_world_whose_router_dies_exits(tmp_path):
    """A router process SIGKILLed with its worlds up: every rank reads EOF
    on its channel and exits. (The dead router leaves its worlds'
    directories, here under `tmp_path`.)"""
    proc = subprocess.run([sys.executable, str(ROUTER_SCRIPT)], cwd=ROOT, capture_output=True,
                          text=True, timeout=BOUND_S,
                          env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)})
    assert proc.returncode == -signal.SIGKILL, proc.stdout[-2000:] + proc.stderr[-2000:]
    pids = [int(p) for p in proc.stdout.split("pids:")[1].split()]
    assert len(pids) == 4
    deadline = time.monotonic() + BOUND_S
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in pids if _alive(p)]


# ---------------------------------------------------------------- bench ----


def test_bench_fleet_rungs_take_tpukits_devices(monkeypatch):
    """`bench_fleet_serving` at 4 devices gives each rung tpukit's
    `n_dev // replicas` devices a replica (4, 2, 1) and the disaggregated
    half 2 (`bench.py:1052-1056`), checked on a recording router. Only the
    in-process rung has a warm-up router; every timed router is waited
    for (`ready`) before its run."""
    from tpukit_torch import serve as serve_pkg
    from tpukit_torch.bench import serving

    seen = []

    class Recording:
        def __init__(self, host, cfg, serve, fleet, eos_id, device=None):
            seen.append((fleet.replicas, fleet.devices_per_replica, fleet.disagg_prefill))
            self.last_summary = {"disagg_prefill": {"handoffs": 0}}

        def ready(self):
            seen.append("ready")

        def run(self, reqs, max_wall_s=None):
            return [Completion(rid=r.rid, ids=np.asarray(r.ids), prompt_len=len(r.ids),
                               generated=1, reason="eos", arrival_s=0.0, admit_s=0.0,
                               done_s=1.0, active_s=0.5) for r in reqs]

    monkeypatch.setattr(serve_pkg, "FleetRouter", Recording)
    cfg = GPTConfig(dim=32, head_dim=8, heads=4, num_layers=1, vocab_size=64,
                    max_position_embeddings=64)
    rec = serving.bench_fleet_serving(cfg, 4, requests=4, slots=2, max_new=2, device="cpu")
    assert seen == [(1, 4, False), "ready", (2, 2, False), "ready",
                    (4, 1, False), (4, 1, False), "ready",
                    (2, 2, False), "ready", (2, 2, True), "ready"]
    assert rec["meshed"] and rec["parity_ok"]
    assert [r["devices_per_replica"] for r in rec["rungs"]] == [4, 2, 1]
    assert "error" not in rec["disagg_prefill"]
