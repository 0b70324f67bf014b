"""The port's bench twin (`tpukit_torch/bench/`) against tpukit's `bench.py`
and `tools/bench_ladder.py`, on the CPU at a tiny shape (dim 32, 2 layers,
vocab 211, sequence 17, f32).

  - Each training record that runs here in seconds, from the same function
    at the same shape: the port's record has tpukit's keys, key for key
    (nested dicts and list rows too), and both records' parity bits are
    true (losses bit-identical where tpukit calls them so, bytes equal to
    the closed forms). In a world of one, in this process:
    `host_pipeline`, `obs_overhead`, `moe_ep_comm`, `moe_dispatch_ladder`,
    and the records that need several cards, which say so as tpukit's do
    (`elastic_restore`, `pipe_moe`, `pipe_interleave`'s rungs; its bubble
    grid is tpukit's). On two gloo ranks (the world of
    `tests/test_torch_distributed.py`'s `world_run`, which runs
    `torch_dist_worker.bench_records`): `quant_comm`, `comm_overlap` (its
    bucket rungs' `overlap_frac` 1.0) and `elastic_restore`.
  - The headline's final loss on tpukit's parameters (bridged) equals
    tpukit's `setup_step` / `time_windows` loss after the same steps, at
    the band of the train tests (rtol 1e-5).
  - The entry point's JSON has tpukit's top-level keys, every serving
    record measured with tpukit's keys and no error (the records against
    tpukit's own are `tests/test_torch_bench_serving.py`'s); without a
    card it raises `CudaUnavailableError`, and `--compilation_cache_dir`
    `NotPortedError`; the harness's batches are tpukit's.
"""

import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as tk_bench
import tpukit_torch
from tools import bench_ladder as tk_ladder
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.pipeline_schedule import bubble_table as tk_bubble_table
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit_torch import mesh
from tpukit_torch.bench import __main__ as bench_main
from tpukit_torch.bench import ladder, records
from tpukit_torch.bridge import params_from_numpy
from test_torch_distributed import global_batch, init_params, tk_cfg, world_run  # noqa: F401
from torch_dist_worker import BENCH_STEPS, BENCH_TINY
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
STEPS = 2


def _cfgs():
    return (TkGPTConfig(**BENCH_TINY, compute_dtype=jnp.float32),
            bench_main.bench_config(**BENCH_TINY, compute_dtype=torch.float32))


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


@pytest.fixture
def world_of_one():
    with mesh.scoped_runtime():
        yield mesh.initialize_runtime("cpu")


def _world_one_record(name, dev):
    _, cfg = _cfgs()
    headline = lambda: bench_main.headline_strategy(1)  # noqa: E731
    return {
        "host_pipeline": lambda: records.bench_host_pipeline(cfg, headline, 4, steps=4,
                                                             device=dev),
        "obs_overhead": lambda: records.bench_obs_overhead(cfg, headline, 4, steps=8,
                                                           checksum_every=4, device=dev),
        "moe_ep_comm": lambda: records.bench_moe_ep_comm(cfg, 1, steps=STEPS, device=dev),
        "moe_dispatch_ladder": lambda: records.bench_moe_dispatch_ladder(cfg, 1, steps=STEPS,
                                                                         device=dev),
        "elastic_restore": lambda: records.bench_elastic_restore(cfg, 1, device=dev),
    }[name]()


def _tk_record(name, n_dev=1):
    tk, _ = _cfgs()
    return {
        "host_pipeline": lambda: tk_bench.bench_host_pipeline(tk, TkSingleDevice(), 4, steps=4),
        "obs_overhead": lambda: tk_bench.bench_obs_overhead(tk, TkSingleDevice(), 4, steps=8,
                                                            checksum_every=4),
        "moe_ep_comm": lambda: tk_bench.bench_moe_ep_comm(tk, n_dev, steps=STEPS),
        "moe_dispatch_ladder": lambda: tk_bench.bench_moe_dispatch_ladder(tk, n_dev,
                                                                          steps=STEPS),
        "elastic_restore": lambda: tk_bench.bench_elastic_restore(tk, n_dev),
        "quant_comm": lambda: tk_bench.bench_quant_comm(tk, n_dev, steps=BENCH_STEPS),
        "comm_overlap": lambda: tk_bench.bench_comm_overlap(tk, n_dev, steps=BENCH_STEPS),
    }[name]()


PARITY = {
    "host_pipeline": lambda r: r["loss_bit_identical"],
    "obs_overhead": lambda r: r["loss_bit_identical"],
    "moe_ep_comm": lambda r: r["bytes_match"],
    "moe_dispatch_ladder": lambda r: all("error" not in row for row in r),
    "elastic_restore": lambda r: r.get("parity_ok", "error" in r),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_world_of_one_record_matches_tpukit(world_of_one, name):
    """The record at the tiny shape in a world of one against tpukit's at
    one device: tpukit's keys, key for key, and both parity bits true;
    `elastic_restore` needs two cards in both, and says so alike."""
    mine = _world_one_record(name, world_of_one)
    theirs = _tk_record(name)
    _same_keys(mine, theirs, name)
    assert PARITY[name](mine) and PARITY[name](theirs), (mine, theirs)
    if name == "elastic_restore":
        assert mine == theirs
    if name == "moe_ep_comm":
        assert mine["measured_a2a"] == mine["expected_a2a"] == theirs["expected_a2a"]


def test_pipeline_records_need_stage_ranks(world_of_one):
    """`pipe_interleave`'s bubble grid is tpukit's (`bubble_table`), its
    rungs fail in a world of one, where no second stage rank exists (each
    rung's error lands in the record), with tpukit's top-level keys;
    `pipe_moe` raises tpukit's error."""
    rec = records.bench_pipe_interleave(1, device=world_of_one)
    assert list(rec) == ["stages", "microbatches", "layers", "bubble_table", "rungs", "caveat"]
    assert rec["bubble_table"] == tk_bubble_table(2)
    assert [sorted(r) for r in rec["rungs"]] == [["error", "virtual_stages"]] * 3
    with pytest.raises(ValueError, match="pipe_moe rung needs >= 2 devices"):
        records.bench_pipe_moe(1, device=world_of_one)
    with pytest.raises(ValueError, match="pipe_moe rung needs >= 2 devices"):
        tk_bench.bench_pipe_moe(1)


MULTI = ("quant_comm", "comm_overlap", "elastic_restore")


@pytest.mark.parametrize("world_run", [2], indirect=True, ids=["world2"])
@pytest.mark.parametrize("name", MULTI)
def test_two_rank_record_matches_tpukit(world_run, name):
    """The record run by two gloo ranks (`torch_dist_worker.bench_records`)
    against tpukit's on a two-device mesh: tpukit's keys, key for key; the
    parity bits true in both (the wire's bytes equal the closed forms, the
    resharded state the direct one); `comm_overlap`'s bucket rungs pass
    the overlap gate with `overlap_frac` 1.0."""
    mine = json.loads(str(world_run["got"][f"bench/{name}"]))
    theirs = _tk_record(name, n_dev=2)
    _same_keys(mine, theirs, name)
    if name == "elastic_restore":
        assert mine["parity_ok"] and theirs["parity_ok"]
        for k in ("state_bytes", "bytes_read", "blocks_read", "from_world", "to_world"):
            assert mine[k] == theirs[k], k
        return
    for rows in (mine, theirs):
        assert not [r for r in rows if "error" in r], rows
        for r in rows:
            if r.get("expected") or (name == "comm_overlap" and r["comm_dtype"] != "f32"):
                assert r["bytes_match"] is True, r
    rungs = [(r["strategy"], r["comm_dtype"], r.get("grad_buckets")) for r in mine]
    assert rungs == [(r["strategy"], r["comm_dtype"], r.get("grad_buckets")) for r in theirs]
    if name == "comm_overlap":
        gates = [r["overlap"] for r in mine if r["grad_buckets"]]
        assert len(gates) == 3
        assert all(g["overlap_frac"] == 1.0 and g["gate_ok"] and g["clean"] for g in gates)


@pytest.mark.parametrize("world_run", [2], indirect=True, ids=["world2"])
def test_two_rank_serving_record_on_rank_zero(world_run):
    """In a world of two gloo ranks a serving record runs through
    `on_rank_zero`, as the entry point runs them: rank 0 gets the record
    (tpukit's keys, the tracer's tokens the same bits), rank 1 None, and
    both leave the wait."""
    from tpukit_torch.bench import serving

    got = json.loads(str(world_run["got"]["bench/serving_on_rank_zero"]))
    assert got["got_none"] == [False, True]
    assert serving.key_mismatches("serve_trace_overhead", got["record"]) == []
    assert got["record"]["tokens_bit_identical"] is True


def test_headline_loss_matches_tpukit(world_of_one):
    """The headline's step (first step recorded, two more warm-up steps,
    one window of two) on tpukit's initial parameters against tpukit's
    `setup_step` / `time_windows` (three warm-up steps, one window of two)
    at the same batch: the final loss within rtol 1e-5, after five AdamW
    steps at 1e-4."""
    tk, cfg = _cfgs()
    step, state, _, _ = tk_ladder.setup_step(tk, TkSingleDevice())
    init = jax.tree.map(np.asarray, jax.device_get(state.params))
    b, t = tk_ladder.make_batch(np.random.RandomState(0), tk.vocab_size, 4,
                                tk.max_position_embeddings - 1)
    _, _, tk_loss = tk_ladder.time_windows(step, state, b, t, steps=2, windows=1)
    head = bench_main.headline(cfg, 4, steps=2, windows=1, device=world_of_one,
                               params=params_from_numpy(init, "cpu"))
    np.testing.assert_allclose(head["final_loss"], tk_loss, rtol=1e-5)
    assert head["xla"]["kind"] == "xla" and head["xla"]["hlolint"]["clean"]
    assert head["xla"]["flops"] is None and head["xla"]["collectives"] == {}


def test_harness_batches_are_tpukits():
    """`make_batch` gives tpukit's arrays from the same seed; the ladder's
    rungs are tpukit's."""
    ours = ladder.make_batch(np.random.RandomState(3), 211, 4, 9)
    theirs = tk_ladder.make_batch(np.random.RandomState(3), 211, 4, 9)
    for k in theirs[0]:
        np.testing.assert_array_equal(ours[0][k], theirs[0][k])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ladder.LADDER == tk_ladder.LADDER


def _tk_result_keys() -> list:
    """The keys of `bench.py`'s result dict, read off its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    result = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    return [k.value for k in result.keys]


# the serving records' size in the entry point's test: their config (head
# dim 32, so that a page of 8 holds whole int8 quant blocks; 64 positions for
# the ring's largest bucket, 32, and the new tokens) and their arguments
SERVING_TINY = dict(BENCH_TINY, head_dim=32, heads=1, max_position_embeddings=64)
SERVING_ARGS = {key: dict(requests=4, slots=2, max_new=2)
                for key, _, _ in bench_main.SERVING_RECORDS}
SERVING_ARGS["decode_fused"]["window"] = 2
SERVING_ARGS["spec_decode"] = dict(requests=2, slots=2, max_new=4, k=2, train_steps=(2, 2))


def test_entry_point_has_tpukits_keys(world_of_one, monkeypatch):
    """`run` (the entry point's body) in a world of one at the tiny shape,
    the ladder's full-width rungs left out (`run_ladder` given no rung),
    the long-context probe at S 32 and the serving records at SERVING_TINY
    and SERVING_ARGS: tpukit's top-level keys in tpukit's order; every
    serving record measured, with tpukit's keys and no error, the fleet's
    rungs meshless; the compile cache null; the records that need several
    cards say so."""
    from tpukit_torch.bench import serving

    _, cfg = _cfgs()
    real = bench_main.run_ladder
    monkeypatch.setattr(bench_main, "run_ladder",
                        lambda **kw: real(only="no-such-rung", **kw))
    monkeypatch.setattr(bench_main, "LONG_CONTEXT", (32, 2))
    serving_cfg = bench_main.bench_config(**SERVING_TINY, compute_dtype=torch.float32)
    real_serving = bench_main.serving_records
    monkeypatch.setattr(bench_main, "serving_records",
                        lambda _, n_dev, device: real_serving(serving_cfg, n_dev, device))
    monkeypatch.setattr(bench_main, "SERVING_RECORDS", tuple(
        (key, label, functools.partial(record, **SERVING_ARGS[key]))
        for key, label, record in bench_main.SERVING_RECORDS))
    result = bench_main.run(world_of_one, cfg=cfg, per_chip_batch=2, steps=1, windows=1)
    assert list(result) == _tk_result_keys()
    for key, _, _ in bench_main.SERVING_RECORDS:
        rec = (result["obs_overhead"]["serving"] if key == "serve_trace_overhead"
               else result[key])
        assert isinstance(rec, dict) and "error" not in rec, (key, rec)
        assert serving.key_mismatches(key, rec) == [], (key, rec)
    fleet = result["fleet_serving"]
    assert fleet["meshed"] is False and fleet["parity_ok"]
    assert [r["devices_per_replica"] for r in fleet["rungs"]] == [0, 0, 0]
    assert result["decode_fused"]["parity_ok"] and result["paged_kv"]["parity_ok"]
    assert result["compile_cache"] is None
    assert result["chips"] == 1 and result["device"] == "cpu" and result["ladder"] == []
    assert result["elastic_restore"] == {
        "error": "needs >= 2 chips (no smaller world to reshard onto)"}
    assert "pipe_moe rung needs >= 2 devices" in result["pipe_moe"]["error"]
    assert result["fsdp_cpu_offload_ok"] is None  # offload needs a CUDA device
    assert result["host_pipeline"]["loss_bit_identical"]
    assert result["obs_overhead"]["loss_bit_identical"]
    assert result["long_context_error"] is None and result["moe_error"] is None
    json.dumps(result)


def test_entry_point_refuses_the_cpu_and_the_cache(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        bench_main.main([])
    with pytest.raises(tpukit_torch.NotPortedError, match="compilation_cache_dir"):
        bench_main.main(["--compilation_cache_dir", ".jax_cache", "--device", "cpu"])


def test_entry_point_runs_only_the_named_serving_records(monkeypatch, capsys):
    """`--serving_records` runs the named serving records alone (in the
    records' order, no headline or training record) and prints them as one
    JSON object by key; an unknown key is refused."""
    ran = []

    def fake(key):
        def record(cfg, n_dev, device=None):
            ran.append(key)
            return {"n_dev": n_dev, "dim": cfg.dim}
        return record

    monkeypatch.setattr(bench_main, "SERVING_RECORDS", tuple(
        (key, label, fake(key)) for key, label, _ in bench_main.SERVING_RECORDS))
    monkeypatch.setattr(bench_main, "run", lambda *a, **kw: pytest.fail("the whole bench ran"))
    assert bench_main.main(["--device", "cpu", "--serving_records",
                            "fleet_serving,paged_kv"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert json.loads(out[0]) == {"paged_kv": {"n_dev": 1, "dim": 256},
                                  "fleet_serving": {"n_dev": 1, "dim": 256}}
    assert ran == ["paged_kv", "fleet_serving"]
    with pytest.raises(SystemExit):
        bench_main.main(["--device", "cpu", "--serving_records", "no_such_record"])
