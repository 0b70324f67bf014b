"""The port's `fit` under telemetry and failure observability, end to end
on the CPU, against tpukit's (`tests/test_flightrec.py:415-596`,
`tests/test_obs.py:520-610`).

Recipe 1 at tiny width (the recovery tests' argv: 200 rows of batch 8, 25
steps, windows at steps 9, 17 and 25) from tpukit's initial parameters
(a `.pt` at step 0, through `--resume`), beside tpukit's `fit` on the same
argv: the `--metrics_log` JSONL has tpukit's `(kind, step, epoch)`
sequence (tpukit's `xla` records aside: the eager port compiles nothing),
its losses and grad and param norms within rtol 1e-4 of tpukit's (the
update norm, a difference of two parameter copies, within 1e-3), tpukit's
span keys, and `tools/report.py` renders it. Telemetry on against off, and
`--debug_nans` on a healthy run, change no loss and no parameter bit. A
chaos hang trips the watchdog (a bundle, a JSONL record, the armed anomaly
trace) and training completes; a planted diverging heartbeat is reported
once; a NaN parameter under `--debug_nans` raises `FloatingPointError`.
Two gloo ranks of recipe 2 with `--heartbeat_dir`: a `bitflip` on rank 1
is caught by the checksums, and the deferred rollback runs on both ranks
at the same boundary, with tpukit's record fields.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit import data as tk_data
from tpukit import recovery as tk_recovery
from tpukit.flags import parse_flags as tk_parse_flags
from tpukit.model import gpt as tk_gpt
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import fit as tk_fit
from tpukit_torch import checkpoint as ckpt
from tpukit_torch.bridge import params_from_numpy
from tpukit_torch.recipes import single
from tpukit_torch.shardings import leaves, paths
from tpukit_torch.train import create_train_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--batch_size", "8", "--epochs", "1", "--sequence_length", "64", "--dim", "32",
        "--head_dim", "8", "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
        "--dataset_slice", "200", "--num_workers", "0", "--disable_amp", "--prefetch", "0"]
SAVES = ["--checkpoint_every", "8", "--keep_checkpoints", "1"]
TELEMETRY = ["--log_grad_norms", "--divergence_check_freq", "4", "--metrics_dir", "md"]
FIT_RTOL = 1e-4  # the recipe's f32 window bar against tpukit's fit
UPDATE_RTOL = 1e-3  # a difference of two parameter copies


def _set(argv: list, flag: str, value: str) -> list:
    out = list(argv)
    out[out.index(flag) + 1] = value
    return out


@pytest.fixture(scope="module")
def init_pt(tmp_path_factory):
    """tpukit's initial parameters of ARGS' model as a port `.pt` at step 0."""
    tk_cfg = tk_gpt.GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2,
                              vocab_size=tk_data.get_tokenizer().vocab_size,
                              max_position_embeddings=64, compute_dtype=jnp.float32)
    init = tk_gpt.init_params(jax.random.PRNGKey(0), tk_cfg)
    state = create_train_state(params_from_numpy(jax.tree.map(np.asarray, init), device="cpu"),
                               1e-3)
    return ckpt.save(state, directory=tmp_path_factory.mktemp("init"))


def _in(directory: Path, fn, *args):
    directory.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def _records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def _port(directory: Path, argv: list, log: bool = True):
    """The port's recipe 1 in `directory`: (result, its JSONL records)."""
    extra = ["--metrics_log", "run.jsonl"] if log else []
    result = _in(directory, single.main, argv + extra + ["--device", "cpu"])
    return result, _records(directory / "run.jsonl")


def _kes(records) -> list:
    return [(r["kind"], r.get("step"), r.get("epoch")) for r in records if r["kind"] != "xla"]


def _train(records) -> list:
    return [r for r in records if r["kind"] == "train"]


def _same_params(a, b) -> None:
    for n, x, y in zip(paths(a.state.params), leaves(a.state.params), leaves(b.state.params)):
        assert torch.equal(x, y), n


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_pt):
    """tpukit's fit and the port's with telemetry on; the port's with it
    off; the port's with it off and `--debug_nans`."""
    tmp = tmp_path_factory.mktemp("telemetry")
    log = tmp / "tk" / "run.jsonl"
    (tmp / "tk").mkdir()
    _in(tmp / "tk", tk_fit, tk_parse_flags(ARGS + SAVES + TELEMETRY + ["--metrics_log", str(log)]),
        TkSingleDevice())
    resume = ["--resume", str(init_pt)]
    on = _port(tmp / "on", ARGS + SAVES + TELEMETRY + resume)
    off = _port(tmp / "off", ARGS + SAVES + resume + ["--no_metrics"], log=False)
    nans = _port(tmp / "nans", ARGS + SAVES + resume + ["--no_metrics", "--debug_nans"],
                 log=False)
    return dict(tmp=tmp, tk=_records(log), on=on, off=off, nans=nans)


def test_jsonl_has_tpukit_s_kinds_steps_and_epochs(runs):
    """The port's records, in order, are tpukit's (train windows, the
    checksums, the retention prunes, validation, epoch, the metrics
    epilogue), tpukit's `xla` records aside."""
    got, want = _kes(runs["on"][1]), _kes(runs["tk"])
    assert got == want
    kinds = {k for k, _, _ in got}
    assert {"train", "divergence_check", "ckpt_prune", "validation", "epoch", "metrics"} <= kinds
    assert [s for k, s, _ in got if k == "train"] == [9, 17, 25]


def test_window_values_are_within_the_fit_bar(runs):
    """Losses and the grad and param norms within rtol 1e-4 of tpukit's,
    the update norm within 1e-3; tokens/s positive, MFU None on the CPU,
    as tpukit's."""
    got, want = _train(runs["on"][1]), _train(runs["tk"])
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               rtol=FIT_RTOL)
    for key, rtol in (("grad_norm", FIT_RTOL), ("param_norm", FIT_RTOL),
                      ("update_norm", UPDATE_RTOL)):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=rtol,
                                   err_msg=key)
    assert all(r["tokens_per_sec"] > 0 and r["mfu"] is None is r.get("hbm") for r in got)
    assert [w["loss"] for w in runs["on"][0].metrics["train_windows"]] == \
        [r["loss"] for r in got]


def test_record_and_span_keys_are_tpukit_s(runs):
    """Every record carries tpukit's keys, and each window's span keys are
    tpukit's (data, h2d, step, sync, telemetry, checkpoint, other); the
    spans sum to the window."""
    by_kind = {}
    for r in runs["tk"]:
        by_kind.setdefault(r["kind"], set(r))
    for r in runs["on"][1]:
        assert set(r) == by_kind[r["kind"]], r["kind"]
    for got, want in zip(_train(runs["on"][1]), _train(runs["tk"])):
        assert set(got["spans"]) == set(want["spans"])
        assert abs(sum(got["spans"].values()) - 1.0) < 1e-6
        assert 0.0 < got["goodput"] <= 1.0 and got["window_s"] > 0


def test_report_flightview_and_top_read_a_port_run(runs):
    """`tools/report.py` renders the log and its `--min_goodput 0` gate
    passes; `tools/top.py --once` renders the metrics directory the run
    merged (its snapshot, the merged JSON and the OpenMetrics text)."""
    from tools import report, top

    log = runs["tmp"] / "on" / "run.jsonl"
    text = report.summarize(report.load(str(log)))
    for needle in ("tokens/sec", "goodput", "grad norm", "divergence checks",
                   "checkpoint retention", "metrics (train)"):
        assert needle in text, needle
    assert report.main([str(log), "--min_goodput", "0"]) == 0
    md = runs["tmp"] / "on" / "md"
    assert sorted(p.name for p in md.iterdir()) == ["metrics-merged.json", "metrics-p00000.json",
                                                    "metrics.prom"]
    assert top.main([str(md), "--once"]) == 0


def test_xla_records_come_from_the_comm_audit(runs):
    """The port's `kind="xla"` records (the comm audit of rank 0's first
    train and eval step): tpukit's functions and keys, None for what only a
    compiled program has, the collectives and lint verdict of one device;
    `tools/report.py` renders them in its `== xla ==` section."""
    from tools import report

    mine = [r for r in runs["on"][1] if r["kind"] == "xla"]
    theirs = [r for r in runs["tk"] if r["kind"] == "xla"]
    assert [r["fn"] for r in mine] == [r["fn"] for r in theirs] == ["train_step", "eval_step"]
    for got, want in zip(mine, theirs):
        assert set(got) == set(want)
        assert got["strategy"] == want["strategy"] == "single"
        assert got["flops"] is got["bytes_accessed"] is got["memory"] is None
        assert got["collectives"] == {} and got["expected_comm_ops"] == want["expected_comm_ops"]
        assert got["hlolint"] == {"clean": True, "errors": 0, "warnings": 0, "violations": []}
    text = report.summarize(report.load(str(runs["tmp"] / "on" / "run.jsonl")))
    assert "== xla static analysis: train_step [single] ==" in text
    assert "== xla static analysis: eval_step [single] ==" in text


def test_telemetry_and_debug_nans_change_no_number(runs):
    """Telemetry on, off, and `--debug_nans` on a healthy run: the same
    window losses and final parameters, bit for bit."""
    on, off, nans = runs["on"][0], runs["off"][0], runs["nans"][0]
    assert on.metrics["train_windows"] == off.metrics["train_windows"] == \
        nans.metrics["train_windows"]
    _same_params(on, off)
    _same_params(nans, off)
    assert not torch.is_anomaly_enabled()
    assert torch.overrides._get_current_function_mode_stack() == []


@pytest.mark.parametrize("flag,value", [("--hang_timeout", "-1"),
                                        ("--divergence_check_freq", "-2")])
def test_fit_rejects_negative_telemetry_flags_as_tpukit(tmp_path, flag, value):
    """tpukit's `ValueError` texts (`train.py:381-387`), before any work."""
    want = {"--hang_timeout": "--hang_timeout must be >= 0, got -1.0",
            "--divergence_check_freq": "--divergence_check_freq must be >= 0, got -2"}[flag]
    with pytest.raises(ValueError, match=want):
        tk_fit(tk_parse_flags(ARGS + [flag, value]), TkSingleDevice())
    with pytest.raises(ValueError, match=want):
        _in(tmp_path, single.main, ARGS + [flag, value, "--device", "cpu"])


# ------------------------------------------------------- the hung step ----


@pytest.fixture(scope="module")
def hang_run(tmp_path_factory, init_pt):
    """A chaos hang of 3 s at step 3 under `--hang_timeout 1` and
    `--trace_on_anomaly 2`: the watchdog fires during the hang, the next
    window surfaces it, and the hang arms the anomaly trace."""
    tmp = tmp_path_factory.mktemp("hang")
    t0 = time.perf_counter()
    result, records = _port(tmp, ARGS + ["--resume", str(init_pt), "--chaos_spec", "hang@3:3",
                                         "--hang_timeout", "1", "--trace_on_anomaly", "2",
                                         "--debug_dir", "dbg", "--heartbeat_dir", "hb"])
    return tmp, result, records, time.perf_counter() - t0


def test_hung_step_dumps_a_bundle_with_the_training_thread_s_stack(hang_run):
    tmp, _, _, _ = hang_run
    bundles = sorted((tmp / "dbg").glob("bundle-*-hang-*.json"))
    assert len(bundles) == 1
    bundle = json.loads(bundles[0].read_text())
    assert bundle["reason"] == "hang" and bundle["step"] == 3 and bundle["stuck_for_s"] >= 1.0
    main = next(frames for name, frames in bundle["stacks"].items()
                if name.startswith("MainThread"))
    assert any("on_step" in line for line in main) and any("sleep" in line for line in main)
    assert any("tpukit-watchdog" in n for n in bundle["stacks"])
    assert [r["step"] for r in bundle["ring"] if r["kind"] == "step"] == [1, 2, 3]
    assert "0" in bundle["heartbeats"]
    assert bundle["config"]["hang_timeout"] == 1.0
    assert set(bundle["inflight"]) == {"host_step", "async_checkpoint_in_flight", "prefetcher"}
    assert bundle["memory"] is None  # the CPU
    from tools import flightview

    assert flightview.main([str(tmp / "dbg")]) == 0


def test_hang_surfaces_in_the_jsonl_and_arms_the_trace(hang_run):
    """One `watchdog` hang record at the next window naming the bundle;
    the trace armed once, started at the next step, stopped after 2 steps,
    its Chrome trace on disk; report.py names both."""
    tmp, _, records, _ = hang_run
    [hang] = [r for r in records if r["kind"] == "watchdog"]
    assert (hang["event"], hang["step"], hang["hangs"]) == ("hang", 9, 1) and hang["bundles"]
    tr = [r for r in records if r["kind"] == "anomaly_trace"]
    assert [(r["event"], r["step"]) for r in tr] == [("armed", 9), ("started", 10),
                                                      ("stopped", 11)]
    assert tr[0]["reason"] == "hang"
    trace = json.loads((tmp / "dbg" / "anomaly_trace" / "trace-p00000.json").read_text())
    assert any(ev.get("name", "").startswith("aten::") for ev in trace["traceEvents"])
    from tools.report import load, summarize

    text = summarize(load(str(tmp / "run.jsonl")))
    assert "watchdog" in text and "HANG" in text and "anomaly trace" in text


def test_training_completes_after_the_hang(hang_run):
    _, result, records, _ = hang_run
    assert result.state.step == 25
    assert [r["kind"] for r in records][-3:] == ["validation", "epoch", "metrics"]


def test_profile_dir_writes_the_run_s_trace(tmp_path, init_pt):
    """`--profile_dir` traces the loop with `torch.profiler` (CPU activity
    here; CUDA too on a card, or it raises) into `trace-p00000.json`; it
    excludes the anomaly tracer, as in tpukit (`train.py:1011-1017`)."""
    argv = _set(ARGS, "--dataset_slice", "32") + ["--resume", str(init_pt), "--profile_dir",
                                                  "prof", "--trace_on_anomaly", "2"]
    result, records = _port(tmp_path, argv)
    assert result.state.step == 4
    trace = json.loads((tmp_path / "prof" / "trace-p00000.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    assert not [r for r in records if r["kind"] == "anomaly_trace"]


@pytest.mark.parametrize("fmt", ["auto", "sharded"])
def test_resume_into_another_world_logs_tpukit_s_resize_record(tmp_path, init_pt, fmt):
    """A checkpoint saved by a world of 2 DDP ranks resumed by recipe 1:
    the first record is tpukit's `resize` (its keys, the mismatch, the
    format and bytes read), and report.py lists it under recovery."""
    state = create_train_state(ckpt.load(init_pt)["params"], 1e-3)
    world = {"nprocs": 2, "device_count": 2, "strategy": "ddp", "mesh_axes": {"data": 2},
             "global_batch": 16}
    path = ckpt.save_auto(state, fmt, directory=tmp_path / "saved", meta={"world": world})
    _, records = _port(tmp_path, _set(ARGS, "--dataset_slice", "16") + ["--resume", str(path)])
    rec = records[0]
    assert set(rec) == {"kind", "step", "checkpoint", "mismatch", "saved_world", "world", "swept",
                        "format", "bytes_read", "blocks_read", "wall_s", "time"}
    assert (rec["kind"], rec["step"], rec["saved_world"]) == ("resize", 0, world)
    assert rec["format"] == ("pt" if fmt == "auto" else fmt) and rec["bytes_read"] > 0
    assert "device_count" in rec["mismatch"] and rec["blocks_read"] >= 1
    from tools.report import load, summarize

    assert "resized:" in summarize(load(str(tmp_path / "run.jsonl")))


# ----------------------------------------------------------- debug nans ----


def test_debug_nans_raises_at_a_nan_parameter_and_restores(tmp_path, init_pt):
    """A NaN in one parameter: `--debug_nans` raises `FloatingPointError`
    at the first op that returns one, and the scope is gone afterwards;
    without the flag the run trains on to a NaN loss."""
    state = create_train_state(ckpt.load(init_pt)["params"], 1e-3)
    with torch.no_grad():
        state.params["layers"]["norm1"]["scale"][0, 0] = float("nan")
    path = ckpt.save(state, directory=tmp_path / "nan")
    argv = _set(ARGS, "--dataset_slice", "16") + ["--resume", str(path)]
    with pytest.raises(FloatingPointError, match="nan"):
        _port(tmp_path / "a", argv + ["--debug_nans"])
    assert not torch.is_anomaly_enabled()
    assert torch.overrides._get_current_function_mode_stack() == []
    result, _ = _port(tmp_path / "b", argv)
    assert np.isnan(result.metrics["eval"]["loss"])


# ----------------------------------------------------------- divergence ----


def test_planted_divergence_is_reported_once_with_one_bundle(tmp_path, init_pt):
    """tpukit's `divergence_run` (`tests/test_flightrec.py:519-596`): a
    planted beat of a fake rank 1 disagreeing at step 8 is reported once
    (a `divergence` record, one bundle), the run's own beat carries its
    checksum, and report.py names it."""
    hb = tmp_path / "hb"
    hb.mkdir()
    (hb / "heartbeat-p00001.json").write_text(json.dumps({
        "process": 1, "step": 8, "time": time.time() + 3600,
        "checksum": "deadbeef:deadbeef", "checksum_step": 8}))
    _, records = _port(tmp_path, ARGS + ["--resume", str(init_pt), "--divergence_check_freq", "4",
                                         "--heartbeat_dir", "hb", "--debug_dir", "dbg"])
    checks = [r for r in records if r["kind"] == "divergence_check"]
    assert [r["step"] for r in checks] == [4, 8, 12, 16, 20, 24]
    assert all(len(r["checksum"]) == 17 and ":" in r["checksum"] for r in checks)
    [div] = [r for r in records if r["kind"] == "divergence"]
    [m] = div["mismatches"]
    assert m["checksum_step"] == 8 and "deadbeef:deadbeef" in (m["checksum"], m["expected"])
    assert len(list((tmp_path / "dbg").glob("bundle-*-divergence-*.json"))) == 1
    beat = json.loads((hb / "heartbeat-p00000.json").read_text())
    assert beat["checksum"] == checks[-1]["checksum"] and beat["checksum_step"] == 24
    from tools.report import load, summarize

    text = summarize(load(str(tmp_path / "run.jsonl")))
    assert "DIVERGENCE" in text and "deadbeef" in text


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


RANKS_TIMEOUT = 240  # seconds the two ranks may take, below the suite's limit
PORT_TAKEN = ("EADDRINUSE", "Address already in use")


def _run_ranks(argv: list, cwd: Path, env: dict, world: int = 2, tries: int = 3) -> list:
    """(stdout, stderr) of `world` ranks of `argv` on a free port. Another
    process may take the port between `_free_port` and rank 0's store:
    then the ranks run again, on a new port in a clean `cwd`. Ranks that
    outlive RANKS_TIMEOUT are killed and the test fails."""
    for attempt in range(tries):
        run_env = {**env, "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
                   "WORLD_SIZE": str(world)}
        procs = [subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env={**run_env, "RANK": str(r), "LOCAL_RANK": str(r)})
                 for r in range(world)]
        try:
            outs = [p.communicate(timeout=RANKS_TIMEOUT) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            pytest.fail(f"{world} ranks did not finish in {RANKS_TIMEOUT} s")
        taken = any(p.returncode and any(t in err for t in PORT_TAKEN)
                    for p, (_, err) in zip(procs, outs))
        if not taken or attempt == tries - 1:
            break
        for child in cwd.iterdir():
            shutil.rmtree(child) if child.is_dir() else child.unlink()
    assert [p.returncode for p in procs] == [0] * world, [o[1][-2000:] for o in outs]
    return outs


def test_ddp_bitflip_drives_the_deferred_rollback_on_both_ranks(tmp_path):
    """Recipe 2 on two gloo ranks with `--heartbeat_dir`, the checksums
    every 4 steps, `--on_anomaly rollback`, the norms and both metrics
    outputs: `bitflip@10:1` diverges rank 1's replica; rank 0 sees the
    mismatch at a window, publishes the decision one window ahead, and both
    ranks roll back to the same checkpoint at that boundary (one ack each),
    after the final drain's rendezvous; the rollback record has tpukit's
    fields, and no divergence is seen after it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "tpukit_torch.recipes.ddp",
            *_set(_set(ARGS, "--dataset_slice", "400"), "--batch_size", "4"), "--device", "cpu",
            "--chaos_spec", "bitflip@10:1", "--divergence_check_freq", "4",
            "--heartbeat_dir", "hb", "--on_anomaly", "rollback", "--checkpoint_every", "4",
            "--log_grad_norms", "--metrics_log", "run.jsonl", "--metrics_dir", "md",
            "--debug_dir", "dbg"]
    outs = _run_ranks(argv, tmp_path, env)
    records = _records(tmp_path / "run.jsonl")
    [div] = [r for r in records if r["kind"] == "divergence"]
    [rb] = [r for r in records if r["kind"] == "rollback"]
    keys = {f.name for f in dataclasses.fields(tk_recovery.RollbackPlan)}
    assert set(rb) == keys | {"kind", "timeline", "quarantined", "time"}
    assert rb["reason"] == "divergence" and rb["anomaly_step"] == div["step"]
    assert rb["target_step"] == rb["anomaly_step"] - rb["steps_lost"] <= div["step"] - 8
    decision = json.loads((tmp_path / "hb" / "rollback-0001.json").read_text())
    assert decision["execute_after"] == div["step"] + 8
    acks = [json.loads(p.read_text()) for p in sorted((tmp_path / "hb").glob("rollback-0001-ack-*"))]
    assert acks == [{"process": 0, "step": rb["target_step"]},
                    {"process": 1, "step": rb["target_step"]}]
    assert (tmp_path / "hb" / "rollback-final-drain.json").exists()
    [line] = [x for x in outs[0][0].splitlines() if x.startswith("rollback 1/")]
    assert f"(divergence at step {div['step']})" in line
    # the ranks ran on in lockstep after it: their last beats agree
    beats = [json.loads(p.read_text()) for p in sorted((tmp_path / "hb").glob("heartbeat-p*"))]
    assert len(beats) == 2 and len({(b["step"], b["timeline"]) for b in beats}) == 1
    assert beats[0]["timeline"] == 1
    [flip] = [r for r in records if r["kind"] == "chaos"]
    assert (flip["fault"], flip["step"], flip["process"]) == ("bitflip", 10, 1)
    after = [r for r in records if r["kind"] == "divergence" and r["time"] > rb["time"]]
    assert not after
    train = _train(records)
    assert all("grad_norm" in r and "update_norm" in r for r in train)
    assert sorted(p.name for p in (tmp_path / "md").glob("metrics-p*.json")) == [
        "metrics-p00000.json", "metrics-p00001.json"]
    assert len(list((tmp_path / "dbg").glob("bundle-*-divergence-p00000-*.json"))) == 1
