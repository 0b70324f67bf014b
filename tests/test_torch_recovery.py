"""The port's recovery plane against tpukit's, on the CPU: the chaos
grammar and engine, the retry wrapper, the exit codes, rollback planning,
quarantine, the coordinators' files, heartbeats, the loss sentinel, world
bookkeeping, the checkpoints' meta sidecars, retention and async saves, and
`fit` end to end: the two resume faults (an explicit `--resume` that fails
verification; a preemption checkpoint's mid-epoch position), preemption and
`--resume latest`, rollback, and exit codes 75, 76 and 77.

The port's recipe runs start from tpukit's initial parameters (a `.pt` at
step 0, through `--resume`), so its windows can be held against tpukit's
`fit` at the recipe test's bar (rtol 1e-4,
`test_torch_train.py::test_recipe_matches_tpukit_fit`); a port run against
another port run is held bit for bit.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit import chaos as tk_chaos
from tpukit import checkpoint as tkc
from tpukit import data as tk_data
from tpukit import recovery as tk_recovery
from tpukit import reshard as tk_reshard
from tpukit import retry as tk_retry
from tpukit.flags import parse_flags as tk_parse_flags
from tpukit.model import gpt as tk_gpt
from tpukit.obs import heartbeat as tk_heartbeat
from tpukit.obs import sentinels as tk_sentinels
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import create_train_state as tk_create_train_state
from tpukit.train import fit as tk_fit
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit_torch import chaos, recovery, reshard, retry
from tpukit_torch import checkpoint as ckpt
from tpukit_torch.bridge import params_from_numpy
from tpukit_torch.model import gpt
from tpukit_torch.obs import heartbeat, sentinels
from tpukit_torch.recipes import single
from tpukit_torch.shardings import SingleDevice, leaves, paths
from tpukit_torch.train import TrainState, create_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]

# recipe 1 at tiny width: 200 rows of batch 8, 25 steps; windows close at
# steps 9, 17 and 25
ARGS = ["--batch_size", "8", "--epochs", "1", "--sequence_length", "64", "--dim", "32",
        "--head_dim", "8", "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
        "--dataset_slice", "200", "--num_workers", "0", "--disable_amp"]
FIT_RTOL = 1e-4  # the recipe's f32 window bar against tpukit's fit
# nan_loss@12 poisons the window ending at step 17; the newest checkpoint
# outside it (17 - 8 = 9) is step 8 (tpukit tests/test_recovery.py:636-639)
ROLLBACK = ["--checkpoint_every", "4", "--chaos_spec", "nan_loss@12", "--spike_threshold", "8"]


def _set(argv: list, flag: str, value: str) -> list:
    """`argv` with `flag`'s value replaced."""
    out = list(argv)
    out[out.index(flag) + 1] = value
    return out


def _tk_config(vocab: int):
    return tk_gpt.GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=vocab,
                            max_position_embeddings=64, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def init_pt(tmp_path_factory):
    """tpukit's initial parameters of ARGS' model (what its `fit` inits
    from seed 0) as a port `.pt` at step 0, outside any `checkpoints/`."""
    tk_cfg = _tk_config(tk_data.get_tokenizer().vocab_size)
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


def _tk_fit(directory: Path, argv: list) -> tuple:
    """tpukit's `fit` in `directory`: (result, its JSONL records)."""
    log = directory / "run.jsonl"
    flags = tk_parse_flags(argv + ["--metrics_log", str(log), "--prefetch", "0"])
    try:
        result = _in(directory, tk_fit, flags, TkSingleDevice())
    finally:
        records = ([json.loads(x) for x in log.read_text().splitlines()]
                   if log.exists() else [])
    return result, records


def _tk_windows(records) -> list:
    return [r["loss"] for r in records if r["kind"] == "train"]


def _port(directory: Path, argv: list):
    return _in(directory, single.main, argv + ["--device", "cpu"])


def _port_windows(result) -> list:
    return [w["loss"] for w in result.metrics["train_windows"]]


def _same_params(a, b) -> None:
    """Two fit results' parameters, bit for bit."""
    a, b = a.state, b.state
    for n, x, y in zip(paths(a.params), leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------- chaos ----

GOOD_SPECS = [
    "nan_loss@120, spike_loss@7:50, sigterm@300,hang@450:2.5,"
    "bitflip@10:1,ckpt_io_fail@2:3,loader_io_fail@1,skip@17",
    "resize@6:4", "sigint@3,ckpt_read_fail@2:2", "replica_kill@3:1,replica_sigkill@4",
    "slow_replica@2:50,stuck_request@4,ledger_io_fail@1:2", "", " nan_loss@1 ,",
]
BAD_SPECS = [
    "nan_loss", "nan_loss@", "@12", "frobnicate@3", "nan_loss@x",  # typos
    "hang@10:-2", "spike_loss@7:0", "ckpt_io_fail@0", "loader_io_fail@2:0",  # insane params
    "resize@6", "resize@6:0", "resize@6:2.5", "replica_kill@3:1.5", "slow_replica@2",
    "stuck_request@4:1", "ledger_io_fail@0",
]


@pytest.mark.parametrize("spec", GOOD_SPECS + BAD_SPECS)
def test_chaos_spec_parses_and_refuses_as_tpukit(spec):
    """`parse_spec` accepts and refuses exactly what tpukit's does, with
    tpukit's entries and messages (tests/test_recovery.py:68-105,
    test_reshard.py's resize grammar)."""
    try:
        want = tk_chaos.parse_spec(spec)
    except tk_chaos.ChaosSpecError as exc:
        with pytest.raises(chaos.ChaosSpecError) as got:
            chaos.parse_spec(spec)
        assert str(got.value) == str(exc)
        assert spec in BAD_SPECS
        return
    assert chaos.parse_spec(spec) == want
    assert spec in GOOD_SPECS


@pytest.mark.parametrize("spec", ["replica_kill@3", "nan_loss@3", "bitflip@5:9", "skip@4"])
def test_chaos_engine_and_fleet_validation_refuse_as_tpukit(spec):
    """The training engine refuses fleet kinds and out-of-world bitflips;
    `validate_fleet_spec` refuses training kinds; both with tpukit's
    messages."""
    for make in (lambda m: m.ChaosEngine(spec, process_count=4),
                 lambda m: m.validate_fleet_spec(spec)):
        try:
            want = make(tk_chaos)
        except tk_chaos.ChaosSpecError as exc:
            with pytest.raises(chaos.ChaosSpecError) as got:
                make(chaos)
            assert str(got.value) == str(exc)
            continue
        got = make(chaos)
        if isinstance(want, list):
            assert got == want
        else:
            assert got.skip_batches == want.skip_batches


def test_chaos_step_faults_fire_once_as_tpukit():
    """nan_loss, spike_loss (with its multiplier) and hang fire at their
    step exactly once, on the observed loss only; a step repeated after a
    rollback does not fire again."""
    spec = "nan_loss@5,spike_loss@3:100,hang@4:0"
    tk_eng, eng = tk_chaos.ChaosEngine(spec), chaos.ChaosEngine(spec)
    state = {"w": torch.zeros(3)}
    for step in (3, 4, 5, 5, 3):
        _, tk_loss, tk_fired = tk_eng.on_step(step, {"w": jnp.zeros(3)},
                                              jnp.asarray(2.5, jnp.float32))
        s, loss, fired = eng.on_step(step, state, torch.tensor(2.5))
        assert s is state and fired == tk_fired
        np.testing.assert_array_equal(loss.numpy(), np.asarray(tk_loss))
    assert eng.drain_fired() == tk_eng.drain_fired() and eng.fired == []


def test_chaos_bitflip_targets_its_rank_and_flips_tpukit_s_bit():
    """bitflip@N:p flips on rank p only: the lowest bit of the first
    element of the first leaf in jax's flatten order (keys sorted), in
    place, the same bits as tpukit's flip (f32 parameters, as both
    packages keep them)."""
    dtype = torch.float32
    def tree():
        return {"z": {"w": torch.ones(3, dtype=dtype)},
                "a": {"b": torch.linspace(1, 2, 6, dtype=dtype).reshape(2, 3)}}

    other = chaos.ChaosEngine("bitflip@4:1", process_index=0, process_count=2)
    state = TrainState(params=tree(), optimizer=None)
    _, _, fired = other.on_step(4, state, torch.tensor(1.0))
    assert fired == [{"fault": "bitflip", "step": 4, "process": 1}]
    assert all(torch.equal(x, y) for x, y in zip(leaves(state.params), leaves(tree())))
    assert not other.mutates_state_at(4)

    mine = chaos.ChaosEngine("bitflip@4:1", process_index=1, process_count=2)
    assert mine.mutates_state_at(4)
    first = state.params["a"]["b"]
    _, _, fired = mine.on_step(4, state, torch.tensor(1.0))
    assert fired[0]["flipped"] is True and state.params["a"]["b"] is first  # in place
    changed = (state.params["a"]["b"] != tree()["a"]["b"])
    assert int(changed.sum()) == 1 and bool(changed.view(-1)[0])
    assert torch.equal(state.params["z"]["w"], tree()["z"]["w"])
    tk_state = {k: {kk: jnp.asarray(v.numpy()) for kk, v in d.items()}
                for k, d in tree().items()}
    tk_eng = tk_chaos.ChaosEngine("bitflip@4:1", process_index=1, process_count=2)
    flipped, _, _ = tk_eng.on_step(4, tk_state, jnp.float32(1.0))
    np.testing.assert_array_equal(state.params["a"]["b"].numpy(),
                                  np.asarray(flipped["a"]["b"]))


def test_chaos_io_faults_count_occurrences_as_tpukit():
    """`ckpt_io_fail@2:2`: the 2nd operation fails its first two attempts
    (retries re-enter without advancing the occurrence); other sites pass."""
    spec = "ckpt_io_fail@2:2,loader_io_fail@1,ckpt_read_fail@3"
    calls = ["ckpt_write"] * 5 + ["loader_fetch"] * 3 + ["ckpt_read"] * 4 + ["other"]

    def outcomes(mod):
        eng = mod.ChaosEngine(spec)
        out = []
        for site in calls:
            try:
                eng.io_fault(site)
                out.append("ok")
            except IOError as exc:
                out.append(str(exc))
        return out, eng.fired

    assert outcomes(chaos) == outcomes(tk_chaos)


def test_chaos_module_hooks_install_and_clear():
    assert chaos.installed() is None
    chaos.maybe_io_fault("ckpt_write")  # nothing installed: a no-op
    eng = chaos.ChaosEngine("ckpt_io_fail@1")
    prev = chaos.install(eng)
    try:
        assert prev is None and chaos.installed() is eng
        with pytest.raises(IOError, match="injected transient ckpt_write"):
            chaos.maybe_io_fault("ckpt_write")
    finally:
        chaos.install(prev)
    assert chaos.installed() is None


# ---------------------------------------------------------------- retry ----


def test_retry_policy_validates_and_backs_off_as_tpukit():
    import random

    for bad in (dict(retries=-1), dict(jitter=1.0), dict(base_delay=-0.1)):
        with pytest.raises(ValueError):
            retry.RetryPolicy(**bad)
    pol = retry.RetryPolicy(retries=8, base_delay=0.1, max_delay=1.0, jitter=0.0)
    delays = [pol.delay(k, random.Random(0)) for k in range(1, 7)]
    assert delays == [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]
    jit, tk_jit = retry.RetryPolicy(jitter=0.5), tk_retry.RetryPolicy(jitter=0.5)
    a, b = random.Random(3), random.Random(3)
    assert [jit.delay(k, a) for k in (1, 2, 3)] == [tk_jit.delay(k, b) for k in (1, 2, 3)]


def test_retry_io_recovers_within_budget_and_observes():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError(f"transient {calls['n']}")
        return "ok"

    slept = []
    assert retry.retry_io(flaky, label="t", policy=retry.RetryPolicy(retries=3),
                          sleep=slept.append) == "ok"
    assert calls["n"] == 3 and len(slept) == 2
    log = retry.RetryLog()
    retry.set_observer(log)
    try:
        calls["n"] = 0
        retry.retry_io(flaky, label="obs", policy=retry.RetryPolicy(retries=3),
                       sleep=lambda s: None)
    finally:
        retry.set_observer(None)
    events = log.drain()
    assert [e["attempt"] for e in events] == [1, 2] and {e["label"] for e in events} == {"obs"}
    assert log.total == 2 and log.drain() == []


def test_retry_io_fails_loud_after_budget_and_with_zero_budget():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise IOError("still down")

    with pytest.raises(IOError, match="still down"):
        retry.retry_io(always, policy=retry.RetryPolicy(retries=2), sleep=lambda s: None)
    assert calls["n"] == 3
    calls["n"] = 0
    with pytest.raises(IOError):
        retry.retry_io(always, policy=retry.RetryPolicy(retries=0), sleep=lambda s: None)
    assert calls["n"] == 1


@pytest.mark.parametrize("error", [
    ValueError("a bug, not weather"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    subprocess.CalledProcessError(1, ["nvcc", "flash_attention.cu"]),
])
def test_retry_io_never_retries_programming_errors(error):
    """Only `OSError` is retried: a bug, a CUDA error or a failed kernel
    build goes up at the first attempt."""
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise error

    with pytest.raises(type(error)):
        retry.retry_io(broken, sleep=lambda s: None)
    assert calls["n"] == 1


# ------------------------------------------------------------- recovery ----


def test_exit_code_contract_is_tpukit_s():
    for name in ("EXIT_CLEAN", "EXIT_PREEMPTED", "EXIT_ANOMALY_ABORT",
                 "EXIT_ROLLBACK_EXHAUSTED"):
        assert getattr(recovery, name) == getattr(tk_recovery, name)
    assert (recovery.EXIT_PREEMPTED, recovery.EXIT_ANOMALY_ABORT,
            recovery.EXIT_ROLLBACK_EXHAUSTED) == (75, 76, 77)
    assert issubclass(recovery.RollbackBudgetExhausted, recovery.AnomalyAbort)


@pytest.mark.parametrize("raised", [None, "Preempted", "AnomalyAbort",
                                    "RollbackBudgetExhausted", "TrainingAborted", "KeyError"])
def test_run_recipe_maps_exceptions_as_tpukit(raised):
    def main_of(mod):
        def main(argv):
            if raised == "KeyError":
                raise KeyError("boom")
            if raised is not None:
                raise getattr(mod, raised)("x")
        return main

    if raised == "KeyError":  # an unexpected crash keeps its traceback
        for mod in (recovery, tk_recovery):
            with pytest.raises(KeyError):
                mod.run_recipe(main_of(mod))
        return
    assert recovery.run_recipe(main_of(recovery)) == tk_recovery.run_recipe(main_of(tk_recovery))


def _fake_state(step: int):
    from flax import struct

    @struct.dataclass
    class S:
        step: int
        w: np.ndarray

    return S(step=step, w=np.arange(8, dtype=np.float32) + step)


def _tk_dir(directory: Path, steps=(2, 4, 6, 8), meta=True) -> Path:
    """tpukit consolidated checkpoints (with sidecars) at `steps`."""
    for step in steps:
        tkc.save(_fake_state(step), directory, meta={"step": step} if meta else None)
    return directory


@pytest.mark.parametrize("anomaly,window", [(9, 4), (9, 8), (5, 4), (20, 8), (8, 0)])
def test_recovery_plan_picks_tpukit_s_checkpoint(tmp_path, anomaly, window):
    _tk_dir(tmp_path)
    tk_plan = tk_recovery.RecoveryEngine(tmp_path, max_rollbacks=2).plan("nan", anomaly, window)
    plan = recovery.RecoveryEngine(tmp_path, max_rollbacks=2).plan("nan", anomaly, window)
    if tk_plan is None:
        assert plan is None
        return
    assert plan.record() == tk_plan.record()


def test_recovery_budget_exhaustion_and_no_candidate(tmp_path):
    eng = recovery.RecoveryEngine(tmp_path, max_rollbacks=0)
    assert eng.plan("nan", 10, window=0) is None and eng.exhausted
    _tk_dir(tmp_path, steps=(6,))
    eng = recovery.RecoveryEngine(tmp_path, max_rollbacks=3)
    assert eng.plan("nan", 5, window=4) is None and eng.exhausted
    with pytest.raises(ValueError):
        recovery.RecoveryEngine(tmp_path, max_rollbacks=-1)
    eng = recovery.RecoveryEngine(tmp_path, max_rollbacks=3)
    plan = eng.plan("nan", 14, window=8)
    eng.committed(plan)
    assert (eng.count, eng.steps_lost, eng.history) == (1, 8, [plan])


def test_quarantine_renames_as_tpukit(tmp_path):
    """Both engines rename the abandoned timeline's checkpoints and their
    sidecars alike; rank 0 only; the newest good is then the target."""
    dirs = {}
    for mod in (tk_recovery, recovery):
        d = _tk_dir(tmp_path / mod.__name__)
        eng = mod.RecoveryEngine(d, max_rollbacks=3)
        plan = eng.plan("spike", anomaly_step=9, window=4)
        assert eng.quarantine(plan, process_zero=False) == []
        dirs[mod] = (sorted(eng.quarantine(plan)), sorted(p.name for p in d.iterdir()))
    assert dirs[recovery] == dirs[tk_recovery]
    assert dirs[recovery][0] == ["checkpoint-step000000006.msgpack.quarantined-0001",
                                 "checkpoint-step000000008.msgpack.quarantined-0001"]
    assert ckpt._step_of(ckpt.latest_good(tmp_path / recovery.__name__)) == 4


def test_quarantine_moves_a_pt_with_its_flags(tmp_path, tiny_params):
    state = create_train_state(params_from_numpy(jax.tree.map(np.asarray, tiny_params),
                                                 device="cpu"), 1e-3)
    for step in (4, 8):
        state.step = step
        ckpt.save(state, flags=None, directory=tmp_path, meta={"step": step})
    eng = recovery.RecoveryEngine(tmp_path)
    plan = eng.plan("nan", 12, window=8)
    assert eng.quarantine(plan) == ["checkpoint-8.pt.quarantined-0001"]
    assert sorted(p.name for p in tmp_path.glob("checkpoint-8*")) == [
        "checkpoint-8.pt.meta.json.quarantined-0001", "checkpoint-8.pt.quarantined-0001"]
    assert [p.name for p in ckpt.all_checkpoints(tmp_path)] == ["checkpoint-4.pt"]


@pytest.mark.parametrize("writer", ["tpukit", "port"])
def test_rollback_coordinator_files_cross_read(tmp_path, writer):
    """rank 0 of one package publishes; rank 1 of the other confirms,
    refuses a split-brain plan, times out without a decision, and acks."""
    w, r = (tk_recovery, recovery) if writer == "tpukit" else (recovery, tk_recovery)
    plan_w = w.RollbackPlan(seq=1, reason="nan", anomaly_step=20, target_step=12,
                            target_path="c", steps_lost=8)
    plan_r = r.RollbackPlan(**plan_w.record())
    p0 = w.RollbackCoordinator(tmp_path, process_index=0, process_count=2)
    p1 = r.RollbackCoordinator(tmp_path, process_index=1, process_count=2, timeout_s=0.2)
    with pytest.raises(r.TrainingAborted, match="timed out"):
        p1.confirm(plan_r)
    p0.publish(plan_w)
    p1.confirm(plan_r)
    with pytest.raises(r.TrainingAborted, match="split-brain"):
        p1.confirm(dataclasses.replace(plan_r, target_step=8))
    p1.ack(1, 12)
    assert [json.loads(p.read_text()) for p in tmp_path.glob("rollback-0001-ack-*.json")] == [
        {"process": 1, "step": 12}]
    p0.publish(dataclasses.replace(plan_w, seq=2), execute_after=28)
    assert p1.read(2) == {**plan_w.record(), "seq": 2, "execute_after": 28}
    r.RollbackCoordinator(tmp_path, process_index=0, process_count=2)  # a new incarnation
    assert not list(tmp_path.glob("rollback-*.json"))


@pytest.mark.parametrize("writer", ["tpukit", "port"])
def test_preempt_coordinator_files_cross_read(tmp_path, writer):
    w, r = (tk_recovery, recovery) if writer == "tpukit" else (recovery, tk_recovery)
    p1 = w.PreemptCoordinator(tmp_path, process_index=1, process_count=2)
    p0 = r.PreemptCoordinator(tmp_path, process_index=0, process_count=2)
    p1.request("SIGTERM")
    p1.request("SIGTERM")
    assert len(list(tmp_path.glob("preempt-request-p*.json"))) == 1
    assert p0.any_request() == "SIGTERM"
    dec = p0.publish("SIGTERM", execute_after=48)
    assert dec == {"signal": "SIGTERM", "execute_after": 48, "run_start": 0}
    assert p1.read() == dec and p0.publish("SIGINT", execute_after=64) == dec
    p1.run_start = 48  # another incarnation's reader ignores them
    assert p1.read() is None
    w.PreemptCoordinator(tmp_path, process_index=0, process_count=2)  # p0's sweep
    assert p0.read() is None


def test_preemption_guard_sets_flag_and_restores_handlers():
    prev = signal.getsignal(signal.SIGTERM)
    with recovery.PreemptionGuard() as guard:
        assert guard.pending is None
        signal.raise_signal(signal.SIGTERM)
        assert guard.pending == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is prev


# -------------------------------------------------- heartbeat, sentinel ----


def test_heartbeats_cross_read_and_check_as_tpukit(tmp_path):
    """Beats of both packages in one directory: each reader sees both,
    names the same stragglers (missing, stale, lagging) and the same
    divergence."""
    hb = heartbeat.Heartbeat(tmp_path, process_index=0, process_count=4, timeout_s=10)
    tk_hb = tk_heartbeat.Heartbeat(tmp_path, process_index=1, process_count=4, timeout_s=10)
    hb.beat(40, now=1000.0, checksum="aa", checksum_step=32, timeline=1)
    tk_hb.beat(16, now=1000.0, checksum="bb", checksum_step=32, timeline=1)
    heartbeat.Heartbeat(tmp_path, process_index=2, process_count=4).beat(
        40, now=900.0, checksum="aa", checksum_step=32, timeline=1)
    for a, b in ((hb, tk_hb), (tk_hb, hb)):
        assert a.read_all() == b.read_all() and set(a.read_all()) == {0, 1, 2}
        assert a.check(now=1001.0, step_lag=8) == b.check(now=1001.0, step_lag=8)
        assert a.check_divergence() == b.check_divergence()
    assert {s["reason"] for s in hb.check(now=1001.0, step_lag=8)} == {"missing", "stale",
                                                                       "lagging"}
    assert hb.check_divergence() == [{"process": 1, "checksum_step": 32, "checksum": "bb",
                                      "expected": "aa"}]


def test_spike_sentinel_fires_as_tpukit():
    losses = [5.0, 4.9, 4.8, 4.85, 4.7, 9.5, 4.6, float("nan"), 4.5, 30.0, 4.4]
    ours, theirs = sentinels.SpikeSentinel(3.0), tk_sentinels.SpikeSentinel(3.0)
    for step, loss in enumerate(losses):
        a, b = ours.observe(loss, step), theirs.observe(loss, step)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.record() == b.record()
    ours.reset()
    assert ours.observe(100.0, 99) is None  # no history: no spike
    with pytest.raises(ValueError):
        sentinels.SpikeSentinel(0)


# -------------------------------------------------------------- reshard ----


def test_world_of_a_tpukit_meta_matches_the_port_s(tmp_path):
    """A single-device world records what tpukit's does, so a tpukit-written
    meta at the same world is no mismatch; the sweep removes tpukit's
    names."""
    world = reshard.current_world(SingleDevice(), global_batch=8)
    assert world == tk_reshard.current_world(TkSingleDevice(), global_batch=8)
    path = tkc.save(_fake_state(3), tmp_path, meta={"world": world})
    assert reshard.saved_world(path) == tk_reshard.saved_world(path) == world
    assert reshard.describe_mismatch(reshard.saved_world(path), world) is None
    other = {**world, "nprocs": 4, "device_count": 4, "strategy": "ddp"}
    assert reshard.describe_mismatch(other, world) == tk_reshard.describe_mismatch(other, world)
    assert reshard.describe_mismatch(None, world) is None
    hb = tmp_path / "hb"
    for d in (hb, tmp_path / "hb_tk"):
        d.mkdir()
        for name in ("heartbeat-p00003.json", "rollback-0001.json", "preempt-decision.json",
                     "preempt-request-p00001.json", "keep.json"):
            (d / name).write_text("{}")
    assert reshard.sweep_stale_world(hb) == tk_reshard.sweep_stale_world(tmp_path / "hb_tk")
    assert [p.name for p in hb.iterdir()] == ["keep.json"]


def test_resize_resumed_at_another_world_raises(tmp_path, init_pt):
    """resize@N:M exits 75 with `resize_to` M in its meta; a relaunch whose
    world differs from the saving one and is not M raises (tpukit
    `train.py:592-606`), one that is M resumes; the same world resumes."""
    argv = ARGS + ["--resume", str(init_pt), "--chaos_spec", "resize@3:2"]
    code = _in(tmp_path, recovery.run_recipe, single.main, argv + ["--device", "cpu"])
    assert code == recovery.EXIT_PREEMPTED
    path = tmp_path / "checkpoints" / "checkpoint-3.pt"
    meta = ckpt.read_meta(path)
    assert meta["resize_to"] == 2 and meta["batch_in_epoch"] == 3
    short = _set(ARGS, "--dataset_slice", "40") + ["--resume", str(path)]
    same = _port(tmp_path, short)
    assert same.state.step == 5  # the same world: a plain continuation
    ckpt.meta_path(path).write_text(json.dumps(
        {**meta, "world": {**meta["world"], "nprocs": 4, "device_count": 4}}))
    with pytest.raises(RuntimeError, match="expecting relaunch at 2 devices, but this world "
                                           "has 1"):
        _port(tmp_path, ARGS + ["--resume", str(path)])
    ckpt.meta_path(path).write_text(json.dumps(
        {**meta, "resize_to": 1, "world": {**meta["world"], "nprocs": 4, "device_count": 4}}))
    assert _port(tmp_path, short).state.step == 5


# ----------------------------------------------------------- checkpoints ----


def _batch(rng, vocab: int = 97):
    from tpukit_torch.batching import prepare_batch
    from tpukit_torch.train import to_device

    ids = rng.randint(3, vocab, size=(2, 13)).astype(np.int32)
    raw = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    return to_device(*prepare_batch(raw, 2), "cpu")


@pytest.fixture()
def stepped(tiny_params):
    """The port's state of tiny_config after two AdamW steps."""
    state = create_train_state(params_from_numpy(jax.tree.map(np.asarray, tiny_params),
                                                 device="cpu"), 1e-3)
    cfg = gpt.GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=97,
                        max_position_embeddings=64, compute_dtype=torch.float32)
    rng = np.random.RandomState(0)
    for _ in range(2):
        train_step(state, cfg, SingleDevice(), *_batch(rng))
    return cfg, state


def _files(path: Path) -> dict:
    """Every file of a checkpoint (its sidecars included) by name: bytes."""
    if path.is_dir():
        return {p.name: p.read_bytes() for p in sorted(path.iterdir())}
    return {p.name: p.read_bytes() for p in sorted(path.parent.iterdir())
            if p.name.startswith(path.stem)}


@pytest.mark.parametrize("fmt", ["auto", "consolidated", "sharded"])
def test_meta_sidecar_in_every_format_is_read_by_tpukit(tmp_path, stepped, fmt):
    _, state = stepped
    meta = {"step": 2, "epoch": 0, "batch_in_epoch": 2, "preempted": True, "signal": "SIGTERM"}
    path = ckpt.save_auto(state, fmt, directory=tmp_path, meta=meta)
    assert ckpt.read_meta(path) == tkc.read_meta(path) == meta
    if fmt != "auto":
        assert tkc.verify_checkpoint(path) == (True, "verified")
    again = ckpt.save_auto(state, fmt, directory=tmp_path / "plain")
    assert ckpt.read_meta(again) is None


@pytest.mark.parametrize("fmt", ["auto", "consolidated", "sharded"])
def test_async_writer_bytes_equal_the_sync_writer_s(tmp_path, stepped, fmt):
    """`AsyncCheckpointer.save_auto` publishes the sync writer's bytes,
    every file of the checkpoint and its sidecars."""
    from tpukit_torch.flags import parse_flags

    _, state = stepped
    flags = parse_flags(["--device", "cpu"])
    meta = {"world": {"nprocs": 1}}
    saver = ckpt.AsyncCheckpointer()
    a = saver.save_auto(state, fmt, flags, directory=tmp_path / "a", meta=meta)
    saver.wait()
    assert not saver.in_flight
    b = ckpt.save_auto(state, fmt, flags, directory=tmp_path / "b", meta=meta)
    assert a.name == b.name and _files(a) == _files(b) and len(_files(a)) >= 3


@pytest.mark.parametrize("fmt", ["auto", "consolidated", "sharded"])
def test_async_snapshot_is_taken_at_save_time(tmp_path, stepped, fmt):
    """The next step updates the parameters in place while the write runs:
    the checkpoint still holds the state of the moment of the save."""
    cfg, state = stepped
    want = {n: p.detach().clone() for n, p in zip(paths(state.params), leaves(state.params))}
    saver = ckpt.AsyncCheckpointer()
    path = saver.save_auto(state, fmt, directory=tmp_path)
    rng = np.random.RandomState(1)
    for _ in range(3):
        train_step(state, cfg, SingleDevice(), *_batch(rng))
    saver.wait()
    back = create_train_state(gpt.init_params(cfg, seed=5, device="cpu"), 1e-3)
    ckpt.restore_any(path, back)
    assert back.step == 2
    for n, p in zip(paths(back.params), leaves(back.params)):
        assert torch.equal(p, want[n]), n


@pytest.mark.parametrize("fmt", ["auto", "consolidated", "sharded"])
def test_async_errors_surface_at_the_next_barrier(tmp_path, stepped, fmt):
    """A background failure is re-raised by `wait()` (and by the next save,
    which joins first), never lost; one write in flight at most."""
    _, state = stepped
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where the directory should be")
    saver = ckpt.AsyncCheckpointer()
    saver.save_auto(state, fmt, directory=blocker / "sub")
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as exc:
        saver.wait()
    assert isinstance(exc.value.__cause__, OSError)
    saver.wait()  # the error was delivered once
    saver.save_auto(state, fmt, directory=blocker / "sub")
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        saver.save_auto(state, fmt, directory=tmp_path / "ok")
    assert not saver.in_flight
    saver.save_auto(state, fmt, directory=tmp_path / "ok")
    saver.wait()
    assert ckpt.all_checkpoints(tmp_path / "ok")


def test_prune_keeps_newest_k_as_tpukit(tmp_path):
    """tpukit `test_reshard.py:413-431` on the port's retention."""
    for d in (tmp_path / "port", tmp_path / "tk"):
        _tk_dir(d, steps=(2, 4, 6, 8, 10))
    removed = ckpt.prune_checkpoints(tmp_path / "port", keep=2)
    assert sorted(removed) == sorted(tkc.prune_checkpoints(tmp_path / "tk", keep=2)) == [
        "checkpoint-step000000002.msgpack", "checkpoint-step000000004.msgpack",
        "checkpoint-step000000006.msgpack"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "tk").iterdir())
    assert [ckpt._step_of(p) for p in ckpt.all_checkpoints(tmp_path / "port")] == [8, 10]
    assert ckpt.prune_checkpoints(tmp_path / "port", keep=2) == []
    with pytest.raises(ValueError):
        ckpt.prune_checkpoints(tmp_path / "port", keep=0)


def test_prune_never_touches_quarantined_timelines(tmp_path):
    """tpukit `test_reshard.py:434-456`."""
    _tk_dir(tmp_path, steps=(2, 4, 6, 8, 10))
    eng = recovery.RecoveryEngine(tmp_path, max_rollbacks=3)
    assert len(eng.quarantine(eng.plan("nan", anomaly_step=11, window=4))) == 2
    assert sorted(ckpt.prune_checkpoints(tmp_path, keep=1)) == [
        "checkpoint-step000000002.msgpack", "checkpoint-step000000004.msgpack"]
    assert [ckpt._step_of(p) for p in ckpt.all_checkpoints(tmp_path)] == [6]
    assert len(list(tmp_path.glob("*.quarantined-0001"))) >= 2


def test_prune_protects_latest_good_when_kept_are_corrupt(tmp_path):
    """tpukit `test_reshard.py:459-470`."""
    _tk_dir(tmp_path, steps=(2, 4, 6, 8), meta=False)
    for step in (6, 8):
        bad = tmp_path / f"checkpoint-step{step:09d}.msgpack"
        bad.write_bytes(b"bitrot" + bad.read_bytes()[6:])
    assert ckpt.prune_checkpoints(tmp_path, keep=2) == ["checkpoint-step000000002.msgpack"]
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        assert ckpt._step_of(ckpt.latest_good(tmp_path)) == 4


def test_all_checkpoints_and_latest_good_span_the_three_formats(tmp_path, stepped):
    _, state = stepped
    for step, fmt in ((2, "auto"), (4, "consolidated"), (6, "sharded"), (8, "auto")):
        state.step = step
        ckpt.save_auto(state, fmt, directory=tmp_path)
    (tmp_path / "checkpoint-step000000010.sharded.tmp").mkdir()  # an unpublished save
    names = [p.name for p in ckpt.all_checkpoints(tmp_path)]
    assert names == ["checkpoint-2.pt", "checkpoint-step000000004.msgpack",
                     "checkpoint-step000000006.sharded", "checkpoint-8.pt"]
    assert ckpt.latest_good(tmp_path, max_step=7).name == "checkpoint-step000000006.sharded"
    assert ckpt.latest_good(tmp_path, max_step=1) is None


# --------------------------------------------------------- fit: C6, C7 ----


def test_resume_path_that_fails_verification_raises_as_tpukit(tmp_path):
    """C6: a tpukit consolidated checkpoint of the recipe's model with one
    payload byte flipped still decodes, so the port used to resume from it;
    tpukit's `fit` refuses it with `ValueError`, and so must the port's."""
    tk_cfg = _tk_config(tk_data.get_tokenizer().vocab_size)
    state = tk_create_train_state(jax.random.PRNGKey(0), tk_cfg, tk_make_optimizer(1e-3))
    path = tkc.save(state, tmp_path / "ck")
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x01  # a bit of the middle of a weight array
    path.write_bytes(bytes(blob))
    probe = create_train_state(gpt.init_params(gpt.GPTConfig(
        dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tk_cfg.vocab_size,
        max_position_embeddings=64, compute_dtype=torch.float32), device="cpu"), 1e-3)
    ckpt.restore_any(path, probe)  # the damage decodes silently
    argv = ARGS + ["--resume", str(path)]
    with pytest.raises(ValueError, match="failed integrity verification") as tk_exc:
        _tk_fit(tmp_path / "tk", argv)
    with pytest.raises(ValueError, match="failed integrity verification") as exc:
        _port(tmp_path / "port", argv)
    assert str(exc.value) == str(tk_exc.value)


def test_preempted_checkpoint_continues_its_epoch_as_tpukit(tmp_path):
    """C7: tpukit's initial state saved with `{"preempted": true, "epoch":
    0, "batch_in_epoch": 2}` beside it; both packages resume at batch 2 of
    epoch 0, so their windows (closing where an uninterrupted run's do)
    agree."""
    tk_cfg = _tk_config(tk_data.get_tokenizer().vocab_size)
    state = tk_create_train_state(jax.random.PRNGKey(0), tk_cfg, tk_make_optimizer(1e-3))
    path = tkc.save(state, tmp_path / "ck",
                    meta={"preempted": True, "epoch": 0, "batch_in_epoch": 2})
    argv = ARGS + ["--resume", str(path)]
    tk_result, records = _tk_fit(tmp_path / "tk", argv)
    result = _port(tmp_path / "port", argv)
    assert [w["step"] for w in result.metrics["train_windows"]] == [7, 15, 23]
    np.testing.assert_allclose(_port_windows(result), _tk_windows(records), rtol=FIT_RTOL)
    assert result.state.step == int(tk_result.state.step) == 23


# --------------------------------------------- fit: preemption, rollback ----


def test_preempted_recipe_exits_75_and_resumes_bit_exact(tmp_path, init_pt):
    """`python -m tpukit_torch.recipes.single --chaos_spec sigterm@9` exits
    75 with a checkpoint whose sidecar tpukit reads; `--resume latest`
    continues bit for bit with the uninterrupted run; tpukit's own
    preempted and resumed run gives the same windows within the fit bar."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    run = tmp_path / "run"
    run.mkdir()
    proc = subprocess.run([sys.executable, "-m", "tpukit_torch.recipes.single", *ARGS,
                           "--device", "cpu", "--resume", str(init_pt),
                           "--chaos_spec", "sigterm@9"],
                          cwd=run, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert "Preempted: SIGTERM at step 9" in proc.stderr
    path = run / "checkpoints" / "checkpoint-9.pt"
    meta = tkc.read_meta(path)
    assert (meta["preempted"], meta["epoch"], meta["batch_in_epoch"], meta["step"],
            meta["signal"]) == (True, 0, 9, 9, "SIGTERM")
    resumed = _port(run, ARGS + ["--resume", "latest"])
    control = _port(tmp_path / "control", ARGS + ["--resume", str(init_pt)])
    assert [w["step"] for w in resumed.metrics["train_windows"]] == [17, 25]
    assert resumed.metrics["train_windows"] == control.metrics["train_windows"][1:]
    assert resumed.state.step == control.state.step == 25
    _same_params(resumed, control)

    tk_run = tmp_path / "tk"
    with pytest.raises(tk_recovery.Preempted):
        _tk_fit(tk_run, ARGS + ["--chaos_spec", "sigterm@9"])
    _, records = _tk_fit(tk_run, ARGS + ["--resume", "latest"])
    np.testing.assert_allclose(_port_windows(resumed), _tk_windows(records), rtol=FIT_RTOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_ddp_preemption_is_collective_and_exits_in_lockstep(tmp_path):
    """Two gloo ranks under DDP with a heartbeat directory: each rank's
    sigterm@9 becomes a request, rank 0 publishes one decision a full
    window past the next boundary (step 32), and both ranks save there
    (tpukit's sharded format through the async writer: each rank's shard,
    met through the filesystem) and exit 75."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    argv = [sys.executable, "-m", "tpukit_torch.recipes.ddp",
            *_set(_set(ARGS, "--dataset_slice", "400"), "--batch_size", "4"), "--device", "cpu",
            "--chaos_spec", "sigterm@9", "--heartbeat_dir", "hb",
            "--checkpoint_format", "sharded", "--async_checkpoint"]
    procs = [subprocess.Popen(argv, cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [75, 75], [o[1][-1500:] for o in outs]
    assert all("Preempted: SIGTERM at step 32" in err for _, err in outs)
    hb = tmp_path / "hb"
    assert json.loads((hb / "preempt-decision.json").read_text()) == {
        "signal": "SIGTERM", "execute_after": 32, "run_start": 0}
    assert sorted(p.name for p in hb.glob("preempt-request-p*.json")) == [
        "preempt-request-p00000.json", "preempt-request-p00001.json"]
    assert {json.loads(p.read_text())["step"] for p in hb.glob("heartbeat-p*.json")} == {32}
    path = tmp_path / "checkpoints" / "checkpoint-step000000032.sharded"
    assert tkc.verify_checkpoint(path) == (True, "verified")
    assert sorted(p.name for p in path.iterdir()) == [
        "manifest.json", "resume.json", "shard-00000.npz", "shard-00000.npz.sha256",
        "shard-00001.npz", "shard-00001.npz.sha256"]
    meta = tkc.read_meta(path)
    assert (meta["batch_in_epoch"], meta["world"]["nprocs"], meta["world"]["strategy"]) == (
        32, 2, "ddp")


@pytest.fixture(scope="module")
def rollback_runs(tmp_path_factory, init_pt):
    """nan_loss@12 under --on_anomaly rollback in the port and in tpukit,
    and the port's control restored from the rollback's target with the
    stream at the same position (skip@17)."""
    tmp = tmp_path_factory.mktemp("rollback")
    argv = ARGS + ROLLBACK + ["--on_anomaly", "rollback", "--max_rollbacks", "2"]
    port = _port(tmp / "port", argv + ["--resume", str(init_pt)])
    control = _port(tmp / "control", ARGS + [
        "--checkpoint_every", "4", "--chaos_spec", "skip@17",
        "--resume", str(tmp / "port" / "checkpoints" / "checkpoint-8.pt")])
    tk = _tk_fit(tmp / "tk", argv)
    return tmp, port, control, tk


def test_rollback_restores_quarantines_and_matches_the_restored_control(rollback_runs):
    """The rollback of tpukit's `test_chaos_rollback_*` in the port: the
    sentinel sees NaN in the window ending at step 17, the step-8
    checkpoint comes back in place, steps 12 and 16 are quarantined, the
    run completes at step 16; its windows after the rollback and its final
    checkpoint equal the restored control's bit for bit, and tpukit's
    rollback run within the fit bar."""
    tmp, port, control, (_, records) = rollback_runs
    [rb] = port.metrics["events"]["rollbacks"]
    tk_rb = next(r for r in records if r["kind"] == "rollback")
    for key in ("reason", "anomaly_step", "target_step", "steps_lost", "timeline"):
        assert rb[key] == tk_rb[key], key
    assert (rb["anomaly_step"], rb["target_step"], rb["steps_lost"]) == (17, 8, 9)
    assert sorted(rb["quarantined"]) == ["checkpoint-12.pt.quarantined-0001",
                                         "checkpoint-16.pt.quarantined-0001"]
    assert port.metrics["spike_events"] == 1 and port.state.step == 16
    assert ckpt._step_of(ckpt.latest_any(tmp / "port" / "checkpoints")) == 16
    post = port.metrics["train_windows"][rb["windows_before"]:]
    assert post and post == control.metrics["train_windows"]
    assert (tmp / "port" / "checkpoints" / "checkpoint-16.pt").read_bytes() == (
        tmp / "control" / "checkpoints" / "checkpoint-16.pt").read_bytes()
    rb_idx = next(i for i, r in enumerate(records) if r["kind"] == "rollback")
    tk_post = [r["loss"] for r in records[rb_idx:] if r["kind"] == "train"]
    np.testing.assert_allclose([w["loss"] for w in post], tk_post, rtol=FIT_RTOL)
    windows = _port_windows(port)
    tk_windows = _tk_windows(records)
    assert np.isnan(windows[1]) and np.isnan(tk_windows[1])
    np.testing.assert_allclose(windows[0], tk_windows[0], rtol=FIT_RTOL)


@pytest.mark.parametrize("code,extra", [
    (76, ["--spike_action", "abort"]),
    (77, ["--on_anomaly", "rollback", "--max_rollbacks", "0"]),
])
def test_abort_exit_codes_on_tpukit_s_argv(tmp_path, code, extra):
    """The same argv exits 76 (sentinel abort) or 77 (rollback budget
    spent) in both packages' recipes, each with the blown-up state
    checkpointed at step 17."""
    argv = ARGS + ROLLBACK + extra

    def tk_main(a):
        return tk_fit(tk_parse_flags(a + ["--prefetch", "0"]), TkSingleDevice())

    assert _in(tmp_path / "tk", tk_recovery.run_recipe, tk_main, argv) == code
    assert _in(tmp_path / "port", recovery.run_recipe, single.main,
               argv + ["--device", "cpu"]) == code
    assert (tmp_path / "tk" / "checkpoints" / "checkpoint-step000000017.msgpack").exists()
    assert ckpt.read_meta(tmp_path / "port" / "checkpoints" / "checkpoint-17.pt")["world"][
        "strategy"] == "single"


def test_transient_io_faults_are_retried_in_fit(tmp_path, init_pt):
    """Two failed attempts of the first checkpoint write and one of the
    second batch fetch are absorbed by `--io_retries 3`: the run is the
    uninjected run, bit for bit, and counted its three retries."""
    argv = ARGS + ["--resume", str(init_pt), "--checkpoint_every", "8"]
    faulty = _port(tmp_path / "faulty", argv + [
        "--chaos_spec", "ckpt_io_fail@1:2,loader_io_fail@2"])
    clean = _port(tmp_path / "clean", argv)
    labels = sorted(e["label"] for e in faulty.metrics["events"]["retries"])
    assert labels == ["ckpt_write", "ckpt_write", "loader_fetch"]
    assert faulty.metrics["retries"] == 3
    assert faulty.metrics["train_windows"] == clean.metrics["train_windows"]
    _same_params(faulty, clean)
    with pytest.raises(OSError, match="injected transient ckpt_write"):
        _port(tmp_path / "zero", argv + ["--chaos_spec", "ckpt_io_fail@1", "--io_retries", "0"])


def test_retention_and_async_saves_in_fit(tmp_path, init_pt):
    """`--keep_checkpoints 2` leaves the newest two checkpoints; with
    `--async_checkpoint` they are the sync writer's bytes."""
    argv = ARGS + ["--resume", str(init_pt), "--checkpoint_every", "4",
                   "--keep_checkpoints", "2", "--checkpoint_format", "consolidated"]
    sync = _port(tmp_path / "sync", argv)
    asyn = _port(tmp_path / "async", argv + ["--async_checkpoint"])
    for run in ("sync", "async"):
        assert [p.name for p in ckpt.all_checkpoints(tmp_path / run / "checkpoints")] == [
            "checkpoint-step000000024.msgpack", "checkpoint-step000000025.msgpack"]
    for name in ("checkpoint-step000000024.msgpack", "checkpoint-step000000025.msgpack"):
        for suffix in ("", ".sha256", ".meta.json"):
            assert (tmp_path / "sync" / "checkpoints" / (name + suffix)).read_bytes() == (
                tmp_path / "async" / "checkpoints" / (name + suffix)).read_bytes()
    assert sync.metrics["train_windows"] == asyn.metrics["train_windows"]


def test_fit_rejects_bad_recovery_flags_as_tpukit(tmp_path):
    for extra, match in ((["--max_rollbacks", "-1"], "max_rollbacks"),
                         (["--io_retries", "-1"], "io_retries"),
                         (["--keep_checkpoints", "-1"], "keep_checkpoints"),
                         (["--prefetch", "-1"], "prefetch")):
        with pytest.raises(ValueError, match=match):
            _port(tmp_path, ARGS + extra)
    with pytest.raises(chaos.ChaosSpecError):
        _port(tmp_path, ARGS + ["--chaos_spec", "frobnicate@3"])
    assert chaos.installed() is None  # torn down on the way out
    assert not (tmp_path / "checkpoints").exists()
