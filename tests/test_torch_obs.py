"""The port's telemetry modules (`tpukit_torch/obs/`) against tpukit's
(`tpukit/obs/`), one module at a time, on the CPU at `tiny_config` sizes:
spans, the flight recorder, the JSONL logger, the FLOPs model and the
meter's clock, the metrics plane (merged snapshots byte-equal to tpukit's),
the state checksums (tpukit's value bit for bit, a tpukit checkpoint's
state included), the hang watchdog and the anomaly tracer (mirroring
`tests/test_flightrec.py:38-230`), the global norms (rtol 1e-5 on the same
gradients), the memory gauges, the `--debug_nans` scope, the loader's
closed-form row counts and the deferred rollback's decision files.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit import batching as tk_batching
from tpukit import checkpoint as tkc
from tpukit import recovery as tk_recovery
from tpukit.data import ArrayDataset as TkArrayDataset
from tpukit.loader import DataLoader as TkDataLoader
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.obs import divergence as tk_divergence
from tpukit.obs import meter as tk_meter
from tpukit.obs import metrics as tk_metrics
from tpukit.obs import spans as tk_spans
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import TrainState as TkTrainState
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit.train import make_step_fns
from tpukit_torch import checkpoint as ckpt
from tpukit_torch import recovery
from tpukit_torch.bridge import params_from_numpy
from tpukit_torch.data import ArrayDataset
from tpukit_torch.loader import DataLoader
from tpukit_torch.model import gpt
from tpukit_torch.obs import (AnomalyTracer, FlightRecorder, GOODPUT_SPANS, HangWatchdog,
                              Heartbeat, MetricRegistry, MFUMeter, SpanTimeline, StepLogger,
                              format_breakdown, format_checksum, global_norms,
                              live_memory_stats, make_state_checksum, matmul_param_count,
                              merge_snapshot_dir, moe_active_flops_per_token,
                              peak_flops_per_chip, publish_snapshot, to_openmetrics,
                              train_flops_per_token, tree_checksum, write_merged)
from tpukit_torch.shardings import SingleDevice
from tpukit_torch.train import _debug_nans_scope, create_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LR = 1e-3
NORM_RTOL = 1e-5  # global_norms on the same arrays


def _port_cfg(tk_cfg, **kw):
    return gpt.GPTConfig(dim=tk_cfg.dim, head_dim=tk_cfg.head_dim, heads=tk_cfg.heads,
                         num_layers=tk_cfg.num_layers, vocab_size=tk_cfg.vocab_size,
                         max_position_embeddings=tk_cfg.max_position_embeddings,
                         compute_dtype=torch.float32, **kw)


def _batches(vocab, n, seed=6):
    """`n` (model batch, targets) pairs: token ids with trailing pad."""
    rng, out = np.random.RandomState(seed), []
    for _ in range(n):
        ids = rng.randint(3, vocab, size=(3, 25)).astype(np.int32)
        mask = np.ones_like(ids)
        ids[1, 18:], mask[1, 18:] = 2, 0
        out.append(tk_batching.prepare_batch({"input_ids": ids, "attention_mask": mask}, 2))
    return out


def _port_batch(mb, tgt):
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in mb.items()},
            torch.from_numpy(tgt))


class _Tk:
    """tpukit's f32 train state and its jitted step, with the norms."""

    def __init__(self, cfg, params):
        self.opt = tk_make_optimizer(LR)
        params = jax.tree.map(jnp.copy, params)  # the jitted step donates its state
        self.state = TkTrainState(params=params, opt_state=self.opt.init(params),
                                  step=jnp.int32(0))
        self.fn = make_step_fns(cfg, self.opt, TkSingleDevice(),
                                jax.eval_shape(lambda: self.state), log_grad_norms=True)[0]

    def step(self, mb, tgt):
        self.state, loss, norms = self.fn(self.state, {k: jnp.asarray(v) for k, v in mb.items()},
                                          jnp.asarray(tgt))
        return float(loss), {k: float(v) for k, v in norms.items()}


@pytest.fixture(scope="module")
def stepped(tiny_config, tiny_params):
    """tpukit's state and the port's, each two steps from the same
    parameters on the same batches, with each step's norms."""
    tk = _Tk(tiny_config, tiny_params)
    state = create_train_state(params_from_numpy(jax.tree.map(np.asarray, tiny_params), "cpu"),
                               LR)
    cfg = _port_cfg(tiny_config)
    norms = []
    for mb, tgt in _batches(tiny_config.vocab_size, 2):
        tk_loss, tk_norms = tk.step(mb, tgt)
        loss, got = train_step(state, cfg, SingleDevice(), *_port_batch(mb, tgt),
                               log_grad_norms=True)
        norms.append((tk_norms, {k: float(v) for k, v in got.items()}))
    return tk, state, norms


# ---------------------------------------------------------------- spans ----


def _drive(tl):
    """The same phases through a timeline: step, data, a nested span, sync."""
    with tl.span("step"):
        time.sleep(0.02)
    with tl.span("data"):
        time.sleep(0.01)
    with tl.span("eval"):
        with tl.span("telemetry"):  # nested: the outer span takes it
            time.sleep(0.01)
    with tl.span("sync"):
        time.sleep(0.01)
    time.sleep(0.005)  # outside any span: "other"
    return tl.window()


@pytest.mark.parametrize("make", [SpanTimeline, tk_spans.SpanTimeline],
                         ids=["port", "tpukit"])
def test_spans_sum_to_the_wall_and_nest_as_tpukit(make):
    """A window's seconds sum to its wall, goodput is step + sync, a nested
    span goes to the outer one, and `window()` resets, as tpukit's tests
    hold (`tests/test_obs.py:36-86`); the two modules format one breakdown
    the same way."""
    win = _drive(make())
    assert win["total_s"] >= 0.05
    assert abs(sum(win["seconds"].values()) - win["total_s"]) < 1e-6
    assert abs(sum(win["fractions"].values()) - 1.0) < 1e-6
    assert win["goodput"] == pytest.approx(win["fractions"]["step"] + win["fractions"]["sync"])
    assert "telemetry" not in win["seconds"] and win["seconds"]["eval"] >= 0.009
    assert win["seconds"]["other"] >= 0.004
    assert format_breakdown(win) == tk_spans.format_breakdown(win)
    assert GOODPUT_SPANS == tk_spans.GOODPUT_SPANS
    tl = make()
    with tl.span("step"):
        time.sleep(0.01)
    tl.window()
    with tl.span("data"):
        time.sleep(0.01)
    ep = tl.epoch()  # the epoch spans both windows
    assert ep["seconds"]["step"] >= 0.009 and ep["seconds"]["data"] >= 0.009
    assert tl.window()["seconds"].get("data", 0.0) == 0.0  # epoch() reset the window


# ------------------------------------------------------ recorder, logger ----


def test_flight_recorder_bounds_memory_as_tpukit():
    """The ring keeps the newest `capacity` records and counts all of them;
    a snapshot while another thread records is never torn."""
    rec = FlightRecorder(capacity=16)
    for i in range(100):
        rec.record("step", step=i)
    assert len(rec) == 16 and rec.total_recorded == 100
    assert [r["step"] for r in rec.snapshot()] == list(range(84, 100))
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)
    stop, errors = threading.Event(), []

    def writer():
        i = 0
        while not stop.is_set():
            rec.record("step", step=i)
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(200):
            steps = [r["step"] for r in rec.snapshot()]
            if steps != sorted(steps):
                errors.append(steps)
    finally:
        stop.set()
        t.join()
    assert not errors


def test_step_logger_writes_one_line_a_record(tmp_path):
    """Each record is one whole line on disk before any close; an empty
    path logs nothing; close is idempotent."""
    path = tmp_path / "log.jsonl"
    logger = StepLogger(str(path))
    logger.log(kind="train", step=1, loss=2.5)
    logger.log(kind="train", step=2, loss=2.25)
    lines = path.read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    assert all("time" in json.loads(line) for line in lines)
    logger.close()
    logger.close()
    StepLogger("").log(kind="noop")


# ---------------------------------------------------------------- meter ----

FLOP_CONFIGS = {
    "tiny": dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=97),
    "gpt-small": dict(dim=768, head_dim=64, heads=12, num_layers=12, vocab_size=50257),
    "e8-top1": dict(dim=768, head_dim=64, heads=12, num_layers=12, vocab_size=50257,
                    num_experts=8),
    "e4-top2": dict(dim=64, head_dim=16, heads=4, num_layers=3, vocab_size=206,
                    num_experts=4, router_top_k=2),
}


@pytest.mark.parametrize("name", sorted(FLOP_CONFIGS))
def test_flops_per_token_equal_tpukit_s(name):
    """`matmul_param_count`, `train_flops_per_token` and
    `moe_active_flops_per_token` are tpukit's, exactly, at S 511 and 63."""
    kw = FLOP_CONFIGS[name]
    tk_cfg = TkGPTConfig(**kw, max_position_embeddings=512)
    cfg = gpt.GPTConfig(**kw, max_position_embeddings=512)
    assert matmul_param_count(cfg) == tk_meter.matmul_param_count(tk_cfg)
    for seq in (511, 63):
        assert train_flops_per_token(cfg, seq) == tk_meter.train_flops_per_token(tk_cfg, seq)
        assert moe_active_flops_per_token(cfg, seq) == \
            tk_meter.moe_active_flops_per_token(tk_cfg, seq)


def test_mfu_meter_clock_and_peak():
    """The first update starts the clock and is not counted; rates use the
    time of the last tick; MFU is None without a peak (the CPU) and
    tokens/s x FLOPs/token / (cards x peak) on the H100."""
    cfg = gpt.GPTConfig(**FLOP_CONFIGS["gpt-small"], max_position_embeddings=512)
    assert peak_flops_per_chip(None) is None and peak_flops_per_chip("cpu") is None
    assert peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989.4e12
    meter = MFUMeter(cfg, 511, num_chips=2, peak=989.4e12)
    assert meter.tokens_per_sec is None and meter.mfu is None and not meter.started
    meter.update(10_000)  # starts the clock
    assert meter.started and meter.total_tokens == 0
    time.sleep(0.02)
    for _ in range(3):
        meter.update(32_704)
    assert meter.tokens_per_sec is None  # no tick yet
    meter.tick()
    assert meter.total_tokens == 3 * 32_704 and meter.elapsed >= 0.02
    assert meter.tokens_per_sec == pytest.approx(3 * 32_704 / meter.elapsed)
    assert meter.tokens_per_sec_per_chip == pytest.approx(meter.tokens_per_sec / 2)
    assert meter.mfu == pytest.approx(meter.tokens_per_sec_per_chip
                                      * train_flops_per_token(cfg, 511) / 989.4e12)
    assert MFUMeter(cfg, 511).mfu is None


# -------------------------------------------------------------- metrics ----


def _registry(module_cls, rank: int):
    reg = module_cls()
    reg.inc("train_windows", 2 + rank)
    reg.inc("train_retries", 1, site="ckpt_write")
    reg.gauge("train_goodput", 0.5 + 0.1 * rank)
    for v in (0.001, 0.01 * (rank + 1), 0.3):
        reg.observe("train_span_s", v, phase="step")
    reg.observe("train_window_s", 0.25 + rank)
    return reg


def test_metrics_snapshots_merge_byte_equal_to_tpukit(tmp_path):
    """Per-rank snapshot files written by the port merge, in the port and
    in tpukit, to the same bytes (`metrics-merged.json`, `metrics.prom`);
    tpukit's files merge in the port to those bytes too; a torn file is
    skipped and counted by both."""
    for writer, make, publish in (("port", MetricRegistry, publish_snapshot),
                                  ("tk", tk_metrics.MetricRegistry, tk_metrics.publish_snapshot)):
        d = tmp_path / writer / "snaps"
        for r in (0, 1):
            publish(d, r, _registry(make, r), process_count=2, time_s=float(r))
        (d / "metrics-p00042.json").write_text('{"process": 42, "metr')
    out = {}
    for writer in ("port", "tk"):
        d = tmp_path / writer / "snaps"
        for reader, merge, write in (("port", merge_snapshot_dir, write_merged),
                                     ("tk", tk_metrics.merge_snapshot_dir,
                                      tk_metrics.write_merged)):
            merged, meta = merge(d, 2)
            assert meta == {"files": 3, "skipped": 1, "stale": 0, "merged": 2}
            dest = tmp_path / f"{writer}-{reader}"
            write(dest, merged, meta=meta)
            out[writer, reader] = tuple((dest / name).read_bytes()
                                        for name in ("metrics-merged.json", "metrics.prom"))
    assert len(set(out.values())) == 1
    reg = _registry(MetricRegistry, 0)
    assert to_openmetrics(reg) == tk_metrics.to_openmetrics(_registry(tk_metrics.MetricRegistry,
                                                                      0))
    assert reg.summary() == _registry(tk_metrics.MetricRegistry, 0).summary()


# ------------------------------------------------------------ checksums ----


def test_tree_checksum_is_tpukit_s_bit_for_bit(tiny_params):
    """The u32 of the bridged parameters, and of single leaves of every
    kind tpukit folds (f32, bf16, int32, bool, a scalar, odd lengths), is
    tpukit's."""
    host = jax.tree.map(np.asarray, tiny_params)
    assert int(tree_checksum(params_from_numpy(host, "cpu"))) == \
        int(tk_divergence.tree_checksum(tiny_params))
    rng = np.random.RandomState(3)
    leaves_ = {"a": rng.randn(7, 5).astype(np.float32), "b": np.int32(-5),
               "c": rng.randint(-9, 9, size=(13,)).astype(np.int32),
               "d": rng.rand(3, 3) > 0.5, "e": rng.randn(1).astype(np.float32)}
    tk_tree = jax.tree.map(jnp.asarray, leaves_)
    tk_tree["f"] = jnp.asarray(rng.randn(9), dtype=jnp.bfloat16)
    port_tree = {k: torch.from_numpy(np.array(v)) for k, v in leaves_.items()}
    port_tree["f"] = torch.from_numpy(np.asarray(tk_tree["f"].astype(jnp.float32))).to(
        torch.bfloat16)
    assert int(tree_checksum(port_tree)) == int(tk_divergence.tree_checksum(tk_tree))


def test_state_checksum_of_a_tpukit_checkpoint_is_tpukit_s(stepped, tiny_config, tmp_path):
    """A state restored from tpukit's consolidated checkpoint (two AdamW
    steps: params, count, mu, nu) gives tpukit's `params:opt_state` string;
    one element nudged by an ulp changes its half and only it."""
    tk, _, _ = stepped
    path = tkc.save(tk.state, tmp_path)
    state = create_train_state(gpt.init_params(_port_cfg(tiny_config), seed=3, device="cpu"), LR)
    ckpt.restore_any(path, state)
    fn = make_state_checksum()
    want = tk_divergence.format_checksum(tk_divergence.make_state_checksum()(tk.state))
    assert format_checksum(fn(state)) == want
    assert format_checksum(fn(state)) == want  # idempotent
    p, o = want.split(":")
    q = state.params["layers"]["attn"]["q"]["kernel"]
    with torch.no_grad():
        q[0, 1, 2] = torch.nextafter(q[0, 1, 2], torch.tensor(1e9))
    got_p, got_o = format_checksum(fn(state)).split(":")
    assert got_p != p and got_o == o
    mu = state.optimizer.state[state.params["lm_head"]["kernel"]]["exp_avg"]
    mu[3, 4] += 1e-6
    assert format_checksum(fn(state)).split(":")[1] != o


# ----------------------------------------------------- watchdog, tracer ----


def _wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def test_watchdog_fires_on_a_hung_step_and_its_bundle_renders(tmp_path):
    """Armed and overrun: a bundle within ~the timeout with every thread's
    stack, the ring, the heartbeats, the probes (a raising probe as its
    error) and the flags; `tools/flightview.py` renders it (tpukit
    `tests/test_flightrec.py:101-156`)."""
    rec = FlightRecorder()
    for i in range(5):
        rec.record("step", step=i)
    hb = Heartbeat(tmp_path / "hb", process_index=0, process_count=1)
    hb.beat(4, checksum="aa:bb", checksum_step=4)
    wd = HangWatchdog(tmp_path / "dbg", timeout_s=0.3, recorder=rec, heartbeat=hb,
                      probes={"ok": lambda: {"buffered": 2},
                              "broken": lambda: (_ for _ in ()).throw(RuntimeError("boom"))},
                      config={"hang_timeout": 0.3}, device="cpu")
    try:
        t0 = time.monotonic()
        wd.arm(5)
        assert _wait_for(lambda: wd.dumps, timeout=5.0)
        assert time.monotonic() - t0 < 0.3 * 3 + 1.0
        assert wd.hang_count == 1
    finally:
        wd.close()
    bundle = json.loads(wd.dumps[0].read_text())
    assert bundle["reason"] == "hang" and bundle["step"] == 5 and bundle["stuck_for_s"] >= 0.3
    assert any(n.startswith("MainThread") for n in bundle["stacks"])
    assert any("tpukit-watchdog" in n for n in bundle["stacks"])
    assert [r["step"] for r in bundle["ring"]] == list(range(5))
    assert bundle["heartbeats"]["0"]["checksum"] == "aa:bb"
    assert bundle["inflight"]["ok"] == {"buffered": 2} and "boom" in bundle["inflight"]["broken"]
    assert bundle["config"]["hang_timeout"] == 0.3
    assert bundle["memory"] is None and bundle["process"]["index"] == 0
    from tools import flightview

    assert flightview.main([str(wd.dumps[0])]) == 0
    text = flightview.render(bundle)
    for needle in ("hang", "MainThread", "flight recorder", "heartbeats"):
        assert needle in text


def test_watchdog_rearms_after_disarm_and_keeps_its_dump_budget(tmp_path):
    """A disarm before the deadline dumps nothing, a healthy cadence of
    re-arms never fires, and an arm after a disarm fires again;
    `trigger()` dumps at once and shares the `max_dumps` budget (tpukit
    `tests/test_flightrec.py:159-202`)."""
    wd = HangWatchdog(tmp_path / "dbg", timeout_s=0.25)
    try:
        wd.arm(1)
        wd.disarm()
        time.sleep(0.5)
        assert not wd.dumps
        for step in range(8):
            wd.arm(step)
            time.sleep(0.05)
        wd.disarm()
        assert not wd.dumps and wd.hang_count == 0
        wd.arm(9)
        assert _wait_for(lambda: wd.hang_count == 1, timeout=5.0)
        assert wd.hang_events == [{"step": 9, "bundle": str(wd.dumps[0])}]
    finally:
        wd.close()
    wd = HangWatchdog(tmp_path / "dbg2", timeout_s=0.0, recorder=FlightRecorder(), max_dumps=2)
    try:
        p1 = wd.trigger("spike", step=10, loss=9.5)
        p2 = wd.trigger("divergence", step=11)
        assert p1 is not None and p2 is not None
        assert wd.trigger("spike", step=12) is None
        assert len(wd.dumps) == 2 and wd._thread is None
        assert json.loads(p1.read_text())["loss"] == 9.5
    finally:
        wd.close()
    with pytest.raises(ValueError, match="timeout"):
        HangWatchdog(tmp_path / "dbg3", timeout_s=-1)


def test_anomaly_tracer_arms_once_and_writes_a_trace(tmp_path):
    """idle -> armed -> tracing -> done after K steps, one trace a run; the
    Chrome trace holds the profiled ops (tpukit
    `tests/test_flightrec.py:205-228`)."""
    tr = AnomalyTracer(tmp_path / "tr", steps=2)
    assert not tr.maybe_start()
    assert tr.trigger("spike") is True and tr.trigger("nan") is False
    assert tr.reason == "spike"
    assert tr.maybe_start() is True and tr.tracing and tr.maybe_start() is False
    torch.ones(4).add(1)
    assert tr.step() is False
    assert tr.step() is True
    assert tr.done and not tr.tracing
    assert tr.trigger("spike") is False and not tr.maybe_start()
    trace = json.loads(tr.path.read_text())
    assert any(ev.get("name") == "aten::add" for ev in trace["traceEvents"])
    with pytest.raises(ValueError, match="step count"):
        AnomalyTracer(tmp_path, steps=0)


# ---------------------------------------------------------------- norms ----


def test_global_norms_equal_tpukit_s_on_the_same_arrays(tiny_params, tiny_config):
    """grad, update and param norms of the same trees within rtol 1e-5 of
    tpukit's `global_norms` (optax's `global_norm`)."""
    from tpukit.obs.sentinels import global_norms as tk_global_norms

    rng = np.random.RandomState(0)
    host = jax.tree.map(np.asarray, tiny_params)
    grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * 1e-2).astype(np.float32), host)
    updates = jax.tree.map(lambda x: (rng.randn(*x.shape) * 1e-4).astype(np.float32), host)
    want = tk_global_norms(*(jax.tree.map(jnp.asarray, t) for t in (grads, updates, host)))
    got = global_norms(*(params_from_numpy(t, "cpu") for t in (grads, updates, host)))
    assert set(got) == set(want) == {"grad_norm", "update_norm", "param_norm"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=NORM_RTOL, err_msg=k)
        assert got[k].dtype == torch.float32 and got[k].dim() == 0


def test_train_step_norms_track_tpukit_s_step(stepped):
    """The step's norms beside tpukit's jitted step's on the same batches:
    the gradient and the post-update parameters at the fit bar (rtol 1e-4),
    the update (a difference of two parameter copies) at rtol 1e-3; without
    the flag the step returns the loss alone."""
    _, state, norms = stepped
    for tk_norms, got in norms:
        assert set(got) == set(tk_norms)
        np.testing.assert_allclose(got["grad_norm"], tk_norms["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["param_norm"], tk_norms["param_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["update_norm"], tk_norms["update_norm"], rtol=1e-3)


# ------------------------------------------------------- memory, nans ----


def test_memory_stats_are_none_on_the_cpu():
    assert live_memory_stats("cpu") is None and live_memory_stats(None) is None


def test_debug_nans_scope_raises_and_restores():
    """In the scope a NaN out of a forward op or a backward function raises
    `FloatingPointError` (an Inf does not, as `jax_debug_nans`); outside
    it, and after it, nothing is checked (tpukit
    `tests/test_train.py:276-298`)."""
    assert not torch.is_anomaly_enabled()
    with _debug_nans_scope():
        assert torch.is_anomaly_enabled()
        assert torch.log(torch.tensor(0.0)).item() == -float("inf")
        torch.empty(4)  # uninitialized memory is not an op's result
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.tensor(-1.0))
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    x = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(FloatingPointError, match="returned nan"), _debug_nans_scope():
        # a finite forward whose backward is 0 x inf: sqrt's at 0, masked
        y = torch.where(x > 0, torch.sqrt(x), torch.zeros_like(x))
        y.sum().backward()
    assert not torch.is_anomaly_enabled()
    assert torch.overrides._get_current_function_mode_stack() == []


# ------------------------------------------------------ loader row counts ----


def _datasets(n, seq=8):
    ids = np.arange(n * seq, dtype=np.int32).reshape(n, seq) % 97 + 3
    return ArrayDataset(ids, np.ones_like(ids)), TkArrayDataset(ids, np.ones_like(ids))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("n,reps,bs", [(253, 2, 32), (64, 1, 16), (100, 3, 8), (7, 4, 4),
                                       (5, 2, 8)])
def test_global_real_row_counts_equal_tpukit_s(n, reps, bs, drop_last):
    """The meter's per-step global rows: tpukit's closed form, and what the
    ranks' loaders yield summed."""
    ds, tk_ds = _datasets(n)
    kw = dict(shuffle=True, seed=7, num_replicas=reps, drop_last=drop_last, pad_to_batch=True)
    ours = [DataLoader(ds, bs, rank=r, **kw) for r in range(reps)]
    want = TkDataLoader(tk_ds, bs, rank=0, **kw).global_real_row_counts()
    np.testing.assert_array_equal(ours[0].global_real_row_counts(), want)
    yielded = sum(np.array([b["real_rows"] for b in ld], dtype=np.int64) for ld in ours)
    np.testing.assert_array_equal(yielded, want)


# ------------------------------------------------ deferred-rollback files ----


@pytest.mark.parametrize("writer", ["tpukit", "port"])
def test_abort_and_final_drain_files_cross_read(tmp_path, writer):
    """`publish_abort` and the final-drain marker are tpukit's files: the
    other package reads the abort record and finds the marker; a rank
    waiting for a missing marker times out with tpukit's error."""
    mods = {"tpukit": tk_recovery, "port": recovery}
    w = mods[writer].RollbackCoordinator(tmp_path, process_index=0, process_count=2,
                                         timeout_s=0.2)
    r = mods["port" if writer == "tpukit" else "tpukit"].RollbackCoordinator(
        tmp_path, process_index=1, process_count=2, timeout_s=0.2)
    with pytest.raises(Exception, match="final-drain marker"):
        r.wait_final_drain()
    w.publish_abort(1, "divergence", 16, execute_after=24)
    assert r.read(1) == {"seq": 1, "action": "abort", "reason": "divergence",
                         "anomaly_step": 16, "execute_after": 24}
    w.publish_final_drain(24)
    r.wait_final_drain()
    assert json.loads((tmp_path / "rollback-final-drain.json").read_text()) == {"step": 24}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rollback-0001.json",
                                                          "rollback-final-drain.json"]
