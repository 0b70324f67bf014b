"""The bench's serving records (twins of tpukit's `bench.py` :467-1324) and
the induction trainer the speculation record serves (`_induction_train`,
tpukit :1144).

Every record serves tpukit's seeded synthetic stream through the port's
`ServeEngine` (or its `FleetRouter`) on one card: the fixture tokenizer
with `pad_token_id` 2, `cfg` with the tokenizer's vocabulary (and the
record's compute dtype), and `ServeConfig(window_steps=10**9)`, so no
window record is written. `params`, where a record takes it, is a numpy
tree (tpukit's `init_params`, fetched) that goes through
`bridge.params_from_numpy`; without it the record draws its own on
`device` (`model.init_params(seed=0)`). Each side of a comparison runs a
warm pass first (the kernels' build and load, the allocator), then the
measured pass, as tpukit's compile-absorbing warm passes do. Walls are
host clocks around a run that ends in host reads of its tokens, so the
card has finished. The record keys are tpukit's, in its order
(`RECORD_KEYS`).
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

# tpukit's record keys, in its order (bench.py :594-709, :780-996,
# :1060-1138, :1300-1320); `rungs` rows and nested records in ROW_KEYS
RECORD_KEYS = {
    "serving": ["requests", "slots", "buckets", "max_new_tokens", "generated_tokens",
                "decode_quantum", "continuous", "serial", "serial_cached", "speedup",
                "speedup_vs_cached"],
    "serve_trace_overhead": ["requests", "slots", "max_new_tokens", "tokens_per_sec_off",
                             "tokens_per_sec_on", "overhead_frac", "tokens_bit_identical",
                             "events_emitted", "events_dropped"],
    "metrics_overhead": ["requests", "slots", "max_new_tokens", "tokens_per_sec_off",
                         "tokens_per_sec_on", "overhead_frac", "tokens_bit_identical",
                         "series", "snapshot_publish_s"],
    "serve_dispatch_attribution": ["requests", "slots", "max_new_tokens", "decode_quantum",
                                   "quanta", "wall_s", "dispatch_overhead_s", "device_s",
                                   "dispatch_frac", "mean_dispatch_ms_per_quantum",
                                   "mean_device_ms_per_quantum",
                                   "summary_dispatch_overhead_s", "summary_device_s",
                                   "trace_complete", "completed"],
    "decode_fused": ["requests", "slots", "max_new_tokens", "page_size", "window_quanta",
                     "unfused_q1", "fused_q1", "fused_loop", "parity_ok", "kernel_speedup",
                     "amortization_speedup"],
    "paged_kv": ["requests", "buckets", "page_size", "max_new_tokens", "ring", "paged",
                 "paged_int8", "parity_ok", "int8_token_agreement",
                 "slots_at_equal_hbm_ratio", "prefix"],
    "fleet_serving": ["requests", "slots_per_replica", "buckets", "max_new_tokens",
                      "total_devices", "meshed", "rungs", "parity_ok", "scaling_2x_vs_1",
                      "disagg_prefill", "caveat"],
    "spec_decode": ["requests", "slots", "spec_k", "max_new_tokens", "buckets",
                    "stream_profile", "train", "t0", "t0.8", "speedup_ngram_t0"],
}
ROW_KEYS = {
    "serving.continuous": ["tokens_per_sec", "wall_s", "generated_tokens", "p50_e2e_s",
                           "p99_e2e_s", "p50_token_s", "p99_token_s", "mean_occupancy",
                           "prefill_s", "decode_s"],
    "serving.serial": ["tokens_per_sec", "wall_s", "generated_tokens", "p50_e2e_s",
                       "p99_e2e_s"],
    "decode_fused.rung": ["tokens_per_sec", "wall_s", "generated_tokens", "quanta",
                          "decode_steps", "mean_dispatch_ms_per_quantum",
                          "mean_device_ms_per_quantum", "trace_complete"],
    "paged_kv.rung": ["tokens_per_sec", "wall_s", "generated_tokens", "slots",
                      "max_live_slots", "kv_bytes"],
    "paged_kv.prefix": ["hits", "hit_rate", "pages_reused", "admit_latency_hit_s",
                        "admit_latency_cold_s"],
    "fleet_serving.rung": ["replicas", "devices_per_replica", "tokens_per_sec", "wall_s",
                           "generated_tokens", "p50_e2e_s", "p99_e2e_s",
                           "mean_admit_latency_s"],
    "fleet_serving.disagg_prefill": ["colocated_admit_latency_s", "disagg_admit_latency_s",
                                     "colocated_tokens_per_sec", "disagg_tokens_per_sec",
                                     "handoffs", "worker_prefix_hits"],
    "spec_decode.train": ["target_loss", "draft_loss", "train_s"],
    "spec_decode.vanilla": ["tokens_per_sec", "wall_s", "wall_spread_s", "generated_tokens",
                            "verify_steps"],
    "spec_decode.draft": ["tokens_per_sec", "wall_s", "wall_spread_s", "generated_tokens",
                          "verify_steps", "accept_rate", "proposed", "accepted",
                          "accepted_hist", "draft_s", "verify_s", "speedup"],
}
# where each record nests ROW_KEYS' rows: key -> row (a list: every row)
NESTED = {
    "serving": {"continuous": "serving.continuous", "serial": "serving.serial",
                "serial_cached": "serving.serial"},
    "paged_kv": {"ring": "paged_kv.rung", "paged": "paged_kv.rung",
                 "paged_int8": "paged_kv.rung", "prefix": "paged_kv.prefix"},
    "decode_fused": {"unfused_q1": "decode_fused.rung", "fused_q1": "decode_fused.rung",
                     "fused_loop": "decode_fused.rung"},
    "fleet_serving": {"rungs": "fleet_serving.rung",
                      "disagg_prefill": "fleet_serving.disagg_prefill"},
    "spec_decode": {"train": "spec_decode.train"},
}
SPEC_TRAIN_STEPS = (900, 1500)  # the target's and the draft's (tpukit :1236, :1239)
MAX_WALL_S = 900


def key_mismatches(name: str, rec: dict) -> list:
    """Where `rec`, the `name` record, departs from tpukit's key lists
    (`RECORD_KEYS`, its rows' `ROW_KEYS`): a list of (where, keys found)."""
    bad = [] if list(rec) == RECORD_KEYS[name] else [(name, list(rec))]
    rows = [(f"{name}.{k}", rec.get(k), want) for k, want in NESTED.get(name, {}).items()]
    if name == "spec_decode":
        for t in ("t0", "t0.8"):
            rung = rec.get(t) or {}
            if list(rung) != ["vanilla", "ngram", "model"]:
                bad.append((f"{name}.{t}", list(rung)))
            rows += [(f"{name}.{t}.{d}", rung.get(d),
                      "spec_decode.vanilla" if d == "vanilla" else "spec_decode.draft")
                     for d in ("vanilla", "ngram", "model")]
    for where, row, want in rows:
        if name == "fleet_serving" and want == "fleet_serving.rung":
            bad += [(f"{where}[{i}]", list(r)) for i, r in enumerate(row or [])
                    if "error" not in r and list(r) != ROW_KEYS[want]]
        elif name == "fleet_serving" and isinstance(row, dict) and "error" in row:
            continue  # the disaggregated half's failure, landed as tpukit's
        elif not isinstance(row, dict) or list(row) != ROW_KEYS[want]:
            bad.append((where, list(row) if isinstance(row, dict) else row))
    return bad


class _Setup:
    """One record's tokenizer, model config, parameters, EOS id and
    stream, as each of tpukit's records builds them."""

    def __init__(self, cfg, requests, max_new, buckets, lengths=None, compute_dtype=None,
                 params=None, device=None, **stream_kw):
        from tpukit_torch import resolve_device
        from tpukit_torch.bridge import params_from_numpy
        from tpukit_torch.data import get_tokenizer
        from tpukit_torch.model import init_params
        from tpukit_torch.serve import synthetic_request_stream

        self.device = resolve_device(device)
        self.tokenizer = get_tokenizer()
        self.tokenizer.pad_token_id = 2
        kw = {"vocab_size": self.tokenizer.vocab_size}
        if compute_dtype is not None:
            kw["compute_dtype"] = compute_dtype
        self.cfg = cfg.replace(**kw)
        self.params = (params_from_numpy(params, self.device) if params is not None
                       else init_params(self.cfg, seed=0, device=self.device))
        self.eos = int(self.tokenizer.eos_token_id)
        self.stream = synthetic_request_stream(
            self.tokenizer, requests, seed=0, max_new_tokens=max_new, buckets=buckets,
            lengths=lengths, **stream_kw)

    def engine(self, serve, **kw):
        from tpukit_torch.serve import ServeEngine

        return ServeEngine(self.params, self.cfg, serve, eos_id=self.eos, device=self.device,
                           **kw)


def _timed_run(eng, stream):
    t0 = time.perf_counter()
    comps = eng.run(list(stream), max_wall_s=MAX_WALL_S)
    return comps, time.perf_counter() - t0


def _tokens(comps) -> dict:
    return {c.rid: [int(x) for x in np.asarray(c.ids)] for c in comps}


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values), q))


def _ring_setup(cfg, requests, slots, max_new, params, device):
    from tpukit_torch.serve import ServeConfig

    buckets = lengths = (8, 16, 24, 32)
    s = _Setup(cfg, requests, max_new, buckets, lengths, params=params, device=device)
    return s, ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                          window_steps=10**9)


def bench_serving(cfg, n_dev, requests=32, slots=8, max_new=16, params=None,
                  device=None) -> dict:
    """Continuous batching against serial per-request decoding on the same
    seeded stream (tpukit :467). The engine admits into `slots` ring lanes
    mid-decode; `serial` decodes one request at a time through
    `sampling._decode_loop` (each step forwards the whole buffer), and
    `serial_cached` through `_decode_loop_cached` (one token a step against
    a KV cache). Each side runs twice and reports the second run; `speedup`
    is continuous over serial, `speedup_vs_cached` over serial_cached."""
    from tpukit_torch.sampling import _decode_loop, _decode_loop_cached

    s, serve = _ring_setup(cfg, requests, slots, max_new, params, device)

    def run_continuous():
        eng = s.engine(serve)
        comps, wall = _timed_run(eng, s.stream)
        gen = sum(c.generated for c in comps)
        summ = eng.last_summary
        return dict(
            tokens_per_sec=round(gen / wall, 1), wall_s=round(wall, 3),
            generated_tokens=gen,
            p50_e2e_s=round(_pct([c.e2e_s for c in comps], 50), 4),
            p99_e2e_s=round(_pct([c.e2e_s for c in comps], 99), 4),
            p50_token_s=round(_pct([c.per_token_s for c in comps], 50), 5),
            p99_token_s=round(_pct([c.per_token_s for c in comps], 99), 5),
            mean_occupancy=round(summ["mean_occupancy"], 3),
            prefill_s=round(summ["prefill_s"], 3),
            decode_s=round(summ["decode_s"], 3),
        )

    def run_serial(decode_fn):
        t0 = time.perf_counter()
        gen, finish = 0, []
        for r in s.stream:
            buf = torch.zeros((1, len(r.ids) + max_new), dtype=torch.int32, device=s.device)
            buf[0, :len(r.ids)] = torch.tensor(r.ids, dtype=torch.int32)
            _, length = decode_fn(s.params, s.cfg, buf, len(r.ids), s.eos)
            gen += int(length) - len(r.ids)
            finish.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        return dict(
            tokens_per_sec=round(gen / wall, 1), wall_s=round(wall, 3),
            generated_tokens=gen,
            p50_e2e_s=round(_pct(finish, 50), 4),
            p99_e2e_s=round(_pct(finish, 99), 4),
        )

    run_continuous()
    cont = run_continuous()
    run_serial(_decode_loop)
    ser = run_serial(_decode_loop)
    run_serial(_decode_loop_cached)
    ser_cached = run_serial(_decode_loop_cached)
    return {
        "requests": requests, "slots": slots, "buckets": list(serve.buckets),
        "max_new_tokens": max_new,
        "generated_tokens": cont["generated_tokens"],
        "decode_quantum": serve.decode_quantum,
        "continuous": cont, "serial": ser, "serial_cached": ser_cached,
        "speedup": (round(cont["tokens_per_sec"] / ser["tokens_per_sec"], 2)
                    if ser["tokens_per_sec"] else None),
        "speedup_vs_cached": (round(cont["tokens_per_sec"] / ser_cached["tokens_per_sec"], 2)
                              if ser_cached["tokens_per_sec"] else None),
    }


def _overhead(tps_off, tps_on):
    return round((tps_off - tps_on) / tps_off, 4) if tps_off else None


def bench_serve_trace_overhead(cfg, n_dev, requests=32, slots=8, max_new=16, params=None,
                               device=None) -> dict:
    """The request tracer's cost on the engine (tpukit :580): the same
    stream served with the tracer off, then on, after a warm pass; the
    tokens must be the same bits (the tracer observes, it never
    schedules). `obs_overhead["serving"]` of the bench's line."""
    from tpukit_torch.obs import TraceRecorder

    s, serve = _ring_setup(cfg, requests, slots, max_new, params, device)

    def run(traced: bool):
        tracer = TraceRecorder() if traced else None
        comps, wall = _timed_run(s.engine(serve, tracer=tracer), s.stream)
        return sum(c.generated for c in comps) / wall, _tokens(comps), tracer

    run(False)
    tps_off, toks_off, _ = run(False)
    tps_on, toks_on, tracer = run(True)
    return {
        "requests": requests, "slots": slots, "max_new_tokens": max_new,
        "tokens_per_sec_off": round(tps_off, 1),
        "tokens_per_sec_on": round(tps_on, 1),
        "overhead_frac": _overhead(tps_off, tps_on),
        "tokens_bit_identical": toks_off == toks_on,
        "events_emitted": tracer.total_emitted,
        "events_dropped": tracer.dropped,
    }


def bench_metrics_overhead(cfg, n_dev, requests=32, slots=8, max_new=16, params=None,
                           device=None) -> dict:
    """The metrics plane's cost on the engine (tpukit :635): registry off,
    then on, after a warm pass, with the same bits out; the snapshot's
    publish and merge into a temporary directory timed apart."""
    from tpukit_torch.obs import MetricRegistry, merge_snapshot_dir, publish_snapshot

    s, serve = _ring_setup(cfg, requests, slots, max_new, params, device)

    def run(with_metrics: bool):
        metrics = MetricRegistry() if with_metrics else None
        comps, wall = _timed_run(s.engine(serve, metrics=metrics), s.stream)
        return sum(c.generated for c in comps) / wall, _tokens(comps), metrics

    run(False)
    tps_off, toks_off, _ = run(False)
    tps_on, toks_on, metrics = run(True)
    snap = metrics.snapshot()
    series = len(snap["counters"]) + len(snap["gauges"]) + len(snap["hists"])
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        publish_snapshot(d, 0, metrics, time_s=time.time())
        merge_snapshot_dir(d)
        publish_s = time.perf_counter() - t0
    return {
        "requests": requests, "slots": slots, "max_new_tokens": max_new,
        "tokens_per_sec_off": round(tps_off, 1),
        "tokens_per_sec_on": round(tps_on, 1),
        "overhead_frac": _overhead(tps_off, tps_on),
        "tokens_bit_identical": toks_off == toks_on,
        "series": series,
        "snapshot_publish_s": round(publish_s, 6),
    }


def _quantum_walls(tracer) -> tuple[list, float, float]:
    """The trace's quantum events, their dispatch walls [t0, t1] and their
    sync walls [s0, s1], summed."""
    quanta = [e for e in tracer.snapshot() if e.get("ev") == "quantum"]
    disp = sum(q["t1"] - q["t0"] for q in quanta)
    dev = sum(q["s1"] - q["s0"] for q in quanta if "s1" in q)
    return quanta, disp, dev


def _per_quantum_ms(total, quanta):
    return round(1e3 * total / len(quanta), 3) if quanta else None


def bench_serve_dispatch_attribution(cfg, n_dev, requests=32, slots=8, max_new=16,
                                     params=None, device=None) -> dict:
    """Where a decode quantum's wall goes on a traced run (tpukit :701): the
    quantum events' dispatch walls (`dispatch_overhead_s`) against their
    sync walls (`device_s`), the summary's span-derived split beside them,
    and the trace's completeness. The port's ring quantum is eager torch:
    its dispatch wall holds the host's launches, its sync wall the wait for
    the card."""
    from tpukit_torch.obs import TraceRecorder, build_trees, completeness

    s, serve = _ring_setup(cfg, requests, slots, max_new, params, device)

    def run():
        tracer = TraceRecorder()
        eng = s.engine(serve, tracer=tracer)
        comps, wall = _timed_run(eng, s.stream)
        return eng, tracer, comps, wall

    run()
    eng, tracer, comps, wall = run()
    summ = eng.last_summary or {}
    quanta, disp, dev = _quantum_walls(tracer)
    tot = disp + dev
    return {
        "requests": requests, "slots": slots, "max_new_tokens": max_new,
        "decode_quantum": serve.decode_quantum,
        "quanta": len(quanta),
        "wall_s": round(wall, 3),
        "dispatch_overhead_s": round(disp, 4),
        "device_s": round(dev, 4),
        "dispatch_frac": round(disp / tot, 4) if tot else None,
        "mean_dispatch_ms_per_quantum": _per_quantum_ms(disp, quanta),
        "mean_device_ms_per_quantum": _per_quantum_ms(dev, quanta),
        "summary_dispatch_overhead_s": round(summ.get("dispatch_overhead_s", 0.0), 4),
        "summary_device_s": round(summ.get("device_s", 0.0), 4),
        "trace_complete": completeness(build_trees(tracer.snapshot())),
        "completed": len(comps),
    }


def bench_decode_fused(cfg, n_dev, requests=24, slots=4, max_new=12, window=8, params=None,
                       device=None) -> dict:
    """The fused-decode ladder at f32 with pages of 8 (tpukit :770):
    `unfused_q1` (each tick attends over the gathered page view in plain
    torch, tpukit's XLA path) against `fused_q1` (each tick runs the paged
    kernels once a layer) at one tick a quantum is `kernel_speedup`;
    `fused_loop` (`decode_quantum=window` through `decode_loop_window`)
    against `fused_q1` is `amortization_speedup`. `parity_ok`: the three
    rungs' tokens are equal, request for request.

    The port's window is not tpukit's on-device loop: `decode_loop_window`
    reads the lanes' `active` flags on the host after every tick
    (`serve/decode.py`; tpukit runs the window as one `lax.while_loop`,
    ROADMAP A11), so `amortization_speedup` measures what the host-read
    window saves over one dispatch a tick, not an on-device window."""
    from tpukit_torch.obs import TraceRecorder, build_trees, completeness
    from tpukit_torch.serve import ServeConfig

    buckets = lengths = (8, 16)
    page = 8
    s = _Setup(cfg, requests, max_new, buckets, lengths, compute_dtype=torch.float32,
               params=params, device=device)
    pages = slots * (-(-(max(buckets) + max_new) // page)) + 1

    def run(fused, quantum):
        serve = ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                            window_steps=10**9, page_size=page, num_pages=pages,
                            fused_decode=fused, decode_quantum=quantum)
        s.engine(serve).run(list(s.stream), max_wall_s=MAX_WALL_S)
        tracer = TraceRecorder()
        eng = s.engine(serve, tracer=tracer)
        comps, wall = _timed_run(eng, s.stream)
        gen = sum(c.generated for c in comps)
        quanta, disp, dev = _quantum_walls(tracer)
        rec = {
            "tokens_per_sec": round(gen / wall, 1),
            "wall_s": round(wall, 3),
            "generated_tokens": gen,
            "quanta": len(quanta),
            "decode_steps": eng.steps,
            "mean_dispatch_ms_per_quantum": _per_quantum_ms(disp, quanta),
            "mean_device_ms_per_quantum": _per_quantum_ms(dev, quanta),
            "trace_complete": completeness(build_trees(tracer.snapshot())),
        }
        return rec, _tokens(comps)

    unfused, toks_u = run(False, 1)
    fused_q1, toks_f1 = run(True, 1)
    fused_loop, toks_fl = run(True, window)
    return {
        "requests": requests, "slots": slots, "max_new_tokens": max_new,
        "page_size": page, "window_quanta": window,
        "unfused_q1": unfused, "fused_q1": fused_q1, "fused_loop": fused_loop,
        "parity_ok": bool(toks_u == toks_f1 == toks_fl),
        "kernel_speedup": (round(fused_q1["tokens_per_sec"] / unfused["tokens_per_sec"], 3)
                           if unfused["tokens_per_sec"] else None),
        "amortization_speedup": (
            round(fused_loop["tokens_per_sec"] / fused_q1["tokens_per_sec"], 3)
            if fused_q1["tokens_per_sec"] else None),
    }


def bench_paged_kv(cfg, n_dev, requests=24, max_new=12, slots=4, params=None,
                   device=None) -> dict:
    """Ring against paged against paged int8 at equal KV bytes, f32 (tpukit
    :875): the paged pool is sized to the ring's `kv_bytes` through
    `paged.pool_bytes`, its tokens must be the ring's (`parity_ok`); int8
    pages fit about 4x the pages in the same bytes, so the int8 rung gets
    4x the slots, `max_live_slots` counts how many decoded at once, and
    `int8_token_agreement` is its tokens' mean match with the f32 pages'.
    The `prefix` block re-serves the paged config on a stream whose
    requests share one system prompt of a page."""
    from tpukit_torch.serve import ServeConfig, synthetic_request_stream
    from tpukit_torch.serve import paged as paged_lib

    buckets = lengths = (8, 16)
    page = 8
    s = _Setup(cfg, requests, max_new, buckets, lengths, compute_dtype=torch.float32,
               params=params, device=device)

    def run(serve, reqs):
        s.engine(serve).run(list(reqs), max_wall_s=MAX_WALL_S)
        eng = s.engine(serve)
        comps, wall = _timed_run(eng, reqs)
        gen = sum(c.generated for c in comps)
        summ = eng.last_summary
        rec = dict(tokens_per_sec=round(gen / wall, 1), wall_s=round(wall, 3),
                   generated_tokens=gen, slots=serve.slots,
                   max_live_slots=summ["max_live_slots"], kv_bytes=summ["kv_bytes"])
        return rec, _tokens(comps), summ

    ring, ring_toks, _ = run(ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                                         window_steps=10**9), s.stream)
    per_page_f32 = paged_lib.pool_bytes(s.cfg, 1, page, "f32")
    per_page_int8 = paged_lib.pool_bytes(s.cfg, 1, page, "int8")
    min_pages = -(-(max(buckets) + max_new) // page) + 1  # one request and the null page
    paged_cfg = ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                            window_steps=10**9, page_size=page,
                            num_pages=max(ring["kv_bytes"] // per_page_f32, min_pages))
    paged, paged_toks, _ = run(paged_cfg, s.stream)
    int8_cfg = ServeConfig(slots=4 * slots, buckets=buckets, max_new_tokens=max_new,
                           window_steps=10**9, page_size=page, kv_dtype="int8",
                           num_pages=max(ring["kv_bytes"] // per_page_int8, min_pages))
    int8, int8_toks, _ = run(int8_cfg, s.stream)
    agree = [float(np.mean(np.asarray(int8_toks[r][:m]) == np.asarray(paged_toks[r][:m])))
             for r in paged_toks
             for m in [min(len(int8_toks[r]), len(paged_toks[r]))] if m]
    shared = synthetic_request_stream(s.tokenizer, requests, seed=0, max_new_tokens=max_new,
                                      buckets=buckets, lengths=lengths, shared_prefix=page)
    _, _, psum = run(paged_cfg, shared)
    return {
        "requests": requests, "buckets": list(buckets), "page_size": page,
        "max_new_tokens": max_new,
        "ring": ring, "paged": paged, "paged_int8": int8,
        "parity_ok": bool(ring_toks == paged_toks),
        "int8_token_agreement": round(float(np.mean(agree)), 4) if agree else None,
        "slots_at_equal_hbm_ratio": round(int8["max_live_slots"]
                                          / max(ring["max_live_slots"], 1), 2),
        "prefix": {
            "hits": psum.get("prefix_hits"),
            "hit_rate": psum.get("prefix_hit_rate"),
            "pages_reused": psum.get("prefix_pages_reused"),
            "admit_latency_hit_s": psum.get("admit_latency_hit_s"),
            "admit_latency_cold_s": psum.get("admit_latency_cold_s"),
        },
    }


def bench_fleet_serving(cfg, n_dev, requests=32, slots=4, max_new=12, params=None,
                        device=None) -> dict:
    """Fleet scaling (tpukit :996): 1, 2 and 4 replicas behind
    `FleetRouter` on the same stream at f32, each rung's tokens held
    against the 1-replica rung's (`parity_ok`), `scaling_2x_vs_1`, then
    colocated against disaggregated prefill at 2 paged replicas over a
    shared-system-prompt stream (admit latency, handoffs).

    With fewer than 4 cards (`n_dev`, the world) the replicas are meshless,
    every one on `device`. At 4 cards and up each replica takes `n_dev //
    replicas` devices, tpukit's rule (`bench.py:1052-1056`): a replica of
    one card is an engine on `cuda:i` in this process, a replica of more a
    grid over its cards, a world of rank processes of its own
    (`serve/replica_world.py`); the disaggregated half's 2 replicas take
    `n_dev // 2` each, and its prefill worker, with no card to spare, runs
    on `device`. A rung of in-process replicas is timed after a warm-up
    run of its own router, as tpukit's; a grid rung's worlds are fresh
    processes in every router, so it has no warm-up run: its clock starts
    once every world has started (`FleetRouter.ready`; each rank has set up
    its groups' communicators), and its ranks' first calls fall inside it."""
    from tpukit_torch import resolve_device
    from tpukit_torch.serve import (FleetConfig, FleetRouter, ServeConfig,
                                    synthetic_request_stream)

    buckets = lengths = (8, 16)
    s = _Setup(cfg, requests, max_new, buckets, lengths, compute_dtype=torch.float32,
               params=params, device="cpu")
    host = s.params  # the one host copy the router places on each replica's device
    device = resolve_device(device)
    serve = ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                        window_steps=10**9)
    meshed = n_dev >= 4

    def run_fleet(n_replicas, fleet_kw=None, serve_cfg=None, reqs=None):
        fc = FleetConfig(replicas=n_replicas,
                         devices_per_replica=(n_dev // n_replicas) if meshed else 0,
                         window_steps=10**9, **(fleet_kw or {}))
        sv = serve_cfg or serve
        stream = reqs or s.stream
        if fc.devices_per_replica <= 1:  # a grid's worlds are new processes each router
            FleetRouter(host, s.cfg, sv, fc, eos_id=s.eos, device=device).run(
                list(stream), max_wall_s=MAX_WALL_S)
        router = FleetRouter(host, s.cfg, sv, fc, eos_id=s.eos, device=device)
        router.ready()  # the worlds' start is set-up, as the warm-up run is
        comps, wall = _timed_run(router, stream)
        gen = sum(c.generated for c in comps)
        return dict(
            replicas=n_replicas,
            devices_per_replica=fc.devices_per_replica,
            tokens_per_sec=round(gen / wall, 1), wall_s=round(wall, 3),
            generated_tokens=gen,
            p50_e2e_s=round(_pct([c.e2e_s for c in comps], 50), 4),
            p99_e2e_s=round(_pct([c.e2e_s for c in comps], 99), 4),
            mean_admit_latency_s=round(float(np.mean([c.admit_latency_s for c in comps])), 5),
        ), _tokens(comps), router.last_summary

    rungs, toks = [], {}
    for n_replicas in (1, 2, 4):
        if n_replicas > max(requests, 1):
            continue
        try:
            rec, t, _ = run_fleet(n_replicas)
            rungs.append(rec)
            toks[n_replicas] = t
        except Exception as exc:  # a rung's failure lands in its row, as tpukit's
            rungs.append({"replicas": n_replicas, "error": repr(exc)})
    parity = (1 in toks) and all(toks[n] == toks[1] for n in toks)
    by_n = {r["replicas"]: r for r in rungs if "error" not in r}
    scaling = (round(by_n[2]["tokens_per_sec"] / by_n[1]["tokens_per_sec"], 2)
               if 1 in by_n and 2 in by_n and by_n[1]["tokens_per_sec"] else None)

    try:
        page = 8
        paged_cfg = ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                                window_steps=10**9, page_size=page)
        shared = synthetic_request_stream(s.tokenizer, requests, seed=0,
                                          max_new_tokens=max_new, buckets=buckets,
                                          lengths=lengths, shared_prefix=page)
        colo, _, _ = run_fleet(2, serve_cfg=paged_cfg, reqs=shared)
        dis, _, dsum = run_fleet(2, fleet_kw=dict(disagg_prefill=True), serve_cfg=paged_cfg,
                                 reqs=shared)
        dp = (dsum or {}).get("disagg_prefill") or {}
        disagg = dict(
            colocated_admit_latency_s=colo["mean_admit_latency_s"],
            disagg_admit_latency_s=dis["mean_admit_latency_s"],
            colocated_tokens_per_sec=colo["tokens_per_sec"],
            disagg_tokens_per_sec=dis["tokens_per_sec"],
            handoffs=dp.get("handoffs"),
            worker_prefix_hits=dp.get("worker_prefix_hits"),
        )
    except Exception as exc:
        disagg = {"error": repr(exc)}

    where = (f"{n_dev} cards: a replica takes n_dev // replicas of them, a grid over "
             f"several served by a world of its own, one process a card" if meshed else
             f"{device.type} with {n_dev} card(s) in the world: every replica is a meshless "
             f"engine on {device}, so replicas share one device and the curve measures the "
             f"router's scheduling")
    return {
        "requests": requests, "slots_per_replica": slots,
        "buckets": list(buckets), "max_new_tokens": max_new,
        "total_devices": n_dev, "meshed": meshed,
        "rungs": rungs,
        "parity_ok": bool(parity),
        "scaling_2x_vs_1": scaling,
        "disagg_prefill": disagg,
        "caveat": (f"{where}; one router process drives every replica, and the port's "
                   f"quantum reads its flags on the host every tick (ROADMAP A11), so "
                   f"in-process replicas on one card run one after the other"),
    }


def _induction_rows(tokenizer, row_len: int, seed: int) -> np.ndarray:
    """512 rows, each one short phrase (2-4 tokens of a fixture story's
    8-token head) tiled to `row_len + 1` tokens, from tpukit's draws."""
    from tpukit_torch.data import synthetic_stories

    rng0 = np.random.RandomState(seed)
    enc = tokenizer(synthetic_stories(128), truncation=True, max_length=8)["input_ids"]
    rows = []
    while len(rows) < 512:
        head = enc[rng0.randint(len(enc))]
        plen = min(int(rng0.randint(2, 5)), len(head))
        if plen < 2:
            continue
        phrase = np.asarray(head[:plen], np.int32)
        rows.append(np.tile(phrase, -(-(row_len + 1) // plen))[: row_len + 1])
    return np.asarray(rows, np.int32)


def _induction_train(cfg, tokenizer, steps, row_len, lr=3e-3, seed=7, batch=8, params=None,
                     device=None):
    """Train `cfg` on tiled-phrase rows, the `repetitive` stream profile as
    training data, so that greedy decoding learns to continue a repetition
    (tpukit :1144, whose docstring gives the measured reasons: 2+ layers,
    `row_len` covering the serving positions, in-domain phrases). AdamW
    under `train.cosine_decay_schedule(lr, steps)`, optax's schedule step
    for step; batches of `batch` rows drawn by `RandomState(0)`, the rows
    by `RandomState(seed)`. `params` (a numpy tree) starts from given
    weights, else `init_params(seed=0)`. Returns (train state, final
    loss); the state is what `bench/induction.py` checkpoints."""
    from tpukit_torch import resolve_device
    from tpukit_torch.bench.ladder import setup_step
    from tpukit_torch.bridge import params_from_numpy
    from tpukit_torch.train import cosine_decay_schedule

    device = resolve_device(device)
    step_fn, state = setup_step(
        cfg, lr=cosine_decay_schedule(lr, steps), device=device,
        params=params_from_numpy(params, device) if params is not None else None)
    data = _induction_rows(tokenizer, row_len, seed)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(row_len, dtype=np.int32),
                                               (batch, row_len)))
    rng = np.random.RandomState(0)
    loss = None
    for _ in range(steps):
        idx = rng.randint(0, len(data), size=batch)
        mb = {"input_ids": data[idx, :row_len], "position_ids": pos,
              "mask": np.zeros((batch, row_len), dtype=bool)}
        state, loss = step_fn(state, mb, data[idx, 1: row_len + 1])
    return state, float(loss)


def bench_spec_decode(cfg, n_dev, requests=24, slots=4, max_new=48, k=10,
                      train_steps=SPEC_TRAIN_STEPS, device=None) -> dict:
    """Speculative decoding against the vanilla engine on the `repetitive`
    stream (tpukit :1199). The target (dim 128, 4 x 32 heads, 4 layers,
    f32) and the draft (dim 32, 2 x 16 heads, 2 layers) are first trained
    `train_steps` steps each by `_induction_train`, over rows that cover
    the serving positions (largest bucket + `max_new` + `k` + 2). Rungs at
    temperature 0 and 0.8, each proposer (`ngram`, `model`) against the
    same temperature's vanilla engine: a warm run, then the best of three
    measured runs; `speedup_ngram_t0` is the n-gram rung's speedup at 0."""
    from tpukit_torch import resolve_device
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.pipeline import _tree_map
    from tpukit_torch.serve import ServeConfig, ServeEngine, synthetic_request_stream

    device = resolve_device(device)
    tokenizer = get_tokenizer()
    tokenizer.pad_token_id = 2
    buckets = (16, 32)
    row_len = max(buckets) + max_new + k + 2
    tgt_cfg = cfg.replace(dim=128, head_dim=32, heads=4, num_layers=4,
                          vocab_size=tokenizer.vocab_size, max_position_embeddings=128,
                          compute_dtype=torch.float32, num_experts=0)
    draft_cfg = tgt_cfg.replace(dim=32, head_dim=16, heads=2, num_layers=2)
    t0 = time.perf_counter()
    tgt_state, tgt_loss = _induction_train(tgt_cfg, tokenizer, train_steps[0], row_len,
                                           device=device)
    draft_state, draft_loss = _induction_train(draft_cfg, tokenizer, train_steps[1], row_len,
                                               device=device)
    params = _tree_map(torch.Tensor.detach, tgt_state.params)  # served, not trained
    draft_params = _tree_map(torch.Tensor.detach, draft_state.params)
    del tgt_state, draft_state
    train_s = time.perf_counter() - t0
    eos = int(tokenizer.eos_token_id)
    stream = synthetic_request_stream(tokenizer, requests, seed=3, max_new_tokens=max_new,
                                      buckets=buckets, stream_profile="repetitive")

    def run(draft, temperature):
        serve = ServeConfig(slots=slots, buckets=buckets, max_new_tokens=max_new,
                            temperature=temperature, window_steps=10**9,
                            draft=draft, spec_k=k)
        kw = (dict(draft_params=draft_params, draft_cfg=draft_cfg)
              if draft == "model" else {})
        ServeEngine(params, tgt_cfg, serve, eos_id=eos, device=device, **kw).run(
            list(stream), max_wall_s=MAX_WALL_S)
        walls = []
        for _ in range(3):
            eng = ServeEngine(params, tgt_cfg, serve, eos_id=eos, device=device, **kw)
            comps, wall = _timed_run(eng, stream)
            walls.append(wall)
        wall = min(walls)
        gen = sum(c.generated for c in comps)
        out = dict(tokens_per_sec=round(gen / wall, 1), wall_s=round(wall, 3),
                   wall_spread_s=round(max(walls) - wall, 3),
                   generated_tokens=gen, verify_steps=eng.steps)
        if draft:
            summ = eng.last_summary or {}
            spec = summ.get("spec") or {}
            out.update(
                accept_rate=(round(spec["accept_rate"], 4)
                             if spec.get("accept_rate") is not None else None),
                proposed=spec.get("proposed"), accepted=spec.get("accepted"),
                accepted_hist=spec.get("accepted_hist"),
                draft_s=round(summ.get("draft_s", 0.0), 3),
                verify_s=round(summ.get("verify_s", 0.0), 3),
            )
        return out

    rec = {
        "requests": requests, "slots": slots, "spec_k": k,
        "max_new_tokens": max_new, "buckets": list(buckets),
        "stream_profile": "repetitive",
        "train": {"target_loss": round(tgt_loss, 4), "draft_loss": round(draft_loss, 4),
                  "train_s": round(train_s, 1)},
    }
    for label, temp in (("t0", 0.0), ("t0.8", 0.8)):
        van = run("", temp)
        rung = {"vanilla": van}
        for d in ("ngram", "model"):
            r = run(d, temp)
            r["speedup"] = (round(r["tokens_per_sec"] / van["tokens_per_sec"], 2)
                            if van["tokens_per_sec"] else None)
            rung[d] = r
        rec[label] = rung
    rec["speedup_ngram_t0"] = rec["t0"]["ngram"]["speedup"]
    return rec

