"""The bench's training records (twins of tpukit's `bench.py` record
functions, :71-464 and :1324-1786), each over the ranks of the default
group (`n_dev`: one card a rank) on `device`.

What stands in for tpukit's compiled program: a record that reads a step's
collectives runs that step under the comm audit's recorder
(`analysis.comm_ir.record_comm`) and reads its c10d calls, where tpukit
parses the optimized HLO; the lint is `analysis.lint_trace` against the
strategy's plan. Nothing is compiled, so the fields tpukit fills from a
compiler's stderr (`involuntary_remat_warnings`) are None. A record's
parity bits are tpukit's: equal losses where tpukit calls them equal, bytes
equal to the closed forms. Speeds are recorded as measured.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from tpukit_torch.bench.ladder import free_cache, make_batch, setup_step, time_windows


def recorded_step(step, state, model_batch, targets):
    """One step under the comm audit's recorder: (state, loss, trace)."""
    from tpukit_torch.analysis import record_comm

    with record_comm() as trace:
        state, loss = step(state, model_batch, targets)
    return state, loss, trace


def _zero() -> dict:
    return {"count": 0, "bytes": 0}


def bench_host_pipeline(cfg, strategy_fn, batch, depth=2, steps=24, device=None) -> dict:
    """The prefetch path against the synchronous one on the headline step
    (tpukit :71). The real input path (`DataLoader` -> `prepare_batch` ->
    host tensors -> the device -> the step) over one batch schedule twice,
    from equal initial states: synchronously (the `data` and `h2d` spans)
    and through a depth-`depth` `HostPrefetcher` (the `prefetch_stall`
    span, the host copy to the device included, as `fit` spans it). The
    window share of each, the buffer's occupancy, and whether the final
    losses are the same bits (they must be: same batches, same order, same
    step). `strategy_fn()` makes the strategy of each run; each rank loads
    its rows of every batch, as the recipes load them."""
    from tpukit_torch.batching import prepare_batch
    from tpukit_torch.data import ArrayDataset
    from tpukit_torch.loader import DataLoader
    from tpukit_torch.obs import SpanTimeline
    from tpukit_torch.prefetch import HostPrefetcher
    from tpukit_torch.train import host_to_device, to_host, train_step

    seq = cfg.max_position_embeddings
    pad_id = 2
    rng = np.random.RandomState(7)
    ids = rng.randint(3, cfg.vocab_size, size=(steps * batch, seq)).astype(np.int32)
    ds = ArrayDataset(ids, np.ones_like(ids))

    def run(prefetched: bool):
        step, state = setup_step(cfg, strategy_fn(), device=device)
        shards, shard = step.strategy.row_shards, step.strategy.row_shard()
        pin = step.device.type == "cuda"

        def pipeline(raw):
            b, t = prepare_batch(raw, pad_id)
            return to_host(b, t, pin)

        wb, wt = make_batch(np.random.RandomState(0), cfg.vocab_size, batch, seq - 1)
        state, _ = step(state, wb, wt)  # the kernels' build and load, untimed
        spans = SpanTimeline()
        loader = DataLoader(ds, batch // shards, num_replicas=shards, rank=shard)
        occupancy, loss = None, None
        spans.epoch()
        if prefetched:
            pf = HostPrefetcher(loader, pipeline, depth=depth)
            try:
                while True:
                    with spans.span("prefetch_stall"):
                        try:
                            host = next(pf)
                        except StopIteration:
                            break
                        b, t = host_to_device(host, step.device)
                    with spans.span("step"):
                        loss = train_step(state, cfg, step.strategy, b, t)
            finally:
                occupancy = pf.window_stats()["occupancy"]
                pf.close()
        else:
            it = iter(loader)
            while True:
                with spans.span("data"):
                    try:
                        raw = next(it)
                    except StopIteration:
                        break
                    host = pipeline(raw)
                with spans.span("h2d"):
                    b, t = host_to_device(host, step.device)
                with spans.span("step"):
                    loss = train_step(state, cfg, step.strategy, b, t)
        with spans.span("sync"):
            final = float(loss)
        win = spans.epoch()
        del state
        return final, win, occupancy

    loss_sync, win_sync, _ = run(prefetched=False)
    loss_pf, win_pf, occupancy = run(prefetched=True)
    frac_s, frac_p = win_sync["fractions"], win_pf["fractions"]
    return {
        "depth": depth,
        "steps": steps,
        "sync_input_share": round(frac_s.get("data", 0.0) + frac_s.get("h2d", 0.0), 4),
        "prefetch_stall_share": round(frac_p.get("prefetch_stall", 0.0), 4),
        "prefetch_occupancy": round(occupancy, 3) if occupancy is not None else None,
        "sync_wall_s": round(win_sync["total_s"], 4),
        "prefetch_wall_s": round(win_pf["total_s"], 4),
        "loss_bit_identical": loss_sync == loss_pf,
        "final_loss": round(loss_pf, 6),
    }


def bench_obs_overhead(cfg, strategy_fn, batch, steps=48, checksum_every=8,
                       device=None) -> dict:
    """The flight recorder and the divergence checksum on the headline step
    (tpukit :166): the same step over the same batch for `steps` steps
    twice, from equal initial states, bare and with a `FlightRecorder`
    record a step plus a state checksum every `checksum_every` steps, read
    at the window's host read as `fit` reads it. Both walls, the overhead
    fraction and whether the final losses are the same bits (the recorder
    only observes; the checksum reads the state and writes nothing)."""
    from tpukit_torch.obs import FlightRecorder, format_checksum, make_state_checksum

    seq = cfg.max_position_embeddings
    b, t = make_batch(np.random.RandomState(3), cfg.vocab_size, batch, seq - 1)

    def run(instrumented: bool):
        step, state = setup_step(cfg, strategy_fn(), device=device)
        state, loss = step(state, b, t)  # the kernels' build and load, untimed
        float(loss)
        rec = FlightRecorder() if instrumented else None
        checksum_fn = make_state_checksum() if instrumented else None
        if checksum_fn is not None:
            format_checksum(checksum_fn(state))  # its first call outside the window
        last_ck = pending = None
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            state, loss = step(state, b, t)
            if rec is not None:
                rec.record("step", step=i)
                if i % checksum_every == 0:
                    pending = (i, checksum_fn(state))
            if i % checksum_every == 0:
                float(loss)  # the window's host read both runs pay
                if pending is not None:
                    last_ck = format_checksum(pending[1])
                    rec.record("divergence_check", step=pending[0], checksum=last_ck)
                    pending = None
        final = float(loss)
        wall = time.perf_counter() - t0
        del state
        return final, wall, last_ck

    loss_off, wall_off, _ = run(False)
    loss_on, wall_on, last_ck = run(True)
    return {
        "steps": steps,
        "checksum_every": checksum_every,
        "baseline_wall_s": round(wall_off, 4),
        "instrumented_wall_s": round(wall_on, 4),
        "overhead_frac": round((wall_on - wall_off) / wall_off, 4),
        "loss_bit_identical": loss_off == loss_on,
        "final_loss": round(loss_on, 6),
        "last_checksum": last_ck,
    }


def _ep(n_dev: int, num_experts: int, dispatch: str = "a2a"):
    from tpukit_torch.ops.moe_dispatch import ExpertGrid
    from tpukit_torch.shardings import ExpertParallel

    expert = math.gcd(n_dev, num_experts)
    grid = {"data": n_dev // expert, "expert": expert}
    return ExpertParallel(ExpertGrid(**grid), dispatch=dispatch), grid


def bench_moe_ep_comm(cfg, n_dev, num_experts=8, steps=8, device=None) -> dict:
    """The expert-parallel all-to-all dispatch (tpukit :235): the e8 shape
    under `ExpertParallel` on recipe 8's `(data, expert)` grid with the
    all-to-all exchange. Its first step runs under the comm audit's
    recorder: the all-to-all calls and bytes it issued against the closed
    form (`dispatch_comm`), then tokens/s a card through that path. On one
    card the expert axis is 1 and nothing crosses ranks: expected ==
    measured == 0."""
    from tpukit_torch.analysis import collective_summary

    strat, grid = _ep(n_dev, num_experts)
    cfg_m = cfg.replace(num_experts=num_experts)
    seq = cfg.max_position_embeddings
    batch = 32 * n_dev
    b, t = make_batch(np.random.RandomState(5), cfg.vocab_size, batch, seq - 1)
    step, state = setup_step(cfg_m, strat, device=device)
    state, _, trace = recorded_step(step, state, b, t)
    measured = collective_summary(trace).get("all-to-all", _zero())
    expected = strat.dispatch_comm(cfg_m, global_batch=batch, seq=seq - 1)["train"]
    times, state, loss = time_windows(step, state, b, t, steps=steps, windows=3, warmup=1)
    del state
    free_cache()
    return {
        "mesh": grid,
        "dispatch": "a2a",
        "backend": step.device.type,
        "expected_a2a": {"count": expected["count"], "bytes": expected["bytes"]},
        "measured_a2a": measured,
        "bytes_match": (measured["count"] == expected["count"]
                        and measured["bytes"] == expected["bytes"]),
        "involuntary_remat_warnings": None,
        "tokens_per_sec_per_chip": round(steps * batch * (seq - 1) / min(times) / n_dev, 1),
        "final_loss": round(loss, 6),
    }


def bench_moe_dispatch_ladder(cfg, n_dev, num_experts=8, steps=8, device=None) -> list:
    """The MoE dataflows at the e8 shape, top-1 and top-2 (tpukit :309):
    "xla" (the meshless einsums over capacity buffers), "a2a" (the
    exchange under `ExpertParallel`) and "pallas" (the grouped-expert
    kernels), each with tokens/s a card and an MFU of the active FLOPs
    (`moe_active_flops_per_token`). "xla" and "pallas" run meshless under
    `SingleDevice` (`DataParallel` on several cards). A rung that fails
    lands as `{"dispatch", "top_k", "error"}`."""
    from tpukit_torch.obs import moe_active_flops_per_token, peak_flops_per_chip
    from tpukit_torch.obs.meter import device_kind
    from tpukit_torch.shardings import DataParallel, SingleDevice

    seq = cfg.max_position_embeddings
    batch = 32 * n_dev
    rows = []
    for top_k in (1, 2):
        for dispatch in ("xla", "a2a", "pallas"):
            cfg_m = cfg.replace(num_experts=num_experts, router_top_k=top_k)
            try:
                if dispatch == "a2a":
                    strat, _ = _ep(n_dev, num_experts)
                else:
                    cfg_m = cfg_m.replace(moe_dispatch=dispatch)
                    strat = DataParallel() if n_dev > 1 else SingleDevice()
                step, state = setup_step(cfg_m, strat, device=device)
                b, t = make_batch(np.random.RandomState(5), cfg.vocab_size, batch, seq - 1)
                times, state, loss = time_windows(step, state, b, t, steps=steps, windows=3,
                                                  warmup=2)
                del state
                peak = peak_flops_per_chip(device_kind(step.device))
                tps_chip = steps * batch * (seq - 1) / min(times) / n_dev
                flops = moe_active_flops_per_token(cfg_m, seq - 1)
                rows.append({
                    "dispatch": dispatch,
                    "top_k": top_k,
                    "tokens_per_sec_per_chip": round(tps_chip, 1),
                    "active_flops_per_token": flops,
                    "mfu_active": round(tps_chip * flops / peak, 4) if peak else None,
                    "final_loss": round(loss, 6),
                })
            except Exception as exc:
                rows.append({"dispatch": dispatch, "top_k": top_k, "error": repr(exc)})
                print(f"moe ladder rung {dispatch}/top{top_k} failed: {exc!r}", file=sys.stderr)
            free_cache()
    return rows


def _comm_rungs(cfg, n_dev, num_experts):
    """(name, strategy maker, config maker, the wire's world) of the DDP,
    FSDP and EP rungs (tpukit :1362-1374)."""
    from tpukit_torch.shardings import FSDP, DataParallel

    expert = math.gcd(n_dev, num_experts)
    return [
        ("ddp", DataParallel, lambda **kw: cfg.replace(**kw), n_dev),
        ("fsdp", FSDP, lambda **kw: cfg.replace(**kw), n_dev),
        ("ep", lambda: _ep(n_dev, num_experts)[0],
         lambda **kw: cfg.replace(num_experts=num_experts, **kw), expert),
    ]


def bench_quant_comm(cfg, n_dev, num_experts=8, steps=8, device=None) -> list:
    """`--comm_dtype` f32 against bf16 against int8 on each strategy with
    hand-placed collectives (tpukit :1324): ddp (the gradient all-reduce),
    fsdp (the gradient reduce-scatter), ep (the dispatch payload). Each
    rung's first step runs under the comm audit's recorder: its
    collectives against the closed forms (`grad_comm`, `dispatch_comm`),
    the ring model's bytes on the wire (`ring_wire_bytes`; EP's of the
    all-to-all alone) and their ratio to the rung's f32, then tokens/s a
    card and the final loss's delta from f32's after the same steps. On
    one card the collectives are skipped (the quantizer's numerics stay):
    expected is None."""
    from tpukit_torch.analysis import collective_summary, ring_wire_bytes

    seq = cfg.max_position_embeddings
    batch = 32 * n_dev
    rows = []
    for name, strat_fn, cfg_fn, world in _comm_rungs(cfg, n_dev, num_experts):
        f32_loss = f32_wire = None
        for dtype in ("f32", "bf16", "int8"):
            try:
                c = cfg_fn(comm_dtype=dtype)
                strat = strat_fn()
                strat.validate_config(c)
                b, t = make_batch(np.random.RandomState(5), cfg.vocab_size, batch, seq - 1)
                step, state = setup_step(c, strat, device=device)
                state, _, trace = recorded_step(step, state, b, t)
                coll = collective_summary(trace)
                if name == "ep":
                    wire = ring_wire_bytes({"all-to-all": coll.get("all-to-all") or _zero()},
                                           world)
                    audit = strat.dispatch_comm(c, global_batch=batch, seq=seq - 1)
                    expected = ({"all-to-all": {"count": audit["train"]["count"],
                                                "bytes": audit["train"]["bytes"]}}
                                if audit else None)
                else:
                    wire = ring_wire_bytes(coll, world)
                    expected = strat.grad_comm(c, state.params)
                exact = None
                if expected:
                    exact = all((coll.get(op) or _zero()) == rec for op, rec in expected.items())
                times, state, loss = time_windows(step, state, b, t, steps=steps, windows=3,
                                                  warmup=1)
                del state
                row = {
                    "strategy": name,
                    "comm_dtype": dtype,
                    "wire_bytes": wire,
                    "expected": expected,
                    "measured": {op: coll.get(op) for op in (expected or {})
                                 if coll.get(op)} or None,
                    "bytes_match": exact,
                    "involuntary_remat_warnings": None,
                    "tokens_per_sec_per_chip": round(
                        steps * batch * (seq - 1) / min(times) / n_dev, 1),
                    "final_loss": round(loss, 6),
                }
                if dtype == "f32":
                    f32_loss, f32_wire = loss, wire
                else:
                    row["loss_delta_vs_f32"] = (round(loss - f32_loss, 6)
                                                if f32_loss is not None else None)
                    row["wire_ratio_vs_f32"] = round(wire / f32_wire, 4) if f32_wire else None
                rows.append(row)
            except Exception as exc:
                rows.append({"strategy": name, "comm_dtype": dtype, "error": repr(exc)})
                print(f"quant comm rung {name}/{dtype} failed: {exc!r}", file=sys.stderr)
            free_cache()
    return rows


def bench_comm_overlap(cfg, n_dev, num_experts=8, steps=8, device=None) -> list:
    """Step time at f32 against int8 against int8 with `--grad_buckets 4`
    on the DDP, FSDP and EP worlds (tpukit :1467), so that the wire's cut
    and the buckets' schedule show apart. Each rung's first step runs under
    the comm audit's recorder: its collectives against the plan
    (`bytes_match`), and on a world that declares overlap the `overlap`
    gate's verdict (`overlap_frac`: the wires issued with backward left to
    hide behind over those declared, capped at 1), then the step time,
    tokens/s a card, the final loss and its delta from f32's."""
    from tpukit_torch.analysis import (collective_summary, lint_trace, summarize,
                                       train_comm_plan)

    seq = cfg.max_position_embeddings
    batch = 32 * n_dev
    rows = []
    for name, strat_fn, cfg_fn, _ in _comm_rungs(cfg, n_dev, num_experts):
        f32_loss = f32_step = None
        for dtype, buckets in (("f32", 0), ("int8", 0), ("int8", 4)):
            try:
                c = cfg_fn(comm_dtype=dtype, grad_buckets=buckets)
                strat = strat_fn()
                strat.validate_config(c)
                b, t = make_batch(np.random.RandomState(5), cfg.vocab_size, batch, seq - 1)
                step, state = setup_step(c, strat, device=device)
                state, _, trace = recorded_step(step, state, b, t)
                coll = collective_summary(trace)
                plan = train_comm_plan(strat, c, params=state.params, global_batch=batch,
                                       seq=seq - 1)
                exact = None
                if plan is not None and plan.ops:
                    exact = all((coll.get(op) or _zero()) == rec for op, rec in plan.ops.items())
                overlap = None
                if plan is not None and plan.overlap:
                    verdict = summarize(lint_trace(trace, plan=plan))
                    gate = verdict.get("overlap_gate") or {}
                    declared = gate.get("declared") or 0
                    overlap = {
                        "declared": declared,
                        "overlappable": gate.get("overlappable", 0),
                        "overlap_frac": (round(min(1.0, gate.get("overlappable", 0) / declared),
                                               4) if declared else None),
                        "gate_ok": gate.get("ok"),
                        "clean": verdict["clean"],
                    }
                times, state, loss = time_windows(step, state, b, t, steps=steps, windows=3,
                                                  warmup=1)
                del state
                step_time = min(times) / steps
                row = {
                    "strategy": name,
                    "comm_dtype": dtype,
                    "grad_buckets": buckets,
                    "step_time_s": round(step_time, 6),
                    "tokens_per_sec_per_chip": round(batch * (seq - 1) / step_time / n_dev, 1),
                    "bytes_match": exact,
                    "overlap": overlap,
                    "involuntary_remat_warnings": None,
                    "final_loss": round(loss, 6),
                }
                if dtype == "f32" and buckets == 0:
                    f32_loss, f32_step = loss, step_time
                else:
                    row["loss_delta_vs_f32"] = (round(loss - f32_loss, 6)
                                                if f32_loss is not None else None)
                    row["step_time_vs_f32"] = (round(step_time / f32_step, 4)
                                               if f32_step else None)
                rows.append(row)
            except Exception as exc:
                rows.append({"strategy": name, "comm_dtype": dtype, "grad_buckets": buckets,
                             "error": repr(exc)})
                print(f"comm overlap rung {name}/{dtype}/b{buckets} failed: {exc!r}",
                      file=sys.stderr)
            free_cache()
    return rows


def bench_pipe_interleave(n_dev, steps=3, micro=8, device=None) -> dict:
    """Flat 1F1B against V = 2 and V = 4 virtual chunks a stage at an equal
    micro-batch count (tpukit :1615). Two kinds of numbers, kept apart:
    `bubble_table` and each rung's `bubble_frac` come from the tick tables
    (`pipeline_schedule`; the V = 1 row is the closed form (2S-2)/(M+2S-2)),
    which need no card; each rung's step time, tokens/s a card and
    `wall_ratio_vs_flat` beside `predicted_ratio_vs_flat` (the schedule's
    cost in forward units, a chunk 1/V of a stage) are the walls of the
    stage ranks (one a card). A rung that fails lands as
    `{"virtual_stages", "error"}`: fewer cards than stages fail every
    rung, and the table stays."""
    from tpukit_torch.model import GPTConfig
    from tpukit_torch.pipeline import Pipeline1F1B
    from tpukit_torch.pipeline_schedule import bubble_table, cached_schedule, flat_1f1b_bubble

    stages = 4 if n_dev >= 4 else 2
    layers = 4 * stages
    seq = 128
    cfg_p = GPTConfig(dim=128, head_dim=32, heads=4, num_layers=layers, vocab_size=8192,
                      max_position_embeddings=seq, compute_dtype=torch.bfloat16)
    batch = 2 * micro
    record = {
        "stages": stages,
        "microbatches": micro,
        "layers": layers,
        "bubble_table": bubble_table(stages),
        "rungs": [],
        "caveat": ("bubble_frac/predicted_ratio come from the tick tables and need no card; "
                   "the walls are the stage ranks' own, one a card, over c10d"),
    }
    flat_cost = 3.0 * (micro + 2 * stages - 2)
    flat_step = None
    for v in (1, 2, 4):
        try:
            if v == 1:
                bubble, cost = flat_1f1b_bubble(stages, micro), flat_cost
            else:
                st = cached_schedule(stages, v, micro).stats
                bubble = st["bubble_frac"]
                cost = (st["fwd_phase_ticks"] + 2.0 * st["bwd_phase_ticks"]) / v
            if n_dev % stages:
                raise ValueError(f"a pipeline of {stages} stage ranks needs a world that "
                                 f"divides by {stages}, got {n_dev}")
            strat = Pipeline1F1B(num_microbatches=micro, data=n_dev // stages, stages=stages)
            c = cfg_p.replace(virtual_stages=v)
            b, t = make_batch(np.random.RandomState(5), c.vocab_size, batch, seq)
            step, state = setup_step(c, strat, device=device)
            times, state, loss = time_windows(step, state, b, t, steps=steps, windows=3,
                                              warmup=2)
            del state
            step_time = min(times) / steps
            row = {
                "virtual_stages": v,
                "bubble_frac": round(bubble, 4),
                "sched_cost_units": round(cost, 2),
                "predicted_ratio_vs_flat": round(cost / flat_cost, 4),
                "step_time_s": round(step_time, 6),
                "tokens_per_sec_per_chip": round(batch * seq / step_time / stages, 1),
                "final_loss": round(loss, 6),
            }
            if v == 1:
                flat_step = step_time
            else:
                row["wall_ratio_vs_flat"] = (round(step_time / flat_step, 4)
                                             if flat_step else None)
            record["rungs"].append(row)
        except Exception as exc:
            record["rungs"].append({"virtual_stages": v, "error": repr(exc)})
            print(f"pipe interleave rung V={v} failed: {exc!r}", file=sys.stderr)
        free_cache()
    return record


def bench_pipe_moe(n_dev, micro=4, steps=3, device=None) -> dict:
    """The interleaved 1F1B pipeline with 8 experts through the grouped-
    expert dispatch (tpukit :1723) against `SingleDevice` on the same
    parameters and per-micro objective (CE + aux, f32): the parity bit
    (loss within 1e-4), and tokens/s a card. Needs two cards (stage
    ranks)."""
    from tpukit_torch.model import GPTConfig
    from tpukit_torch.pipeline import Pipeline1F1B
    from tpukit_torch.shardings import SingleDevice

    stages = 2
    if n_dev < stages:
        raise ValueError("pipe_moe rung needs >= 2 devices")
    seq = 64
    cfg_m = GPTConfig(dim=64, head_dim=16, heads=4, num_layers=8, vocab_size=1024,
                      max_position_embeddings=seq, compute_dtype=torch.float32,
                      num_experts=8, moe_dispatch="pallas", virtual_stages=2)
    batch = 2 * micro
    b, t = make_batch(np.random.RandomState(5), cfg_m.vocab_size, batch, seq)
    step_ref, state_ref = setup_step(cfg_m.replace(virtual_stages=1), SingleDevice(),
                                     device=device)
    state_ref, ref_loss = step_ref(state_ref, b, t)
    ref_loss = float(ref_loss)
    del state_ref
    strat = Pipeline1F1B(num_microbatches=micro, moe_dispatch="pallas",
                         data=n_dev // stages, stages=stages)
    step, state = setup_step(cfg_m, strat, device=device)
    state, loss = step(state, b, t)
    loss = float(loss)
    times, state, _ = time_windows(step, state, b, t, steps=steps, windows=2, warmup=1)
    del state
    delta = abs(loss - ref_loss)
    return {
        "stages": stages,
        "virtual_stages": 2,
        "microbatches": micro,
        "num_experts": 8,
        "dispatch": "pallas",
        "loss": round(loss, 6),
        "ref_loss": round(ref_loss, 6),
        "loss_delta": round(delta, 8),
        "parity_ok": bool(delta < 1e-4),
        "tokens_per_sec_per_chip": round(steps * batch * seq / min(times) / stages, 1),
    }


def bench_elastic_restore(cfg, n_dev, device=None) -> dict:
    """A sharded FSDP checkpoint of the world landing on a world of half
    its ranks (tpukit :379): saved by `FSDP` over the `n_dev` ranks, then
    restored (`checkpoint.restore_sharded`: each leaf assembled from its
    blocks, this rank's piece put in place) by `FSDP` over a `DeviceMesh`
    of ranks [0, n_dev / 2), and directly by the whole world. The
    restore's wall and the blocks and bytes it read (each rank assembles
    every leaf whole, so it reads every block once), the host's peak RSS
    across it (`ru_maxrss`) and that less the state's own bytes
    (`rss_overhead_bytes`), and the parity bit: every leaf of the half
    world's state the same bytes as the direct restore's. Needs two cards."""
    import resource
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from tpukit_torch import checkpoint as ckpt_lib
    from tpukit_torch import mesh as mesh_lib
    from tpukit_torch import reshard as reshard_lib
    from tpukit_torch.shardings import FSDP, gather_full, leaves

    if n_dev < 2:
        return {"error": "needs >= 2 chips (no smaller world to reshard onto)"}
    rank = mesh_lib.rank()
    src = FSDP()
    _, state = setup_step(cfg, src, device=device)
    state_bytes = sum(t.numel() * t.element_size() for _, _, t in ckpt_lib._state_entries(state))
    box = [tempfile.mkdtemp(prefix="tpukit-torch-bench-resize-") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    ckdir = box[0]
    try:
        path = ckpt_lib.save_sharded(state, ckdir,
                                     meta={"world": reshard_lib.current_world(src)})
        del state
        half_ranks = list(range(n_dev // 2))
        group = dist.new_group(half_ranks)
        resized = info = None
        if rank in half_ranks:
            dev = torch.device(device) if device is not None else None
            half = FSDP(mesh=DeviceMesh.from_group(group, (dev or _any_device()).type,
                                                   mesh_dim_names=("data",)))
            rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            t0 = time.perf_counter()
            _, resized = setup_step(cfg, half, device=device)
            ckpt_lib.restore_sharded(path, resized)
            wall = time.perf_counter() - t0
            rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            shards = ckpt_lib._Shards(path)
            try:
                blocks = [b for bs in shards.blocks.values() for b in bs]
            finally:
                shards.close()
            info = {"wall_s": wall, "bytes_read": sum(b[2] for b in blocks),
                    "blocks_read": len(blocks), "rss_delta": (rss1 - rss0) * 1024}
        _, direct = setup_step(cfg, FSDP(), device=device)
        ckpt_lib.restore_sharded(path, direct)
        want = [gather_full(t).detach().cpu().numpy().tobytes()
                for t in leaves(direct.params)]
        parity = None
        if resized is not None:
            got = [gather_full(t).detach().cpu().numpy().tobytes()
                   for t in leaves(resized.params)]
            parity = got == want
        del direct, resized
        dist.barrier()
        if info is None:
            return {"error": f"rank {rank} holds no shard of the half world"}
        return {
            "from_world": {"strategy": "fsdp", "devices": n_dev},
            "to_world": {"strategy": "fsdp", "devices": n_dev // 2},
            "state_bytes": int(state_bytes),
            "restore_wall_s": round(info["wall_s"], 4),
            "bytes_read": int(info["bytes_read"]),
            "blocks_read": int(info["blocks_read"]),
            "peak_rss_delta_bytes": int(info["rss_delta"]),
            "rss_overhead_bytes": int(info["rss_delta"]) - int(state_bytes),
            "parity_ok": bool(parity),
        }
    finally:
        if rank == 0:
            shutil.rmtree(ckdir, ignore_errors=True)


def _any_device():
    return torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
