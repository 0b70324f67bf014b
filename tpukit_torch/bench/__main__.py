"""`python -m tpukit_torch.bench`: GPT training throughput on the card(s)
(twin of tpukit's `bench.py`).

    python -m tpukit_torch.bench [--moe_dispatch xla|pallas] [--device cpu]
    torchrun --nproc_per_node N -m tpukit_torch.bench [--serving_records KEY,...]

A plain run is a world of one; under `torchrun` every rank drives one card
(tpukit reads its N from `len(jax.devices())`). Trains tpukit's bench GPT
(dim 256, 8 x 32 heads, 8 layers, sequence 256, the GPT-2 vocab; bf16,
batch 64 a card, AdamW at 1e-4, random weights from seed 0, synthetic
batches) and reports tokens/s a card and MFU against the card's peak bf16
rate (`obs.meter`), best of four windows of 12 steps, with the slowest
window's MFU beside it (`mfu_window_min`). Then the training records, each
in its own try, a failure landing in the record as `error`:
long context (S 2048, batch 16 a card), FSDP with `--cpu_offload`, the e8
MoE probe, `moe_ep_comm`, `moe_dispatch_ladder`, `quant_comm`,
`comm_overlap`, `pipe_interleave`, `pipe_moe`, `elastic_restore`,
`host_pipeline`, `obs_overhead` and, on one card, the ladder
(`bench/ladder.py`, `bench/records.py`).

Then the serving records (`bench/serving.py`), in tpukit's order, each in
its own try: `serving` (continuous batching against the serial loops),
`paged_kv`, `spec_decode` (after `_induction_train`),
`serve_dispatch_attribution`, `decode_fused`, `fleet_serving`, the
request tracer's cost (`obs_overhead["serving"]`) and `metrics_overhead`.
tpukit's serving records use one device whatever the world, and its fleet
record all of them: in a world of N > 1 they run on rank 0 after the
training records, while the other ranks leave their cards idle and wait on
a gloo group (not NCCL, whose watchdog a record of minutes could cross), so
no record is timed while another rank runs work. `--serving_records`
(the port's own) runs only the named serving records, as they run there,
and prints them alone: one JSON object by key.

`decode_fused`'s `amortization_speedup` measures the port's window, which
reads the lanes' flags on the host after every tick (ROADMAP A11), not
tpukit's on-device loop.

Rank 0 prints exactly one JSON line, with tpukit's keys in tpukit's order
(`bench.py:2124-2172`). Records that need several cards say so at a world
of one, as tpukit's do. Nothing is compiled: `compile_cache` is null,
`--compilation_cache_dir` raises NotPortedError, and `xla_train_step` is
the comm audit's `kind="xla"` record of the headline's first step, whose
cost fields are None.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from tpukit_torch.bench import records, serving
from tpukit_torch.bench.ladder import (free_cache, make_batch, run_ladder, setup_step,
                                       time_windows)

LONG_CONTEXT = (2048, 16)  # the long-context probe's sequence and rows a card (tpukit :1874)
# the serving records in tpukit's order (bench.py :2011-2110): (key, the
# label of a failure, the record)
SERVING_RECORDS = (
    ("serving", "serving probe", serving.bench_serving),
    ("paged_kv", "paged kv probe", serving.bench_paged_kv),
    ("spec_decode", "spec decode probe", serving.bench_spec_decode),
    ("serve_dispatch_attribution", "serve dispatch attribution probe",
     serving.bench_serve_dispatch_attribution),
    ("decode_fused", "fused decode probe", serving.bench_decode_fused),
    ("fleet_serving", "fleet serving probe", serving.bench_fleet_serving),
    ("serve_trace_overhead", "serve trace overhead probe", serving.bench_serve_trace_overhead),
    ("metrics_overhead", "metrics overhead probe", serving.bench_metrics_overhead),
)
WAIT_TIMEOUT = datetime.timedelta(hours=4)  # the other ranks' wait on rank 0's serving records


def bench_config(**kw):
    """tpukit's bench GPT (`bench.py:1827-1835`)."""
    from tpukit_torch.model import GPTConfig

    base = dict(dim=256, head_dim=32, heads=8, num_layers=8, vocab_size=50257,
                max_position_embeddings=256, compute_dtype=torch.bfloat16)
    base.update(kw)
    return GPTConfig(**base)


def headline_strategy(n_dev: int):
    """tpukit's: `DataParallel` over several cards, else `SingleDevice`."""
    from tpukit_torch.shardings import DataParallel, SingleDevice

    return DataParallel() if n_dev > 1 else SingleDevice()


def headline(cfg, per_chip_batch: int, steps: int = 12, windows: int = 4, device=None,
             params: dict | None = None, rng=None) -> dict:
    """The headline step (tpukit :1837-1867): `per_chip_batch` rows a card
    of `make_batch(rng)` at S = max_position_embeddings - 1; its first
    warm-up step under the comm audit's recorder (`xla_train_step`), then
    `windows` windows of `steps`. Returns the window times, the tokens a
    window, tokens/s (total and a card), MFU, the final loss and the
    record."""
    from tpukit_torch.analysis import xla_record
    from tpukit_torch.mesh import world_size
    from tpukit_torch.obs import peak_flops_per_chip, train_flops_per_token
    from tpukit_torch.obs.meter import device_kind

    n_dev = world_size()
    seq = cfg.max_position_embeddings
    batch = per_chip_batch * n_dev
    rng = rng if rng is not None else np.random.RandomState(0)
    step, state = setup_step(cfg, headline_strategy(n_dev), device=device, params=params)
    model_batch, targets = make_batch(rng, cfg.vocab_size, batch, seq - 1)
    state, _, trace = records.recorded_step(step, state, model_batch, targets)
    xla = xla_record("train_step", trace, step.strategy, cfg, state.params, batch, seq - 1,
                     step.device.type)
    times, state, final_loss = time_windows(step, state, model_batch, targets, steps=steps,
                                            windows=windows, warmup=2)
    best = min(times)
    tps = steps * batch * (seq - 1) / best
    peak = peak_flops_per_chip(device_kind(step.device))
    mfu = (tps / n_dev) * train_flops_per_token(cfg, seq - 1) / peak if peak else None
    return dict(times=times, best=best, tps=tps, tps_chip=tps / n_dev, mfu=mfu,
                final_loss=final_loss, xla=xla, batch=batch, n_dev=n_dev, state=state,
                model_batch=model_batch, targets=targets, device=step.device)


def _probe(label: str, fn):
    """`fn()`, or (None, its error's repr) printed to stderr."""
    try:
        return fn(), None
    except Exception as exc:
        print(f"{label} failed: {exc!r}", file=sys.stderr)
        return None, repr(exc)
    finally:
        free_cache()


def long_context(cfg, n_dev: int, rng, device) -> float:
    """Tokens/s a card at `LONG_CONTEXT` (S 2048, batch 16 a card), through
    the flash kernels (tpukit :1869-1888)."""
    long_seq, long_batch = LONG_CONTEXT[0], LONG_CONTEXT[1] * n_dev
    step, state = setup_step(cfg.replace(max_position_embeddings=long_seq),
                             headline_strategy(n_dev), device=device)
    b, t = make_batch(rng, cfg.vocab_size, long_batch, long_seq)
    times, state, _ = time_windows(step, state, b, t, steps=8, windows=4, warmup=2)
    return 8 * long_batch * long_seq / min(times) / n_dev


def fsdp_offload(cfg, n_dev: int, model_batch, targets, device):
    """FSDP with `--cpu_offload` (tpukit :1890-1915): (ok, tokens/s a card),
    or (None, None) where offload is not supported (the CPU). The sharded
    parameters must live in host memory before and after the steps."""
    from tpukit_torch.shardings import FSDP, leaves

    strat = FSDP(cpu_offload=True)
    if not strat._offload_supported(torch.device(device)):
        return None, None
    step, state = setup_step(cfg, strat, device=device)

    def on_host():
        return {_local(p).device.type for p in leaves(state.params)} == {"cpu"}

    if not on_host():
        raise AssertionError("offloaded parameters are not in host memory")
    times, state, _ = time_windows(step, state, model_batch, targets, steps=6, windows=1,
                                   warmup=2)
    if not on_host():
        raise AssertionError("offloaded parameters left host memory")
    return True, 6 * targets.shape[0] * (targets.shape[1]) / times[0] / n_dev


def _local(p):
    return p.to_local() if hasattr(p, "to_local") else p


def moe_probe(cfg, n_dev: int, rng, moe_dispatch: str, device) -> float:
    """The e8 model's tokens/s a card (tpukit :1917-1932)."""
    step, state = setup_step(cfg.replace(num_experts=8, moe_dispatch=moe_dispatch),
                             headline_strategy(n_dev), device=device)
    moe_batch = 32 * n_dev
    b, t = make_batch(rng, cfg.vocab_size, moe_batch, cfg.max_position_embeddings - 1)
    times, state, _ = time_windows(step, state, b, t, steps=8, windows=3, warmup=2)
    return 8 * moe_batch * (cfg.max_position_embeddings - 1) / min(times) / n_dev


def serving_records(cfg, n_dev: int, device, keys=None) -> dict:
    """Every serving record (or those of `keys`) on this rank's card, each
    a failure landing as `{"error": ...}`, by key."""
    out = {}
    for key, label, record in SERVING_RECORDS:
        if keys is not None and key not in keys:
            continue
        rec, err = _probe(label, lambda: record(cfg, n_dev, device=device))
        out[key] = rec if err is None else {"error": err}
    return out


def on_rank_zero(fn):
    """`fn()` on rank 0, None elsewhere; in a world of N > 1 the other ranks
    wait for it in a barrier of a gloo group, whose timeout is WAIT_TIMEOUT."""
    from tpukit_torch import mesh

    if mesh.world_size() == 1:
        return fn()
    group = dist.new_group(backend="gloo", timeout=WAIT_TIMEOUT)
    try:
        return fn() if mesh.rank() == 0 else None
    finally:
        dist.barrier(group=group)
        dist.destroy_process_group(group)


def run(device=None, moe_dispatch: str = "xla", cfg=None, per_chip_batch: int = 64,
        steps: int = 12, windows: int = 4) -> dict:
    """Every record of the bench in this world; tpukit's result dict."""
    from tpukit_torch.obs.meter import device_kind

    cfg = cfg if cfg is not None else bench_config()
    rng = np.random.RandomState(0)
    head = headline(cfg, per_chip_batch, steps, windows, device=device, rng=rng)
    n_dev, batch, device = head["n_dev"], head["batch"], head["device"]
    model_batch, targets = head["model_batch"], head["targets"]
    del head["state"]

    long_tps, long_err = _probe("long-context bench",
                                lambda: long_context(cfg, n_dev, rng, device))
    offload, offload_err = _probe("fsdp cpu_offload probe",
                                  lambda: fsdp_offload(cfg, n_dev, model_batch, targets, device))
    offload_ok, offload_tps = offload if offload is not None else (False, None)
    moe_tps, moe_err = _probe("moe probe",
                              lambda: moe_probe(cfg, n_dev, rng, moe_dispatch, device))
    moe_ep_comm, moe_ep_comm_err = _probe(
        "moe ep comm probe", lambda: records.bench_moe_ep_comm(cfg, n_dev, device=device))
    ladder_moe, err = _probe("moe dispatch ladder",
                             lambda: records.bench_moe_dispatch_ladder(cfg, n_dev, device=device))
    moe_dispatch_ladder = ladder_moe if err is None else [{"dispatch": "ladder", "error": err}]
    quant, err = _probe("quant comm ladder",
                        lambda: records.bench_quant_comm(cfg, n_dev, device=device))
    quant_comm = quant if err is None else [{"strategy": "quant_comm", "error": err}]
    overlap, err = _probe("comm overlap ladder",
                          lambda: records.bench_comm_overlap(cfg, n_dev, device=device))
    comm_overlap = overlap if err is None else [{"strategy": "comm_overlap", "error": err}]
    pipe, err = _probe("pipe interleave ladder",
                       lambda: records.bench_pipe_interleave(n_dev, device=device))
    pipe_interleave = pipe if err is None else {"error": err}
    pipe_moe, err = _probe("pipe moe probe", lambda: records.bench_pipe_moe(n_dev, device=device))
    pipe_moe = pipe_moe if err is None else {"error": err}
    restore, err = _probe("elastic restore probe",
                          lambda: records.bench_elastic_restore(cfg, n_dev, device=device))
    elastic_restore = restore if err is None else {"error": err}
    host_pipeline, host_pipeline_err = _probe(
        "host pipeline probe",
        lambda: records.bench_host_pipeline(cfg, lambda: headline_strategy(n_dev), batch,
                                            device=device))
    obs_overhead, obs_overhead_err = _probe(
        "obs overhead probe",
        lambda: records.bench_obs_overhead(cfg, lambda: headline_strategy(n_dev), batch,
                                           device=device))
    ladder = None
    if n_dev == 1:
        ladder, err = _probe("ladder", lambda: run_ladder(steps=6, windows=3, device=device))
        ladder = ladder if err is None else [{"shape": "ladder", "error": err}]
    served = on_rank_zero(lambda: serving_records(cfg, n_dev, device)) or {}
    if obs_overhead is None:
        obs_overhead = {}
    obs_overhead["serving"] = served.get("serve_trace_overhead")

    mfu, best = head["mfu"], head["best"]
    result = {
        "metric": "gpt_train_tokens_per_sec_per_chip",
        "value": round(head["tps_chip"], 1),
        "unit": "tokens/s/chip",
        "vs_baseline": round(mfu / 0.35, 4) if mfu is not None else None,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "mfu_window_min": round(mfu * best / max(head["times"]), 4) if mfu is not None else None,
        "tokens_per_sec_total": round(head["tps"], 1),
        "long_context_s2048_tokens_per_sec_per_chip": round(long_tps, 1) if long_tps else None,
        "long_context_error": long_err,
        "fsdp_cpu_offload_ok": offload_ok,
        "fsdp_cpu_offload_tokens_per_sec_per_chip": round(offload_tps, 1) if offload_tps else None,
        "fsdp_cpu_offload_error": offload_err,
        "moe_e8_tokens_per_sec_per_chip": round(moe_tps, 1) if moe_tps else None,
        "moe_e8_dispatch": moe_dispatch,
        "moe_error": moe_err,
        "moe_ep_comm": moe_ep_comm,
        "moe_ep_comm_error": moe_ep_comm_err,
        "moe_dispatch_ladder": moe_dispatch_ladder,
        "quant_comm": quant_comm,
        "comm_overlap": comm_overlap,
        "pipe_interleave": pipe_interleave,
        "pipe_moe": pipe_moe,
        "elastic_restore": elastic_restore,
        "serving": served.get("serving"),
        "paged_kv": served.get("paged_kv"),
        "spec_decode": served.get("spec_decode"),
        "serve_dispatch_attribution": served.get("serve_dispatch_attribution"),
        "decode_fused": served.get("decode_fused"),
        "fleet_serving": served.get("fleet_serving"),
        "host_pipeline": host_pipeline,
        "host_pipeline_error": host_pipeline_err,
        "obs_overhead": obs_overhead,
        "obs_overhead_error": obs_overhead_err,
        "metrics_overhead": served.get("metrics_overhead"),
        "ladder": ladder,
        "chips": n_dev,
        "device": device_kind(device) or device.type,
        "config": (f"GPT-20M dim{cfg.dim} L{cfg.num_layers} seq{cfg.max_position_embeddings} "
                   f"{'bf16' if cfg.compute_dtype == torch.bfloat16 else 'f32'} batch{batch}, "
                   f"eager train step"),
        "final_loss": round(head["final_loss"], 4),
        "xla_train_step": head["xla"],
        "compile_cache": None,
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--compilation_cache_dir", default="",
                    help="tpukit's persistent XLA cache: the eager port compiles no programs, "
                    "so a value raises NotPortedError")
    ap.add_argument("--moe_dispatch", choices=("xla", "pallas"), default="xla",
                    help="dataflow of the moe_e8 probe (moe_dispatch_ladder measures xla, a2a "
                    "and pallas side by side)")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (one card a rank; the default)")
    ap.add_argument("--serving_records", default="",
                    help="comma-separated keys of serving records: only these run, on rank 0, "
                    "printed as one JSON object by key (no headline or training record)")
    args = ap.parse_args(argv)
    keys = [k for k in args.serving_records.split(",") if k]
    unknown = sorted(set(keys) - {key for key, _, _ in SERVING_RECORDS})
    if unknown:
        ap.error(f"--serving_records: unknown {unknown}")
    from tpukit_torch import NotPortedError, mesh, resolve_device
    from tpukit_torch.flags import NOT_CARRIED

    if args.compilation_cache_dir:
        raise NotPortedError(f"--compilation_cache_dir is not carried: "
                             f"{NOT_CARRIED['compilation_cache_dir']}")
    device = resolve_device(args.device)
    with mesh.scoped_runtime():
        device = mesh.initialize_runtime(device)
        with contextlib.redirect_stdout(sys.stderr):  # stdout holds the one JSON line
            if keys:
                result = on_rank_zero(lambda: serving_records(
                    bench_config(), mesh.world_size(), device, keys))
            else:
                result = run(device, moe_dispatch=args.moe_dispatch)
        if mesh.rank() == 0:
            print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
