"""`python -m tpukit_torch.serve`: continuous-batching serving on one GPU
(the port of `main-serve.py`).

Serves a checkpoint (`--checkpoint PATH|latest`, any of the three formats
of `tpukit_torch.checkpoint`: the port's `.pt`, tpukit's consolidated
msgpack or sharded directory, whichever package wrote it) or, without one,
fresh seeded parameters, over a seeded synthetic request stream (or the
`--prompt`s given), and prints the throughput line of `main-serve.py`. A
checkpoint is verified first (a failed check raises; it is never replaced
by seeded weights) and restored params-only. Runs on cuda unless `--device
cpu` is given. `--page_size 0` (the default) serves from the ring KV
cache, `--page_size P` from pages of P positions; `--temperature`/`--top_k`
sample with each request's seeded key; `--draft ngram|model` decodes
speculatively on the ring (the draft model from `--draft_checkpoint PATH`,
or fresh seeded, shaped by the `--draft_*` flags).

The serving grid is tpukit's (`main-serve.py:251-265`): a dense model is
served by `TensorParallel` over `pick_serve_grid(world, heads, slots,
paged)` (heads over `model`, the ring's slots over `data`; paged serving
on a model-only grid), an MoE model with its parameters replicated over
the largest data degree that divides the slots. Launched by `torchrun`
(or `python -m torch.distributed.run ... --device cpu` on gloo ranks),
every rank of the grid serves the same stream in lockstep and rank 0
prints; ranks the grid leaves out wait. A plain run is a world of one.

Telemetry is on, as tpukit's defaults have it (`main-serve.py:418-431`): a
`kind="serve"` record every `--window_steps` decode steps and a
`kind="serve_summary"` at the end go to `--metrics_log` (a JSONL file that
`tools/report.py` reads); request traces (a ring of `--trace_capacity`
span events, flushed as `kind="trace_event"`/`"trace"` rows that
`tools/traceview.py` renders) unless `--no_trace`; the metrics plane
(latency histograms, counters, gauges, `kind="metrics"`, `--slo`'s
`kind="slo"` rows, snapshots in `--metrics_dir` that `tools/top.py`
reads) unless `--no_metrics`. `--slo` is parsed at launch, so a malformed
clause fails the start. On a grid only its first rank writes.

The fleet (`main-serve.py:500-760`): `--replicas N` routes the stream
through `serve.fleet.FleetRouter` over N replicas: engines in this process
on this device (`--devices_per_replica 0`) or replica i on `cuda:i`
(`--devices_per_replica 1`), or with `--devices_per_replica D` above 1
each replica on a `(data, model)` grid over its own D devices, a c10d
world of D rank processes (`serve/replica_world.py`; with `--device cpu`,
`TPUKIT_CPU_DEVICES` sizes the device list, as tpukit's). With
disaggregated prefill (`--disagg_prefill`), autoscale, the `--fleet_kill`
chaos plan, the durable ledger (`--fleet_dir`) with heartbeat liveness
(`--replica_timeout`), the retry budget, backpressure
(`--max_queue_depth`) and deadlines (`--deadline_ms`, which the single
engine honours too). `--fleet_procs` runs each replica as a worker process
(this entry point again, with `--fleet_worker i`) driven through the
ledger, where `replica_sigkill` chaos is a real SIGKILL; as tpukit's, a
worker serves meshless, on `cuda:i` with `--devices_per_replica 1` and on
this device otherwise. The checkpoint is read once and placed once a
device (once a subset). `kind="fleet"` windows, `fleet_event` rows and the
`fleet_summary` go to `--metrics_log` (`tools/report.py --min_fleet_tps`).

Every flag of `main-serve.py` parses with tpukit's default; a value other
than the default of one the port does not carry raises `NotPortedError`
naming its ROADMAP.md item (`NOT_CARRIED`).

  python -m tpukit_torch.serve --requests 64                  # ring, greedy
  python -m tpukit_torch.serve --checkpoint latest --page_size 16 --fused_decode
  python -m tpukit_torch.serve --temperature 0.8 --top_k 40   # sampled
  python -m tpukit_torch.serve --draft ngram --stream_profile repetitive
  python -m tpukit_torch.serve --draft model --draft_dim 64 --draft_num_layers 2 \\
      --draft_checkpoint draft/checkpoint-step000000100.msgpack
  python -m tpukit_torch.serve --num_experts 8 --moe_dispatch pallas --fused_decode \\
      --page_size 16
  python -m tpukit_torch.serve --device cpu --num_layers 2 --dim 64 \\
      --head_dim 16 --heads 4 --requests 8 --page_size 8 --fused_decode
  python -m tpukit_torch.serve --page_size 16 --fused_decode --metrics_log serve.jsonl \\
      --metrics_dir metrics --slo 'ttft<=250ms@p99;e2e<=2s@p99'
  torchrun --nproc_per_node 4 -m tpukit_torch.serve --page_size 16 --fused_decode
  python -m tpukit_torch.serve --replicas 2 --page_size 16 --fused_decode \\
      --fleet_kill replica_kill@8:1 --metrics_log fleet.jsonl
  python -m tpukit_torch.serve --replicas 2 --page_size 16 --disagg_prefill
  python -m tpukit_torch.serve --replicas 2 --devices_per_replica 4 --page_size 16 \\
      --fused_decode --fleet_kill replica_kill@40:1 --metrics_log fleet.jsonl
  TPUKIT_CPU_DEVICES=4 python -m tpukit_torch.serve --device cpu --replicas 2 \\
      --devices_per_replica 2 --num_layers 2 --dim 64 --head_dim 16 --heads 4 \\
      --requests 8 --page_size 8 --fused_decode
  python -m tpukit_torch.serve --replicas 2 --fleet_procs --fleet_dir fleet \\
      --replica_timeout 60 --fleet_kill replica_sigkill@6:1 --metrics_log fleet.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpukit_torch import NotPortedError, resolve_device

# main-serve.py flags the port parses but does not carry: name -> (argparse
# keywords with tpukit's default, the ROADMAP.md item)
NOT_CARRIED = {
    "compilation_cache_dir": (dict(type=str, default=""),
                              "item 18 'Tracing and metrics' (the eager port compiles no "
                              "programs to cache)"),
}


def build_parser() -> argparse.ArgumentParser:
    """`main-serve.py`'s parser (`parse_serve_flags`, with tpukit's
    `add_serve_flags` and `add_fleet_flags`), every flag with tpukit's
    default, plus `--device` and `--prompt`."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--head_dim", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--num_layers", type=int, default=8)
    ap.add_argument("--sequence_length", type=int, default=256,
                    help="position table size; the slot width (max bucket + "
                    "max_new_tokens, in whole pages when paged, + spec_k "
                    "under --draft) must fit")
    ap.add_argument("--disable_amp", action="store_true",
                    help="compute in f32 instead of bf16")
    ap.add_argument("--num_experts", type=int, default=0,
                    help="routed experts per layer (0: the dense model)")
    ap.add_argument("--moe_top_k", type=int, default=1)
    ap.add_argument("--moe_dispatch", choices=("xla", "pallas"), default="xla",
                    help="meshless decode dataflow of an MoE model; 'pallas' "
                    "(dropless, the grouped-expert kernels) makes the cached "
                    "decode exact")
    ap.add_argument("--checkpoint", type=str, default="",
                    help="path (.pt, .msgpack or .sharded directory) or 'latest' "
                    "(the newest good one in checkpoints/); empty serves fresh "
                    "seeded params. The shape flags must equal the training run's")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--buckets", type=str, default="16,32,64")
    ap.add_argument("--max_new_tokens", type=int, default=20)
    ap.add_argument("--decode_quantum", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 decodes greedily; above 0 samples with each "
                    "request's seeded key")
    ap.add_argument("--top_k", type=int, default=0,
                    help="sample among the k largest logits (0: all)")
    ap.add_argument("--page_size", type=int, default=0,
                    help="token positions per KV page (must divide every "
                    "bucket); 0 (the default) selects the ring cache")
    ap.add_argument("--num_pages", type=int, default=0)
    ap.add_argument("--kv_dtype", choices=("f32", "bf16", "int8"), default="f32")
    ap.add_argument("--prefill_chunk", type=int, default=0)
    ap.add_argument("--fused_decode", action="store_true",
                    help="decode ticks run the CUDA paged-attention kernel "
                    "(its plain PyTorch version on the CPU)")
    ap.add_argument("--window_steps", type=int, default=32,
                    help="decode steps per kind=\"serve\" JSONL window")
    ap.add_argument("--metrics_log", type=str, default="",
                    help="the JSONL file of the run's records (tools/report.py)")
    ap.add_argument("--no_trace", action="store_true",
                    help="disable request-scoped span tracing (kind=\"trace_event\"/"
                    "\"trace\" rows, per-phase latency percentiles, tools/traceview.py)")
    ap.add_argument("--trace_capacity", type=int, default=8192,
                    help="span events the trace ring keeps (the oldest are evicted, "
                    "and an evicted event leaves its request's tree incomplete)")
    ap.add_argument("--no_metrics", action="store_true",
                    help="disable the metrics plane (latency histograms, "
                    "kind=\"metrics\"/\"slo\" rows, snapshot files, tools/top.py)")
    ap.add_argument("--slo", type=str, default="",
                    help="service objectives, e.g. \"ttft<=250ms@p99;tpot<=40ms@p95;"
                    "e2e<=2s@p99\", parsed at launch; each window writes each target's "
                    "compliance and error-budget burn as kind=\"slo\" rows")
    ap.add_argument("--metrics_dir", type=str, default="",
                    help="directory of the metric snapshot files (metrics-pNNNNN.json) "
                    "and their merge with its OpenMetrics text (tools/top.py)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=0.0)
    ap.add_argument("--shared_prefix", type=int, default=0)
    ap.add_argument("--stream_profile", default="uniform",
                    choices=("uniform", "repetitive", "shared_prefix"))
    ap.add_argument("--prompt", action="append", default=None,
                    help="serve these prompts (repeat the flag), one request each, "
                    "in place of the synthetic stream, and print every completion")
    ap.add_argument("--draft", choices=("", "ngram", "model"), default="",
                    help="speculative decoding on the ring: 'ngram' "
                    "self-speculation or a draft 'model'")
    ap.add_argument("--spec_k", type=int, default=4,
                    help="draft tokens proposed per slot per verify")
    ap.add_argument("--ngram_max", type=int, default=3,
                    help="longest n-gram the self-speculation proposer matches")
    ap.add_argument("--draft_checkpoint", type=str, default="",
                    help="checkpoint PATH of the --draft model (no 'latest'); "
                    "empty serves fresh seeded draft params")
    ap.add_argument("--draft_dim", type=int, default=64)
    ap.add_argument("--draft_head_dim", type=int, default=16)
    ap.add_argument("--draft_heads", type=int, default=4)
    ap.add_argument("--draft_num_layers", type=int, default=2)
    add_fleet_flags(ap)
    for name, (kw, _) in NOT_CARRIED.items():
        ap.add_argument(f"--{name}", **kw)
    return ap


def add_fleet_flags(ap: argparse.ArgumentParser) -> None:
    """tpukit's `add_fleet_flags` (`tpukit/flags.py:478-561`), the same
    names and defaults."""
    ap.add_argument("--replicas", type=int, default=0,
                    help="fleet mode: route the stream over this many engine replicas "
                    "(0: the single engine)")
    ap.add_argument("--devices_per_replica", type=int, default=0,
                    help="0: every replica on --device; 1: replica i on cuda:i; D > 1: "
                    "replica i on a (data, model) grid over its D devices, a world of "
                    "D processes")
    ap.add_argument("--min_replicas", type=int, default=1,
                    help="autoscale floor (scale-down never goes below)")
    ap.add_argument("--max_replicas", type=int, default=0,
                    help="autoscale ceiling; 0: --replicas (no scale-up headroom)")
    ap.add_argument("--scale_up_occupancy", type=float, default=0.0,
                    help="mean fleet slot occupancy above which a window scales up "
                    "(0 disables)")
    ap.add_argument("--scale_down_occupancy", type=float, default=0.0,
                    help="mean fleet slot occupancy below which an idle-queue window "
                    "drains one replica (0 disables)")
    ap.add_argument("--fleet_window_steps", type=int, default=16,
                    help="dispatch rounds a kind=\"fleet\" window (and autoscale check)")
    ap.add_argument("--disagg_prefill", action="store_true",
                    help="a prefill worker runs the chunked prefill and hands finished "
                    "prefixes to decode replicas as pages (needs --page_size)")
    ap.add_argument("--prefill_slots", type=int, default=0,
                    help="prefill worker lanes (0: --slots)")
    ap.add_argument("--prefill_pages", type=int, default=0,
                    help="prefill worker pool pages (0: the --num_pages default)")
    ap.add_argument("--fleet_kill", type=str, default="",
                    help="serving chaos: replica_kill@R[:idx], replica_sigkill@R[:idx] "
                    "(a real SIGKILL under --fleet_procs), slow_replica@R:ms, "
                    "stuck_request@N (pair with --deadline_ms), ledger_io_fail@k:c")
    ap.add_argument("--fleet_dir", type=str, default="",
                    help="the durable request ledger (write-ahead leases, exactly-once "
                    "completion records, replay on restart) and the heartbeat files")
    ap.add_argument("--replica_timeout", type=float, default=0.0,
                    help="declare a replica dead when its heartbeat is older than this "
                    "many seconds (0 disables; needs --fleet_dir)")
    ap.add_argument("--request_retries", type=int, default=3,
                    help="reassignments a request survives after replica deaths")
    ap.add_argument("--max_queue_depth", type=int, default=0,
                    help="shed arrived requests beyond this depth, lowest priority first "
                    "(0: unbounded)")
    ap.add_argument("--deadline_ms", type=float, default=0.0,
                    help="every request's end-to-end deadline: a lane past it is evicted "
                    "with its partial tokens (reason \"deadline\"; 0: none)")
    ap.add_argument("--fleet_procs", action="store_true",
                    help="run each replica as a worker process driven through the ledger "
                    "(needs --fleet_dir)")
    ap.add_argument("--fleet_worker", type=int, default=-1,
                    help="internal: the replica id of a --fleet_procs worker process")


def parse_flags(argv=None):
    return build_parser().parse_args(argv)


def _reject_unported(flags) -> None:
    for name, (kw, item) in NOT_CARRIED.items():
        value = getattr(flags, name)
        if value != kw.get("default", False):
            raise NotPortedError(
                f"--{name} {value!r} is not in the port yet (ROADMAP.md, queue A {item})")


def _restore(path, cfg, device, what: str, shape_flags: str):
    """Verify, then restore the parameters of `cfg`'s model from `path`."""
    from tpukit_torch import checkpoint as ckpt_lib
    from tpukit_torch.model import init_params

    ok, detail = ckpt_lib.verify_checkpoint(path)
    if not ok:
        raise RuntimeError(f"{what} {path}: failed integrity verification ({detail})")
    try:
        return ckpt_lib.restore_params(path, init_params(cfg, device="meta"), device)
    except ValueError as exc:
        raise ValueError(
            f"{what} {path}: state structure does not match the {shape_flags} must equal "
            f"the training run's). Original error: {exc}") from exc


_MODEL_FLAGS = "model flags (--dim/--heads/--num_layers/--num_experts..."


def _model_config(flags, tokenizer):
    from tpukit_torch.model import GPTConfig

    return GPTConfig(
        dim=flags.dim, head_dim=flags.head_dim, heads=flags.heads,
        num_layers=flags.num_layers, vocab_size=tokenizer.vocab_size,
        max_position_embeddings=flags.sequence_length,
        compute_dtype=torch.float32 if flags.disable_amp else torch.bfloat16,
        num_experts=flags.num_experts, router_top_k=flags.moe_top_k,
        moe_dispatch=flags.moe_dispatch if flags.num_experts > 0 else "xla",
    )


def _serve_config(flags):
    from tpukit_torch.serve.engine import ServeConfig

    return ServeConfig(
        slots=flags.slots, buckets=tuple(sorted({int(b) for b in flags.buckets.split(",") if b})),
        max_new_tokens=flags.max_new_tokens, temperature=flags.temperature,
        top_k=flags.top_k, window_steps=flags.window_steps,
        decode_quantum=flags.decode_quantum, page_size=flags.page_size,
        num_pages=flags.num_pages, kv_dtype=flags.kv_dtype,
        prefill_chunk=flags.prefill_chunk, fused_decode=flags.fused_decode,
        draft=flags.draft, spec_k=flags.spec_k, ngram_max=flags.ngram_max,
    )


def _checkpoint_path(flags):
    from tpukit_torch import checkpoint as ckpt_lib

    path = ckpt_lib.latest_any() if flags.checkpoint == "latest" else Path(flags.checkpoint)
    if path is None:
        raise FileNotFoundError("--checkpoint latest: no checkpoint found")
    return path


def _requests(flags, tokenizer, buckets) -> list:
    """The `--prompt`s, or the seeded synthetic stream, each request with
    `--deadline_ms` (tpukit's `_apply_request_knobs`, `main-serve.py:500`)."""
    from tpukit_torch.serve.engine import Request, synthetic_request_stream

    if flags.prompt:
        encoded = tokenizer(list(flags.prompt))["input_ids"]
        requests = [Request(rid=i, ids=tuple(int(t) for t in ids[: max(buckets)]),
                            max_new_tokens=flags.max_new_tokens, seed=flags.seed)
                    for i, ids in enumerate(encoded)]
    else:
        requests = synthetic_request_stream(
            tokenizer, flags.requests, seed=flags.seed,
            max_new_tokens=flags.max_new_tokens, buckets=buckets, qps=flags.qps,
            shared_prefix=flags.shared_prefix, stream_profile=flags.stream_profile,
        )
    if flags.deadline_ms:
        requests = [dataclasses.replace(r, deadline_ms=flags.deadline_ms) for r in requests]
    return requests


def serving_grid(flags, world: int, announce: bool = True) -> dict:
    """tpukit's serving grid (`main-serve.py:251-265`): for a dense model
    `pick_serve_grid`'s; for an MoE model data-only, the largest degree
    that divides the slots."""
    from tpukit_torch.serve.fleet import pick_serve_grid

    if flags.num_experts > 0:
        data = world
        while data > 1 and flags.slots % data:
            data -= 1
        return {"data": data, "model": 1}
    return pick_serve_grid(world, flags.heads, flags.slots, paged=flags.page_size > 0,
                           announce=announce)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = parse_flags(argv)
    _reject_unported(flags)
    from tpukit_torch import mesh as mesh_lib
    from tpukit_torch.obs import parse_slo

    # a malformed objective fails the launch, not the first window
    slo = parse_slo(flags.slo) if flags.slo else None

    device = resolve_device(flags.device)
    if flags.replicas > 0:
        return _run_fleet(flags, argv, device, slo)
    with mesh_lib.scoped_runtime():  # a world brought up here ends here
        device = mesh_lib.initialize_runtime(device)
        grid = serving_grid(flags, mesh_lib.world_size(), announce=mesh_lib.is_process_zero())
        grid_mesh = mesh_lib.create_tp_mesh(grid["data"], grid["model"], device.type,
                                            idle_ok=True)
        if grid_mesh.get_coordinate() is not None:
            _serve(flags, device, grid_mesh, slo)
        mesh_lib.sync_global_devices()
    return 0


def _serve(flags, device, grid_mesh, slo) -> None:
    """Serve on this rank's place of `grid_mesh`; the grid's first rank
    prints and alone gets the logger's path, the tracer, the registry and
    the snapshot directory (it publishes as process 0)."""
    from tpukit_torch import checkpoint as ckpt_lib
    from tpukit_torch import mesh as mesh_lib
    from tpukit_torch import reshard as reshard_lib
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.model import GPTConfig, init_params
    from tpukit_torch.obs import FlightRecorder, MetricRegistry, StepLogger, TraceRecorder
    from tpukit_torch.serve.engine import ServeEngine
    from tpukit_torch.shardings import DataParallel, SingleDevice, TensorParallel

    p0 = mesh_lib.is_process_zero()
    show = print if p0 else (lambda *a, **k: None)
    logger = StepLogger(flags.metrics_log if p0 else "")
    recorder = FlightRecorder()
    tokenizer = get_tokenizer()
    cfg = _model_config(flags, tokenizer)
    strategy = None if cfg.num_experts > 0 else TensorParallel(mesh=grid_mesh)
    if strategy is not None:
        strategy.validate_config(cfg)
    serve = _serve_config(flags)
    buckets = serve.buckets
    if flags.checkpoint:
        path = _checkpoint_path(flags)
        params, info = _restore(path, cfg, device, "--checkpoint", _MODEL_FLAGS)
        placement = strategy
        if placement is None:  # an MoE model, replicated over the grid's data ranks
            placement = SingleDevice()
            if grid_mesh.size(0) > 1:
                placement = DataParallel()
                placement.mesh = grid_mesh  # the grid's axes, for the record
        world = reshard_lib.current_world(placement)
        mismatch = reshard_lib.describe_mismatch(reshard_lib.saved_world(path), world)
        logger.log(kind="ckpt_restore", params_only=True, checkpoint=str(path),
                   mismatch=mismatch or "", world=world, **info)
        recorder.record("ckpt_restore", params_only=True, mismatch=mismatch or "")
        step, skipped = ckpt_lib._step_of(path), info["bytes_skipped"]
        show(f"serving checkpoint {path} (" + (f"step {step}, " if step >= 0 else "")
             + f"params-only restore: {info['bytes_read']} B read"
             + (f", {skipped} B of opt state skipped" if skipped else "") + ")")
    else:
        params = init_params(cfg, seed=flags.seed, device=device)
        show(f"serving fresh seeded params (no --checkpoint) on {device}")
    show(f"serving grid: data {grid_mesh.size(0)} x model {grid_mesh.size(1)} ("
         + ("TensorParallel" if strategy is not None else "MoE, replicated") + ")")
    if strategy is not None:
        params = strategy.setup(params)
    draft_params = draft_cfg = None
    if flags.draft == "model":
        draft_cfg = GPTConfig(
            dim=flags.draft_dim, head_dim=flags.draft_head_dim, heads=flags.draft_heads,
            num_layers=flags.draft_num_layers, vocab_size=tokenizer.vocab_size,
            max_position_embeddings=flags.sequence_length, compute_dtype=cfg.compute_dtype,
        )
        if flags.draft_checkpoint == "latest":
            raise ValueError(
                "--draft_checkpoint takes an explicit path: 'latest' would resolve through "
                "the same checkpoint directory as --checkpoint latest and pick the "
                "identical (newest) save for both models")
        if flags.draft_checkpoint:
            d_path = Path(flags.draft_checkpoint)
            draft_params, d_info = _restore(
                d_path, draft_cfg, device, "--draft_checkpoint",
                "draft shape flags (--draft_dim/--draft_heads/--draft_num_layers...")
            logger.log(kind="ckpt_restore", params_only=True, draft=True,
                       checkpoint=str(d_path), **d_info)
            recorder.record("ckpt_restore", params_only=True, draft=True)
            show(f"draft model {d_path} (params-only restore: {d_info['bytes_read']} B read)")
        else:
            draft_params = init_params(draft_cfg, seed=flags.seed, device=device)
            show("draft model: fresh seeded params (no --draft_checkpoint)")
    tracer = None if flags.no_trace or not p0 else TraceRecorder(capacity=flags.trace_capacity)
    metrics = None if flags.no_metrics or not p0 else MetricRegistry()
    engine = ServeEngine(params, cfg, serve, eos_id=int(tokenizer.eos_token_id),
                         device=device, draft_params=draft_params, draft_cfg=draft_cfg,
                         mesh=grid_mesh, logger=logger, recorder=recorder, tracer=tracer,
                         metrics=metrics, slo=slo,
                         metrics_dir=(flags.metrics_dir or None) if p0 else None)
    requests = _requests(flags, tokenizer, buckets)
    t0 = time.perf_counter()
    completions = engine.run(requests)
    wall = time.perf_counter() - t0
    s = engine.last_summary
    gen = sum(c.generated for c in completions)
    show(f"served {len(completions)} requests / {gen} tokens in "
         f"{wall:.2f}s ({gen / wall:.1f} tokens/s, occupancy "
         f"{100 * s['mean_occupancy']:.0f}%), {engine.steps} decode ticks")
    if serve.paged:
        show(f"paged KV: {s['num_pages']} pages x {s['page_size']} tokens "
             f"({s['kv_dtype']}), prefix hits {s['prefix_hits']}/{s['admitted']} "
             f"admissions, {s['prefix_pages_reused']} pages of prefill skipped")
    else:
        show(f"ring KV: {serve.slots} slots x {serve.kv_width} positions "
             f"({s['kv_bytes']} bytes)")
    if serve.draft:
        sp = s["spec"]
        rate = sp["accept_rate"]
        show(f"speculative decoding ({serve.draft}, k={serve.spec_k}): accepted "
             f"{sp['accepted']}/{sp['proposed']} draft tokens"
             + (f" ({100 * rate:.0f}%)" if rate is not None else "")
             + f", appended/verify histogram {sp['accepted_hist']}")
    e2e = sorted(c.e2e_s for c in completions)
    if e2e:
        show(f"e2e latency p50 {1e3 * e2e[len(e2e) // 2]:.1f} ms  "
             f"p99 {1e3 * e2e[min(len(e2e) - 1, int(len(e2e) * 0.99))]:.1f} ms")
    if s.get("trace_complete") is not None:
        show(f"traces: {100 * s['trace_complete']:.0f}% complete span trees; phase p50 (ms) "
             + "  ".join(f"{k} {1e3 * v:.1f}" for k, v in (s.get("phase_p50") or {}).items()
                         if v)
             + (f" (view: python tools/traceview.py {flags.metrics_log})"
                if flags.metrics_log else ""))
    if s.get("trace_dropped"):
        show(f"WARNING: {s['trace_dropped']} trace events evicted (ring saturated) — phase "
             f"aggregates above are built from an incomplete history; grow --trace_capacity")
    if s.get("slo_overall_compliance") is not None:
        show(f"SLO compliance {100 * s['slo_overall_compliance']:.2f}% (worst target, "
             f"cumulative) for --slo {flags.slo!r}")
    if flags.metrics_dir:
        show(f"metric snapshots -> {flags.metrics_dir} (live: python tools/top.py "
             f"{flags.metrics_dir}" + (f" --log {flags.metrics_log}" if flags.metrics_log
                                       else "") + ")")
    shown = sorted(completions, key=lambda c: c.rid)
    for c in shown if flags.prompt else shown[:3]:
        show(f"  [{c.rid}] " + tokenizer.decode(np.asarray(c.ids),
                                                 skip_special_tokens=True))
    if flags.metrics_log:
        show(f"serve telemetry -> {flags.metrics_log} (render: python tools/report.py "
             f"{flags.metrics_log})")
    logger.close()



# ---- the fleet (main-serve.py:500-760) --------------------------------------


def _replica_device(flags, device, idx: int) -> torch.device:
    """A worker process's device: `cuda:idx` with `--devices_per_replica 1`
    on the card, else the entry point's (tpukit's worker serves meshless on
    the default device whatever `--devices_per_replica` says,
    `main-serve.py:540-562`)."""
    if flags.devices_per_replica == 1 and device.type == "cuda":
        if idx >= torch.cuda.device_count():
            raise ValueError(f"--devices_per_replica 1: replica {idx} needs cuda:{idx}, "
                             f"have {torch.cuda.device_count()} card(s)")
        return torch.device("cuda", idx)
    return device


def _run_fleet(flags, argv, device, slo) -> int:
    """Fleet serving: the worker (`--fleet_worker`) and process-fleet
    (`--fleet_procs`) modes, else `FleetRouter` over `--replicas` engines in
    this process. The checkpoint is read once, to the host, and placed once
    a device; fresh seeded parameters are made on `device`, as the single
    engine's are."""
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.model import init_params
    from tpukit_torch.obs import FlightRecorder, MetricRegistry, StepLogger, TraceRecorder
    from tpukit_torch.serve.fleet import FleetConfig, FleetRouter

    tokenizer = get_tokenizer()
    cfg = _model_config(flags, tokenizer)
    serve = _serve_config(flags)
    if flags.fleet_worker >= 0:
        return _run_fleet_worker(flags, cfg, serve, tokenizer, device)
    if flags.fleet_procs:
        return _run_fleet_procs(flags, argv, tokenizer, serve)
    if flags.draft == "model":
        raise ValueError(
            "--replicas with --draft model is a future round (the draft "
            "params would need their own per-replica placement); "
            "--draft ngram (self-speculation, no second model) runs per "
            "replica today")
    fleet = FleetConfig(
        replicas=flags.replicas, devices_per_replica=flags.devices_per_replica,
        min_replicas=flags.min_replicas, max_replicas=flags.max_replicas,
        scale_up_occupancy=flags.scale_up_occupancy,
        scale_down_occupancy=flags.scale_down_occupancy,
        window_steps=flags.fleet_window_steps, disagg_prefill=flags.disagg_prefill,
        prefill_slots=flags.prefill_slots, prefill_pages=flags.prefill_pages,
        kill_spec=flags.fleet_kill, fleet_dir=flags.fleet_dir,
        replica_timeout=flags.replica_timeout, request_retries=flags.request_retries,
        max_queue_depth=flags.max_queue_depth,
    )
    logger = StepLogger(flags.metrics_log)
    recorder = FlightRecorder()
    path = info = None
    if flags.checkpoint:
        path = _checkpoint_path(flags)
        params, info = _restore(path, cfg, torch.device("cpu"), "--checkpoint", _MODEL_FLAGS)
    else:
        params = init_params(cfg, seed=flags.seed, device=device)
        print(f"serving fresh seeded params (no --checkpoint) on {device}")
    # one tracer and one registry for the router and every replica
    tracer = None if flags.no_trace else TraceRecorder(capacity=flags.trace_capacity)
    metrics = None if flags.no_metrics else MetricRegistry()
    router = FleetRouter(params, cfg, serve, fleet, eos_id=int(tokenizer.eos_token_id),
                         device=device, logger=logger, recorder=recorder, tracer=tracer,
                         metrics=metrics, slo=slo, metrics_dir=flags.metrics_dir or None)
    if path is not None:
        logger.log(kind="ckpt_restore", params_only=True, fleet=True, checkpoint=str(path),
                   replicas=flags.replicas, placements=router.placements, **info)
        recorder.record("ckpt_restore", params_only=True, fleet=True,
                        placements=router.placements)
        print(f"fleet cold start from {path}: {info['bytes_read']} B read ONCE, "
              f"{router.placements} placement(s) for {flags.replicas} replica(s)"
              + (" + prefill worker" if fleet.disagg_prefill else ""))
    requests = _requests(flags, tokenizer, serve.buckets)
    t0 = time.perf_counter()
    completions = router.run(requests)
    wall = time.perf_counter() - t0
    s = router.last_summary
    gen = sum(c.generated for c in completions)
    print(f"fleet served {len(completions)} requests / {gen} tokens in {wall:.2f}s "
          f"({gen / wall:.1f} tokens/s) over {s['replicas_final']} replica(s) "
          f"(peak {s['replicas_peak']})")
    if s["kills"] or s["requeued"]:
        print(f"  failures: {s['kills']} replica kill(s) ({s['replicas_dead']} by liveness), "
              f"{s['leases_revoked']} lease(s) revoked, {s['requeued']} request(s) "
              f"re-queued, {s['duplicate_completions']} duplicate completion(s)")
    if s["deadline_misses"] or s["rejected"] or s["request_failures"]:
        print(f"  requests: {s['deadline_misses']} deadline miss(es), {s['rejected']} shed "
              f"by backpressure, {s['request_failures']} terminal failure(s)")
    if s.get("ledger"):
        led = s["ledger"]
        print(f"  ledger: {led['completed']} durable completion record(s), "
              f"{led['replayed']} replayed, {led['duplicates']} duplicate(s) "
              f"-> {flags.fleet_dir}")
    if s["scale_ups"] or s["scale_downs"]:
        print(f"  autoscale: {s['scale_ups']} up / {s['scale_downs']} down")
    if fleet.disagg_prefill:
        d = s["disagg_prefill"]
        print(f"  disaggregated prefill: {d['handoffs']} handoffs, "
              f"{d['worker_prefix_hits']} worker prefix hits, {d['worker_pages_reused']} "
              f"pages of prefill skipped")
    if s["p50_e2e_s"] is not None:
        print(f"  e2e latency p50 {1e3 * s['p50_e2e_s']:.1f} ms  "
              f"p99 {1e3 * s['p99_e2e_s']:.1f} ms")
    if s.get("trace_complete") is not None:
        print(f"  traces: {100 * s['trace_complete']:.0f}% complete span trees; phase p50 "
              f"(ms) " + "  ".join(f"{k} {1e3 * v:.1f}"
                                   for k, v in (s.get("phase_p50") or {}).items() if v))
    if s.get("trace_dropped"):
        print(f"  WARNING: {s['trace_dropped']} trace events evicted (per replica "
              f"{s['trace_dropped_by_replica']}) — grow --trace_capacity")
    if s.get("slo_overall_compliance") is not None:
        print(f"  SLO compliance {100 * s['slo_overall_compliance']:.2f}% (worst target, "
              f"cumulative) for --slo {flags.slo!r}")
    for c in sorted(completions, key=lambda c: c.rid) if flags.prompt else ():
        print(f"  [{c.rid}] " + tokenizer.decode(np.asarray(c.ids), skip_special_tokens=True))
    if flags.metrics_log:
        print(f"fleet telemetry -> {flags.metrics_log} (render: python tools/report.py "
              f"{flags.metrics_log})")
    logger.close()
    return 0


def _run_fleet_worker(flags, cfg, serve, tokenizer, device) -> int:
    """`--fleet_worker i` (set by the `--fleet_procs` supervisor): ONE
    replica engine as a process of its own, driven through the ledger under
    `--fleet_dir` (`ledger.serve_from_ledger`). It makes or restores its own
    parameters (processes share no memory) and writes no JSONL."""
    from tpukit_torch.model import init_params
    from tpukit_torch.serve.engine import ServeEngine
    from tpukit_torch.serve.ledger import serve_from_ledger

    idx = flags.fleet_worker
    device = _replica_device(flags, device, idx)
    if device.index is not None:
        torch.cuda.set_device(device)  # the kernels launch on the current device
    if flags.checkpoint:
        params, _ = _restore(_checkpoint_path(flags), cfg, device, "--checkpoint",
                             _MODEL_FLAGS)
    else:
        params = init_params(cfg, seed=flags.seed, device=device)
    engine = ServeEngine(params, cfg, serve, eos_id=int(tokenizer.eos_token_id),
                         device=device, replica=idx)
    comps = serve_from_ledger(engine, flags.fleet_dir, idx)
    print(f"fleet worker {idx}: {len(comps)} completion(s) published")
    return 0


def _run_fleet_procs(flags, argv, tokenizer, serve) -> int:
    """`--fleet_procs`: each replica a worker process (this entry point with
    `--fleet_worker i`), coordinated only through the ledger under
    `--fleet_dir`; `replica_sigkill` chaos delivers a real SIGKILL, and
    process exit or heartbeat age revokes the victim's leases."""
    from tpukit_torch import chaos as chaos_lib
    from tpukit_torch.obs import FlightRecorder, StepLogger
    from tpukit_torch.serve.ledger import ProcessFleet

    if not flags.fleet_dir:
        raise ValueError(
            "--fleet_procs requires --fleet_dir: the ledger directory is "
            "the only channel between supervisor and worker processes")
    logger = StepLogger(flags.metrics_log)
    recorder = FlightRecorder()
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)

    def spawn(idx):
        return subprocess.Popen([sys.executable, "-m", "tpukit_torch.serve", *argv,
                                 "--fleet_worker", str(idx)], env=env)

    fleet = ProcessFleet(
        flags.fleet_dir, spawn=spawn, replicas=flags.replicas,
        replica_timeout=flags.replica_timeout or 5.0, request_retries=flags.request_retries,
        chaos=chaos_lib.ServingChaos(flags.fleet_kill), logger=logger, recorder=recorder)
    rec = fleet.run(_requests(flags, tokenizer, serve.buckets))
    print(f"process fleet served {rec['requests']} requests / {rec['generated_tokens']} "
          f"tokens in {rec['wall_s']:.2f}s over {flags.replicas} worker process(es)")
    if rec["replicas_dead"] or rec["kills"]:
        print(f"  failures: {rec['kills']} SIGKILL(s), {rec['replicas_dead']} replica "
              f"death(s), {rec['leases_revoked']} lease(s) revoked, {rec['requeued']} "
              f"request(s) re-queued, {rec['duplicate_completions']} duplicate completion(s)")
    if rec["request_failures"] or rec["deadline_misses"]:
        print(f"  requests: {rec['request_failures']} terminal failure(s), "
              f"{rec['deadline_misses']} deadline miss(es)")
    if rec["retry_total"]:
        print(f"  {rec['retry_total']} transient I/O error(s) retried")
    if flags.metrics_log:
        print(f"fleet telemetry -> {flags.metrics_log} (render: python tools/report.py "
              f"{flags.metrics_log})")
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
