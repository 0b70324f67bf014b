"""`python -m tpukit_torch.analysis`: lint the c10d calls of the port's
audited worlds against their comm plans (twin of `tools/hlolint.py`'s
`--world N` mode).

    python -m tpukit_torch.analysis --world 2 --device cpu [--worlds ddp_int8,...]
        [--out findings.jsonl] [--waive overlap]

`--world N` runs N ranks (gloo on the CPU, `--device cpu`; NCCL, one rank a
card, otherwise) and in each builds tpukit's audited worlds (`WORLDS`,
`tools/hlolint.py:67-96`) that the port has, at the shapes of tpukit's
dryrun: one train step of DDP and FSDP at f32 and int8, the EP exchange at
f32 and int8, the bucketed int8 wires that declare overlap (`*_overlap`),
the interleaved pipeline and its MoE twin; one decode step of the serving
grid on the ring, the paged cache, the fused paged kernel, the speculative
verify, and a fleet replica's. Each step runs under
`comm_ir.record_comm`, and `rules.lint_trace` holds its trace to the plan
(`plan.train_comm_plan`, `decode_comm_plan`, `fleet_decode_comm_plan`).
Every rank lints its own trace; rank 0 writes the findings of all as
`kind="hlolint"` JSONL (stdout, or `--out`) with `world` and `rank`, which
`tools/report.py` renders. Any error finding exits 1. For a world that
declares overlap, rank 0 also prints each collective's backward ops left
at its issue (`CommTrace.backward_left`, what the gate reads) to stderr.

tpukit's `--hlo` fixture mode and its `sched_loop` world have no
counterpart: the port has no HLO, and its decode window runs on the host
(the parked on-device window).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

WORLDS = (
    "ddp_f32", "ddp_int8", "fsdp_f32", "fsdp_int8",
    "ep_a2a", "ep_int8", "tp_decode", "paged_decode", "spec_verify",
    "ddp_overlap", "fsdp_overlap", "ep_overlap",
    "fleet_decode", "paged_fused",
    "pipe_interleave", "pipe_moe",
)
DECODE_WORLDS = ("tp_decode", "paged_decode", "spec_verify", "fleet_decode", "paged_fused")


def _dryrun_cfg(comm_dtype="f32", num_experts=0, grad_buckets=0):
    """tpukit's `_dryrun_cfg` (`tools/hlolint.py:99`)."""
    import torch

    from tpukit_torch.model import GPTConfig

    return GPTConfig(dim=64, head_dim=16, heads=8, num_layers=4, vocab_size=128,
                     max_position_embeddings=32, compute_dtype=torch.float32,
                     comm_dtype=comm_dtype, num_experts=num_experts,
                     grad_buckets=grad_buckets)


def train_strategy(name: str, world: int):
    """(strategy, cfg) of train world `name` on `world` ranks."""
    from tpukit_torch.ops.moe_dispatch import ExpertGrid
    from tpukit_torch.pipeline import Pipeline1F1B
    from tpukit_torch.shardings import FSDP, DataParallel, ExpertParallel

    overlap = name.endswith("overlap")
    comm = "f32" if name.endswith("f32") or name == "ep_a2a" else "int8"
    if name.startswith("pipe"):
        stages = 4 if world % 4 == 0 else world
        cfg = _dryrun_cfg(num_experts=4 if name == "pipe_moe" else 0).replace(
            num_layers=8, virtual_stages=2)
        if name == "pipe_moe":
            # a stage-only grid, as tpukit's (its a2a-free guard)
            return Pipeline1F1B(num_microbatches=4, moe_dispatch="pallas",
                                stages=stages), cfg
        return Pipeline1F1B(num_microbatches=4, data=world // stages, stages=stages), cfg
    if name.startswith("ep"):
        inner = next((s for s in (4, 2) if world % s == 0), 1)
        cfg = _dryrun_cfg(comm_dtype=comm, num_experts=2 * inner,
                          grad_buckets=4 if overlap else 0)
        return ExpertParallel(ExpertGrid(data=world // inner, expert=inner)), cfg
    cfg = _dryrun_cfg(comm_dtype=comm, grad_buckets=4 if overlap else 0)
    return (DataParallel() if name.startswith("ddp") else FSDP()), cfg


def _train_world(name: str, world: int, device) -> dict:
    import numpy as np
    import torch

    from tpukit_torch.analysis import comm_ir, train_comm_plan
    from tpukit_torch.model import gpt
    from tpukit_torch.train import create_train_state, train_step

    strategy, cfg = train_strategy(name, world)
    strategy.validate_config(cfg)
    params = gpt.init_params(cfg, seed=0, device=device)
    state = create_train_state(params, 1e-3, strategy, cfg)
    seq = 16 if 16 % world == 0 else world
    divisor = strategy.batch_divisor
    batch_n = -(-8 // divisor) * divisor
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(batch_n, seq)).astype(np.int32)
    shards, shard = strategy.row_shards, strategy.row_shard()
    rows = slice(shard * batch_n // shards, (shard + 1) * batch_n // shards)
    batch = {"input_ids": torch.from_numpy(ids[rows]).to(device),
             "position_ids": torch.arange(seq, dtype=torch.int32, device=device).expand(
                 rows.stop - rows.start, seq).contiguous(),
             "mask": torch.zeros((rows.stop - rows.start, seq), dtype=torch.bool,
                                 device=device)}
    targets = torch.from_numpy(np.roll(ids, -1, axis=1)[rows]).to(device)  # int32: the CE kernel's
    with comm_ir.record_comm() as trace:
        train_step(state, cfg, strategy, batch, targets)
    plan = train_comm_plan(strategy, cfg, params=state.params, global_batch=batch_n, seq=seq)
    return {"name": name, "trace": trace, "plan": plan}


def _decode_world(name: str, world: int, device) -> dict:
    import torch

    from tpukit_torch import mesh as mesh_lib
    from tpukit_torch.analysis import comm_ir, decode_comm_plan, fleet_decode_comm_plan
    from tpukit_torch.model import GPTConfig, gpt
    from tpukit_torch.serve import decode as serve_decode
    from tpukit_torch.serve import spec as spec_lib
    from tpukit_torch.serve.engine import ServeConfig, ServeEngine
    from tpukit_torch.shardings import TensorParallel

    fused = name == "paged_fused"
    paged = name == "paged_decode" or fused
    spec = name == "spec_verify"
    fleet = name == "fleet_decode"
    cfg = GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=160,
                    max_position_embeddings=64, compute_dtype=torch.float32)
    slots, width, page, spec_k = 4, 24, 8, 3
    if fleet or world == 1:
        grid, model, data = None, 1, 1
    else:
        # tpukit's grids at 8 devices: paged on model alone, the ring on
        # data x model
        model = world if paged or world % 4 else world // 2
        data = world // model
        grid = mesh_lib.create_tp_mesh(data, model, device.type)
    params = gpt.init_params(cfg, seed=0, device=device)
    if grid is not None:
        params = TensorParallel(mesh=grid).setup(params)
    serve = ServeConfig(slots=slots, max_new_tokens=width - 16, buckets=(16,),
                        page_size=page if paged else 0, fused_decode=fused,
                        draft="ngram" if spec else "", spec_k=spec_k)
    if fleet:
        # the second replica of a two-replica fleet: the standalone engine's
        # step on its own device; the router adds no collective
        from tpukit_torch.serve.fleet import FleetConfig, FleetRouter

        router = FleetRouter(gpt.init_params(cfg, seed=0, device="cpu"), cfg, serve,
                             FleetConfig(replicas=2), eos_id=0, device=device)
        engine = router._replicas[1]
    else:
        engine = ServeEngine(params, cfg, serve, eos_id=0, device=device, mesh=grid)
    engine.cursors.fill_(5)
    engine.active.fill_(True)
    engine.limits.fill_(12)
    if paged:  # slot s holds pages [s mp + 1, (s + 1) mp]; page 0 is the null page
        bt = engine.cache["bt"]
        bt.copy_(torch.arange(1, bt.numel() + 1, dtype=torch.int32, device=device).view_as(bt))
    args = (engine.params, engine.cfg, engine.buf, engine.cache, engine.cursors, engine.active,
            engine.limits, engine.keys, engine.eos_id, 0.0, 0)
    with comm_ir.record_comm() as trace:
        if spec:
            spec_lib.spec_ngram_step(*args, k=spec_k, max_ngram=3)
        else:
            serve_decode.decode_step(*args)
    tp_mesh = {"data": data, "model": model}
    plan = (fleet_decode_comm_plan(engine.cfg, tp_mesh, slots) if fleet else
            decode_comm_plan(engine.cfg, tp_mesh, slots, paged=paged,
                             verify_tokens=spec_k + 1 if spec else 1))
    return {"name": name, "trace": trace, "plan": plan}


def build_world(name: str, world: int, device) -> dict:
    """Run one audited world's step on this rank and return its lint
    context: {name, trace, plan}."""
    if name not in WORLDS:
        raise SystemExit(f"unknown world {name!r} — known: {', '.join(WORLDS)}")
    if name in DECODE_WORLDS:
        return _decode_world(name, world, device)
    return _train_world(name, world, device)


def lint_world(ctx: dict, waive: tuple[str, ...] = ()) -> list:
    from tpukit_torch.analysis import lint_trace

    return lint_trace(ctx["trace"], plan=ctx["plan"], waive=waive)


def _rank_main(args) -> int:
    """One rank of the audit: every world, linted; rank 0 writes."""
    import torch
    import torch.distributed as dist

    from tpukit_torch import configure_numerics, mesh, resolve_device
    from tpukit_torch.analysis import summarize

    configure_numerics()
    device = resolve_device(args.device)
    torch.set_num_threads(1)
    device = mesh.initialize_runtime(device, address=args.address, world_size=args.world,
                                     rank=args.rank)
    waive = tuple(w for w in args.waive.split(",") if w)
    names = tuple(w for w in args.worlds.split(",") if w)
    out = None
    if args.rank == 0:
        out = open(args.out, "w") if args.out else sys.stdout
    errors = 0
    try:
        for name in names:
            ctx = build_world(name, args.world, device)
            findings = lint_world(ctx, waive)
            gathered = [None] * args.world
            dist.all_gather_object(gathered, [f.to_record(world=name, rank=args.rank)
                                              for f in findings])
            errors += sum(r["severity"] == "error" for recs in gathered for r in recs)
            if args.rank != 0:
                continue
            s = summarize(findings)
            plan = ctx["plan"]
            planned = (" planned:" + ",".join(f"{op}x{rec['count']}@{rec['bytes']}B"
                                              for op, rec in sorted(plan.ops.items()))
                       if plan is not None and plan.ops else "")
            print(f"comm audit world {name}: {'clean' if s['clean'] else s['violations']} "
                  f"({s['errors']} errors, {s['warnings']} warnings on rank 0; "
                  f"{sum(r['severity'] == 'error' for recs in gathered for r in recs)} "
                  f"errors on {args.world} ranks){planned}", file=sys.stderr)
            if plan is not None and plan.overlap:
                trace = ctx["trace"]
                for c in trace.collectives():
                    print(f"  {c.fn} %{c.name}: {trace.backward_left(c)} backward op(s) left "
                          "at its issue (rank 0)", file=sys.stderr)
            for recs in gathered:
                for rec in recs:
                    out.write(json.dumps(rec) + "\n")
                    if out is not sys.stdout:
                        print(f"  [{rec['severity']:<5}] rank {rec['rank']} {rec['rule']}: "
                              f"{rec['message']}", file=sys.stderr)
    finally:
        if out is not None and out is not sys.stdout:
            out.close()
        mesh.shutdown_runtime()
    if errors and args.rank == 0:
        print(f"comm audit: {errors} violation(s)", file=sys.stderr)
    return 1 if errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, required=True, metavar="N",
                    help="ranks to run the audited worlds on")
    ap.add_argument("--worlds", default=",".join(WORLDS),
                    help=f"comma list (default: all of {', '.join(WORLDS)})")
    ap.add_argument("--device", default=None,
                    help="cpu (gloo ranks) or cuda (one NCCL rank a card; the default)")
    ap.add_argument("--waive", default="", help="comma list of rules to skip")
    ap.add_argument("--out", default=None, help="write the findings JSONL here, not stdout")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from tpukit_torch.analysis.rules import RULES, WAIVABLE

    unknown = {w for w in args.waive.split(",") if w} - set(RULES) - set(WAIVABLE)
    if unknown:
        ap.error(f"unknown rule(s) in --waive: {sorted(unknown)}")
    if args.waive:
        print(f"comm audit: waiving rule(s): {args.waive}", file=sys.stderr)
    if args.rank is not None:
        return _rank_main(args)
    from tpukit_torch import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: CudaUnavailableError
    with tempfile.TemporaryDirectory() as tmp:
        address = f"file://{Path(tmp) / 'store'}"
        base = [sys.executable, "-m", "tpukit_torch.analysis", "--world", str(args.world),
                "--worlds", args.worlds, "--waive", args.waive, "--address", address]
        if args.device:
            base += ["--device", args.device]
        if args.out:
            base += ["--out", args.out]
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(base + ["--rank", str(r)], env={**env, "LOCAL_RANK": str(r)},
                                  stdout=None if r == 0 else subprocess.DEVNULL)
                 for r in range(args.world)]
        codes = [p.wait() for p in procs]
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
