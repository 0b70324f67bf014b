#!/usr/bin/env python3
"""The port's serving fleet over several cards of one host:
`FleetRouter` replicas on `cuda:i` (`--devices_per_replica 1`).

    torchrun is not needed: one process drives every card.
    python3 fleet_cards.py        # on a machine with 4 CUDA cards

Needs four cards. At f32 with 4 layers (`chip_smoke.py` phase 5's model)
the 64-request stream's greedy tokens through four replicas on cuda:0-3,
and through disaggregated prefill with two decode replicas on cuda:0-1
and the prefill worker on cuda:2 (every handoff a cross-card page copy),
must equal one card's engine's, the paged kernels launching layers x the
replicas' ticks; then phase 4's bf16 12-layer engine, one card against
four replicas on four cards, in turns (one, four, four, one), tokens/s of
each and the medians' ratio.
"""

import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from tpukit_torch.serve.fleet import FleetConfig


def main() -> int:
    if torch.cuda.device_count() < 4:
        print("fleet_cards.py needs four CUDA cards", file=sys.stderr)
        return 2
    dev = cs.resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, f"cards {torch.cuda.device_count()}", flush=True)
    cs.build_all()

    cfg, params, serve, reqs, eos = cs.build(dev, fused=True, num_layers=4,
                                             compute_dtype=torch.float32)
    _, single = cs.serve_run(params, cfg, serve, reqs, dev, eos)
    rids = [r.rid for r in reqs]
    for label, fleet in (
            ("4 replicas on cuda:0-3", FleetConfig(replicas=4, devices_per_replica=1)),
            ("disagg: 2 decode replicas on cuda:0-1, worker on cuda:2",
             FleetConfig(replicas=2, devices_per_replica=1, disagg_prefill=True))):
        run = cs._fleet_run(params, cfg, serve, reqs, dev, eos, fleet)
        cs._same_tokens({"fleet": run["outs"], "single": single}, "single", rids, label)
        ticks = cs._paged_formula(run, cfg.num_layers, label)
        devs = [str(e.device) for e in run["engines"]]
        extra = f", worker on {run['router'].prefill.device}" if fleet.disagg_prefill else ""
        print("  " + cs._fleet_line(label, run) + f"; replicas on {devs}{extra}; f32 tokens == "
              f"one card's; paged = {cfg.num_layers} x {ticks}", flush=True)
    del params
    cs._free()

    cfg, params, serve, reqs, eos = cs.build(dev, fused=True)
    four = FleetConfig(replicas=4, devices_per_replica=1, window_steps=8)
    cs.serve_run(params, cfg, serve, reqs[:4], dev, eos)  # warm-ups
    cs._fleet_run(params, cfg, serve, reqs[:8], dev, eos, four)
    tps = {"one card": [], "4 replicas": []}
    for label in ("one card", "4 replicas", "4 replicas", "one card"):
        if label == "one card":
            t0 = time.perf_counter()
            engine, _ = cs.serve_run(params, cfg, serve, reqs, dev, eos)
            wall = time.perf_counter() - t0
            tps[label].append(engine.last_summary["generated_tokens"] / wall)
        else:
            run = cs._fleet_run(params, cfg, serve, reqs, dev, eos, four)
            wall = run["wall"]
            tps[label].append(run["s"]["generated_tokens"] / wall)
        print(f"  {label}: {wall:.3f} s, {tps[label][-1]:.1f} tokens/s", flush=True)
    med = {k: float(np.median(v)) for k, v in tps.items()}
    print(f"bf16 12 layers, 64 requests ({smi}): one card {med['one card']:.1f} tokens/s, "
          f"4 replicas on 4 cards {med['4 replicas']:.1f} (ratio "
          f"{med['4 replicas'] / med['one card']:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
