"""Where a serving run's time goes on the GPU:
`python -m tpukit_torch.serve.profile [--unfused]`.

Serves the GPT-2-small-width stream of `chip_smoke.py` (768 / 12 x 64 /
12 layers, vocab 50257, bf16 compute, 16 slots, pages of 16, 64 requests)
once for wall-clock numbers, then its first 16 requests (one wave of 16
slots) once without and once under `torch.profiler`, and prints: tokens/s,
wall per decode tick, the engine's prefill/decode/sync split, the
device's busy time (sum of CUDA kernel times, from the profiled wave), its
idle share of the profiled wave's wall and of the unprofiled wave's wall
(the profiler slows the host, not the kernels), and the kernels that took
the most device time. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

GPT2_SMALL = dict(dim=768, head_dim=64, heads=12, num_layers=12, vocab_size=50257,
                  max_position_embeddings=1024)
SERVE_SHAPE = dict(slots=16, buckets=(64, 128, 256), max_new_tokens=64, page_size=16,
                   prefill_chunk=64)
REQUESTS = 64


def build(device, fused: bool, kv_dtype: str = "f32", num_layers: int = 12,
          compute_dtype=torch.bfloat16):
    """Config, params, serve config and request stream of the GPT-2-small
    serving run."""
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.model import GPTConfig, init_params
    from tpukit_torch.serve.engine import ServeConfig, synthetic_request_stream

    tok = get_tokenizer()
    cfg = GPTConfig(compute_dtype=compute_dtype, **{**GPT2_SMALL, "num_layers": num_layers})
    params = init_params(cfg, seed=0, device=device)
    serve = ServeConfig(fused_decode=fused, kv_dtype=kv_dtype, **SERVE_SHAPE)
    reqs = synthetic_request_stream(tok, REQUESTS, seed=0,
                                    max_new_tokens=SERVE_SHAPE["max_new_tokens"],
                                    buckets=SERVE_SHAPE["buckets"])
    return cfg, params, serve, reqs, int(tok.eos_token_id)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--unfused", action="store_true")
    flags = ap.parse_args(argv)
    from tpukit_torch import resolve_device
    from tpukit_torch.serve.engine import ServeEngine

    device = resolve_device("cuda")
    cfg, params, serve, reqs, eos = build(device, not flags.unfused)
    run = lambda rs: ServeEngine(params, cfg, serve, eos, device=device).run(list(rs))
    run(reqs[:4])  # warm-up: cuBLAS handles, allocator, kernel build
    torch.cuda.synchronize()

    engine = ServeEngine(params, cfg, serve, eos, device=device)
    t0 = time.perf_counter()
    engine.run(list(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = engine.last_summary
    print(f"{torch.cuda.get_device_name(0)}; fused_decode={serve.fused_decode} "
          f"kv_dtype={serve.kv_dtype}")
    print(f"wall {wall:.4f} s, {s['generated_tokens']} tokens, "
          f"{s['generated_tokens'] / wall:.1f} tokens/s, {engine.steps} decode ticks, "
          f"{1e3 * s['decode_s'] / engine.steps:.3f} ms decode wall per tick; prefill "
          f"{s['prefill_s']:.4f} s, decode {s['decode_s']:.4f} s, sync {s['sync_s']:.4f} s")

    wave = reqs[: serve.slots]
    engine = ServeEngine(params, cfg, serve, eos, device=device)
    t0 = time.perf_counter()
    engine.run(list(wave))
    torch.cuda.synchronize()
    wave_wall = time.perf_counter() - t0
    print(f"unprofiled {len(wave)} requests, {engine.steps} decode ticks: wall "
          f"{wave_wall:.4f} s, {1e3 * engine.last_summary['decode_s'] / engine.steps:.3f} ms "
          f"decode wall per tick")

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    engine = ServeEngine(params, cfg, serve, eos, device=device)
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        engine.run(list(wave))
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    # kernel rows only: a CPU op's row also carries its kernels' device time
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r.device_time_total for r in kernels)
    if not busy_us:
        print("device time not measured: the profiler recorded no CUDA kernel")
        return 1
    print(f"profiled {len(wave)} requests, {engine.steps} decode ticks: wall "
          f"{pwall:.4f} s, {1e3 * engine.last_summary['decode_s'] / engine.steps:.3f} ms "
          f"decode wall per tick; device busy {busy_us / 1e6:.4f} s (sum of kernel "
          f"times), idle share {1 - busy_us / 1e6 / pwall:.4f} of the profiled wall, "
          f"{1 - busy_us / 1e6 / wave_wall:.4f} of the unprofiled wave's wall")
    for r in sorted(kernels, key=lambda r: -r.device_time_total)[:12]:
        print(f"  {r.device_time_total / 1e3:10.3f} ms  {r.count:7d} calls  "
              f"{100 * r.device_time_total / busy_us:5.1f}%  {r.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
