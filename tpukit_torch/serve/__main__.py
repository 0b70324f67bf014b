"""`python -m tpukit_torch.serve`: continuous-batching serving on one GPU
(the port of `main-serve.py`, its paged greedy path).

Serves fresh seeded parameters (no checkpoint) over a seeded synthetic
request stream and prints the throughput line of `main-serve.py`. Runs on
cuda unless `--device cpu` is given.

  python -m tpukit_torch.serve --page_size 16 --fused_decode --requests 64
  python -m tpukit_torch.serve --num_experts 8 --moe_dispatch pallas --fused_decode
  python -m tpukit_torch.serve --device cpu --num_layers 2 --dim 64 \\
      --head_dim 16 --heads 4 --requests 8 --page_size 8 --fused_decode
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpukit_torch import NotPortedError, resolve_device


def parse_flags(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--head_dim", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--num_layers", type=int, default=8)
    ap.add_argument("--sequence_length", type=int, default=256,
                    help="position table size; the paged slot width (max "
                    "bucket + max_new_tokens, in whole pages) must fit")
    ap.add_argument("--disable_amp", action="store_true",
                    help="compute in f32 instead of bf16")
    ap.add_argument("--num_experts", type=int, default=0,
                    help="routed experts per layer (0: the dense model)")
    ap.add_argument("--moe_top_k", type=int, default=1)
    ap.add_argument("--moe_dispatch", choices=("xla", "pallas"), default="xla",
                    help="meshless decode dataflow of an MoE model; 'pallas' "
                    "(dropless, the grouped-expert kernels) makes the cached "
                    "decode exact")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--buckets", type=str, default="16,32,64")
    ap.add_argument("--max_new_tokens", type=int, default=20)
    ap.add_argument("--decode_quantum", type=int, default=4)
    ap.add_argument("--page_size", type=int, default=16,
                    help="token positions per KV page (must divide every "
                    "bucket); 0 selects the ring cache, not ported yet")
    ap.add_argument("--num_pages", type=int, default=0)
    ap.add_argument("--kv_dtype", choices=("f32", "bf16", "int8"), default="f32")
    ap.add_argument("--prefill_chunk", type=int, default=0)
    ap.add_argument("--fused_decode", action="store_true",
                    help="decode ticks run the CUDA paged-attention kernel "
                    "(its plain PyTorch version on the CPU)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=0.0)
    ap.add_argument("--shared_prefix", type=int, default=0)
    ap.add_argument("--stream_profile", default="uniform",
                    choices=("uniform", "repetitive", "shared_prefix"))
    # main-serve.py flags this slice does not carry: named errors
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--checkpoint", type=str, default="")
    ap.add_argument("--draft", type=str, default="")
    ap.add_argument("--replicas", type=int, default=0)
    return ap.parse_args(argv)


def _reject_unported(flags) -> None:
    unported = [
        (flags.checkpoint, "--checkpoint", "checkpoint restore ('Checkpoints')"),
        (flags.draft, "--draft", "speculative decoding ('Speculative decoding')"),
        (flags.replicas, "--replicas", "the fleet router ('Fleet')"),
        (flags.temperature > 0 or flags.top_k > 0, "--temperature/--top_k",
         "seeded sampling, which needs jax.random's threefry ('Seeded sampling')"),
    ]
    for value, flag, what in unported:
        if value:
            raise NotPortedError(
                f"{flag}: {what} is not in the port yet (ROADMAP.md, queue A); "
                f"this slice serves fresh seeded params greedily"
            )


def main(argv=None) -> int:
    flags = parse_flags(argv)
    _reject_unported(flags)
    device = resolve_device(flags.device)
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.model import GPTConfig, init_params
    from tpukit_torch.serve.engine import (ServeConfig, ServeEngine,
                                           synthetic_request_stream)

    tokenizer = get_tokenizer()
    cfg = GPTConfig(
        dim=flags.dim, head_dim=flags.head_dim, heads=flags.heads,
        num_layers=flags.num_layers, vocab_size=tokenizer.vocab_size,
        max_position_embeddings=flags.sequence_length,
        compute_dtype=torch.float32 if flags.disable_amp else torch.bfloat16,
        num_experts=flags.num_experts, router_top_k=flags.moe_top_k,
        moe_dispatch=flags.moe_dispatch if flags.num_experts > 0 else "xla",
    )
    buckets = tuple(sorted({int(b) for b in flags.buckets.split(",") if b}))
    serve = ServeConfig(
        slots=flags.slots, buckets=buckets, max_new_tokens=flags.max_new_tokens,
        decode_quantum=flags.decode_quantum, page_size=flags.page_size,
        num_pages=flags.num_pages, kv_dtype=flags.kv_dtype,
        prefill_chunk=flags.prefill_chunk, fused_decode=flags.fused_decode,
    )
    params = init_params(cfg, seed=flags.seed, device=device)
    print(f"serving fresh seeded params (no --checkpoint) on {device}")
    engine = ServeEngine(params, cfg, serve, eos_id=int(tokenizer.eos_token_id),
                         device=device)
    requests = synthetic_request_stream(
        tokenizer, flags.requests, seed=flags.seed,
        max_new_tokens=flags.max_new_tokens, buckets=buckets, qps=flags.qps,
        shared_prefix=flags.shared_prefix, stream_profile=flags.stream_profile,
    )
    t0 = time.perf_counter()
    completions = engine.run(requests)
    wall = time.perf_counter() - t0
    s = engine.last_summary
    gen = sum(c.generated for c in completions)
    print(f"served {len(completions)} requests / {gen} tokens in "
          f"{wall:.2f}s ({gen / wall:.1f} tokens/s, occupancy "
          f"{100 * s['mean_occupancy']:.0f}%)")
    print(f"paged KV: {s['num_pages']} pages x {s['page_size']} tokens "
          f"({s['kv_dtype']}), prefix hits {s['prefix_hits']}/{s['admitted']} "
          f"admissions, {s['prefix_pages_reused']} pages of prefill skipped")
    e2e = sorted(c.e2e_s for c in completions)
    if e2e:
        print(f"e2e latency p50 {1e3 * e2e[len(e2e) // 2]:.1f} ms  "
              f"p99 {1e3 * e2e[min(len(e2e) - 1, int(len(e2e) * 0.99))]:.1f} ms")
    for c in completions[:3]:
        print(f"  [{c.rid}] " + tokenizer.decode(np.asarray(c.ids),
                                                 skip_special_tokens=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
