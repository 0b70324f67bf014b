"""Where a training step's time goes on the GPU:
`python -m tpukit_torch.recipes.profile [--rung NAME] [--steps N]`.

Runs the train step of one rung on synthetic token batches built as the
repo's ladder builds them, from random weights (seed 0):

  - `gpt-small-dim768` (`tools/bench_ladder.py:34`; GPT-2 small, Radford et
    al. 2019: 768 / 12 x 64 / 12 layers, sequence 512, vocab 50257), batch
    64, bf16 compute, AdamW, `SingleDevice`;
  - `gpt-small-dim768-e8`: the same trunk with every FFN an 8-expert bank,
    top-1 Switch routing (Fedus et al. 2021), capacity factor 1.25, aux
    weight 0.01; batch 32 (`bench.py:1928`'s MoE probe); `ExpertParallel`
    on a 1 x 1 grid with the pallas dispatch, so the grouped-expert kernels
    run over the capacity buffers (recipe 8 on one device).

It times a steady window of steps by host clock (each step ends in a host
read of its loss), then profiles a short window under `torch.profiler` and
prints: step wall and tokens/s, peak device memory, the device's busy time
(sum of CUDA kernel times) and idle share of the profiled and of the
unprofiled wall, the device time of each of the port's kernels against
everything else, and the kernels that took the most device time. Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

GPT2_SMALL_TRAIN = dict(dim=768, head_dim=64, heads=12, num_layers=12, vocab_size=50257,
                        max_position_embeddings=512)
BATCH, SEQ = 64, 512
# rung -> (batch, config overrides, strategy: "single" or the EP dispatch)
RUNGS = {
    "gpt-small-dim768": (BATCH, {}, "single"),
    "gpt-small-dim768-e8": (32, dict(num_experts=8, router_top_k=1), "pallas"),
}
PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_dcap_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "ce_fwd_kernel", "ce_bwd_dw_kernel", "ce_bwd_dh_kernel",
                "moe_rows_kernel", "moe_dw_kernel")


def synthetic_batch(rng, vocab: int, batch: int, seq: int, pad_rows: int = 0):
    """(model_batch, targets) as `tools/bench_ladder.py:41-53` builds them:
    uniform token ids, positions 0..seq-1, no padding, targets the ids
    rolled by one. With `pad_rows`, that many rows end in padding from a
    seeded length on (pad id 2, mask True, targets -100)."""
    ids = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    mask = np.zeros_like(ids, dtype=bool)
    for r in range(pad_rows):
        keep = int(rng.randint(seq // 4, seq))
        ids[r, keep:] = 2
        mask[r, keep:] = True
    targets = np.roll(ids, -1, axis=1).astype(np.int32)
    targets[mask | np.roll(mask, -1, axis=1)] = -100
    model_batch = {
        "input_ids": ids,
        "position_ids": np.ascontiguousarray(
            np.broadcast_to(np.arange(seq, dtype=np.int32), ids.shape)),
        "mask": mask,
    }
    return model_batch, targets


def build_train(device, num_layers: int = 12, compute_dtype=torch.bfloat16,
                attention_impl: str = "auto", learning_rate: float = 1e-4, seed: int = 0,
                **moe):
    """Config and train state of the GPT-2-small-width step; `moe` sets
    the MoE fields of the config (num_experts, router_top_k, ...)."""
    from tpukit_torch.model import GPTConfig, init_params
    from tpukit_torch.train import create_train_state

    cfg = GPTConfig(compute_dtype=compute_dtype, attention_impl=attention_impl,
                    **{**GPT2_SMALL_TRAIN, "num_layers": num_layers}, **moe)
    return cfg, create_train_state(init_params(cfg, seed=seed, device=device), learning_rate)


def rung_strategy(kind: str):
    """The strategy of a rung: `SingleDevice`, or `ExpertParallel` on one
    device with the named dispatch."""
    from tpukit_torch.shardings import ExpertParallel, SingleDevice

    return SingleDevice() if kind == "single" else ExpertParallel(dispatch=kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rung", choices=tuple(RUNGS), default="gpt-small-dim768")
    ap.add_argument("--steps", type=int, default=6, help="steps in the timed window")
    flags = ap.parse_args(argv)
    from tpukit_torch import resolve_device
    from tpukit_torch.train import to_device, train_step

    device = resolve_device("cuda")
    batch, moe, kind = RUNGS[flags.rung]
    cfg, state = build_train(device, **moe)
    rng = np.random.RandomState(0)
    batches = [to_device(*synthetic_batch(rng, cfg.vocab_size, batch, SEQ), device)
               for _ in range(2)]
    strategy = rung_strategy(kind)
    step = lambda i: float(train_step(state, cfg, strategy, *batches[i % 2]))
    for i in range(2):  # warm-up: kernel builds, cuBLAS handles, the allocator
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(flags.steps):
        t0 = time.perf_counter()
        step(i)
        walls.append(time.perf_counter() - t0)
    wall = float(np.mean(walls))
    print(f"{torch.cuda.get_device_name(0)}; {flags.rung}: train step B{batch} S{SEQ} dim "
          f"{cfg.dim} layers {cfg.num_layers} experts {cfg.num_experts} vocab "
          f"{cfg.vocab_size} bf16, {strategy.name}: wall per step {wall:.4f} s (min "
          f"{min(walls):.4f}, max {max(walls):.4f}, {flags.steps} steps), "
          f"{batch * SEQ / wall:.1f} tokens/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_steps = 2
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for i in range(prof_steps):
            step(i)
        pwall = time.perf_counter() - t0
    # kernel rows only: a CPU op's row also carries its kernels' device time
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r.device_time_total for r in kernels)
    if not busy_us:
        print("device time not measured: the profiler recorded no CUDA kernel")
        return 1
    busy = busy_us / 1e6 / prof_steps
    per_kernel = {name: sum(r.device_time_total for r in kernels if name in r.key)
                  for name in PORT_KERNELS}
    ours = sum(per_kernel.values())
    print(f"profiled {prof_steps} steps: wall {pwall / prof_steps:.4f} s per step; device "
          f"busy {busy:.4f} s per step (sum of kernel times), idle share "
          f"{1 - busy / (pwall / prof_steps):.4f} of the profiled wall, "
          f"{1 - busy / wall:.4f} of the unprofiled wall")
    print(f"the port's kernels (flash attention, fused head + CE, grouped experts): "
          f"{ours / 1e6 / prof_steps:.4f} s per step, {ours / busy_us:.4f} of device time; "
          + ", ".join(f"{n} {t / 1e3 / prof_steps:.3f} ms" for n, t in per_kernel.items()))
    for r in sorted(kernels, key=lambda r: -r.device_time_total)[:15]:
        print(f"  {r.device_time_total / 1e3 / prof_steps:10.3f} ms/step "
              f"{r.count // prof_steps:6d} calls/step "
              f"{100 * r.device_time_total / busy_us:5.1f}%  {r.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
