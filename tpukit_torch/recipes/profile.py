"""Where a training step's time goes on the GPU:
`python -m tpukit_torch.recipes.profile [--rung NAME] [--steps N]
[--strategy single|ddp|fsdp|fsdp-offload|pipe|pipe-1f1b|tp|cp|cp-ulysses|ep]
[--heads H] [--sequence_length L] [--batch_size B] [--data D] [--expert E]
[--comm_dtype f32|bf16|int8] [--grad_buckets N]`.

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

`--strategy ddp|fsdp|fsdp-offload` runs the dense rung's step under
`DataParallel`, `FSDP` or `FSDP(cpu_offload=True)` (recipes 2 and 3) in a
world of one over NCCL, in place of `SingleDevice`; `--strategy
pipe|pipe-1f1b` under `Pipeline` (GPipe) or `Pipeline1F1B` with 4
micro-batches (recipes 4 and 5: one stage, the head the vocab-parallel
CE); `--strategy tp` under `TensorParallel` on recipe 6's grid
(`recipes/tp.py:pick_grid` of the world and the heads). Under `torchrun
--nproc_per_node N` those strategies span N cards, each rank printing its
own lines (`--batch_size` rows a data replica, as the recipes load them).
`--heads H` splits the rung's 768 into H heads of 768 / H (12 x 64 by
default), which moves recipe 6's grid: 6 x 128 over four cards is data 2 x
model 2. `--strategy cp|cp-ulysses` runs the rung under `ContextParallel`
(recipe 7: the zigzag ring, or Ulysses) on a `(data, seq)` grid of the
world, `--data D` replicas (1 by default) of world / D sequence ranks, at
the rung's 32768 tokens a step by default (batch 64 x S 512, the position
table 513 long, so that S divides over the ranks as tpukit checks it);
`--sequence_length L` (the position table; the step runs S = L - 1, as
`fit` does) and `--batch_size B` (rows a data replica) set another shape,
e.g. `main-ring.py`'s `--sequence_length 8193 --batch_size 4`.
`--strategy ep` runs the `gpt-small-dim768-e8` rung (its default under
ep) under `ExpertParallel` with the pallas dispatch (recipe 8) on a
`(data, expert)` grid of the world: recipe 8's `pick_grid` of the world
and the experts, or `--expert E` ranks on the expert axis; each rank steps
on `--batch_size` rows of its own (32, the rung's, by default), drawn from
a seed of its rank, and the grid's tokens/s is printed beside the card's.
`--comm_dtype` and `--grad_buckets` set the config's fields (recipes 2,
3 and 8's flags): the hand-placed gradient wire of
`DataParallel` and `FSDP`, the exchange's payload under `ExpertParallel`.

It times a steady window of steps by host clock (each step ends in a host
read of its loss), then profiles a short window under `torch.profiler` and
prints: step wall and tokens/s, peak device memory, the device's busy time
(sum of CUDA kernel times) and idle share of the profiled and of the
unprofiled wall, the device time of each of the port's kernels against
everything else, the calls and device time of PyTorch's float adds and
fills, the annotated regions (the optimizer step, DDP's forward, FSDP2's
hooks) with the device and host time under each, and the kernels that
took the most device time, the launches a step of each of the
port's kernels, by their counters, and the c10d collectives of one step
(calls and bytes of each, counted by wrapping `torch.distributed`'s
functions) beside the strategy's closed form where it has one. Needs one
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
                "flash_bwd_dq_kernel", "ce_fwd_wgmma_kernel", "ce_fwd_combine_kernel",
                "ce_bwd_d_wgmma_kernel", "ce_bwd_dh_wgmma_kernel", "ce_bwd_dh_combine_kernel",
                "ce_bwd_dw_wgmma_kernel", "moe_rows_wgmma_kernel", "moe_dz2_kernel",
                "moe_dw_wgmma_kernel", "moe_combine_kernel", "moe_rows_kernel", "moe_dw_kernel")
# PyTorch's elementwise kernels counted on their own line: float adds (of
# gradients, among others) and fills (zero-filled buffers)
ELEMENTWISE = {"adds": "CUDAFunctor_add", "fills": "FillFunctor"}
# what the data-parallel strategies add: NCCL's kernels (the collectives of
# DDP and FSDP2) and the copies between host and device (CPU offload)
TRANSFERS = {"nccl": "nccl", "host to device": "Memcpy HtoD", "device to host": "Memcpy DtoH"}


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
                strategy=None, **moe):
    """Config and train state of the GPT-2-small-width step; `moe` sets
    the MoE fields of the config (num_experts, router_top_k, ...) or
    overrides its shape (heads, head_dim); a `strategy` sets the state up
    for itself (`create_train_state`)."""
    from tpukit_torch.model import GPTConfig, init_params
    from tpukit_torch.train import create_train_state

    cfg = GPTConfig(compute_dtype=compute_dtype, attention_impl=attention_impl,
                    **{**GPT2_SMALL_TRAIN, "num_layers": num_layers, **moe})
    if strategy is not None:
        strategy.validate_config(cfg)
    return cfg, create_train_state(init_params(cfg, seed=seed, device=device), learning_rate,
                                   strategy, cfg)


STRATEGIES = ("single", "ddp", "fsdp", "fsdp-offload", "pipe", "pipe-1f1b", "tp", "cp",
              "cp-ulysses", "ep")
EP_RUNG = "gpt-small-dim768-e8"  # --strategy ep's rung
PIPE_MICRO = 4  # the pipeline's micro-batches (recipe 4's "4x" at one stage)


def rung_strategy(kind: str, strategy: str = "single", heads: int = 12, data: int = 1,
                  expert: int = 0, experts: int = 8):
    """The strategy of a rung: `SingleDevice`, or `ExpertParallel` on one
    device with the named dispatch; `strategy` names a data-parallel,
    pipeline, tensor-, context- or expert-parallel one (`DataParallel`,
    `FSDP`, `FSDP(cpu_offload=True)`, `Pipeline`, `Pipeline1F1B`,
    `TensorParallel` on recipe 6's grid for `heads`, `ContextParallel` with
    the ring or Ulysses over `data` replicas, `ExpertParallel` with the
    rung's dispatch on recipe 8's grid of the world and `experts`, or on
    `expert` ranks an expert group) in place of `SingleDevice`."""
    from tpukit_torch import mesh
    from tpukit_torch.ops.moe_dispatch import ExpertGrid
    from tpukit_torch.pipeline import Pipeline, Pipeline1F1B
    from tpukit_torch.recipes import moe
    from tpukit_torch.recipes.tp import pick_grid
    from tpukit_torch.shardings import (FSDP, ContextParallel, DataParallel, ExpertParallel,
                                        SingleDevice, TensorParallel)

    if strategy == "ep":
        world = mesh.world_size()
        grid = (moe.pick_grid(world, experts) if not expert
                else {"data": world // expert, "expert": expert})
        return ExpertParallel(ExpertGrid(**grid), dispatch=kind)
    if strategy == "tp":
        return TensorParallel(**pick_grid(mesh.world_size(), heads))
    if strategy in ("cp", "cp-ulysses"):
        return ContextParallel(data=data, attention="ring" if strategy == "cp" else "ulysses")
    if strategy != "single":
        return {"ddp": DataParallel, "fsdp": FSDP,
                "fsdp-offload": lambda: FSDP(cpu_offload=True),
                "pipe": lambda: Pipeline(num_microbatches=PIPE_MICRO),
                "pipe-1f1b": lambda: Pipeline1F1B(num_microbatches=PIPE_MICRO)}[strategy]()
    return SingleDevice() if kind == "single" else ExpertParallel(dispatch=kind)


def _launch_counters() -> dict:
    """The port's per-kernel launch counters (each wrapper adds one where it
    launches its kernel), by module."""
    from tpukit_torch.ops import flash_attention, fused_head_ce, moe_gemm, paged_attention

    return {"flash": flash_attention.launches, "ce": fused_head_ce.launches,
            "moe": moe_gemm.launches, "paged": paged_attention.launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rung", choices=tuple(RUNGS), default=None,
                    help=f"default: gpt-small-dim768 ({EP_RUNG} under --strategy ep)")
    ap.add_argument("--steps", type=int, default=6, help="steps in the timed window")
    ap.add_argument("--strategy", choices=STRATEGIES, default="single")
    ap.add_argument("--heads", type=int, default=GPT2_SMALL_TRAIN["heads"],
                    help="attention heads (head_dim = 768 / heads)")
    ap.add_argument("--sequence_length", type=int, default=0,
                    help="the position table; the step runs S = L - 1 tokens a row (default: "
                    "the rung's S 512, with a table of 513 under cp)")
    ap.add_argument("--batch_size", type=int, default=0,
                    help="rows a data replica (default: the rung's)")
    ap.add_argument("--data", type=int, default=1, help="cp: data replicas of the grid")
    ap.add_argument("--expert", type=int, default=0,
                    help="ep: ranks on the expert axis (default: recipe 8's pick_grid)")
    ap.add_argument("--comm_dtype", choices=("f32", "bf16", "int8"), default="f32",
                    help="the payload of the hand-placed collectives (ddp, fsdp, ep)")
    ap.add_argument("--grad_buckets", type=int, default=0,
                    help="ddp, fsdp: gradient buckets of the hand-placed wire")
    flags = ap.parse_args(argv)
    flags.rung = flags.rung or (EP_RUNG if flags.strategy == "ep" else "gpt-small-dim768")
    if flags.strategy == "ep" and not RUNGS[flags.rung][1]:
        raise ValueError(f"--strategy ep needs an MoE rung, got --rung {flags.rung}")
    from tpukit_torch import mesh, resolve_device

    device = resolve_device("cuda")
    with mesh.scoped_runtime():
        if flags.strategy != "single":
            device = mesh.initialize_runtime(device)
        return _profile(flags, device)


def _profile(flags, device) -> int:
    from tpukit_torch.train import to_device, train_step

    from tpukit_torch import mesh

    batch, moe, kind = RUNGS[flags.rung]
    strategy = rung_strategy(kind, flags.strategy, flags.heads, flags.data, flags.expert,
                             moe.get("num_experts", 0))
    dim = GPT2_SMALL_TRAIN["dim"]
    if dim % flags.heads:
        raise ValueError(f"--heads {flags.heads} must divide the rung's dim {dim}")
    shape = {} if flags.heads == GPT2_SMALL_TRAIN["heads"] else dict(
        heads=flags.heads, head_dim=dim // flags.heads)
    positions = flags.sequence_length or (SEQ + 1 if flags.strategy.startswith("cp") else SEQ)
    seq = SEQ if positions == SEQ else positions - 1
    if positions != SEQ:
        shape["max_position_embeddings"] = positions
    batch = flags.batch_size or batch
    comm = dict(comm_dtype=flags.comm_dtype, grad_buckets=flags.grad_buckets)
    cfg, state = build_train(device, strategy=strategy, **shape, **moe, **comm)
    ranks = strategy.grid.size if flags.strategy == "ep" else 1  # ranks with rows of their own
    rng = np.random.RandomState(mesh.rank() if ranks > 1 else 0)
    batches = [to_device(*synthetic_batch(rng, cfg.vocab_size, batch, seq), device)
               for _ in range(2)]
    step = lambda i: float(train_step(state, cfg, strategy, *batches[i % 2]))
    for i in range(2):  # warm-up: kernel builds, cuBLAS handles, the allocator
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _launch_counters()
    for c in counters.values():
        c.update(dict.fromkeys(c, 0))
    walls = []
    for i in range(flags.steps):
        t0 = time.perf_counter()
        step(i)
        walls.append(time.perf_counter() - t0)
    wall = float(np.mean(walls))
    launches = {f"{mod}.{k}": v // flags.steps for mod, c in counters.items()
                for k, v in c.items() if v}
    grid = (f" (data {strategy.data_size} x model {strategy.model_size})"
            if flags.strategy == "tp" else
            f" (data {strategy.data_size} x seq {strategy.seq_size})"
            if flags.strategy.startswith("cp") else
            f" (data {strategy.grid.data} x expert {strategy.grid.expert}, rank "
            f"{mesh.rank()}, {batch} rows a rank)" if flags.strategy == "ep" else "")
    print(f"{torch.cuda.get_device_name(0)}; {flags.rung}: train step B{batch} S{seq} dim "
          f"{cfg.dim} heads {cfg.heads}x{cfg.head_dim} layers {cfg.num_layers} experts "
          f"{cfg.num_experts}{grid} vocab "
          f"{cfg.vocab_size} bf16, {strategy.name}: wall per step {wall:.4f} s (min "
          f"{min(walls):.4f}, max {max(walls):.4f}, {flags.steps} steps), "
          f"{batch * seq / wall:.1f} tokens/s"
          + (f" (the grid's {ranks * batch * seq / wall:.1f})" if ranks > 1 else "")
          + f", max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    print(f"launches a step (the port's counters): {launches}")
    if flags.strategy != "single":
        from tpukit_torch.analysis.comm_ir import comm_bytes

        seen = comm_bytes(lambda: step(0))
        closed = getattr(strategy, "grad_comm", lambda *a: None)(cfg, state.params)
        print(f"collectives of one step, comm {cfg.comm_dtype}, buckets {cfg.grad_buckets} "
              f"(calls, bytes of the output): {seen}; the strategy's closed form of its "
              f"gradient wire: {closed}")

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_steps = 2
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for i in range(prof_steps):
            step(i)
        pwall = time.perf_counter() - t0
    # kernel (and copy) rows only: a CPU op's row also carries its kernels'
    # device time, and so does the device row of an annotated region (the
    # optimizer step, DDP's forward, FSDP2's hooks), which has the name of a
    # host-side row too
    rows = prof.key_averages()
    host = {r.key: r for r in rows if r.device_type == torch.autograd.DeviceType.CPU}
    device = [r for r in rows if r.device_type == torch.autograd.DeviceType.CUDA]
    spans = [r for r in device if r.key in host or getattr(r, "is_user_annotation", False)]
    kernels = [r for r in device if r not in spans]
    busy_us = sum(r.device_time_total for r in kernels)
    if not busy_us:
        print("device time not measured: the profiler recorded no CUDA kernel")
        return 1
    busy = busy_us / 1e6 / prof_steps
    per_kernel = {name: sum(r.device_time_total for r in kernels if name in r.key)
                  for name in PORT_KERNELS}
    per_calls = {name: sum(r.count for r in kernels if name in r.key) // prof_steps
                 for name in PORT_KERNELS}
    ours = sum(per_kernel.values())
    print(f"profiled {prof_steps} steps: wall {pwall / prof_steps:.4f} s per step; device "
          f"busy {busy:.4f} s per step (sum of kernel times), idle share "
          f"{1 - busy / (pwall / prof_steps):.4f} of the profiled wall, "
          f"{1 - busy / wall:.4f} of the unprofiled wall")
    print(f"the port's kernels (flash attention, fused head + CE, grouped experts): "
          f"{ours / 1e6 / prof_steps:.4f} s per step, {ours / busy_us:.4f} of device time; "
          + ", ".join(f"{n} {t / 1e3 / prof_steps:.3f} ms ({per_calls[n]} calls)"
                      for n, t in per_kernel.items()))
    for title, tags in (("elementwise", ELEMENTWISE), ("collectives and copies", TRANSFERS)):
        print(f"{title}: " + ", ".join(
            f"{label} {sum(r.count for r in kernels if tag in r.key) // prof_steps} calls/step "
            f"{sum(r.device_time_total for r in kernels if tag in r.key) / 1e3 / prof_steps:.3f} "
            f"ms/step" for label, tag in tags.items()))
    opt = [r for k, r in host.items() if k.startswith("Optimizer.step")]
    print("optimizer step, host time: " + ", ".join(
        f"{r.key} {r.cpu_time_total / 1e3 / prof_steps:.3f} ms/step" for r in opt))
    print("annotated regions (device time of the kernels under each, not added to busy; "
          "host time): " + ", ".join(
              f"{r.key} {r.device_time_total / 1e3 / prof_steps:.3f} ms / "
              f"{host[r.key].cpu_time_total / 1e3 / prof_steps if r.key in host else 0.0:.3f} ms"
              for r in sorted(spans, key=lambda r: -r.device_time_total)))
    for r in sorted(kernels, key=lambda r: -r.device_time_total)[:15]:
        print(f"  {r.device_time_total / 1e3 / prof_steps:10.3f} ms/step "
              f"{r.count // prof_steps:6d} calls/step "
              f"{100 * r.device_time_total / busy_us:5.1f}%  {r.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
