#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`tpukit_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each on its own lines; any failure raises, so the exit code is
not 0:
  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: nvcc builds every kernel source of tpukit_torch/csrc, all at
     once (seconds and the ptxas register/shared-memory report);
  3. kernel vs plain: the paged-attention kernel against its plain PyTorch
     version, element by element, at the shapes phase 4's serving config
     gives it (16 slots, 12 heads x 64, pages of 16, a 320-position
     window), in five pool/compute dtype pairs; the kernel's device time
     (launches captured in a CUDA graph, timed by CUDA events) beside the
     plain version's time and the device-memory bound;
  4. serve: `ServeEngine` at GPT-2-small width (768 / 12 x 64 / 12 layers,
     vocab 50257, bf16) answers 64 requests with fused decoding; the
     kernel's launch count must equal layers x decode ticks;
  5. fused vs unfused: the same stream at f32 compute (4 layers) gives the
     same greedy tokens both ways, and int8 pages agree on >= 90% of them;
  6. training kernels vs plain: flash attention forward and backward at
     64 x 12 x 512 x 64 (and S = 511, 2048; every bf16 head dim, 16 to 128,
     at S = 511, 512, 2048, with and without a pad mask), fused head + CE
     forward and backward at 32768 tokens x 768 x vocab 50257, bf16 and f32,
     with and without a pad mask, each against its plain version (the CE
     backward under O(1) cotangents, each of its two terms alone, with a
     negative control); device times (CUDA graph), call, plain and SDPA
     times, the least time the card could take, TFLOP/s and the share of
     that bound; then the attention crossover: the eager "xla" path against
     the flash kernels at S = 16 ... 1024;
  7. train step at full width: the gpt-small-dim768 rung (batch 64, S 512,
     bf16), 8 steps; the loss falls on a repeated batch, and each step
     launches the flash kernels 12 + 12 + 12 + 12 times (forward, D, dK/dV,
     dQ) and the CE kernels once each;
  8. the train step through the kernels equals the step through the plain
     versions (f32, 2 layers, 4 steps);
  9. recipe 1 end to end at GPT-2-small width on the fixture corpus
     (`--sequence_length 512`, so S = 511 in front of the attention):
     trains, evaluates, samples through the paged kernel, checkpoints;
 10. MoE kernels vs plain: the grouped-expert FFN forward and backward
     (768 -> 3072 -> 768, 8 experts), bf16 and f32, against their plain
     versions on three segment layouts: the recipe's equal capacity
     segments (20480 rows), the `sort_plan` layout of a real top-1 and
     top-2 routing at the e8 rung's shapes, and an adversarial one (an
     empty expert, 1-row segments, segments across tiles, a padding
     tail); the backward under O(1) seeded cotangents, with negative
     controls; device times (CUDA graph), call and plain times, bounds;
 11. MoE train step at full width: the gpt-small-dim768-e8 rung (batch 32,
     S 512, bf16, ExpertParallel 1 x 1 with the pallas dispatch), 8 steps;
     the loss falls on a repeated batch, and each step launches each
     grouped-expert kernel 12 times, the flash kernels 12 + 12 + 12 + 12 and
     the CE kernels once each;
 12. MoE train step through the kernels == through the plain versions (f32,
     2 layers, top-2, 4 steps), on the ExpertParallel 1 x 1 path and on the
     meshless dropless path;
 13. recipe 8 end to end (`--num_experts 8 --moe_dispatch pallas`) at
     GPT-2-small width on the fixture corpus: trains, evaluates, samples,
     checkpoints;
 14. MoE serving: `ServeEngine` at GPT-2-small width with 8 experts and the
     pallas dispatch answers phase 4's 64 requests with fused decoding; the
     grouped forward launches layers x (prefill dispatches + decode ticks)
     times;
 15. MoE fused vs unfused (f32, 4 layers): the same greedy tokens both ways,
     and the same as the engine's tokens through the plain versions (on
     the CPU) for the first 16 requests;
then one JSON line of kernel results and, last, the device JSON line.

Imports nothing of JAX or of the JAX package. Without CUDA it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tpukit_torch import resolve_device
from tpukit_torch.ops import _cuda
from tpukit_torch.ops.attention import FLASH_MIN_SEQ, causal_attention
from tpukit_torch.ops import flash_attention as fa
from tpukit_torch.ops import fused_head_ce as fce
from tpukit_torch.ops import moe_gemm
from tpukit_torch.ops import paged_attention as pa
from tpukit_torch.ops import quant_comm
from tpukit_torch import checkpoint as ckpt_lib
from tpukit_torch.ops.moe_dispatch import _route_topk
from tpukit_torch.recipes import moe as moe_recipe
from tpukit_torch.recipes import single
from tpukit_torch.recipes.profile import (
    BATCH,
    GPT2_SMALL_TRAIN,
    RUNGS,
    SEQ,
    build_train,
    rung_strategy,
    synthetic_batch,
)
from tpukit_torch.serve.engine import ServeEngine
from tpukit_torch.serve.profile import build
from tpukit_torch.model import GPTConfig, init_params
from tpukit_torch.shardings import ExpertParallel, SingleDevice, leaves, unflatten
from tpukit_torch.train import create_train_state, to_device, train_step

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 non-tensor, bf16 dense
KERNEL = "paged_attention"  # the serving path's csrc source
SOURCES = ("paged_attention", "flash_attention", "fused_head_ce", "moe_gemm")  # every csrc source
F32_ATOL = 1e-5  # f32 compute: the kernel and the plain version sum in different orders
DIFF_SHARE = 0.01  # bf16 compute: most outputs must be bit-equal (see check_kernel)
# Training kernels against their plain versions (phase 6), as (atol, rtol,
# share of the row's largest |value|). f32: tpukit's CPU bars
# (tests/test_flash_attention.py:38,70; tests/test_fused_head_ce.py:41,61),
# except the CE gradients. tpukit's atol 2e-6 there is sized for the mean
# loss's cotangents (1/count); phase 6 holds them under O(1) cotangents, so
# gradients thousands of times larger, where f32 sums of 4096 (dW) or
# 50304 (dH) terms in another order differ by ~sqrt(K) 2^-24 of the row's
# scale. Their bar is 2^-12 of the row's largest |value|: ~4x over the
# worst element such a walk gives, and 7x (dW) to 800x (dH) tighter,
# relative to the gradient, than 2e-6 at the mean loss's scale. bf16: the
# online softmax rounds each tile's probabilities against the running
# maximum and the plain version against the row's maximum, and a rounded
# dS or d may land an ulp apart where the two f32 sums straddle a rounding
# boundary; each element within 2^-6 (two bf16 ulps at the top of the
# binade) of the largest |value| of its row.
FLASH_FWD_TOL = (2e-5, 1e-4, 0.0)
FLASH_GRAD_TOL = (5e-4, 1e-3, 0.0)
CE_LSE_TOL = (1e-5, 1e-5, 0.0)
CE_GRAD_TOL = (0.0, 1e-5, 2.0**-12)
BF16_ROW_SHARE = 2.0**-6
# The grouped-expert kernels against their plain versions (phase 10), both
# given the same inputs (the backward: the kernel's y and kept h). Outputs
# that are f32 sums of f32 or identical terms (every output in f32 compute;
# dWd, dbu, dbd in bf16 compute) differ only in summation order over 768 to
# 4096 terms (D, F, or an expert's rows), ~sqrt(K) 2^-24 of the row's scale:
# 2^-12 of the row's largest |value| + rtol 1e-5 (the CE gradients' bar);
# a dbu summed from the rounded dz1 fails it. Outputs that pass through a
# bf16 rounding of an f32 sum (bf16 y and dx, and dWu = x^T round(dz1)):
# where the kernel's and the plain f32 sums straddle a rounding boundary a
# rounded h or dz1 lands an ulp apart and moves what follows, so
# BF16_ROW_SHARE, as the flash and CE gradients in bf16.
MOE_TOL = (0.0, 1e-5, 2.0**-12)
MOE_ROUNDED = ("y", "dx", "dwu")  # bf16 compute: held at BF16_ROW_SHARE
MOE_ROUTED = dict(batch=32, seq=SEQ, experts=8)  # the e8 rung's routing (phase 10 b)
# phase 10 c: an empty expert, 1-row segments, segments across row tiles;
# 9999 rows, so a 241-row padding tail
MOE_ADVERSARIAL = (3000, 0, 1, 129, 2047, 130, 1, 4691)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _events_ms(run, calls: int) -> float:
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per eager call over `iters` back-to-back calls, by
    CUDA events, after a warm-up. Host dispatch is in the span whenever
    it outlasts the device work. Each result is dropped before the next
    call, as on the main path, so its memory goes back to the allocator's
    cache: results kept alive would send every call's outputs to
    cudaMalloc and time that instead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    return _events_ms(run, iters)


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds per call: `iters` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so no host
    dispatch falls inside the span."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(lambda: [graph.replay() for _ in range(replays)], iters * replays)


def bf16_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per element of `ref [N, H, D]`: 2 bf16 ulp of the largest |ref| in
    its (slot, head) row, and no less than F32_ATOL. Not 2 ulp of the
    element itself: where the kernel's and the plain version's f32 score
    sums straddle a bf16 rounding boundary, that one probability moves by
    a bf16 ulp and every output of the row moves with it, by up to a few
    ulp of the row's scale, which is large beside an output near 0."""
    top = ref.float().abs().amax(-1, keepdim=True).expand(ref.shape)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)  # 0 where the row is 0
    return torch.clamp(2 * ulp, min=F32_ATOL)


def paged_bound_ms(starts, pool_dtype, cdt, n, h, d, p, mp) -> tuple[float, str]:
    """The least time for one call on these inputs: bytes it must move
    (window K/V minus the fresh token, the int8 scale blocks those
    positions touch, the block-table entries read, cursors, q/k/v in and
    the output out) over 3.35 TB/s, against its operations (q.k and p.v,
    2 flops per multiply-add) over the peak rate of the compute dtype."""
    lims = np.minimum(starts, mp * p - 1)
    pool_item = torch.tensor([], dtype=pool_dtype).element_size()
    c_item = torch.tensor([], dtype=cdt).element_size()
    nbytes = int(lims.sum()) * h * d * 2 * pool_item
    pages_read = sum(-(-int(l) // p) for l in lims)
    nbytes += 4 * pages_read + 4 * n + 4 * n * h * d * c_item
    if pool_dtype == torch.int8:
        blocks = 0
        for l in lims:
            for j in range(-(-int(l) // p)):
                blocks += -(-min(p, int(l) - j * p) * d // quant_comm.DEFAULT_BLOCK)
        nbytes += blocks * h * 2 * 4
    ops = 4 * int((lims + 1).sum()) * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[cdt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(dev, n, h, d, p, mp, seed=0):
    """Ragged block tables and cursors at 0, mid-page, a page boundary and
    W - 1 (plus seeded others); pool values and vectors from a seed."""
    w = mp * p
    rng = np.random.RandomState(seed)
    starts = np.concatenate([[0, p // 2 - 1, p, w - 1],
                             rng.randint(0, w, n - 4)]).astype(np.int32)
    num_pages = n * mp + 1
    ids = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((n, mp), np.int32)
    k = 0
    for i, s in enumerate(starts):
        need = min(int(s) // p + 1 + int(rng.randint(3)), mp)
        bt[i, :need] = ids[np.arange(k, k + need) % len(ids)]
        k += need
    bt[1, 0] = bt[0, 0]  # a page two rows read, as a shared prefix page
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return dict(pool_k=rand(num_pages, h, p, d) * 0.5, pool_v=rand(num_pages, h, p, d) * 0.5,
                bt=torch.from_numpy(bt).to(dev), start=torch.from_numpy(starts).to(dev),
                q=rand(n, h, d), k_new=rand(n, h, d), v_new=rand(n, h, d), starts=starts)


def check_kernel(dev, shape: dict) -> dict:
    """Kernel vs plain version in every dtype pair the engine can give it,
    at `shape` (n slots, h heads, head dim d, pages of p, mp pages per
    slot); returns the results of the main path's pair (f32 pages, bf16
    compute).

    Held element by element: f32 compute within F32_ATOL; bf16 compute
    within 2 bf16 ulp of its (slot, head) row's scale (`bf16_tolerance`),
    and no more than DIFF_SHARE of the elements may differ at all. The kernel rounds where
    the plain version rounds, so the two differ only where their f32 sums
    straddle a bf16 rounding boundary; a missed rounding step moves many
    elements by an ulp and fails the share."""
    n, h, d, p, mp = (shape[k] for k in ("n", "h", "d", "p", "mp"))
    base = kernel_inputs(dev, n, h, d, p, mp)
    pairs = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.int8, torch.float32),
             (torch.int8, torch.bfloat16)]
    num_pages = n * mp + 1
    main = None
    for pool_dtype, cdt in pairs:
        if pool_dtype == torch.int8:
            pools, scales = [], []
            for nm in ("pool_k", "pool_v"):
                qv, sv = quant_comm.quantize_blocks(base[nm].reshape(num_pages, h, p * d))
                pools.append(qv.reshape(num_pages, h, p, d))
                scales.append(sv)
        else:
            pools = [base["pool_k"].to(pool_dtype), base["pool_v"].to(pool_dtype)]
            scales = [None, None]
        args = (pools[0], pools[1], scales[0], scales[1], base["bt"], base["start"],
                base["q"].to(cdt), base["k_new"].to(cdt), base["v_new"].to(cdt))
        out = pa.paged_attend(*args)
        ref = pa.paged_attend_reference(*args)
        torch.cuda.synchronize()
        assert out.dtype == cdt and out.shape == (n, h, d)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if cdt == torch.float32:
            tol = torch.full_like(diff, F32_ATOL)
            rule = f"atol {F32_ATOL:g} per element (f32 summation order)"
        else:
            tol = bf16_tolerance(ref)
            rule = (f"2 bf16 ulp of the largest output of each (slot, head), at "
                    f"least {F32_ATOL:g}; at most {DIFF_SHARE:g} of elements not "
                    f"bit-equal")
        worst = (diff / tol).max().item()
        share = (diff > 0).float().mean().item()
        ms = graph_ms(lambda: pa.paged_attend(*args), 200)
        call_ms = time_ms(lambda: pa.paged_attend(*args), 200)
        plain_ms = time_ms(lambda: pa.paged_attend_reference(*args), 100)
        bound, bound_by = paged_bound_ms(base["starts"], pool_dtype, cdt, n, h, d, p, mp)
        print(f"paged_attend pool={str(pool_dtype)[6:]} compute={str(cdt)[6:]}: "
              f"max_abs_err {err:.3e}, worst err/tolerance {worst:.3e}, "
              f"{share:.5f} of elements not bit-equal ({rule}); kernel device "
              f"{ms:.5f} ms (CUDA graph), eager call {call_ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms (eager), bound {bound:.5f} ms ({bound_by}, "
              f"{HBM_BYTES_PER_S / 1e12} TB/s)", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"paged_attend disagrees with its plain version: "
                                 f"err/tolerance {worst} > 1 (pool {pool_dtype}, "
                                 f"compute {cdt}, max_abs_err {err})")
        if cdt == torch.bfloat16 and not share <= DIFF_SHARE:
            raise AssertionError(f"paged_attend differs from its plain version on "
                                 f"{share} of elements > {DIFF_SHARE} (pool "
                                 f"{pool_dtype}, compute {cdt})")
        if (pool_dtype, cdt) == (torch.float32, torch.bfloat16):
            main = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=bound_by)
    return main


def build_all() -> None:
    """Build every csrc source at once, one nvcc each, and print each
    build's time and ptxas register/shared-memory report."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        reports = dict(zip(SOURCES, pool.map(_cuda.build, SOURCES)))
    for name, rep in reports.items():
        print(f"{name}: built in {rep['seconds']:.1f} s"
              f"{' (cached)' if rep['cached'] else ''} -> {rep['path']}")
        for line in rep["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  " + line.strip())
    print(f"all sources built in {time.perf_counter() - t0:.1f} s", flush=True)


def worst_ratio(got, ref, f32_tol, dtype) -> tuple[float, float]:
    """(max abs error, worst error/tolerance) of `got` against `ref`,
    element by element. f32: atol + rtol |ref| + share of the largest |ref|
    of the element's last-dim row (`f32_tol`). bf16: BF16_ROW_SHARE of
    that largest |ref|. Past a zero atol no absolute floor is left, so a
    row that is 0 in the plain version must be 0 in the kernel too."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    top = r.abs().amax(-1, keepdim=True)
    if dtype == torch.float32:
        atol, rtol, share = f32_tol
        tol = atol + rtol * r.abs() + share * top
    else:
        tol = BF16_ROW_SHARE * top
    ratio = torch.where(diff == 0, 0.0, diff / tol)
    return diff.max().item(), ratio.max().item()


def hold(what: str, got, ref, f32_tol, dtype) -> float:
    """`worst_ratio` within 1; returns the max abs error, raises past the
    bar."""
    err, worst = worst_ratio(got, ref, f32_tol, dtype)
    if not worst <= 1.0:
        g, r = got.float(), ref.float()
        at = np.unravel_index(int(((g - r).abs() / (r.abs().amax(-1, keepdim=True) + 1e-30))
                                  .argmax()), tuple(r.shape))
        raise AssertionError(f"{what}: kernel disagrees with its plain version, max_abs_err "
                             f"{err:.3e}, worst err/tolerance {worst:.3e}; worst relative to "
                             f"its row at {tuple(int(i) for i in at)}: kernel "
                             f"{g[at].item():.6e}, plain {r[at].item():.6e}, row's largest "
                             f"|plain| {r[at[:-1]].abs().max().item():.6e}")
    return err


def _bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bounds(b, h, s, d, dtype, masked) -> dict:
    """Least times of the forward and of the backward on these shapes: each
    input read once, each output written once (the backward's D = rowsum(dO
    O) is its input), against the products the causal half needs (forward
    QK^T and PV; backward QK^T, dO V^T, P^T dO, dS^T Q, dS K), 2 flops a
    multiply-add, over the dtype's peak."""
    it = torch.tensor([], dtype=dtype).element_size()
    t, rows = b * h * s * d * it, b * h * s * 4
    bias = b * s * 4 if masked else 0
    pairs = b * h * d * s * (s + 1) / 2
    return dict(forward=_bound(4 * t + rows + bias, 2 * 2 * pairs, dtype),
                backward=_bound(7 * t + 2 * rows + bias, 5 * 2 * pairs, dtype))


def flash_flops(b, h, s, d) -> dict:
    """The products the causal half needs, 2 flops a multiply-add: forward
    QK^T and PV, backward QK^T, dO V^T, P^T dO, dS^T Q, dS K (the kernels'
    second dV product, for P's low bf16 term, is not counted)."""
    pairs = b * h * d * s * (s + 1) / 2
    return dict(fwd=2 * 2 * pairs, bwd=5 * 2 * pairs)


def ce_bounds(n, dim, v_pad, dtype) -> dict:
    """Least times of the forward kernel (h, W in h's dtype and the targets
    in; lse, target logit and argmax out; the head product) and of the
    backward kernels (h, W, the targets, lse and both cotangents in; dH in
    h's dtype and dW f32 out; the head product again plus the dH and dW
    products)."""
    it = torch.tensor([], dtype=dtype).element_size()
    h_b, w_b, prod = n * dim * it, dim * v_pad * it, 2 * n * dim * v_pad
    return dict(forward=_bound(h_b + w_b + 4 * n + 12 * n, prod, dtype),
                backward=_bound(2 * h_b + w_b + dim * v_pad * 4 + 16 * n, 3 * prod, dtype))


def flash_inputs(dev, b, h, s, d, dtype, masked, seed):
    """q, k, v, dO from a seed; with `masked`, trailing padding of seeded
    length on every row and one row fully padded."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda: torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    mask = None
    if masked:
        lens = torch.randint(s // 4, s + 1, (b,), generator=g, device=dev)
        mask = torch.arange(s, device=dev)[None, :] >= lens[:, None]
        mask[-1] = True
    return q, k, v, do, mask


def bf16_ulps(got, ref) -> tuple[float, float]:
    """Largest |got - ref| in bf16 ulps (a binade's spacing,
    2^(floor(log2 |x|) - 7)) of the plain element, over elements where
    ref != 0, and of the largest |plain| of the element's row."""
    r = ref.float()
    ulp = lambda x: torch.exp2(torch.floor(torch.log2(x.clamp(min=1e-30))) - 7)
    diff = (got.float() - r).abs()
    own = (diff / ulp(r.abs()))[r != 0].max().item()
    return own, (diff / ulp(r.abs().amax(-1, keepdim=True))).max().item()


def check_flash(dev, b, h, s, d, dtype, masked, timed=False) -> dict:
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the plain
    version on the same inputs; the backward gets the kernel's out and lse
    on both sides, and the plain backward sums in f64 (the same rounding
    points): where dP - D cancels exactly (query 0 sees key 0 alone, so
    its dQ row is 0) its f32 sums, taken in two orders, leave a residue that
    the bf16 bar, relative to the row, cannot hold; the kernels' D is
    formed as their dP is and cancels to 0. D = rowsum(dO O) from the
    preprocess kernel is held to the f32 rowsum (FLASH_FWD_TOL). With
    `timed`, device and call times too."""
    q, k, v, do, mask = flash_inputs(dev, b, h, s, d, dtype, masked, seed=s + b)
    scale = d**-0.5
    bias = fa.pad_bias(mask, b, s, dev)
    out, lse = fa._forward_cuda(q, k, v, bias, scale)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, bias, scale)
    grads = fa._backward_cuda(q, k, v, bias, out, lse, do, scale)
    ref_grads = fa.flash_backward_reference(q, k, v, bias, out, lse, do, scale,
                                            acc=torch.float64)
    lib = _cuda.load("flash_attention", fa._SIGNATURES)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dcap = torch.empty_like(lse)
    dq_b, dk_b, dv_b = (torch.empty_like(q) for _ in range(3))
    fa.launch_backward(lib, q, k, v, bias, do, out, lse, dcap, dq_b, dk_b, dv_b, scale,
                       stream())
    torch.cuda.synchronize()
    tag = f"flash B{b} H{h} S{s} D{d} {str(dtype)[6:]}{' mask' if masked else ''}"
    err = hold(f"{tag} out", out, ref_out, FLASH_FWD_TOL, dtype)
    hold(f"{tag} lse", lse, ref_lse, FLASH_FWD_TOL, torch.float32)
    hold(f"{tag} D", dcap, (do.float() * out.float()).sum(-1), FLASH_FWD_TOL, torch.float32)
    g_err = max(hold(f"{tag} d{n}", gg, rr, FLASH_GRAD_TOL, dtype)
                for n, gg, rr in zip("qkv", grads, ref_grads))
    if not all(torch.equal(x, y) for x, y in zip(grads, (dq_b, dk_b, dv_b))):
        raise AssertionError(f"{tag}: two backward runs on the same inputs differ")
    res = dict(fwd_err=err, bwd_err=g_err)
    top = ", ".join(f"{n} {t.float().abs().max().item():.3e}"
                    for n, t in zip(("out", "dq", "dk", "dv"), (ref_out, *ref_grads)))
    ulps = bf16_ulps(grads[2], ref_grads[2])
    line = (f"{tag}: forward max_abs_err {err:.3e}, backward {g_err:.3e} (largest "
            f"|plain| {top}); dV largest error {ulps[0]:.3f} bf16 ulps of the element, "
            f"{ulps[1]:.3f} of its row's largest; backward bit-identical on a second run")
    if timed:
        o_b, l_b = torch.empty_like(q), torch.empty_like(lse)
        res.update(
            fwd_ms=graph_ms(lambda: fa.launch_forward(lib, q, k, v, bias, o_b, l_b, scale,
                                                      stream()), 20),
            fwd_call_ms=time_ms(lambda: fa._forward_cuda(q, k, v, bias, scale), 20),
            fwd_plain_ms=time_ms(lambda: fa.flash_forward_reference(q, k, v, bias, scale), 5),
            bwd_ms=graph_ms(lambda: fa.launch_backward(lib, q, k, v, bias, do, out, lse, dcap,
                                                       dq_b, dk_b, dv_b, scale, stream()), 10),
            bwd_call_ms=time_ms(lambda: fa._backward_cuda(q, k, v, bias, out, lse, do, scale),
                                10),
            bwd_plain_ms=time_ms(lambda: fa.flash_backward_reference(q, k, v, bias, out, lse,
                                                                     do, scale), 5),
        )
        # the library yardstick: SDPA causal, no pad mask (it takes is_causal
        # or a mask, not both); timed here only, never called by the port
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["fwd_library_ms"] = time_ms(lambda: sdpa(q, k, v, is_causal=True), 20)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o_g = sdpa(qg, kg, vg, is_causal=True)
        res["bwd_library_ms"] = time_ms(
            lambda: torch.autograd.grad(o_g, (qg, kg, vg), do, retain_graph=True), 10)
        bounds = flash_bounds(b, h, s, d, dtype, masked)
        res.update(fwd_bound=bounds["forward"], bwd_bound=bounds["backward"])
        flops = flash_flops(b, h, s, d)
        for way in ("fwd", "bwd"):
            res[f"{way}_tflops"] = flops[way] / res[f"{way}_ms"] / 1e9
            res[f"{way}_bound_share"] = res[f"{way}_bound"][0] / res[f"{way}_ms"]
        line += (f"; forward device {res['fwd_ms']:.4f} ms (CUDA graph), call "
                 f"{res['fwd_call_ms']:.4f}, plain {res['fwd_plain_ms']:.4f}, SDPA "
                 f"{res['fwd_library_ms']:.4f}, bound {bounds['forward'][0]:.4f} ms "
                 f"({bounds['forward'][1]}), {res['fwd_tflops']:.1f} TFLOP/s, "
                 f"{res['fwd_bound_share']:.3f} of the bound; backward (D, dK/dV, dQ) device "
                 f"{res['bwd_ms']:.4f} ms, call {res['bwd_call_ms']:.4f}, plain "
                 f"{res['bwd_plain_ms']:.4f}, SDPA {res['bwd_library_ms']:.4f}, bound "
                 f"{bounds['backward'][0]:.4f} ms ({bounds['backward'][1]}), "
                 f"{res['bwd_tflops']:.1f} TFLOP/s, {res['bwd_bound_share']:.3f} of the bound")
    print(line, flush=True)
    return res


def ce_inputs(dev, n, dim, vocab, dtype, seed):
    """Post-LayerNorm-scale hidden states, a head kernel at tpukit's init
    scale, seeded targets with every 8th row ignored."""
    v_pad = -(-vocab // 128) * 128
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, dim), generator=g, device=dev).to(dtype)
    bound = dim**-0.5
    w = (torch.rand((dim, v_pad), generator=g, device=dev) * 2 - 1) * bound
    tgt = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    tgt[::8] = -100
    return h, w, tgt


def ce_cotangents(dev, tgt, seed) -> dict:
    """Cotangents of (lse, target logit) for holding the CE backward, all
    O(1) and 0 on ignored rows. d = p * g_lse + onehot * g_tgt is linear in
    them, so each term is held alone as well as in the loss's mix: beside
    the target term, which is ~1e3 times larger at this vocab, a dH or dW
    without the softmax term would sit inside a row-relative bar.
      softmax: g_lse seeded randn, g_tgt 0;
      target:  g_lse 0, g_tgt seeded randn;
      loss:    the mean loss's cotangents times the count (g_lse 1,
               g_tgt -1)."""
    valid = (tgt != -100).float()
    g = torch.Generator(device=dev).manual_seed(seed)
    r1 = torch.randn(valid.shape, generator=g, device=dev) * valid
    r2 = torch.randn(valid.shape, generator=g, device=dev) * valid
    zero = torch.zeros_like(valid)
    return {"softmax": (r1, zero), "target": (zero, r2), "loss": (valid, -valid)}


def check_ce(dev, n, dim, vocab, dtype, timed=False) -> dict:
    """Forward (lse, target logit, argmax) and backward (dH, dW) kernels
    against the plain version on the same inputs; the backward under each
    set of `ce_cotangents`. Negative control: under the softmax set, the
    kernel with g_lse zeroed, which is what a kernel that drops the
    p * g_lse term computes, must fail the same bar (and likewise the
    target term under the target set)."""
    h, w, tgt = ce_inputs(dev, n, dim, vocab, dtype, seed=n)
    terms = fce._forward_cuda(h, w, tgt, vocab, True)
    ref = fce.head_terms_reference(h, w, tgt, vocab, True)
    terms_no_argmax = fce._forward_cuda(h, w, tgt, vocab, False)
    torch.cuda.synchronize()
    tag = f"fused_head_ce N{n} dim{dim} vocab{vocab} {str(dtype)[6:]}"
    err = hold(f"{tag} lse", terms[0], ref[0], CE_LSE_TOL, torch.float32)
    err = max(err, hold(f"{tag} target logit", terms[1], ref[1], CE_LSE_TOL, torch.float32))
    if not (torch.equal(terms_no_argmax[0], terms[0]) and torch.equal(terms_no_argmax[1],
                                                                      terms[1])):
        raise AssertionError(f"{tag}: the forward without argmax gives other lse/logits")
    # argmax: equal, or a near tie of the plain version's own logits
    logits = fce._logits(h, w, vocab)
    rows = torch.nonzero(terms[2] != ref[2])[:, 0]
    gap = (logits[rows, ref[2][rows].long()] - logits[rows, terms[2][rows].long()]).abs()
    if len(rows) and gap.max().item() > 1e-4:
        raise AssertionError(f"{tag}: argmax differs on {len(rows)} rows beyond near ties")
    del logits
    g_err, notes = 0.0, []
    cotangents = ce_cotangents(dev, tgt, seed=n + 1)
    for name, (g_lse, g_tgt) in cotangents.items():
        dh, dw = fce._backward_cuda(h, w, tgt, terms[0], g_lse, g_tgt, vocab)
        ref_dh, ref_dw = fce.head_terms_backward_reference(h, w, tgt, terms[0], g_lse, g_tgt,
                                                           vocab)
        torch.cuda.synchronize()
        e_dh = hold(f"{tag} dh ({name})", dh, ref_dh, CE_GRAD_TOL, dtype)
        e_dw = hold(f"{tag} dw ({name})", dw, ref_dw, CE_GRAD_TOL, dtype)
        g_err = max(g_err, e_dh, e_dw)
        note = (f"{name}: dh {e_dh:.3e} (largest |plain| {ref_dh.float().abs().max().item():.3e}"
                f"), dw {e_dw:.3e} ({ref_dw.abs().max().item():.3e})")
        if name in ("softmax", "target"):
            dropped = (torch.zeros_like(g_lse), g_tgt) if name == "softmax" else (
                g_lse, torch.zeros_like(g_tgt))
            bad_dh, bad_dw = fce._backward_cuda(h, w, tgt, terms[0], *dropped, vocab)
            seen = [worst_ratio(bad, good, CE_GRAD_TOL, dtype)[1]
                    for bad, good in ((bad_dh, ref_dh), (bad_dw, ref_dw))]
            if not min(seen) > 1.0:
                raise AssertionError(f"{tag}: the bar cannot see a CE backward without its "
                                     f"{name} term (err/tolerance dh {seen[0]}, dw {seen[1]})")
            note += f"; without the {name} term err/tolerance dh {seen[0]:.3e}, dw {seen[1]:.3e}"
        notes.append(note)
    g_lse, g_tgt = cotangents["loss"]  # the main path's mix, for the timings
    res = dict(fwd_err=err, bwd_err=g_err)
    line = (f"{tag}: forward max_abs_err {err:.3e} (argmax equal on {n - len(rows)}/{n} "
            f"rows, the rest near ties); backward max_abs_err, O(1) cotangents: "
            + "; ".join(notes))
    if timed:
        lib = _cuda.load("fused_head_ce", fce._SIGNATURES)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        w_c = w.to(dtype)  # the kernels' W, rounded to h's dtype by the wrapper
        bufs = [torch.empty_like(terms[0]), torch.empty_like(terms[1]),
                torch.empty_like(terms[2])]
        dh_b, dw_b = torch.empty_like(dh), torch.empty_like(dw)
        res.update(
            fwd_ms=graph_ms(lambda: fce.launch_forward(lib, h, w_c, tgt, *bufs, vocab, False,
                                                       stream()), 5, replays=3),
            fwd_call_ms=time_ms(lambda: fce._forward_cuda(h, w, tgt, vocab, False), 5),
            fwd_argmax_ms=graph_ms(lambda: fce.launch_forward(lib, h, w_c, tgt, *bufs, vocab,
                                                              True, stream()), 5, replays=3),
            fwd_plain_ms=time_ms(lambda: fce.head_terms_reference(h, w, tgt, vocab, False), 3),
            bwd_ms=graph_ms(lambda: fce.launch_backward(lib, h, w_c, tgt, terms[0], g_lse, g_tgt,
                                                        dh_b, dw_b, vocab, stream()), 3,
                            replays=3),
            bwd_call_ms=time_ms(lambda: fce._backward_cuda(h, w, tgt, terms[0], g_lse, g_tgt,
                                                           vocab), 5),
            bwd_plain_ms=time_ms(lambda: fce.head_terms_backward_reference(
                h, w, tgt, terms[0], g_lse, g_tgt, vocab), 3),
        )
        # two PyTorch calls, not one: no single call does head + CE without
        # logits, so library_ms stays null; this is printed only
        ce = torch.nn.functional.cross_entropy
        two = time_ms(lambda: ce(torch.matmul(h, w.to(dtype)).float(), tgt.long(),
                                 ignore_index=-100), 3)
        bounds = ce_bounds(n, dim, w.shape[1], dtype)
        res.update(fwd_bound=bounds["forward"], bwd_bound=bounds["backward"])
        line += (f"; forward device {res['fwd_ms']:.3f} ms (CUDA graph; "
                 f"{res['fwd_argmax_ms']:.3f} with argmax), call {res['fwd_call_ms']:.3f}, "
                 f"plain {res['fwd_plain_ms']:.3f}, bound {bounds['forward'][0]:.4f} ms "
                 f"({bounds['forward'][1]}); backward device {res['bwd_ms']:.3f} ms, call "
                 f"{res['bwd_call_ms']:.3f}, plain {res['bwd_plain_ms']:.3f}, bound "
                 f"{bounds['backward'][0]:.4f} ms ({bounds['backward'][1]}); matmul + "
                 f"F.cross_entropy (two calls, forward only) {two:.3f} ms")
    print(line, flush=True)
    return res


def check_training_kernels(dev) -> dict:
    """Phase 6: every training kernel against its plain version at the
    slice's shapes, bf16 and f32, with and without a pad mask, the flash
    kernels also at the recipe's S = 511 (a ragged last tile) and at S = 2048
    (several key tiles: the long-sequence gradients tpukit's split backward
    computes), at the gpt-small-dim768 rung's shapes
    (`recipes/profile.py`), and each bf16 flash instance (D = 16, 32, 64,
    128) at S = 511, 512 and 2048 with and without a pad mask. Returns the
    timed main-path runs."""
    g = GPT2_SMALL_TRAIN
    b, s, hh, d = BATCH, SEQ, g["heads"], g["head_dim"]
    main = {"flash": check_flash(dev, b, hh, s, d, torch.bfloat16, True, timed=True)}
    check_flash(dev, b, hh, s, d, torch.bfloat16, False)
    check_flash(dev, 8, hh, s, d, torch.float32, True)
    check_flash(dev, 8, hh, s, d, torch.float32, False)
    check_flash(dev, 8, hh, s - 1, d, torch.bfloat16, True)  # the recipe's S (phase 9)
    check_flash(dev, 2, hh, 2048, d, torch.bfloat16, True)
    check_flash(dev, 2, hh, 2048, d, torch.float32, True)
    # every bf16 instance (head dim 16, 32, 64, 128) at S = 511, 512, 2048,
    # with and without a pad mask, at a small batch
    done = {(512, True), (512, False), (511, True), (2048, True)}  # D = 64, above
    for dd in fa.HEAD_DIMS:
        for ss in (511, 512, 2048):
            for masked in (True, False):
                if dd != d or (ss, masked) not in done:
                    check_flash(dev, 2, 6, ss, dd, torch.bfloat16, masked)
    main["ce"] = check_ce(dev, b * s, g["dim"], g["vocab_size"], torch.bfloat16, timed=True)
    check_ce(dev, 4096, g["dim"], g["vocab_size"], torch.float32)
    check_ce(dev, 4000, g["dim"], g["vocab_size"], torch.bfloat16)
    return main


def attention_crossover(dev, seqs=(16, 32, 64, 128, 256, 384, 512, 1024),
                        tokens=BATCH * SEQ) -> dict:
    """Where `attention_impl="auto"` should switch: one attention call,
    forward and backward through autograd, by the eager "xla" path and by
    the flash kernels, at the rung's 32768 tokens per call (batch
    tokens // S), 12 heads x 64, bf16, with a pad mask of seeded trailing
    padding; mean eager-call time by CUDA events and the peak memory the
    call adds. Returns {S: {impl: (ms, peak bytes)}}."""
    g = GPT2_SMALL_TRAIN
    hh, d = g["heads"], g["head_dim"]
    table = {}
    for s in seqs:
        b = tokens // s
        q, k, v, do, mask = flash_inputs(dev, b, hh, s, d, torch.bfloat16, True, seed=s)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        row = {}
        for impl in ("xla", "flash"):
            def call():
                out = causal_attention(qg, kg, vg, scale=d**-0.5, pad_mask=mask, impl=impl)
                torch.autograd.grad(out, (qg, kg, vg), do)
            ms = time_ms(call, 10)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            row[impl] = (ms, torch.cuda.max_memory_allocated() - base)
        table[s] = row
        print(f"attention B{b} H{hh} S{s} D{d} bf16 mask, forward + backward: xla "
              f"{row['xla'][0]:.4f} ms (peak +{row['xla'][1]} B), flash {row['flash'][0]:.4f} "
              f"ms (peak +{row['flash'][1]} B), flash/xla time {row['flash'][0] / row['xla'][0]:.3f}",
              flush=True)
    faster = [s for s in seqs if all(table[t]["flash"][0] <= table[t]["xla"][0]
                                     for t in seqs if t >= s)]
    print(f"flash is at least as fast as xla from S = {faster[0]} up (of {list(seqs)}); "
          f"`auto` picks flash from FLASH_MIN_SEQ = {FLASH_MIN_SEQ}"
          if faster else f"flash is slower than xla at every S of {list(seqs)}", flush=True)
    return table


def reset_counts() -> None:
    pa.launches = 0
    for counts in (fa.launches, fce.launches, moe_gemm.launches):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return dict(paged=pa.launches, **{f"flash_{k}": v for k, v in fa.launches.items()},
                **{f"ce_{k}": v for k, v in fce.launches.items()},
                **{f"moe_{k}": v for k, v in moe_gemm.launches.items()})


def train_full_width(dev) -> dict:
    """Phase 7: eight train steps of the gpt-small-dim768 rung (batch 64,
    S 512, bf16) on synthetic batches: three full batches and one with 16
    padded rows, each twice. Checks the loss (finite; lower on batch A's
    second visit) and the launch counts; returns them with the step walls."""
    cfg, state = build_train(dev)
    rng = np.random.RandomState(0)
    a, b, c = (to_device(*synthetic_batch(rng, cfg.vocab_size, BATCH, SEQ), dev)
               for _ in range(3))
    p = to_device(*synthetic_batch(rng, cfg.vocab_size, BATCH, SEQ, pad_rows=16), dev)
    strategy = SingleDevice()
    float(train_step(state, cfg, strategy, *p))  # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for batch in (a, b, c, p, a, b, c, p):
        t0 = time.perf_counter()
        losses.append(float(train_step(state, cfg, strategy, *batch)))  # syncs
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    steps, layers = len(losses), cfg.num_layers
    wall = float(np.mean(walls))
    print(f"losses {[round(x, 4) for x in losses]}; step walls (s) "
          f"{[round(w, 4) for w in walls]}; mean {wall:.4f} s, {BATCH * SEQ / wall:.1f} "
          f"tokens/s; max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    print(f"launches in {steps} steps: {counts}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[4] < losses[0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses[0]} -> "
                             f"{losses[4]}")
    want = dict(paged=0, flash_forward=layers * steps, flash_backward_dcap=layers * steps,
                flash_backward_dkv=layers * steps, flash_backward_dq=layers * steps,
                ce_forward=steps, ce_backward_dw=steps,
                ce_backward_dh=steps, **{f"moe_{k}": 0 for k in moe_gemm.launches})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return dict(counts=counts, wall=wall, losses=losses)


def kernel_vs_plain_steps(dev) -> None:
    """Phase 8: the train step through the kernels (CUDA) against the same
    step through the plain versions (the CPU), f32, 2 layers at GPT-2-small
    width, flash attention forced, batch 4 with a padded row, 4 steps from
    the same parameters on the same batches. Losses within rtol 1e-4: f32 on
    both sides, summation order only, carried through four AdamW steps."""
    cpu = torch.device("cpu")
    cfg, cpu_state = build_train(cpu, num_layers=2, compute_dtype=torch.float32,
                                 attention_impl="flash", seed=1)
    params = cpu_state.params
    dev_state = create_train_state(
        unflatten(params, [t.detach().to(dev, copy=True) for t in leaves(params)]), 1e-4)
    rng = np.random.RandomState(1)
    batches = [synthetic_batch(rng, cfg.vocab_size, 4, SEQ, pad_rows=1) for _ in range(4)]
    strategy = SingleDevice()
    reset_counts()
    ours, plain = [], []
    for batch in batches:
        ours.append(float(train_step(dev_state, cfg, strategy, *to_device(*batch, dev))))
        plain.append(float(train_step(cpu_state, cfg, strategy, *to_device(*batch, cpu))))
    counts = read_counts()
    worst = max(abs(a - b) / abs(b) for a, b in zip(ours, plain))
    print(f"kernels {ours} vs plain {plain}: worst relative difference {worst:.3e} (bar "
          f"1e-4); launches {counts}", flush=True)
    if counts["flash_forward"] != 2 * 4 or counts["ce_backward_dh"] != 4:
        raise AssertionError(f"the CUDA steps did not run the kernels: {counts}")
    if not worst <= 1e-4:
        raise AssertionError(f"kernel and plain train steps disagree: {ours} vs {plain}")


def recipe_end_to_end(dev) -> dict:
    """Phase 9: `python -m tpukit_torch.recipes.single` at GPT-2-small width
    on 576 fixture stories (9 steps of 64), 1 epoch, bf16, in
    build/chip_smoke/. `--sequence_length 512`: the recipe trains on
    S - 1 positions (prepare_batch's shift), so S = 511 (a ragged last key
    tile) is in front of the attention, where "auto" picks the flash
    kernels. Checks that the
    flash, CE and paged kernels ran, the eval metrics are finite, three
    samples came back, and the checkpoint restores."""
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    argv = ["--dim", "768", "--head_dim", "64", "--heads", "12", "--num_layers", "12",
            "--sequence_length", "512", "--batch_size", "64", "--epochs", "1",
            "--dataset_slice", "576", "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_counts()
        t0 = time.perf_counter()
        result = single.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        restored = _restores_exactly(result, dev)
    finally:
        os.chdir(cwd)
    print(f"recipe: {wall:.1f} s, eval {result.metrics['eval']}, {len(result.metrics['samples'])} "
          f"samples, {result.metrics['tokens_per_sec']:.1f} train tokens/s, checkpoint "
          f"{result.checkpoint_path}; launches {counts}", flush=True)
    if min(v for k, v in counts.items() if not k.startswith("moe_")) == 0:
        raise AssertionError(f"a kernel of the recipe's path never ran: {counts}")
    if not np.isfinite(result.metrics["eval"]["loss"]) or len(result.metrics["samples"]) != 3:
        raise AssertionError(f"recipe output: {result.metrics}")
    if not restored:
        raise AssertionError(f"checkpoint {result.checkpoint_path} did not restore exactly")
    return counts


def serve_run(params, cfg, serve, reqs, dev, eos_id):
    engine = ServeEngine(params, cfg, serve, eos_id=eos_id, device=dev)
    comps = engine.run(list(reqs))
    torch.cuda.synchronize()
    return engine, {c.rid: np.asarray(c.ids) for c in comps}


def check_outputs(outs, reqs, cfg) -> None:
    assert sorted(outs) == [r.rid for r in reqs], "not every request completed"
    for r in reqs:
        ids = outs[r.rid]
        gen = len(ids) - len(r.ids)
        assert 0 <= gen <= r.max_new_tokens, (r.rid, gen)
        assert np.array_equal(ids[: len(r.ids)], r.ids), r.rid
        assert ((ids >= 0) & (ids < cfg.vocab_size)).all(), r.rid


def agreement(a: dict, b: dict) -> float:
    """tpukit's int8 gate (tests/test_paged.py): per request, the share of
    positions (prompt included) where the two token streams agree, over
    their common length; averaged over requests."""
    return float(np.mean([np.mean(a[r][: min(len(a[r]), len(b[r]))]
                                  == b[r][: min(len(a[r]), len(b[r]))]) for r in a]))


def moe_bank(dev, e, d, f, dtype, seed):
    """An expert bank (Wu, bu, Wd, bd) at tpukit's init scale, U(+-1 /
    sqrt(fan_in)), from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda shape, fan_in: ((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                               * fan_in**-0.5).to(dtype)
    return u((e, d, f), d), u((e, f), d), u((e, f, d), f), u((e, d), f)


def moe_layouts(dev) -> dict:
    """name -> (rows f32 [M, 768] on the card, offsets [9] int32, real rows
    n), rows N(0, 1) from a seed:
      equal:       recipe 8's capacity buffer on one device: 8 experts x
                   batch 32 x capacity 80, 2560 rows each (M 20480);
      top1, top2:  `sort_plan` of the top-k routing of seeded [32, 512, 768]
                   tokens by a seeded router at init scale (M 16384, 32768);
      adversarial: segments of 3000, 0, 1, 129, 2047, 130, 1 and 4691 rows
                   (an empty expert, 1-row segments, segments across row
                   tiles) and a padding tail of 241 rows in the last one."""
    g = torch.Generator(device=dev).manual_seed(10)
    d, e = GPT2_SMALL_TRAIN["dim"], MOE_ROUTED["experts"]
    rows = lambda m: torch.randn((m, d), generator=g, device=dev)
    out = {}
    m = e * MOE_ROUTED["batch"] * 80
    offs = torch.arange(e + 1, dtype=torch.int32, device=dev) * (m // e)
    out["equal"] = (rows(m), offs, m)
    x = torch.randn((MOE_ROUTED["batch"], MOE_ROUTED["seq"], d), generator=g, device=dev)
    router = (torch.rand((d, e), generator=g, device=dev) * 2 - 1) * d**-0.5
    for k in (1, 2):
        cfg = GPTConfig(dim=d, head_dim=64, heads=12, num_layers=1, num_experts=e,
                        router_top_k=k, max_position_embeddings=MOE_ROUTED["seq"],
                        moe_dispatch="pallas")
        _, top_idx, _, _, _ = _route_topk(x, router, cfg)
        src, _, offs = moe_gemm.sort_plan(cfg, top_idx)
        out[f"top{k}"] = (x.reshape(-1, d).index_select(0, src), offs, top_idx.numel())
    sizes = MOE_ADVERSARIAL
    n = sum(sizes)
    m = moe_gemm.plan_rows(n)[1]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    offs[-1] = m
    out["adversarial"] = (rows(m), torch.from_numpy(offs).to(dev), n)
    return out


def moe_bounds(offsets, m, d, f, dtype) -> dict:
    """Least times of the forward (rows and the bank of every expert with
    rows in, y out; 2 products over the M rows) and of the backward (rows,
    g, y and the kept h in, the bank read; dx out in the compute dtype,
    dW and db of all E experts out in f32; 4 products)."""
    it = torch.tensor([], dtype=dtype).element_size()
    o = offsets.tolist()
    e = len(o) - 1
    used = sum(1 for i in range(e) if o[i + 1] > o[i])
    bank = used * (2 * d * f + f + d) * it
    prod = 2 * m * d * f
    fwd = _bound(2 * m * d * it + bank + 4 * (e + 1), 2 * prod, dtype)
    bwd = _bound(4 * m * d * it + m * f * it + bank + e * (2 * d * f + f + d) * 4 + 4 * (e + 1),
                 4 * prod, dtype)
    return dict(forward=fwd, backward=bwd)


def check_moe(dev, name, rows, offsets, n, dtype, timed=False) -> dict:
    """Forward (y) and backward (dx, dWu, dbu, dWd, dbd) kernels against the
    plain versions on the same inputs: the backward under O(1) seeded
    cotangents (0 on the padding rows; the mean loss's would be ~1/count)
    and the kernel's y and kept h on both sides. Padding rows get exactly 0 dx, empty
    experts exactly 0 gradients. Negative controls: the plain backward
    without the relu mask on dz1 must fail the bar on dx, dWu and dbu, and
    (bf16) with dbu summed from the rounded dz1 on dbu. With `timed`, device,
    call and plain times and the bounds too."""
    e, d, f = MOE_ROUTED["experts"], GPT2_SMALL_TRAIN["dim"], 4 * GPT2_SMALL_TRAIN["dim"]
    wu, bu, wd, bd = moe_bank(dev, e, d, f, dtype, seed=len(name))
    xs = rows.to(dtype)
    m = xs.shape[0]
    g = torch.Generator(device=dev).manual_seed(m + len(name))
    cot = torch.randn((m, d), generator=g, device=dev)
    cot[n:] = 0.0
    cot = cot.to(dtype)
    ys, h = moe_gemm._forward_cuda(xs, wu, bu, wd, bd, offsets)
    ref_y = moe_gemm.grouped_ffn_reference(xs, wu, bu, wd, bd, offsets)
    grads = moe_gemm._backward_cuda(xs, cot, ys, h, wu, wd, offsets)
    # the same inputs as the kernels: y and the kept h (a relu mask on an
    # f32 h recomputed within summation noise of 0 would flip one side only)
    refs = moe_gemm.grouped_ffn_backward_reference(xs, cot, ys, wu, bu, wd, offsets, h=h)
    torch.cuda.synchronize()
    tag = f"grouped_ffn {name} M{m} {str(dtype)[6:]}"
    bar = lambda nm: dtype if nm in MOE_ROUNDED else torch.float32  # noqa: E731
    err = hold(f"{tag} y", ys, ref_y, MOE_TOL, bar("y"))
    names = ("dx", "dwu", "dbu", "dwd", "dbd")
    g_err = max(hold(f"{tag} {nm}", got, ref, MOE_TOL, bar(nm))
                for nm, got, ref in zip(names, grads, refs))
    if not (grads[0][n:] == 0).all():
        raise AssertionError(f"{tag}: padding rows got a nonzero dx")
    o = offsets.tolist()
    empty = [i for i in range(e) if o[i + 1] == o[i]]
    if any((t[i] != 0).any() for t in grads[1:] for i in empty):
        raise AssertionError(f"{tag}: an empty expert got a nonzero gradient")
    # an h of ones: the plain backward with no relu mask on dz1 (its dWd,
    # from that h, is not compared)
    bad = moe_gemm.grouped_ffn_backward_reference(xs, cot, ys, wu, bu, wd, offsets,
                                                  h=torch.ones_like(h))[:3]
    seen = [worst_ratio(b, r, MOE_TOL, bar(nm))[1] for nm, b, r in zip(names, bad, refs)]
    if not min(seen) > 1.0:
        raise AssertionError(f"{tag}: the bar cannot see a backward without the relu mask on "
                             f"dz1 (err/tolerance dx, dwu, dbu {seen})")
    note = (f"without the dz1 relu mask err/tolerance dx {seen[0]:.3e}, dwu {seen[1]:.3e}, "
            f"dbu {seen[2]:.3e}")
    if dtype == torch.bfloat16:
        rounded = torch.zeros_like(refs[2])
        for i, s, t in moe_gemm._segments(offsets, e):
            dz2 = torch.where(ys[s:t] > 0, cot[s:t].float(), 0.0).to(dtype).float()
            dz1 = torch.where(h[s:t] > 0, dz2 @ wd[i].float().t(), 0.0)
            rounded[i] = dz1.to(dtype).float().sum(0)  # dbu from the rounded dz1
        seen_r = worst_ratio(rounded, refs[2], MOE_TOL, torch.float32)[1]
        if not seen_r > 1.0:
            raise AssertionError(f"{tag}: the bar cannot see a dbu summed from the rounded dz1 "
                                 f"(err/tolerance {seen_r})")
        note += f"; dbu from the rounded dz1 {seen_r:.3e}"
    counts = [o[i + 1] - o[i] for i in range(e)]
    top = ", ".join(f"{nm} {t.float().abs().max().item():.3e}"
                    for nm, t in zip(("y",) + names, (ref_y,) + tuple(refs)))
    line = (f"{tag} (segments {counts}, {m - n} padding rows): forward max_abs_err {err:.3e}, "
            f"backward {g_err:.3e} (largest |plain| {top}); {note}")
    res = dict(fwd_err=err, bwd_err=g_err)
    if timed:
        lib = _cuda.load("moe_gemm", moe_gemm._SIGNATURES)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        y_b, h_b, dz1_b = torch.empty_like(ys), torch.empty_like(h), torch.empty_like(h)
        part_b = torch.empty((moe_gemm.row_tiles(lib, dtype, m, e), f), device=dev)
        dx_b = torch.empty_like(xs)
        dw_b = [torch.empty_like(t) for t in grads[1:]]
        res.update(
            fwd_ms=graph_ms(lambda: moe_gemm.launch_forward(lib, xs, wu, bu, wd, bd, offsets, h_b,
                                                            y_b, stream()), 20),
            fwd_call_ms=time_ms(lambda: moe_gemm._forward_cuda(xs, wu, bu, wd, bd, offsets), 20),
            fwd_plain_ms=time_ms(lambda: moe_gemm.grouped_ffn_reference(xs, wu, bu, wd, bd,
                                                                        offsets), 5),
            bwd_ms=graph_ms(lambda: moe_gemm.launch_backward(lib, xs, cot, ys, h, wu, wd, offsets,
                                                             dz1_b, part_b, dx_b, *dw_b,
                                                             stream()), 10),
            bwd_call_ms=time_ms(lambda: moe_gemm._backward_cuda(xs, cot, ys, h, wu, wd, offsets),
                                10),
            bwd_plain_ms=time_ms(lambda: moe_gemm.grouped_ffn_backward_reference(
                xs, cot, ys, wu, bu, wd, offsets, h=h), 3),
        )
        bounds = moe_bounds(offsets, m, d, f, dtype)
        res.update(fwd_bound=bounds["forward"], bwd_bound=bounds["backward"])
        line += (f"; forward device {res['fwd_ms']:.4f} ms (CUDA graph), call "
                 f"{res['fwd_call_ms']:.4f}, plain {res['fwd_plain_ms']:.4f}, bound "
                 f"{bounds['forward'][0]:.4f} ms ({bounds['forward'][1]}); backward device "
                 f"{res['bwd_ms']:.4f} ms, call {res['bwd_call_ms']:.4f}, plain "
                 f"{res['bwd_plain_ms']:.4f}, bound {bounds['backward'][0]:.4f} ms "
                 f"({bounds['backward'][1]}); library: none (no one PyTorch call computes "
                 f"the grouped FFN)")
    print(line, flush=True)
    return res


def check_moe_kernels(dev) -> dict:
    """Phase 10: the grouped-expert kernels against their plain versions on
    every layout of `moe_layouts`, bf16 and f32; times on the recipe's
    equal segments in bf16 (the main path) and on the top-1 routing's.
    Returns the timed main-path run."""
    main = None
    for name, (rows, offsets, n) in moe_layouts(dev).items():
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16 and name in ("equal", "top1")
            res = check_moe(dev, name, rows, offsets, n, dtype, timed=timed)
            if timed and name == "equal":
                main = res
    return main


def moe_train_full_width(dev) -> dict:
    """Phase 11: eight train steps of the gpt-small-dim768-e8 rung (batch 32,
    S 512, bf16, 8 experts top-1, ExpertParallel 1 x 1, pallas dispatch) on
    synthetic batches: three full ones and one with 8 padded rows, each
    twice. Checks the loss (finite; lower on batch A's second visit) and the
    launch counts; returns them with the step walls and peak memory."""
    rows, moe, kind = RUNGS["gpt-small-dim768-e8"]
    cfg, state = build_train(dev, **moe)
    rng = np.random.RandomState(0)
    a, b, c = (to_device(*synthetic_batch(rng, cfg.vocab_size, rows, SEQ), dev)
               for _ in range(3))
    p = to_device(*synthetic_batch(rng, cfg.vocab_size, rows, SEQ, pad_rows=8), dev)
    strategy = rung_strategy(kind)
    float(train_step(state, cfg, strategy, *p))  # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for batch in (a, b, c, p, a, b, c, p):
        t0 = time.perf_counter()
        losses.append(float(train_step(state, cfg, strategy, *batch)))  # syncs
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    steps, layers = len(losses), cfg.num_layers
    wall = float(np.mean(walls))
    peak = torch.cuda.max_memory_allocated()
    print(f"losses {[round(x, 4) for x in losses]}; step walls (s) "
          f"{[round(w, 4) for w in walls]}; mean {wall:.4f} s, {rows * SEQ / wall:.1f} "
          f"tokens/s; max_memory_allocated {peak} B")
    print(f"launches in {steps} steps: {counts}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[4] < losses[0]:
        raise AssertionError(f"the loss on a repeated batch did not fall: {losses[0]} -> "
                             f"{losses[4]}")
    want = dict(paged=0, flash_forward=layers * steps, flash_backward_dcap=layers * steps,
                flash_backward_dkv=layers * steps, flash_backward_dq=layers * steps,
                ce_forward=steps, ce_backward_dw=steps,
                ce_backward_dh=steps, **{f"moe_{k}": layers * steps for k in moe_gemm.launches})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return dict(counts=counts, wall=wall, losses=losses, peak=peak)


def moe_kernel_vs_plain_steps(dev) -> None:
    """Phase 12: the MoE train step through the kernels (CUDA) against the
    same step through the plain versions (the CPU): f32, 2 layers at
    GPT-2-small width, 8 experts top-2, flash attention forced, batch 2 with
    a padded row, 4 steps from the same parameters on the same batches; on
    ExpertParallel 1 x 1 with the pallas dispatch and on the meshless
    dropless path. First every gradient leaf of the first batch, router
    and experts included, at the starting parameters: |kernel - plain| /
    |plain| within 1e-3 over each leaf (Frobenius norms). The bar is on the
    leaf's norm, not per element: a relu input within f32 summation noise
    of 0 falls on opposite sides of the mask on the two sides and moves a
    whole dz1 element, so a few elements of the expert and norm gradients
    lie far apart, while a mis-wired gradient moves the norm by O(1). Held
    on the gradients, not on the parameters after the steps: AdamW's first
    steps move an element by about +-lr whatever the size of its gradient,
    so one near-zero gradient of another sign would leave 2 lr between the
    two. Then the losses of the four steps within rtol 1e-4 (f32,
    summation order, four AdamW steps)."""
    cpu = torch.device("cpu")
    for label, strategy, kw in (("ExpertParallel 1x1 pallas", ExpertParallel(dispatch="pallas"),
                                 {}),
                                ("dropless pallas", SingleDevice(), dict(moe_dispatch="pallas"))):
        cfg, cpu_state = build_train(cpu, num_layers=2, compute_dtype=torch.float32,
                                     attention_impl="flash", seed=2, num_experts=8,
                                     router_top_k=2, **kw)
        params = cpu_state.params
        dev_state = create_train_state(
            unflatten(params, [t.detach().to(dev, copy=True) for t in leaves(params)]), 1e-4)
        rng = np.random.RandomState(2)
        batches = [synthetic_batch(rng, cfg.vocab_size, 2, SEQ, pad_rows=1) for _ in range(4)]
        grads = [strategy.value_and_grad(state.params, cfg, *to_device(*batches[0], d))[1]
                 for state, d in ((dev_state, dev), (cpu_state, cpu))]
        rel = {}
        for path, got, ref in zip(ckpt_lib.paths(grads[1]), leaves(grads[0]), leaves(grads[1])):
            diff = (got.cpu() - ref).norm()
            rel[path] = float(diff / ref.norm()) if diff > 0 else 0.0
        worst_leaf = max(rel, key=rel.get)
        print(f"{label}: {len(rel)} gradient leaves at the starting parameters, |kernel - "
              f"plain| / |plain| at most {rel[worst_leaf]:.3e} ({worst_leaf}; bar 1e-3)",
              flush=True)
        if not rel[worst_leaf] <= 1e-3:
            raise AssertionError(f"{label}: kernel and plain gradients disagree: {rel}")
        reset_counts()
        ours, plain = [], []
        for batch in batches:
            ours.append(float(train_step(dev_state, cfg, strategy, *to_device(*batch, dev))))
            plain.append(float(train_step(cpu_state, cfg, strategy, *to_device(*batch, cpu))))
        counts = read_counts()
        worst = max(abs(a - b) / abs(b) for a, b in zip(ours, plain))
        print(f"{label}: kernels {ours} vs plain {plain}: worst relative difference "
              f"{worst:.3e} (bar 1e-4); launches {counts}", flush=True)
        if counts["moe_forward_up"] != 2 * 4 or counts["moe_backward_dwd"] != 2 * 4:
            raise AssertionError(f"{label}: the CUDA steps did not run the MoE kernels: {counts}")
        if not worst <= 1e-4:
            raise AssertionError(f"{label}: kernel and plain train steps disagree: {ours} vs "
                                 f"{plain}")


def _restores_exactly(result, dev) -> bool:
    """The recipe's final checkpoint restores into a fresh state, bit for bit."""
    other = create_train_state(init_params(result.config, seed=5, device=dev), 1e-4)
    ckpt_lib.restore(result.checkpoint_path, other)
    want = dict(zip(ckpt_lib.paths(result.state.params), leaves(result.state.params)))
    got = dict(zip(ckpt_lib.paths(other.params), leaves(other.params)))
    return other.step == result.state.step and all(torch.equal(got[n], want[n]) for n in want)


def moe_recipe_end_to_end(dev) -> dict:
    """Phase 13: `python -m tpukit_torch.recipes.moe --num_experts 8
    --moe_dispatch pallas` at GPT-2-small width on 288 fixture stories (9
    steps of 32), `--sequence_length 512`, 1 epoch, bf16, in
    build/chip_smoke_moe/. Checks that the grouped-expert, flash, CE and
    paged kernels ran, the eval metrics are finite, three samples came
    back, and the checkpoint restores."""
    work = ROOT / "build" / "chip_smoke_moe"
    work.mkdir(parents=True, exist_ok=True)
    argv = ["--dim", "768", "--head_dim", "64", "--heads", "12", "--num_layers", "12",
            "--sequence_length", "512", "--batch_size", "32", "--epochs", "1",
            "--dataset_slice", "288", "--device", "cuda", "--num_experts", "8",
            "--moe_dispatch", "pallas"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_counts()
        t0 = time.perf_counter()
        result = moe_recipe.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        restored = _restores_exactly(result, dev)
    finally:
        os.chdir(cwd)
    print(f"recipe 8: {wall:.1f} s, {result.state.step} steps, windows "
          f"{result.metrics['train_windows']}, eval {result.metrics['eval']}, "
          f"{len(result.metrics['samples'])} samples {result.metrics['samples']}, "
          f"{result.metrics['tokens_per_sec']:.1f} train tokens/s, checkpoint "
          f"{result.checkpoint_path}; launches {counts}", flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of recipe 8's path never ran: {counts}")
    if not np.isfinite(result.metrics["eval"]["loss"]) or len(result.metrics["samples"]) != 3:
        raise AssertionError(f"recipe 8 output: {result.metrics}")
    if not restored:
        raise AssertionError(f"checkpoint {result.checkpoint_path} did not restore exactly")
    return counts


def moe_serving(dev) -> dict:
    """Phase 14: the MoE model at GPT-2-small width (8 experts, top-1, the
    pallas dispatch, bf16) serves phase 4's 64-request stream with fused
    decoding. Every forward (one per prefill dispatch and per decode tick)
    runs each layer's grouped forward once, and each decode tick the paged
    kernel once per layer."""
    cfg, params, serve, reqs, eos = build(dev, fused=True, num_experts=8)
    serve_run(params, cfg, serve, reqs[:4], dev, eos)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine, outs = serve_run(params, cfg, serve, reqs, dev, eos)
    wall = time.perf_counter() - t0
    counts = read_counts()
    s = engine.last_summary
    print(f"MoE served {s['requests']} requests / {s['generated_tokens']} tokens in "
          f"{wall:.3f} s ({s['generated_tokens'] / wall:.1f} tokens/s), decode ticks "
          f"{engine.steps}, prefill dispatches {s['prefill_dispatches']}, prefill "
          f"{s['prefill_s']:.3f} s / decode {s['decode_s']:.3f} s / sync {s['sync_s']:.3f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; launches {counts}",
          flush=True)
    check_outputs(outs, reqs, cfg)
    forwards = s["prefill_dispatches"] + engine.steps
    if counts["moe_forward_up"] != cfg.num_layers * forwards or forwards == 0:
        raise AssertionError(f"grouped forward launches {counts['moe_forward_up']} != "
                             f"{cfg.num_layers} x ({s['prefill_dispatches']} + {engine.steps})")
    if counts["paged"] != cfg.num_layers * engine.steps or counts["moe_backward_dh"] != 0:
        raise AssertionError(f"serving launches {counts}")
    return dict(counts=counts, tokens_per_s=s["generated_tokens"] / wall, wall=wall)


def moe_fused_vs_unfused(dev) -> None:
    """Phase 15: the MoE model at f32 (4 layers, 8 experts, pallas): the
    64-request stream's greedy tokens equal fused and unfused on the card,
    and the first 16 requests' tokens equal those of the same engine
    through the plain versions on the CPU."""
    cfg, params, serve, reqs, eos = build(dev, fused=True, num_layers=4,
                                          compute_dtype=torch.float32, num_experts=8)
    runs = {}
    for label, kw in (("fused", {}), ("unfused", dict(fused_decode=False))):
        _, runs[label] = serve_run(params, cfg, dataclasses.replace(serve, **kw), reqs, dev, eos)
        check_outputs(runs[label], reqs, cfg)
    cpu = torch.device("cpu")
    cpu_params = unflatten(params, [t.to(cpu) for t in leaves(params)])
    _, runs["plain"] = serve_run(cpu_params, cfg, serve, reqs[:16], cpu, eos)
    for label, rids in (("unfused", [r.rid for r in reqs]), ("plain", [r.rid for r in reqs[:16]])):
        for rid in rids:
            if not np.array_equal(runs["fused"][rid], runs[label][rid]):
                raise AssertionError(f"MoE fused kernel tokens and {label} tokens diverge: rid "
                                     f"{rid}")
    print(f"MoE fused == unfused on all {len(reqs)} requests "
          f"({sum(len(v) for v in runs['fused'].values())} tokens incl. prompts); == the plain "
          f"versions on the CPU for the first 16", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs one CUDA GPU",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase("build")
    build_all()

    # the serving run of phase 4 fixes the kernel's shapes for phase 3
    cfg, params, serve, reqs, eos = build(dev, fused=True)
    shape = dict(n=serve.slots, h=cfg.heads, d=cfg.head_dim, p=serve.page_size,
                 mp=serve.pages_per_slot)
    print(f"{KERNEL} dynamic shared memory per block at the serving shapes: "
          f"{4 * (shape['d'] + shape['mp'] * shape['p'] + pa.KERNEL_THREADS)} B "
          f"(query, window scores, reduction scratch)", flush=True)

    phase("kernel vs plain")
    main_pair = check_kernel(dev, shape)

    phase("serve (GPT-2 small width, bf16, fused decode)")
    serve_run(params, cfg, serve, reqs[:4], dev, eos)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    engine, outs = serve_run(params, cfg, serve, reqs, dev, eos)
    wall = time.perf_counter() - t0
    launches = pa.launches
    s = engine.last_summary
    print(f"served {s['requests']} requests / {s['generated_tokens']} tokens in "
          f"{wall:.3f} s ({s['generated_tokens'] / wall:.1f} tokens/s), occupancy "
          f"{s['mean_occupancy']:.3f}, decode ticks {engine.steps}, prefill "
          f"{s['prefill_s']:.3f} s / decode {s['decode_s']:.3f} s / sync {s['sync_s']:.3f} s, "
          f"kv_bytes {s['kv_bytes']}, max_live_slots {s['max_live_slots']}, prefix hits "
          f"{s['prefix_hits']}, max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    print(f"paged_attend launches {launches} = {cfg.num_layers} layers x "
          f"{engine.steps} decode ticks", flush=True)
    check_outputs(outs, reqs, cfg)
    if launches != cfg.num_layers * engine.steps or launches == 0:
        raise AssertionError(f"kernel launches {launches} != {cfg.num_layers} x {engine.steps}")

    phase("fused vs unfused (f32 compute, 4 layers)")
    cfg32, params32, serve32, _, _ = build(dev, fused=True, num_layers=4,
                                            compute_dtype=torch.float32)
    runs = {}
    for label, kw in (("fused", {}), ("unfused", dict(fused_decode=False)),
                      ("int8", dict(kv_dtype="int8"))):
        _, runs[label] = serve_run(params32, cfg32, dataclasses.replace(serve32, **kw),
                                   reqs, dev, eos)
        check_outputs(runs[label], reqs, cfg32)
    for r in reqs:
        a, b = runs["fused"][r.rid], runs["unfused"][r.rid]
        if not np.array_equal(a, b):
            m = min(len(a), len(b))
            pos = int(np.flatnonzero(a[:m] != b[:m])[0]) if (a[:m] != b[:m]).any() else m
            raise AssertionError(f"fused and unfused tokens diverge: rid {r.rid}, "
                                 f"position {pos}")
    agree = agreement(runs["int8"], runs["fused"])
    print(f"fused == unfused on all {len(reqs)} requests "
          f"({sum(len(v) for v in runs['fused'].values())} tokens incl. prompts); "
          f"int8 pages agree on {agree:.4f} of tokens (gate 0.9)", flush=True)
    if agree < 0.9:
        raise AssertionError(f"int8 token agreement {agree} < 0.9")

    phase("training kernels vs plain (the slice's shapes)")
    trained = check_training_kernels(dev)

    phase("attention crossover: eager xla path against the flash kernels")
    attention_crossover(dev)

    phase("train step at full width (gpt-small-dim768, batch 64, S 512, bf16)")
    step = train_full_width(dev)

    phase("train step through kernels == through plain versions (f32, 2 layers)")
    kernel_vs_plain_steps(dev)

    phase("recipe 1 end to end (GPT-2-small width, fixture corpus)")
    recipe_end_to_end(dev)

    phase("MoE kernels vs plain (grouped-expert FFN, 8 x 768 -> 3072 -> 768)")
    moe_main = check_moe_kernels(dev)

    phase("MoE train step at full width (gpt-small-dim768-e8, batch 32, S 512, bf16)")
    moe_step = moe_train_full_width(dev)

    phase("MoE train step through kernels == through plain versions (f32, 2 layers, top-2)")
    moe_kernel_vs_plain_steps(dev)

    phase("recipe 8 end to end (GPT-2-small width, 8 experts, pallas, fixture corpus)")
    moe_recipe_end_to_end(dev)

    phase("MoE serving (GPT-2 small width, 8 experts, pallas, bf16, fused decode)")
    moe_served = moe_serving(dev)

    phase("MoE fused vs unfused vs plain (f32 compute, 4 layers)")
    moe_fused_vs_unfused(dev)

    fl, ce = trained["flash"], trained["ce"]

    def entry(name, source, replaces, launches, res, way, err, library_ms, **extra):
        bound, bound_by = res[f"{way}_bound"]
        return {"name": name, "route": "cuda", "source": f"tpukit_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": res[f"{way}_ms"], "call_ms": res[f"{way}_call_ms"],
                "plain_ms": res[f"{way}_plain_ms"], "bound_ms": bound, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    c, mc = step["counts"], moe_step["counts"]
    print(json.dumps({"kernels": [
        {"name": "paged_attend", "route": "cuda",
         "source": "tpukit_torch/csrc/paged_attention.cu",
         "replaces": "tpukit/ops/paged_attention.py:105",
         "launches": launches, "library_ms": None, **main_pair},
        entry("flash_attention_fwd", "flash_attention.cu", "tpukit/ops/pallas_attention.py:178",
              c["flash_forward"], fl, "fwd", fl["fwd_err"], fl["fwd_library_ms"]),
        entry("flash_attention_bwd", "flash_attention.cu", "tpukit/ops/pallas_attention.py:259",
              c["flash_backward_dkv"], fl, "bwd", fl["bwd_err"], fl["bwd_library_ms"],
              also_replaces=["tpukit/ops/pallas_attention.py:346",
                             "tpukit/ops/pallas_attention.py:389"],
              kernels_per_call=3, launches_by_kernel={"dcap": c["flash_backward_dcap"],
                                                      "dkv": c["flash_backward_dkv"],
                                                      "dq": c["flash_backward_dq"]}),
        entry("fused_head_ce_fwd", "fused_head_ce.cu", "tpukit/ops/fused_head_ce.py:65",
              c["ce_forward"], ce, "fwd", ce["fwd_err"], None),
        entry("fused_head_ce_bwd", "fused_head_ce.cu", "tpukit/ops/fused_head_ce.py:134",
              c["ce_backward_dw"], ce, "bwd", ce["bwd_err"], None,
              kernels_per_call=2, launches_by_kernel={"dw": c["ce_backward_dw"],
                                                      "dh": c["ce_backward_dh"]}),
        entry("moe_grouped_ffn_fwd", "moe_gemm.cu", "tpukit/ops/moe_gemm.py:110",
              mc["moe_forward_up"], moe_main, "fwd", moe_main["fwd_err"], None,
              kernels_per_call=2, launches_by_kernel={"up": mc["moe_forward_up"],
                                                      "down": mc["moe_forward_down"]},
              serve_launches=moe_served["counts"]["moe_forward_up"]),
        entry("moe_grouped_ffn_bwd", "moe_gemm.cu", "tpukit/ops/moe_gemm.py:145",
              mc["moe_backward_dh"], moe_main, "bwd", moe_main["bwd_err"], None,
              kernels_per_call=4, launches_by_kernel={
                  k: mc[f"moe_backward_{k}"] for k in ("dh", "dx", "dwu", "dwd")}),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
