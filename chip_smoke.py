#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`tpukit_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each on its own lines; any failure raises, so the exit code is
not 0:
  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: nvcc builds the serving path's kernel from tpukit_torch/csrc
     (seconds and the ptxas register/shared-memory report);
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
then one JSON line of kernel results and, last, the device JSON line.

Imports nothing of JAX or of the JAX package. Without CUDA it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tpukit_torch import resolve_device
from tpukit_torch.ops import _cuda
from tpukit_torch.ops import paged_attention as pa
from tpukit_torch.ops import quant_comm
from tpukit_torch.serve.engine import ServeEngine
from tpukit_torch.serve.profile import build

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 non-tensor, bf16 dense
KERNEL = "paged_attention"  # the one csrc source on the serving path
F32_ATOL = 1e-5  # f32 compute: the kernel and the plain version sum in different orders
DIFF_SHARE = 0.01  # bf16 compute: most outputs must be bit-equal (see check_kernel)


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
    it outlasts the device work."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(iters)], iters)


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
    rep = _cuda.build(KERNEL)
    print(f"{KERNEL}: built in {rep['seconds']:.1f} s{' (cached)' if rep['cached'] else ''}"
          f" -> {rep['path']}")
    for line in rep["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())

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

    print(json.dumps({"kernels": [{
        "name": "paged_attend", "route": "cuda",
        "source": "tpukit_torch/csrc/paged_attention.cu",
        "replaces": "tpukit/ops/paged_attention.py:105",
        "launches": launches, "library_ms": None, **main_pair,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
