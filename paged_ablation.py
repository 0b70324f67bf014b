#!/usr/bin/env python3
"""A one-off comparison of the paged decode-attention kernels, kept because
PERF.md's figures for them come from it: `python3 paged_ablation.py
[--rounds N] [--parent PATH]` from the repository root on one CUDA card.

Builds `csrc/paged_attention.cu` as it is and in variants, each a textual
patch of exact lines of the source (below; the script raises once those
lines change), and, where `--parent` names one, an earlier version of the
source with the one-kernel C interface (a `tk_paged_attend` that takes no
scratch), one nvcc each, all at once, into
`build/paged_ablation/<variant>/`. Then it times them by
`chip_smoke.graph_ms` at phase 3's first three shapes
(`chip_smoke.kernel_inputs`: N 16 x MP 20, the serving run's; N 16 x MP
64, GPT-2 small's full context; N 1 x MP 64) and at N 16 x MP 4 (a window
of one split), H 12, D 64, pages of 16: the parent and the base in
all five pool/compute pairs, the variants in the main pair (f32 pages,
bf16 compute; `--variants a,b` times only those, in every pair), in
turns (parent and base first and last in every round).
Variants that leave out work compute wrong results: they time only. Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import PAGED_PAIRS, graph_ms, kernel_inputs, paged_bound_ms
from moe_ablation import build_patched
from tpukit_torch.ops import _cuda, quant_comm
from tpukit_torch.ops import paged_attention as pa

H, D, P = 12, 64, 16
SHAPES = {"serving": (16, 20), "full_context": (16, 64), "one_slot": (1, 64),
          "short": (16, 4)}
MAIN = (torch.float32, torch.bfloat16)
# variant -> [(text in paged_attention.cu, replacement)]
VARIANTS = {
    "base": [],
    # each warp owns 1 or 4 ring stages, not 2
    "warp_stages1": [("constexpr int kMaxWarpStages = 2;", "constexpr int kMaxWarpStages = 1;")],
    "warp_stages4": [("constexpr int kMaxWarpStages = 2;", "constexpr int kMaxWarpStages = 4;")],
    # splits aimed at 2, 4 or 16 units an SM, not 8; at least 2 or 8 pages
    # a split, not 4; or one split always (the combine sums that one)
    "units2": [("constexpr int kUnitsPerSm = 8;", "constexpr int kUnitsPerSm = 2;")],
    "units4": [("constexpr int kUnitsPerSm = 8;", "constexpr int kUnitsPerSm = 4;")],
    "units16": [("constexpr int kUnitsPerSm = 8;", "constexpr int kUnitsPerSm = 16;")],
    "min_pages2": [("constexpr int kMinSplitPages = 4;", "constexpr int kMinSplitPages = 2;")],
    "min_pages8": [("constexpr int kMinSplitPages = 4;", "constexpr int kMinSplitPages = 8;")],
    "one_split": [("constexpr int kUnitsPerSm = 8;", "constexpr int kUnitsPerSm = 0;"),
                  ("constexpr int kMinSplitPages = 4;", "constexpr int kMinSplitPages = 1 << 20;")],
    # one kernel launched alone: scores, or values (on stale scores)
    "scores_kernel": [("  if (err == 0)\n    err = launch(allowed_values,",
                       "  if (false)\n    err = launch(allowed_values,"),
                      ("  if (err == 0)\n    err = launch(0, kChained,",
                       "  if (false)\n    err = launch(0, kChained,")],
    "values_kernel": [("  int err = launch(allowed_scores,",
                       "  int err = 0;\n  if (false) err = launch(allowed_scores,"),
                      ("  if (err == 0)\n    err = launch(0, kChained,",
                       "  if (false)\n    err = launch(0, kChained,")],
    # every kernel returns at once: the launches' floor in a graph
    "empty_kernels": [("  Unit<TP> u(p, p.pool_k, p.scale_k, base, lay);",
                       "  return;\n  Unit<TP> u(p, p.pool_k, p.scale_k, base, lay);"),
                      ("  Unit<TP> u(p, p.pool_v, p.scale_v, base, lay);",
                       "  return;\n  Unit<TP> u(p, p.pool_v, p.scale_v, base, lay);"),
                      ("  if (idx >= static_cast<size_t>(p.N) * p.H * p.D) return;",
                       "  return;")],
    # the values and combine kernels launched plainly, after the kernel before
    "no_pdl": [("constexpr bool kChained = true;", "constexpr bool kChained = false;")],
    # 8 warps a block (one stage each)
    "warps8": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    # the stages are never filled: the barriers complete on the arrival
    # alone (the kernels' compute and control on stale shared memory)
    "no_copies": [("      mbar_arrive_expect_tx(&bars[slot(i)], bytes);\n"
                   "      bulk_copy_g2s(stage(i), pool + row_of(i) * P * D, bytes, &bars[slot(i)]);",
                   "      mbar_arrive(&bars[slot(i)]);\n      (void)bytes;")],
    # the warp barrier after each bulk wait in every instance, not int8 only
    "syncwarp_always": [("      if constexpr (sizeof(TP) == 1) __syncwarp();",
                         "      __syncwarp();")],
    # a values-kernel output branch that never runs (the removed one-split
    # mode's rounded store): does its code alone move the timing?
    "out_branch": [("    p.part[(hrow * p.splits + u.split) * D + d] = o;",
                    "    if (p.splits == 0)\n      static_cast<TC*>(p.out)[hrow * D + d] = "
                    "from_f32<TC>(o);\n    else\n      p.part[(hrow * p.splits + u.split) * D + d] "
                    "= o;")],
    # the scores' lanes read their chunks in order, not rotated by position
    "no_rotation": [("int kk = jj % nk;", "int kk = 0;")],
    # the values kernel takes l = 1 without reading the window's scores
    "no_l": [("for (int j = tid; j <= u.lim; j += kThreads) l += expf(srow[j] - m);",
              "l = 1.f;")],
    # both passes stream their pages but compute nothing on them
    "no_page_compute": [("      if (jj < cnt) {\n        int kk = jj % nk;",
                         "      if (false) {\n        int kk = jj % nk;"),
                        ("for (int jj = g; jj < cnt; jj += G) {",
                         "for (int jj = g; jj < 0; jj += G) {")],
}
# the first port's C interface: no scratch, one kernel
_PARENT_SIGNATURES = {
    "tk_paged_attend": (ctypes.c_int, [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]),
}


def build_variant(name: str, parent: Path | None) -> Path:
    src = (parent if name == "parent" else _cuda.CSRC / "paged_attention.cu").read_text()
    return build_patched(src, VARIANTS.get(name, []),
                         _cuda.BUILD_ROOT.parent / "paged_ablation" / name, "paged_attention")


def load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    sigs = _PARENT_SIGNATURES if name == "parent" else pa._SIGNATURES
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def operands(n: int, mp: int, pool_dtype, cdt):
    base = kernel_inputs(torch.device("cuda"), n, H, D, P, mp)
    num_pages = n * mp + 1
    if pool_dtype == torch.int8:
        pools, scales = [], []
        for nm in ("pool_k", "pool_v"):
            qv, sv = quant_comm.quantize_blocks(base[nm].reshape(num_pages, H, P * D))
            pools.append(qv.reshape(num_pages, H, P, D))
            scales.append(sv)
    else:
        pools = [base[nm].to(pool_dtype) for nm in ("pool_k", "pool_v")]
        scales = [None, None]
    args = (pools[0], pools[1], scales[0], scales[1], base["bt"], base["start"],
            base["q"].to(cdt), base["k_new"].to(cdt), base["v_new"].to(cdt))
    return args, base["starts"]


def call(name: str, lib, args, out):
    stream = torch.cuda.current_stream().cuda_stream
    pool_k, pool_v, scale_k, scale_v, bt, start, q, k_new, v_new = args
    num_pages, h, p, d = pool_k.shape
    n, mp = bt.shape
    if name != "parent":
        pa.launch(lib, pa.plan(lib, pool_k.dtype, n, h, p, d, mp), *args, out, stream)
        return
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    code = lib.tk_paged_attend(pa._POOL_KIND[pool_k.dtype], pa._COMPUTE_KIND[q.dtype],
                               ptr(pool_k), ptr(pool_v), ptr(scale_k), ptr(scale_v), ptr(bt),
                               ptr(start), ptr(q), ptr(k_new), ptr(v_new), ptr(out), n, h, p,
                               d, mp, scale_k.shape[-1] if scale_k is not None else 0,
                               1.0 / d**0.5, ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"parent kernel launch failed ({code})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to time, with the base and the parent, "
                         "in every pair (default: all, in the main pair)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier paged_attention.cu with the one-kernel interface")
    flags = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_ablation: needs one CUDA device", file=sys.stderr)
        return 2
    chosen = flags.variants.split(",") if flags.variants else list(VARIANTS)
    if set(chosen) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(set(chosen) - set(VARIANTS))}")
    names = ["base"] + [v for v in chosen if v != "base"] + (["parent"] if flags.parent else [])
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(lambda v: build_variant(v, flags.parent), names)))
    libs = {name: load(name, path) for name, path in paths.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {len(names)} builds", flush=True)
    for label, (n, mp) in SHAPES.items():
        for pool_dtype, cdt in PAGED_PAIRS:
            args, starts = operands(n, mp, pool_dtype, cdt)
            bound, _ = paged_bound_ms(starts, pool_dtype, cdt, n, H, D, P, mp)
            out = torch.empty_like(args[6])
            ref = pa.paged_attend_reference(*args)
            every = (pool_dtype, cdt) == MAIN or flags.variants is not None
            order = [v for v in names if every or v in ("parent", "base")]
            order = [v for v in ("parent", "base") if v in order] + \
                [v for v in order if v not in ("parent", "base")] + \
                [v for v in ("base", "parent") if v in order]
            times = {v: [] for v in order}
            for _ in range(flags.rounds):
                for v in order:
                    times[v].append(graph_ms(lambda: call(v, libs[v], args, out), 200))
            for v in ("parent", "base"):  # the two complete versions agree with the plain one
                if v in libs:
                    call(v, libs[v], args, out)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    if not err <= (1e-5 if cdt == torch.float32 else 2e-2):
                        raise AssertionError(f"{v} disagrees with the plain version: {err}")
            for v, ts in times.items():
                print(f"{label} N {n} MP {mp} pool={str(pool_dtype)[6:]} "
                      f"compute={str(cdt)[6:]} {v}: {min(ts):.5f}-{max(ts):.5f} ms "
                      f"(bound {bound:.5f} ms, {bound / min(ts):.3f} of it)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
