#!/usr/bin/env python3
"""A one-off ablation of the bf16 grouped-expert kernels, kept because
PERF.md's ablation figures come from it: `python3 moe_ablation.py
[--rounds N]` from the repository root on one CUDA card.

Builds `csrc/moe_gemm.cu` as it is and in variants, each a textual patch of
exact lines of the source (below; the script raises once those lines
change), one nvcc each, all at once, into `build/moe_ablation/<variant>/`;
then times the forward and the backward at the main shape (the e8 rung's
20480 capacity rows, 8 x 768 -> 3072 -> 768, bf16, equal segments) and
the forward at the decode tick's (`chip_smoke.moe_layouts`' "decode": 16
rows, top-1) by `chip_smoke.graph_ms`, the variants in turns (base first
and last in every round). Variants that leave out work compute wrong
results: they time only. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import graph_ms, moe_bank, moe_layouts
from tpukit_torch.ops import _cuda
from tpukit_torch.ops import moe_gemm

E, ROWS, D, F = 8, 2560, 768, 3072
# variant -> [(text in moe_gemm.cu, replacement)]
_STAGED_STORE = ("st_b128(out + static_cast<size_t>(row) * N + col,\n"
                 "                  ld_b128(sc + 4 * ((c / 8) * kLd16 + 4 * (c % 8))));")
VARIANTS = {
    "base": [],
    # the bf16 epilogues (up, down, dh, dx) storing from the registers in
    # fragment order, 4 bytes a row per thread, as first written
    "fragment_stores": [
        ("st_b32(slot, pack_bf16x2(v0, v1));",
         "if (wrow + lane / 4 + 8 * hh < t.m_end && col < N)\n"
         "            st_b32(out + static_cast<size_t>(wrow + lane / 4 + 8 * hh) * N + col,\n"
         "                   pack_bf16x2(v0, v1));"),
        (_STAGED_STORE, "(void)c;")],
    # the bf16 epilogues staging their rows but never writing them out
    "no_stores": [(_STAGED_STORE, "(void)c;")],
    # the dh epilogue without the loads of h for the relu mask (every h > 0)
    "dh_no_mask": [
        ("uint4 v{};", "uint4 v{0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};"),
        ("if (row < t.m_end && col < N) v = ld_b128(h + static_cast<size_t>(row) * N + col);",
         "(void)row;")],
    # ... without the shuffles of its column sums
    "dh_no_shuffle": [("for (int o = 4; o < 32; o <<= 1) {", "for (int o = 32; o < 32; o <<= 1) {")],
    # the decode policy's k splits aimed at one unit an SM, or four, not two
    "decode_fill1": [("const int want_up = cdiv(2l * sms", "const int want_up = cdiv(1l * sms"),
                     ("const int want_down = cdiv(2l * sms", "const int want_down = cdiv(1l * sms")],
    "decode_fill4": [("const int want_up = cdiv(2l * sms", "const int want_up = cdiv(4l * sms"),
                     ("const int want_down = cdiv(2l * sms", "const int want_down = cdiv(4l * sms")],
}


def build_patched(src: str, patches, out: Path, name: str) -> Path:
    """`src` with each (old, new) of `patches` replaced (each `old` must
    occur once), built by nvcc into `out/lib<name>.so` with csrc/ on the
    include path."""
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"variant {out.name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(src)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise _cuda.KernelBuildError(f"{out.name}: {proc.stdout}{proc.stderr}")
    return lib


def build_variant(name: str) -> Path:
    return build_patched((_cuda.CSRC / "moe_gemm.cu").read_text(), VARIANTS[name],
                         _cuda.BUILD_ROOT.parent / "moe_ablation" / name, "moe_gemm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_ablation needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in moe_gemm._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    m = E * ROWS
    xs = torch.randn((m, D), generator=g, device=dev).bfloat16()
    cot = torch.randn((m, D), generator=g, device=dev).bfloat16()
    wu, bu, wd, bd = moe_bank(dev, E, D, F, torch.bfloat16, seed=1)
    offs = torch.arange(E + 1, dtype=torch.int32, device=dev) * ROWS
    h, ys = torch.empty((m, F), dtype=torch.bfloat16, device=dev), torch.empty_like(xs)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    # every variant's backward reads the base build's y and h
    moe_gemm.launch_forward(libs["base"], xs, wu, bu, wd, bd, offs, h, ys, stream())
    h_v, y_v = torch.empty_like(h), torch.empty_like(ys)
    rows, offs_t, _ = moe_layouts(dev)["decode"]
    xs_t = rows.bfloat16()
    h_t, y_t = torch.empty((xs_t.shape[0], F), dtype=torch.bfloat16, device=dev), torch.empty_like(xs_t)
    scratch = moe_gemm.backward_scratch(libs["base"], xs, F, E)
    dx = torch.empty_like(xs)
    dw = [torch.empty(t.shape, device=dev) for t in (wu, bu, wd, bd)]
    order = list(VARIANTS) + ["base"]
    times = {name: {"fwd": [], "bwd": [], "tick": []} for name in VARIANTS}
    for _ in range(args.rounds):
        for name in order:
            lib = libs[name]
            times[name]["fwd"].append(graph_ms(lambda: moe_gemm.launch_forward(
                lib, xs, wu, bu, wd, bd, offs, h_v, y_v, stream()), 10))
            times[name]["bwd"].append(graph_ms(lambda: moe_gemm.launch_backward(
                lib, xs, cot, ys, h, wu, wd, offs, scratch, dx, *dw, stream()), 10))
            times[name]["tick"].append(graph_ms(lambda: moe_gemm.launch_forward(
                lib, xs_t, wu, bu, wd, bd, offs_t, h_t, y_t, stream()), 50))
    print(f"M {m} ({E} x {ROWS}) x {D} -> {F} -> {D}, bf16, and the decode tick (M "
          f"{xs_t.shape[0]}, segments {offs_t.diff().tolist()}); device ms per call (CUDA graph), "
          f"each round's value in turn:")
    for name, t in times.items():
        print(f"  {name:15s} forward {[round(x, 4) for x in t['fwd']]} backward "
              f"{[round(x, 4) for x in t['bwd']]} decode-tick forward "
              f"{[round(x, 4) for x in t['tick']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
