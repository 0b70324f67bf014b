#!/usr/bin/env python3
"""A one-off ablation of the bf16 fused head + CE kernels, kept because
PERF.md's ablation figures come from it: `python3 ce_ablation.py
[--rounds N]` from the repository root on one CUDA card.

Each variant patches exact lines of the sources, so the script raises once
those lines change; it is not a standing tool. Builds `csrc/fused_head_ce.cu`
(with its mainloop, `csrc/tk_gemm.cuh`) as it is and in variants, each a
textual patch of the source or the header (below), one nvcc each, all at
once, into
`build/ce_ablation/<variant>/`; then times the forward (without argmax) and
the backward at the main shape (32768 tokens x 768 x vocab 50304, bf16,
`recipes/profile.py`'s rung) by `chip_smoke.graph_ms`, the variants in
turns (base first and last in every round).
Variants that leave out work compute wrong results: they time only.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import graph_ms
from tpukit_torch.ops import _cuda
from tpukit_torch.ops import fused_head_ce as fce

N, DIM, VOCAB, V_PAD = 32768, 768, 50257, 50304
# variant -> [(text in fused_head_ce.cu or tk_gemm.cuh, replacement)]
VARIANTS = {
    "base": [],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "wait0": [("wgmma_wait<1>();  // the previous", "wgmma_wait<0>();  // the previous")],
    "d_no_exp": [("const float p = expf((col < vocab ? x : kPadLogit) - ls);",
                  "const float p = (col < vocab ? x : kPadLogit) - ls;")],
    "fwd_no_exp": [("psum += expf(x - m_new);", "psum += x - m_new;")],
    "dh_one_split": [("const int splits = dh_splits(rows, dim, ldw, &per_split);",
                      "const int splits = cut(cdiv(ldw, kBK), 1, &per_split);")],
}


def build_variant(name: str) -> Path:
    # the kernels' source and the mainloop's header, patched where the text
    # lies; the variant's own copy of the header shadows csrc's
    files = {f: (_cuda.CSRC / f).read_text() for f in ("fused_head_ce.cu", "tk_gemm.cuh")}
    for old, new in VARIANTS[name]:
        where = [f for f, text in files.items() if text.count(old) == 1]
        if len(where) != 1 or sum(text.count(old) for text in files.values()) != 1:
            raise ValueError(f"variant {name}: {old!r} is not in the sources once")
        files[where[0]] = files[where[0]].replace(old, new)
    out = _cuda.BUILD_ROOT.parent / "ce_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (out / f).write_text(text)
    cu = out / "fused_head_ce.cu"
    lib = out / "libfused_head_ce.so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise _cuda.KernelBuildError(f"{name}: {proc.stdout}{proc.stderr}")
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_ablation needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in fce._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((N, DIM), generator=g, device=dev).bfloat16()
    w = ((torch.rand((DIM, V_PAD), generator=g, device=dev) * 2 - 1) * DIM**-0.5).bfloat16()
    tgt = torch.randint(0, VOCAB, (N,), generator=g, device=dev, dtype=torch.int32)
    tgt[::8] = -100
    valid = (tgt != -100).float()
    lse, tl = torch.empty(N, device=dev), torch.empty(N, device=dev)
    best = torch.empty(N, dtype=torch.int32, device=dev)
    dh, dw = torch.empty_like(h), torch.empty((DIM, V_PAD), device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    # every backward reads the base build's lse: a variant's forward writes
    # its own (wrong) terms elsewhere, and exp's time depends on its input
    fce.launch_forward(libs["base"], h, w, tgt, lse, tl, best, VOCAB, False, stream())
    out = [torch.empty_like(lse), torch.empty_like(tl), torch.empty_like(best)]
    order = list(VARIANTS) + ["base"]
    times = {name: {"fwd": [], "bwd": []} for name in VARIANTS}
    for _ in range(args.rounds):
        for name in order:
            lib = libs[name]
            times[name]["fwd"].append(graph_ms(lambda: fce.launch_forward(
                lib, h, w, tgt, *out, VOCAB, False, stream()), 3))
            times[name]["bwd"].append(graph_ms(lambda: fce.launch_backward(
                lib, h, w, tgt, lse, valid, -valid, dh, dw, VOCAB, stream()), 3))
    print(f"N {N} x dim {DIM} x V_pad {V_PAD}, bf16; device ms per call (CUDA graph), each "
          f"round's value in turn:")
    for name, t in times.items():
        print(f"  {name:14s} forward {[round(x, 4) for x in t['fwd']]} backward "
              f"{[round(x, 4) for x in t['bwd']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
