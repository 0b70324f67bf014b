"""The port's CUDA kernel sources, built for the CPU with g++ against a host
emulation of the CUDA runtime (`tpukit_torch/csrc/host_emu/`: one
std::thread per CUDA thread, barriers for __syncthreads and the warp
shuffles), and held against their plain PyTorch versions at small ragged
shapes.

This checks each kernel's arithmetic, indexing, masking and
synchronisation on every CPU run: the mma.sync / ldmatrix / cp.async
instances (the bf16 flash kernels) through `host_emu/tk_mma.cuh`, which
lays fragments out lane by lane as the PTX ISA does, and the wgmma / TMA /
mbarrier instances (the bf16 head + CE and grouped-expert kernels, on the
shared mainloop of `csrc/tk_gemm.cuh`) through `host_emu/tk_hopper.cuh`,
which reads shared memory through the wgmma descriptors, writes TMA boxes
(rank 2 and 3) with the 128B swizzle and zero fill, and holds generic
stores back from wgmma until their proxy fence, so a wrong layout,
swizzle, descriptor, transpose bit, zero fill or missing fence shows here;
the paged-attention kernels' bulk copies (1-D TMA) land only when their
mbarrier is waited on, so a read before the wait sees a stale stage.
The build puts `-I host_emu` ahead of everything: the sources are copied
out of `csrc/` (with `tk_gemm.cuh`, which has no PTX of its own), so their
`#include "tk_mma.cuh"` finds the emulation and not `csrc/tk_mma.cuh`.
`test_ptx_primitive_matches_plain` holds each
emulated primitive against the PTX ISA's layout tables and against
torch.matmul. `chip_smoke.py` holds the same sources, built by nvcc,
against the same plain versions on the card. The launch arguments go
through the wrappers' own `launch_*` functions.

Tolerances. f32: the kernel and the plain version sum in different orders
(~1e-6 relative), so outputs and lse within atol 2e-5 / rtol 1e-4 and
gradients within 5e-5 / 1e-4 (tests/test_flash_attention.py's forward
bar; gradients tighter than its 5e-4). bf16: the online softmax rounds
each tile's probabilities against the running maximum while the plain
version rounds against the row's maximum, so a probability may move by a
bf16 ulp (2^-8 relative); outputs within 2^-6 of the row's largest |value|
per element.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpukit_torch.ops import _cuda
from tpukit_torch.ops import flash_attention as fa
from tpukit_torch.ops import fused_head_ce as fce
from tpukit_torch.ops import moe_gemm
from tpukit_torch.ops import paged_attention as pa
from tpukit_torch.ops import quant_comm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
EMU = ROOT / "tpukit_torch" / "csrc" / "host_emu"
_LAUNCH = re.compile(r"(\w+)<<<([^>]*)>>>\(([^;]*)\);")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the CUDA source built with g++ against the emulator."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the kernel sources for the host")
    out = tmp_path_factory.mktemp("cuda_emu")
    # a csrc header with no emulated twin (tk_gemm.cuh: no PTX of its own)
    # goes beside the sources, so its own includes find host_emu's headers
    csrc = ROOT / "tpukit_torch" / "csrc"
    for header in csrc.glob("*.cuh"):
        if not (EMU / header.name).exists():
            shutil.copy(header, out / header.name)
    libs = {}
    for name, sigs in (("flash_attention", fa._SIGNATURES),
                       ("fused_head_ce", fce._SIGNATURES),
                       ("moe_gemm", moe_gemm._SIGNATURES),
                       ("paged_attention", pa._SIGNATURES)):
        src = (ROOT / "tpukit_torch" / "csrc" / f"{name}.cu").read_text()
        text, n = _LAUNCH.subn(
            lambda m: f"tk_emu::launch({m.group(1)}, {m.group(2)}, {m.group(3)});", src)
        assert n == 1, f"{name}.cu: expected one launch statement, found {n}"
        cpp, so = out / f"{name}.cpp", out / f"lib{name}.so"
        cpp.write_text(text)
        libs[name] = _build(cpp, so, sigs)
    return libs


def _build(cpp: Path, so: Path, sigs: dict) -> ctypes.CDLL:
    """g++ -O2 with the emulation's headers first on the include path."""
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
         "-I", str(EMU), "-o", str(so), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _bf16_close(got, ref, rows_dim=-1):
    """|got - ref| <= 2^-6 x the largest |ref| of the element's row."""
    scale = ref.float().abs().amax(rows_dim, keepdim=True).clamp(min=1e-6)
    err = ((got.float() - ref.float()).abs() / scale).max().item()
    assert err <= 2.0**-6, err


def _flash_inputs(b, h, s, d, dtype, masked, seed):
    rng = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    mask = None
    if masked:
        mask = torch.zeros((b, s), dtype=torch.bool)
        mask[0, s - s // 5:] = True  # trailing padding in row 0
        if b > 1:
            mask[1, :] = True  # a fully padded row (the eval loader's empty rows)
    return q, k, v, do, mask


# bf16 runs the tensor-core kernels: 64-row forward and dQ query tiles,
# 64-key tiles, dK/dV query tiles of 64 (32 at D = 128). s130-d128 spans
# three query tiles and five dK/dV ones; s300-d16 five query tiles and key
# tiles; s45 is no multiple of the 16-row fragments. Head dims 8 and 48 have
# no instance: the wrappers run the 16 and 64 ones on zero-padded copies.
@pytest.mark.parametrize("s,d,dtype,masked", [
    (48, 16, torch.float32, False),
    (130, 32, torch.float32, True),
    (130, 16, torch.bfloat16, True),
    (64, 32, torch.bfloat16, False),
    (80, 64, torch.bfloat16, True),
    (130, 128, torch.bfloat16, True),
    (45, 32, torch.bfloat16, True),
    (300, 16, torch.bfloat16, False),
    (70, 8, torch.bfloat16, True),
    (64, 48, torch.bfloat16, False),
    (40, 8, torch.float32, True),
], ids=["s48-d16-f32", "s130-d32-f32-mask", "s130-d16-bf16-mask", "s64-d32-bf16",
        "s80-d64-bf16-mask", "s130-d128-bf16-mask", "s45-d32-bf16-mask", "s300-d16-bf16",
        "s70-d8-bf16-mask", "s64-d48-bf16", "s40-d8-f32-mask"])
def test_flash_kernels_match_plain_version(emulated, s, d, dtype, masked):
    b, h = 2, 2
    scale = d**-0.5
    q, k, v, do, mask = _flash_inputs(b, h, s, d, dtype, masked, seed=s + d)
    bias = fa.pad_bias(mask, b, s, q.device)
    lib = emulated["flash_attention"]
    out, lse = torch.empty_like(q), torch.empty((b, h, s), dtype=torch.float32)
    fa.launch_forward(lib, q, k, v, bias, out, lse, scale, 0)  # q unscaled
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, bias, scale)

    dcap = torch.empty((b, h, s), dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fa.launch_backward(lib, q, k, v, bias, do, out, lse, dcap, dq, dk, dv, scale, 0)
    # exact sums (f64) in the plain version: its f32 dP and D, summed in two
    # orders, do not cancel to 0 where the kernels' do (dQ of query 0)
    ref_grads = fa.flash_backward_reference(q, k, v, bias, out, lse, do, scale,
                                            acc=torch.float64)

    # D = rowsum(dO * O) from the preprocess kernel: f32 sums in another order
    torch.testing.assert_close(dcap, (do.float() * out.float()).sum(-1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=1e-4)
        for got, ref in zip((dq, dk, dv), ref_grads):
            torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    else:
        _bf16_close(out, ref_out)
        for got, ref in zip((dq, dk, dv), ref_grads):
            _bf16_close(got, ref)


# One warp (32 threads) around the emulated tk_mma.cuh functions. x and y
# are 16 x 16 bf16 tiles staged into shared memory by cp.async; op 0 runs
# one mma on fragments the test builds; ops 1, 2 return what ldmatrix(_trans)
# gives each lane for the row addresses the test chooses; op 3 copies by
# cp.async with zero fill; op 7 packs f32 pairs into bf16x2 words; ops 4-6
# are the flash kernels' products, with
# their ldmatrix addressing: x y^T (y stored n-major, as K), x y (y stored
# k-major, as V, by .trans) and round(x y^T) y (the accumulators packed into
# the next product's A fragment, as P and dS).
_PRIM_SRC = r"""
#include <cstdint>
#include <cstring>
#include "cuda_runtime.h"
#include "cuda_bf16.h"
#include "tk_mma.cuh"

namespace {
using u16 = uint16_t;

void stage(u16* dst, const u16* src) {
  cp_async_16(dst + 8 * threadIdx.x, src + 8 * threadIdx.x, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

uint32_t pack(float a, float b) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

void prim(int op, const uint32_t* regs, const u16* x, const u16* y, const int* addr,
          float* fout, uint32_t* rout) {
  extern __shared__ float smem[];
  u16* xs = reinterpret_cast<u16*>(smem);
  u16* ys = xs + 256;
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  if (op == 0) {
    uint32_t a[4] = {regs[6 * lane], regs[6 * lane + 1], regs[6 * lane + 2], regs[6 * lane + 3]};
    float d[4];
    memcpy(d, fout + 4 * lane, sizeof(d));
    mma_m16n8k16_bf16(d, a, regs[6 * lane + 4], regs[6 * lane + 5]);
    memcpy(fout + 4 * lane, d, sizeof(d));
  } else if (op == 1 || op == 2) {
    stage(xs, x);
    uint32_t r[4];
    const u16* p = xs + 16 * addr[lane] + 8 * addr[32 + lane];
    if (op == 1) ldmatrix_x4(r, p); else ldmatrix_x4_trans(r, p);
    memcpy(rout + 4 * lane, r, sizeof(r));
  } else if (op == 7) {
    for (int i = 0; i < 4; ++i)
      rout[4 * lane + i] = pack_bf16x2(fout[8 * lane + 2 * i], fout[8 * lane + 2 * i + 1]);
  } else if (op == 3) {
    cp_async_16(xs + 8 * lane, x + 8 * lane, lane % 2 == 0);
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * lane + i;
      cp_async_4(ys + 2 * e, y + 2 * e, e % 3 != 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    memcpy(rout + 4 * lane, xs + 8 * lane, 16);
    memcpy(rout + 128 + 4 * lane, ys + 8 * lane, 16);
  } else {
    stage(xs, x);
    stage(ys, y);
    uint32_t a[4], b[4];
    ldmatrix_x4(a, xs + 16 * (lane & 15) + 8 * (lane >> 4));
    if (op == 5)
      ldmatrix_x4_trans(b, ys + 16 * (((lane >> 3) & 1) * 8 + (lane & 7)) + 8 * (lane >> 4));
    else
      ldmatrix_x4(b, ys + 16 * ((lane >> 4) * 8 + (lane & 7)) + 8 * ((lane >> 3) & 1));
    float d[2][4] = {};
    mma_m16n8k16_bf16(d[0], a, b[0], b[1]);
    mma_m16n8k16_bf16(d[1], a, b[2], b[3]);
    if (op == 6) {
      const uint32_t pa[4] = {pack(d[0][0], d[0][1]), pack(d[0][2], d[0][3]),
                              pack(d[1][0], d[1][1]), pack(d[1][2], d[1][3])};
      ldmatrix_x4_trans(b, ys + 16 * (((lane >> 3) & 1) * 8 + (lane & 7)) + 8 * (lane >> 4));
      for (int n = 0; n < 2; ++n)
        for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
      mma_m16n8k16_bf16(d[0], pa, b[0], b[1]);
      mma_m16n8k16_bf16(d[1], pa, b[2], b[3]);
    }
    for (int n = 0; n < 2; ++n)
      for (int i = 0; i < 4; ++i) fout[16 * (g + 8 * (i >= 2)) + 8 * n + 2 * t + (i & 1)] = d[n][i];
  }
}
}  // namespace

extern "C" int tk_prim(int op, const void* regs, const void* x, const void* y, const void* addr,
                       void* fout, void* rout) {
  tk_emu::launch(prim, dim3(1), 32, 1024, nullptr, op, static_cast<const uint32_t*>(regs),
                 static_cast<const u16*>(x), static_cast<const u16*>(y),
                 static_cast<const int*>(addr), static_cast<float*>(fout),
                 static_cast<uint32_t*>(rout));
  return 0;
}
"""



# One warpgroup (128 threads) around the emulated tk_hopper.cuh functions.
# Ops 10-12 stage A (64 x 16) and B (16 x 256) by TMA into 128B-swizzled
# tiles, A and B each K-major or MN-major as the global copy lies (x, y are
# the global matrices, `ld` their row strides), run one m64n256k16 product
# onto the accumulators preloaded from fout, and return each thread's 128
# registers. Op 20 loads one 64 x 16 box at (c0, c1) of x [rows][cols]
# (row stride ld) and returns the 2 KB of shared memory as they lie; op 21
# the same from a rank-3 map of `rows_b` such matrices end to end, at (c0,
# c1, tb). Op 30
# walks one mbarrier through three phases (arrivals, then arrivals plus a
# TMA's bytes) and returns what try_wait said at each step. Op 40 bulk-copies
# `rows_a` 16-byte chunks of x from chunk c0 into shared memory and returns
# the first 16 bytes as they were before the barrier's wait, then the copy.
_HOPPER_SRC = r"""
#include <cstdint>
#include <cstring>
#include "cuda_runtime.h"
#include "cuda_bf16.h"
#include "tk_hopper.cuh"

namespace {
struct Args {
  int op, rows_a, cols_a, ld_a, rows_b, cols_b, ld_b, c0, c1, ta, tb;
};

void hop(Args a, const void* x, const void* y, float* fout, uint32_t* rout) {
  extern __shared__ float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 65536);
  const int t = threadIdx.x;
  if (a.op == 30) {
    if (t == 0) mbar_init(bar, 2);
    __syncthreads();
    uint32_t* seen = rout;
    auto look = [&](int at) {
      if (t == 0) {
        seen[at] = mbar_try_wait(bar, 0);
        seen[at + 1] = mbar_try_wait(bar, 1);
      }
      __syncthreads();
    };
    look(0);
    if (t == 0) mbar_arrive(bar);
    __syncthreads();
    look(2);
    if (t == 1) mbar_arrive(bar);
    __syncthreads();
    look(4);
    CUtensorMap map;
    make_tensor_map(&map, x, a.rows_a, a.cols_a, a.ld_a, 16);
    if (t == 0) mbar_arrive_expect_tx(bar, 2048);
    if (t == 1) mbar_arrive(bar);
    __syncthreads();
    look(6);
    if (t == 0) tma_load_2d(base, &map, bar, 0, 0);
    if (t == 0) mbar_wait(bar, 1);
    __syncthreads();
    look(8);
    return;
  }
  if (a.op == 40) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, 16 * a.rows_a);
      bulk_copy_g2s(base, static_cast<const unsigned char*>(x) + 16 * a.c0, 16 * a.rows_a, bar);
      memcpy(rout, base, 16);  // before the wait
    }
    __syncthreads();
    mbar_wait(bar, 0);
    for (int i = t; i < 4 * a.rows_a; i += 128) memcpy(rout + 4 + i, base + 4 * i, 4);
    return;
  }
  if (a.op == 20 || a.op == 21) {
    CUtensorMap map;
    if (a.op == 20)
      make_tensor_map(&map, x, a.rows_a, a.cols_a, a.ld_a, 16);
    else  // rows_b matrices [rows_a][cols_a] end to end; the box in matrix tb
      make_tensor_map_3d(&map, x, a.rows_b, a.rows_a, a.cols_a, a.ld_a, 16);
    if (t == 0) mbar_init(bar, 1);
    __syncthreads();
    if (t == 0) {
      mbar_arrive_expect_tx(bar, 2048);
      if (a.op == 20)
        tma_load_2d(base, &map, bar, a.c0, a.c1);
      else
        tma_load_3d(base, &map, bar, a.c0, a.c1, a.tb);
    }
    mbar_wait(bar, 0);
    memcpy(rout + 4 * t, base + 16 * t, 16);
    return;
  }
  // A [64 x 16]: K-major as x [64][16], MN-major as x [16][64]; B [16 x 256]:
  // K-major as y [256][16], MN-major as y [16][256] (four 64-wide boxes of
  // 16 k rows, 2 KB apart); boxes of 64 rows, or 16 rows MN-major
  unsigned char* sa = base;
  unsigned char* sb = base + 8192;
  CUtensorMap ma, mb;
  make_tensor_map(&ma, x, a.rows_a, a.cols_a, a.ld_a, a.ta ? 16 : 64);
  make_tensor_map(&mb, y, a.rows_b, a.cols_b, a.ld_b, a.tb ? 16 : 256);
  if (t == 0) mbar_init(bar, 1);
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(bar, (a.ta ? 2048 : 8192) + (a.tb ? 4 * 2048 : 32768));
    tma_load_2d(sa, &ma, bar, 0, 0);
    if (a.tb)
      for (int i = 0; i < 4; ++i) tma_load_2d(sb + 2048 * i, &mb, bar, 64 * i, 0);
    else
      tma_load_2d(sb, &mb, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  float d[128];
  memcpy(d, fout + 128 * t, sizeof(d));
  wgmma_fence();
  const uint64_t da = wgmma_desc(sa, 16, 1024), db = wgmma_desc(sb, a.tb ? 2048 : 16, 1024);
  if (a.ta == 0 && a.tb == 0) wgmma_m64n256k16<0, 0>(d, da, db, 1);
  if (a.ta == 1 && a.tb == 1) wgmma_m64n256k16<1, 1>(d, da, db, 1);
  if (a.ta == 0 && a.tb == 1) wgmma_m64n256k16<0, 1>(d, da, db, 1);
  wgmma_commit();
  wgmma_wait<0>();
  memcpy(fout + 128 * t, d, sizeof(d));
}
}  // namespace

extern "C" int tk_hop(const int* args, const void* x, const void* y, void* fout, void* rout) {
  Args a;
  memcpy(&a, args, sizeof(a));
  tk_emu::launch(hop, dim3(1), 128, 65536 + 1024, nullptr, a, x, y, static_cast<float*>(fout),
                 static_cast<uint32_t*>(rout));
  return 0;
}
"""


@pytest.fixture(scope="module")
def hopper_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("hopper_emu")
    cpp = out / "hopper.cpp"
    cpp.write_text(_HOPPER_SRC)
    return _build(cpp, out / "libhopper.so",
                  {"tk_hop": (ctypes.c_int, [ctypes.c_void_p] * 5)})


def _swizzle128(off):
    """The 128B swizzle of a byte offset: bits [4, 7) ^= bits [7, 10)."""
    return off ^ (((off >> 7) & 7) << 4)


def _hopper_primitive(lib, prim):
    """tk_hopper.cuh's emulation against the PTX ISA: wgmma's accumulator
    layout (written out lane by lane) and both operand majors against
    torch.matmul (exact bf16 products, 16 f32 additions: atol 1e-5), the
    TMA box's swizzled placement and zero fill byte by byte, the
    mbarrier's phase parity step by step, and the bulk copy's bytes, landed
    at the wait."""
    rng = np.random.RandomState(11)
    mk = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    fout = np.zeros(128 * 128, dtype=np.float32)
    rout = np.zeros(512, dtype=np.uint32)

    def call(args, x, y):
        a = np.asarray(args + [0] * (11 - len(args)), dtype=np.int32)
        lib.tk_hop(_ptr(a), _ptr(x), _ptr(y), _ptr(fout), _ptr(rout))

    if prim.startswith("wgmma"):
        ta, tb = {"wgmma_k_major": (0, 0), "wgmma_mn_major": (1, 1),
                  "wgmma_k_mn": (0, 1)}[prim]
        a, b = mk(64, 16), mk(16, 256)
        c = rng.randn(64, 256).astype(np.float32)
        x = (a.t() if ta else a).contiguous()
        y = (b if tb else b.t()).contiguous()
        regs = np.zeros((128, 128), dtype=np.float32)
        place = []
        for t in range(128):  # row 16 w + g + 8 ((i / 2) % 2), col 8 (i / 4) + 2 q + i % 2
            w, g, q = t // 32, (t % 32) // 4, t % 4
            for i in range(128):
                place.append((t, i, 16 * w + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * q + i % 2))
        for t, i, r, col in place:
            regs[t, i] = c[r, col]
        fout[:] = regs.reshape(-1)
        call([ta * 10 + tb, x.shape[0], x.shape[1], x.shape[1], y.shape[0], y.shape[1],
              y.shape[1], 0, 0, ta, tb], x, y)
        got = np.zeros((64, 256), dtype=np.float32)
        out = fout.reshape(128, 128)
        for t, i, r, col in place:
            got[r, col] = out[t, i]
        want = torch.matmul(a.float(), b.float()) + torch.from_numpy(c)
        torch.testing.assert_close(torch.from_numpy(got), want, atol=1e-5, rtol=1e-5)
    elif prim in ("tma_box", "tma_box_3d"):
        rows, cols, ld = 40, 100, 104  # the box (60.., 30..) runs past both edges
        if prim == "tma_box":
            x = mk(rows, ld)
            call([20, rows, cols, ld, 0, 0, 0, 60, 30], x, x)
            xb = _bits(x)
        else:  # matrix 1 of 3: past its edges lie matrix 2's rows, which must not show
            x = mk(3 * rows, ld)
            call([21, rows, cols, ld, 3, 0, 0, 60, 30, 0, 1], x, x)
            xb = _bits(x)[rows:2 * rows]
        got = np.stack([rout & 0xFFFF, rout >> 16], -1).reshape(-1)  # 1024 bf16 = 2 KB
        want = np.zeros(1024, dtype=np.int64)
        for r in range(16):
            for c in range(64):
                row, col = 30 + r, 60 + c
                v = xb[row, col] if row < rows and col < cols else 0
                want[_swizzle128(r * 128 + 2 * c) // 2] = v
        assert (got == want).all()
        # column 100 (byte 80 of each box row) is past the edge: zeros
        edge = _swizzle128(np.arange(16) * 128 + 80) // 2
        assert (got != 0).sum() > 0 and (got[edge] == 0).all()
    elif prim == "bulk_copy":  # 40 chunks (640 bytes) from chunk 3 of x
        x = mk(64, 64)
        call([40, 40, 0, 0, 0, 0, 0, 3], x, x)
        xb = x.contiguous().view(torch.uint8).numpy().reshape(-1)
        got = rout.view(np.uint8)
        assert (got[16:16 + 640] == xb[48:48 + 640]).all()
        # the copy lands at the wait, not before: the emulation's stale bytes
        assert (got[:16] != xb[48:64]).any()
    else:  # mbarrier phases: (try_wait parity 0, parity 1) after each step
        x = mk(16, 64)
        call([30, 16, 64, 64], x, x)
        seen = [int(v) for v in rout[:10]]
        assert seen == [0, 1,  # phase 0 in progress: parity 1 counts as done
                        0, 1,  # one of two arrivals
                        1, 0,  # both: phase 0 done, phase 1 in progress
                        1, 0,  # both arrived, but the TMA's 2 KB are pending
                        0, 1], seen  # the bytes landed: phase 1 done

@pytest.fixture(scope="module")
def prim_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("ptx_emu")
    cpp = out / "prim.cpp"
    cpp.write_text(_PRIM_SRC)
    return _build(cpp, out / "libprim.so",
                  {"tk_prim": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 6)})


def _bits(t):
    """bf16 tensor -> its 16-bit patterns as int64 numpy."""
    return t.contiguous().view(torch.int16).numpy().astype(np.int64) & 0xFFFF


def _word(lo, hi):
    return (int(lo) | (int(hi) << 16)) & 0xFFFFFFFF


def _bf16_from_words(words):
    """uint32 numpy words -> (low, high) halves as f32 numpy."""
    w = np.asarray(words, dtype=np.uint32)
    as_f32 = lambda u: (u.astype(np.uint32) << 16).view(np.float32)
    return as_f32(w & 0xFFFF), as_f32(w >> 16)


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr())


@pytest.mark.parametrize("prim", ["mma_fragments", "ldmatrix_x4", "ldmatrix_x4_trans",
                                  "cp_async", "pack_bf16x2", "qk_product", "pv_product",
                                  "accumulator_as_a", "wgmma_k_major", "wgmma_mn_major",
                                  "wgmma_k_mn", "tma_box", "tma_box_3d", "mbarrier_phases",
                                  "bulk_copy"])
def test_ptx_primitive_matches_plain(request, prim):
    """Each emulated tk_mma.cuh function against the PTX ISA's layout tables
    (written out here, lane by lane) and against torch.matmul in f32 of the
    same bf16 tiles. Products of bf16 are exact in f32, so only the order of
    16 f32 additions differs: atol 1e-5 at O(1) values, 2^-8 relative where
    the result is rounded to bf16 on the way (accumulator_as_a). The
    tk_hopper.cuh cases: `_hopper_primitive`."""
    if prim.startswith(("wgmma", "tma", "mbarrier", "bulk")):
        _hopper_primitive(request.getfixturevalue("hopper_lib"), prim)
        return
    prim_lib = request.getfixturevalue("prim_lib")
    rng = np.random.RandomState(7)
    mk = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    x, y = mk(16, 16), mk(16, 16)
    regs = np.zeros((32, 6), dtype=np.uint32)
    addr = np.zeros(64, dtype=np.int32)
    fout = np.zeros(256, dtype=np.float32)
    rout = np.zeros(256, dtype=np.uint32)
    call = lambda op: prim_lib.tk_prim(op, _ptr(regs), _ptr(x), _ptr(y), _ptr(addr), _ptr(fout),
                                       _ptr(rout))
    lanes = [(lane, lane // 4, lane % 4) for lane in range(32)]
    if prim == "mma_fragments":
        a, b = x, y[:, :8]
        c = rng.randn(16, 8).astype(np.float32)
        ab, bb = _bits(a), _bits(b)
        for lane, g, t in lanes:  # A row-major, B "col", C: PTX ISA m16n8k16 tables
            regs[lane] = [_word(ab[g, 2 * t], ab[g, 2 * t + 1]),
                          _word(ab[g + 8, 2 * t], ab[g + 8, 2 * t + 1]),
                          _word(ab[g, 2 * t + 8], ab[g, 2 * t + 9]),
                          _word(ab[g + 8, 2 * t + 8], ab[g + 8, 2 * t + 9]),
                          _word(bb[2 * t, g], bb[2 * t + 1, g]),
                          _word(bb[2 * t + 8, g], bb[2 * t + 9, g])]
            fout[4 * lane:4 * lane + 4] = [c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                                           c[g + 8, 2 * t + 1]]
        call(0)
        got = np.zeros((16, 8), dtype=np.float32)
        for lane, g, t in lanes:
            got[g, 2 * t:2 * t + 2] = fout[4 * lane:4 * lane + 2]
            got[g + 8, 2 * t:2 * t + 2] = fout[4 * lane + 2:4 * lane + 4]
        want = torch.matmul(a.float(), b.float()) + torch.from_numpy(c)
        torch.testing.assert_close(torch.from_numpy(got), want, atol=1e-5, rtol=1e-5)
    elif prim in ("ldmatrix_x4", "ldmatrix_x4_trans"):
        addr[:32] = rng.randint(0, 16, 32)  # any row ...
        addr[32:] = rng.randint(0, 2, 32)  # ... and either 16-byte chunk, per lane
        call(1 if prim == "ldmatrix_x4" else 2)
        xb = _bits(x)
        for lane, g, t in lanes:
            for j in range(4):  # matrix j: the rows lanes 8j .. 8j + 7 point at
                m = np.stack([xb[addr[8 * j + r], 8 * addr[32 + 8 * j + r]:][:8]
                              for r in range(8)])
                lo, hi = (m[g, 2 * t], m[g, 2 * t + 1]) if prim == "ldmatrix_x4" else \
                    (m[2 * t, g], m[2 * t + 1, g])
                assert rout[4 * lane + j] == _word(lo, hi), (lane, j)
    elif prim == "pack_bf16x2":  # round to nearest even, the first value low
        vals = (rng.randn(256) * np.exp2(rng.randint(-20, 20, 256))).astype(np.float32)
        vals[:4] = [1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8), 0.0]  # ties
        fout[:] = vals
        call(7)
        want = _bits(torch.from_numpy(vals).bfloat16())
        words = rout[:128]
        assert ((words & 0xFFFF) == want[0::2]).all() and ((words >> 16) == want[1::2]).all()
    elif prim == "cp_async":
        call(3)
        xb, yb = _bits(x).reshape(-1), _bits(y).reshape(-1)
        lo, hi = rout[:128] & 0xFFFF, rout[:128] >> 16
        got_x = np.stack([lo, hi], -1).reshape(-1)
        lo, hi = rout[128:] & 0xFFFF, rout[128:] >> 16
        got_y = np.stack([lo, hi], -1).reshape(-1)
        chunk_on = (np.arange(256) // 8) % 2 == 0
        pair_on = (np.arange(256) // 2) % 3 != 0
        assert (got_x == np.where(chunk_on, xb, 0)).all()
        assert (got_y == np.where(pair_on, yb, 0)).all()
    else:
        op = {"qk_product": 4, "pv_product": 5, "accumulator_as_a": 6}[prim]
        call(op)
        got = torch.from_numpy(fout.reshape(16, 16).copy())
        xy_t = torch.matmul(x.float(), y.float().t())
        if prim == "qk_product":
            torch.testing.assert_close(got, xy_t, atol=1e-5, rtol=1e-5)
        elif prim == "pv_product":
            torch.testing.assert_close(got, torch.matmul(x.float(), y.float()), atol=1e-5,
                                       rtol=1e-5)
        else:
            want = torch.matmul(xy_t.bfloat16().float(), y.float())
            # where the two f32 sums of x y^T straddle a bf16 rounding
            # boundary, one rounded element moves by an ulp (2^-8 relative)
            bar = 2.0**-8 * xy_t.abs().max() * y.float().abs().max() + 1e-5
            assert ((got - want).abs() <= bar).all()


def test_build_key_follows_headers(tmp_path, monkeypatch):
    """The card loads `build/tpukit_torch/<key>/lib<name>.so`: editing a
    header under csrc/ that a source includes must change the key, so no
    stale library is loaded; the host emulation's headers are not built
    by nvcc and leave it alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    before = _cuda._target("flash_attention")
    emu = csrc / "host_emu" / "tk_mma.cuh"
    emu.write_text(emu.read_text() + "\n// edited\n")
    assert _cuda._target("flash_attention") == before
    header = csrc / "tk_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _cuda._target("flash_attention")
    assert after != before and after.name == before.name == "libflash_attention.so"


def _ce_inputs(n, dim, vocab, v_pad, dtype, seed):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(n, dim).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(dim, v_pad) * 0.2).astype(np.float32))
    w[:, 7] = w[:, 3]  # columns 3 and 7 tie on every row: argmax must say 3
    w[:, 3] += 2.0  # ... and win often enough to be tested
    w[:, 7] += 2.0
    tgt = rng.randint(0, vocab, n).astype(np.int32)
    tgt[::7] = -100
    tgt[1::11] = vocab - 1  # targets in the last vocab tile
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    return h, w, torch.from_numpy(tgt), g


# bf16 runs the wgmma/TMA kernels on an emulated card of `sms` SMs (the
# persistent grids then loop over several tiles and wrap the stage ring):
# 128 x 256 tiles, so N = 70, 200 and 300 end in ragged row tiles; v_pad 270
# is no multiple of 8 (the wrapper pads W to 272 for TMA); "chunks" runs the
# backward in three chunks of 128, 128 and 44 rows (dW read, added and
# written back in chunk order); on 4 SMs, "splits" runs the forward in two
# vocab splits (the combine's first-index rule across them: columns 3 and
# 7 tie on every row) and dH in two vocab splits; "splits-uneven" has one
# row tile and five vocab tiles, where four splits would fill the SMs but
# two tiles a split leave three, and dH's 20 k-blocks in four splits;
# "dim100" runs a dim that is no multiple of 8 (the wrapper pads h's
# columns and W's rows with zeros to 104).
@pytest.mark.parametrize("n,dim,vocab,v_pad,dtype,sms,chunk_rows,splits", [
    (100, 40, 300, 384, torch.float32, 3, 0, None),
    (70, 32, 250, 270, torch.float32, 3, 0, None),
    (200, 40, 300, 384, torch.bfloat16, 3, 0, None),
    (70, 32, 250, 270, torch.bfloat16, 3, 0, None),
    (300, 40, 300, 384, torch.bfloat16, 3, 128, None),
    (200, 40, 600, 640, torch.bfloat16, 4, 0, (2, 2)),
    (100, 40, 1200, 1280, torch.bfloat16, 4, 0, (3, 4)),
    (100, 100, 300, 384, torch.bfloat16, 3, 0, None),
], ids=["f32", "f32-ragged-vocab", "bf16", "bf16-ragged-vocab", "bf16-chunks", "bf16-splits",
        "bf16-splits-uneven", "bf16-dim100"])
def test_fused_head_ce_kernels_match_plain_version(emulated, monkeypatch, n, dim, vocab, v_pad,
                                                   dtype, sms, chunk_rows, splits):
    monkeypatch.setenv("TK_EMU_SMS", str(sms))
    h, w, tgt, g = _ce_inputs(n, dim, vocab, v_pad, dtype, seed=n + dim)
    lib = emulated["fused_head_ce"]
    if splits is not None:  # (forward, dH) vocab splits launched
        assert lib.tk_ce_fwd_splits(n, v_pad) == splits[0]
        assert fce.backward_plan(lib, n, dim, v_pad) == (n, 1, splits[1] * n * dim)
    lse, tl = torch.empty(n), torch.empty(n)
    best = torch.empty(n, dtype=torch.int32)
    w_c = w.to(dtype)  # the kernels take W in h's dtype, as the wrapper hands it over
    fce.launch_forward(lib, h, w_c, tgt, lse, tl, best, vocab, True, 0)
    ref_lse, ref_tl, ref_best = fce.head_terms_reference(h, w, tgt, vocab, True)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(tl, ref_tl, atol=2e-5, rtol=1e-5)
    assert torch.equal(best, ref_best)
    assert (best == 3).any() and not (best == 7).any()
    lse2, tl2 = torch.empty(n), torch.empty(n)
    fce.launch_forward(lib, h, w_c, tgt, lse2, tl2, best, vocab, False, 0)
    assert torch.equal(lse2, lse) and torch.equal(tl2, tl) and (best == 0).all()

    valid = (tgt != -100).float()
    g_lse, g_tgt = g * valid, -g * valid
    dh, dw = torch.empty_like(h), torch.empty(w.shape)
    chunks = fce.launch_backward(lib, h, w_c, tgt, lse, g_lse, g_tgt, dh, dw, vocab, 0,
                                 chunk_rows=chunk_rows)
    assert chunks == (-(-n // chunk_rows) if chunk_rows else 1)
    ref_dh, ref_dw = fce.head_terms_backward_reference(h, w, tgt, lse, g_lse, g_tgt, vocab)
    assert (dw[:, vocab:] == 0).all()
    torch.testing.assert_close(dw, ref_dw, atol=2e-5, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(dh, ref_dh, atol=2e-5, rtol=1e-4)
    else:
        _bf16_close(dh, ref_dh)
        dh2, dw2 = torch.empty_like(h), torch.empty(w.shape)
        fce.launch_backward(lib, h, w_c, tgt, lse, g_lse, g_tgt, dh2, dw2, vocab, 0,
                            chunk_rows=chunk_rows)
        assert torch.equal(dh2, dh) and torch.equal(dw2, dw)  # the same bits every run


def _moe_inputs(sizes, n, d, f, dtype, seed):
    """Rows sorted into `sizes` segments plus a sort-padding tail folded
    into the last one; a bank at tpukit's init scale; O(1) cotangents, 0 on
    the padding rows."""
    e = len(sizes)
    m = moe_gemm.plan_rows(n)[1]
    rng = np.random.RandomState(seed)
    mk = lambda *shape, s=1.0: torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
    xs = mk(m, d).to(dtype)
    bank = [mk(e, d, f, s=d**-0.5), mk(e, f, s=0.1), mk(e, f, d, s=f**-0.5), mk(e, d, s=0.1)]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    offs[-1] = m
    g = mk(m, d)
    g[n:] = 0.0
    return xs, [t.to(dtype) for t in bank], torch.from_numpy(offs), g.to(dtype)


def _moe_run(lib, xs, bank, offs, g):
    """The forward kernels, then the backward kernels on their y and h:
    (h, y, [dx, dwu, dbu, dwd, dbd])."""
    wu, bu, wd, bd = bank
    m, f = xs.shape[0], wu.shape[2]
    h, ys = torch.empty((m, f), dtype=xs.dtype), torch.zeros_like(xs)
    moe_gemm.launch_forward(lib, xs, wu, bu, wd, bd, offs, h, ys, 0)
    scratch = moe_gemm.backward_scratch(lib, xs, f, wu.shape[0])
    dx = torch.zeros_like(xs)
    grads = [torch.empty(t.shape) for t in (wu, bu, wd, bd)]
    moe_gemm.launch_backward(lib, xs, g, ys, h, wu, wd, offs, scratch, dx, *grads, 0)
    return h, ys, [dx, *grads]


def _hold_moe(dtype, sizes, n, xs, bank, offs, g, h, ys, grads, keep=None):
    """The kernels' outputs (`_moe_run`) against the plain versions on the
    same inputs (the plain backward reads the kernels' h), over the rows
    and experts of `keep` (every expert by default)."""
    wu, bu, wd, bd = bank
    dx, dwu, dbu, dwd, dbd = grads
    keep = list(range(len(sizes))) if keep is None else keep
    bounds = offs.tolist()
    rows = torch.cat([torch.arange(bounds[e], bounds[e + 1]) for e in keep])
    ref_y = moe_gemm.grouped_ffn_reference(xs, wu, bu, wd, bd, offs)
    refs = moe_gemm.grouped_ffn_backward_reference(xs, g, ref_y, wu, bu, wd, offs, h=h)
    ref_h = torch.zeros(h.shape)
    for e, s, t in moe_gemm._segments(offs, len(sizes)):
        ref_h[s:t] = torch.relu(xs[s:t].float() @ wu[e].float() + bu[e].float())
    for got, ref in ((h, ref_h.to(dtype)), (ys, ref_y)):
        if dtype == torch.float32:
            torch.testing.assert_close(got[rows], ref[rows], atol=2e-5, rtol=1e-4)
        else:
            _bf16_close(got[rows], ref[rows])
    # dx is rounded to bf16 like y; the weight gradients come out in f32.
    # The bias gradients sum f32 terms (dz2 exactly, dz1 unrounded) that
    # differ only in summation order, so they keep the f32 bar in bf16 too:
    # a dbu summed from the rounded dz1 fails it. dW sums products of
    # round(dz1), which may land a bf16 ulp apart where the two f32 dh sums
    # straddle a rounding boundary: 2^-12 of the row's largest |value|.
    torch.testing.assert_close(dbu[keep], refs[2][keep], atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(dbd[keep], refs[4][keep], atol=5e-5, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(dx[rows], refs[0][rows], atol=5e-5, rtol=1e-4)
        for got, ref in ((dwu, refs[1]), (dwd, refs[3])):
            torch.testing.assert_close(got[keep], ref[keep], atol=5e-5, rtol=1e-4)
    else:
        _bf16_close(dx[rows], refs[0][rows])
        for got, ref in ((dwu, refs[1]), (dwd, refs[3])):
            got, ref = got[keep], ref[keep]
            top = ref.abs().amax(-1, keepdim=True)
            assert ((got - ref).abs() <= 2.0**-12 * top + 1e-5 * ref.abs()).all()
    for e in keep:
        if sizes[e] == 0:
            assert all((t[e] == 0).all() for t in (dwu, dbu, dwd, dbd))
    assert (dx[n:] == 0).all()
    assert dwu[keep].abs().max() > 0 and dbu[keep].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_gemm_kernels_match_plain_version(emulated, dtype):
    """The forward and backward kernels on an adversarial layout: a segment
    over two row tiles (130 rows), a 1-row segment, an empty expert, a
    padding tail, D and F that are no multiple of the tiles (40, 160)."""
    sizes, n, d, f = [130, 1, 0, 137], 268, 40, 160
    xs, bank, offs, g = _moe_inputs(sizes, n, d, f, dtype, seed=3)
    h, ys, grads = _moe_run(emulated["moe_gemm"], xs, bank, offs, g)
    _hold_moe(dtype, sizes, n, xs, bank, offs, g, h, ys, grads)


# The bf16 wgmma/TMA kernels (64-deep k-blocks, 128-row tiles, or 64-row
# tiles under the decode policy) on layouts that stress the segment walk,
# each backward run twice for the same bits:
#   spill:        every segment's last dW k-block holds rows of the next
#                 expert (70, 90, 100 rows), which the consumers zero;
#   empty-single: empty experts and 1-row segments between larger ones;
#   ring-wrap:    D 72 and F 200, no multiple of 64 (the rank-3 maps'
#                 zero fill past D and F), 4-k-block tiles on 3 SMs, so
#                 each block's 4-stage ring wraps many times;
#   decode:       M = 16 over 8 experts (MoE serving's tick), the decode
#                 policy: 64-row tiles, the down product's 4 k-blocks in
#                 4 splits and the up product's 2 in 2 (on 64 SMs), each
#                 finished by the combine kernel;
#   isolation:    expert 1's first rows of Wu and Wd are +inf; every other
#                 expert's outputs stay exact (a box past D or F must read
#                 zeros, not the next expert's weights);
#   unaligned:    D 36 and F 100, no multiple of 8: the wrapper runs the
#                 kernels on zero-padded copies (40, 104).
@pytest.mark.parametrize("sizes,d,f,sms,decode,poison", [
    ([70, 90, 100], 40, 160, 3, False, False),
    ([1, 0, 1, 200, 1, 0, 60], 40, 160, 3, False, False),
    ([130, 1, 0, 137], 72, 200, 3, False, False),
    ([3, 2, 0, 1, 4, 2, 1, 3], 72, 200, 64, True, False),
    ([130, 1, 0, 137], 40, 160, 3, False, True),
    ([130, 0, 137], 36, 100, 3, False, False),
], ids=["spill", "empty-single", "ring-wrap-sms3", "decode-m16", "isolation", "unaligned"])
def test_moe_gemm_wgmma_layouts_match_plain_version(emulated, monkeypatch, sizes, d, f, sms,
                                                    decode, poison):
    monkeypatch.setenv("TK_EMU_SMS", str(sms))
    n = sum(sizes)
    xs, bank, offs, g = _moe_inputs(sizes, n, d, f, torch.bfloat16, seed=n + d)
    lib = emulated["moe_gemm"]
    small, split_up, split_down, _ = moe_gemm.forward_plan(lib, xs.dtype, xs.shape[0], d, f,
                                                           len(sizes))
    assert (small, split_up, split_down) == ((1, 2, 4) if decode else (0, 1, 1))
    keep = None
    if poison:
        for w in (bank[0], bank[2]):
            w[1, 0] = float("inf")
        keep = [e for e in range(len(sizes)) if e != 1]
    h, ys, grads = _moe_run(lib, xs, bank, offs, g)
    _hold_moe(torch.bfloat16, sizes, n, xs, bank, offs, g, h, ys, grads, keep)
    again = _moe_run(lib, xs, bank, offs, g)
    for got, ref in zip([h, ys, *grads], [again[0], again[1], *again[2]]):
        assert torch.equal(got, ref) or poison and torch.equal(got.nan_to_num(), ref.nan_to_num())


# ---------------------------------------------------------------------------
# Paged decode attention: the scores, values and combine kernels through the
# wrapper's own `launch`, against `paged_attend_reference` on the same
# inputs, with the tolerances of tests/test_torch_paged_attention.py (f32
# compute 1e-6, bf16 compute 1e-2). Five slots with cursors at 0, mid-page,
# a page boundary, W - 1 and 4 P (with four pages a split, the first
# position of split 1: a unit that holds only the fresh token); 2 heads;
# 12 pages a slot. The emulated card's SM count sets the split plan (8
# units an SM over 10 (slot, head) rows, at least 4 pages a split): 1 SM
# one split, 2 two, 3 three, so slot 3's window covers 1, 2 or 3 splits.
# Slot 3's first page is also slot 1's (a page shared by two slots). Head
# dims whose position row is no multiple of 16 bytes (int8 D 8, bf16 D 12)
# and an f32 pool 4 bytes off 16-byte alignment run the byte-load path into
# padded stages; every other case fills its stages by bulk copies. An int8
# page row of 8 KB (P 32, D 256) leaves each warp one ring stage, so a
# warp's next page (two splits of 6 pages: warps own 1 or 2 pages each)
# lands in the stage it has just read. Lanes leave each __syncwarp apart
# (TK_EMU_WARP_SKEW_US), so a lane that reads a scale another lane stored,
# with no __syncwarp between, reads the page before's.
# ---------------------------------------------------------------------------

_PAGED_HEADS, _PAGED_MP = 2, 12


def _paged_inputs(pool_dtype, cdt, p, d, seed, misaligned=False):
    """(args of `paged_attend`, the (page, offset) pairs some slot reads)."""
    rng = np.random.RandomState(seed)
    h, mp = _PAGED_HEADS, _PAGED_MP
    w = mp * p
    starts = np.asarray([0, p // 2 - 1, p, w - 1, 4 * p], np.int32)
    n = len(starts)
    num_pages = n * mp + 1
    ids = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((n, mp), np.int32)
    k = 0
    for i, s in enumerate(starts):
        need = min(int(s) // p + 1, mp)
        bt[i, :need] = ids[k:k + need]
        k += need
    bt[1, 0] = bt[3, 0]  # a page two slots read
    read = {(int(bt[i, j // p]), j % p) for i, s in enumerate(starts)
            for j in range(min(int(s), w - 1))}
    raw = [torch.from_numpy(rng.randn(num_pages, h, p, d).astype(np.float32) * 0.5)
           for _ in range(2)]
    if pool_dtype == torch.int8:
        pools, scales = [], []
        for x in raw:
            qv, sv = quant_comm.quantize_blocks(x.reshape(num_pages, h, p * d))
            pools.append(qv.reshape(num_pages, h, p, d))
            scales.append(sv)
    else:
        pools, scales = [x.to(pool_dtype) for x in raw], [None, None]
    if misaligned:  # the same values 4 bytes past a 16-byte boundary
        for i, x in enumerate(pools):
            flat = torch.empty(x.numel() + 1, dtype=x.dtype)
            flat[1:] = x.reshape(-1)
            pools[i] = flat[1:].view(x.shape)
            assert pools[i].data_ptr() % 16 != 0 and pools[i].is_contiguous()
    vecs = [torch.from_numpy(rng.randn(n, h, d).astype(np.float32)).to(cdt) for _ in range(3)]
    args = (pools[0], pools[1], scales[0], scales[1], torch.from_numpy(bt),
            torch.from_numpy(starts), *vecs)
    return args, read


def _paged_run(lib, args):
    out = torch.empty_like(args[6])
    pool_k, bt = args[0], args[4]
    plan = pa.plan(lib, pool_k.dtype, bt.shape[0], *pool_k.shape[1:], bt.shape[1])
    pa.launch(lib, plan, *args, out, 0)
    return out, plan


def _paged_close(out, ref):
    """Within tests/test_torch_paged_attention.py's bars; in bf16 also at
    most 0.01 of the elements not bit-equal (chip_smoke.py's DIFF_SHARE):
    the kernels round where the plain version rounds, so a dropped rounding
    step moves many elements by an ulp while staying within 1e-2."""
    atol = 1e-6 if out.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    if out.dtype == torch.bfloat16:
        assert (out.float() != ref.float()).float().mean().item() <= 0.01


# (pool, compute, P, D, emulated SMs -> splits, misaligned pool)
_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8


@pytest.mark.parametrize("pool_dtype,cdt,p,d,sms,splits,misaligned", [
    (_F32, _F32, 16, 64, 3, 3, False),
    (_F32, _BF16, 16, 64, 2, 2, False),
    (_BF16, _BF16, 16, 64, 1, 1, False),
    (_I8, _F32, 16, 64, 3, 3, False),
    (_I8, _BF16, 8, 32, 2, 2, False),
    (_F32, _F32, 8, 8, 1, 1, False),
    (_F32, _BF16, 8, 32, 3, 3, False),
    (_BF16, _BF16, 8, 8, 2, 2, False),
    (_I8, _F32, 8, 64, 1, 1, False),
    (_I8, _BF16, 16, 32, 3, 3, False),
    (_BF16, _F32, 16, 32, 2, 2, False),
    (_F32, _F32, 8, 128, 2, 2, False),
    (_I8, _BF16, 32, 8, 3, 3, False),
    (_BF16, _BF16, 8, 12, 3, 3, False),
    (_F32, _BF16, 16, 32, 3, 3, True),
    (_I8, _BF16, 32, 256, 2, 2, False),
], ids=["f32-p16-d64-s3", "f32-bf16-p16-d64-s2", "bf16-p16-d64-s1", "int8-p16-d64-s3",
        "int8-bf16-p8-d32-s2", "f32-p8-d8-s1", "f32-bf16-p8-d32-s3", "bf16-p8-d8-s2",
        "int8-p8-d64-s1", "int8-bf16-p16-d32-s3", "bf16-f32-p16-d32-s2", "f32-p8-d128-s2",
        "int8-bf16-p32-d8-bytes-s3", "bf16-p8-d12-bytes-s3", "f32-bf16-misaligned-s3",
        "int8-bf16-p32-d256-one-stage-s2"])
def test_paged_attention_kernels_match_plain_version(emulated, monkeypatch, pool_dtype, cdt, p,
                                                     d, sms, splits, misaligned):
    monkeypatch.setenv("TK_EMU_SMS", str(sms))
    monkeypatch.setenv("TK_EMU_WARP_SKEW_US", "200")
    args, _ = _paged_inputs(pool_dtype, cdt, p, d, seed=p + d + sms, misaligned=misaligned)
    out, plan = _paged_run(emulated["paged_attention"], args)
    assert plan["splits"] == splits
    if p * d * pool_dtype.itemsize > 4096:
        assert plan["stages"] == 4  # one stage a warp
    assert plan["bulk"] == ((d * torch.tensor([], dtype=pool_dtype).element_size()) % 16 == 0)
    ref = pa.paged_attend_reference(*args)
    assert out.dtype == cdt and out.shape == ref.shape
    _paged_close(out, ref)
    assert torch.equal(out[0], args[8][0])  # cursor 0: the fresh value alone


@pytest.mark.parametrize("pool_dtype,cdt", [(_F32, _F32), (_BF16, _BF16), (_I8, _BF16)],
                         ids=["f32", "bf16", "int8-bf16"])
def test_paged_attention_kernels_never_read_past_the_cursor(emulated, monkeypatch, pool_dtype,
                                                            cdt):
    """NaN in every pool position no slot's window reads (past each cursor,
    at each cursor, whose value is this tick's fresh k/v, and all of the
    null page 0); int8 pools get other codes there and NaN block scales
    where a block holds no read position. The output keeps its bits, so no
    such value is read; the clean run also matches the plain version, which
    cannot run on the poisoned pools. Three splits (3 SMs)."""
    monkeypatch.setenv("TK_EMU_SMS", "3")
    monkeypatch.setenv("TK_EMU_WARP_SKEW_US", "200")
    p, d = 16, 32
    args, read = _paged_inputs(pool_dtype, cdt, p, d, seed=11)
    lib = emulated["paged_attention"]
    clean, plan = _paged_run(lib, args)
    assert plan["splits"] == 3
    _paged_close(clean, pa.paged_attend_reference(*args))
    pools = [t.clone() for t in args[:2]]
    scales = [t.clone() if t is not None else None for t in args[2:4]]
    num_pages = pools[0].shape[0]
    unread = torch.ones((num_pages, p), dtype=torch.bool)
    for page, off in read:
        unread[page, off] = False
    assert unread[0].all() and not unread.all()
    for pool, sc in zip(pools, scales):
        mask = unread[:, None, :, None].expand(pool.shape)
        if pool_dtype == torch.int8:
            pool[mask] = torch.randint(-128, 128, pool.shape, dtype=torch.int8,
                                       generator=torch.Generator().manual_seed(3))[mask]
            elem_read = (~unread)[:, :, None].expand(num_pages, p, d).reshape(num_pages, -1)
            block_read = elem_read.reshape(num_pages, -1, quant_comm.DEFAULT_BLOCK).any(-1)
            sc[~block_read[:, None, :].expand(sc.shape)] = float("nan")
        else:
            pool[mask] = float("nan")
    poisoned, _ = _paged_run(lib, (*pools, *scales, *args[4:]))
    assert torch.equal(poisoned, clean)
