"""The port's CUDA kernel sources, built for the CPU with g++ against a host
emulation of the CUDA runtime (`tpukit_torch/csrc/host_emu/`: one
std::thread per CUDA thread, barriers for __syncthreads and the warp
shuffles), and held against their plain PyTorch versions at small ragged
shapes.

This checks each kernel's arithmetic, indexing, masking and
synchronisation on every CPU run, the WMMA instances through
`host_emu/mma.h` and the mma.sync / ldmatrix / cp.async instances (the bf16
flash kernels) through `host_emu/tk_mma.cuh`, which lays fragments out
lane by lane as the PTX ISA does, so a wrong fragment layout shows here.
The build puts `-I host_emu` ahead of everything: the sources are copied
out of `csrc/`, so their `#include "tk_mma.cuh"` finds the emulation and
not `csrc/tk_mma.cuh`. `test_ptx_primitive_matches_plain` holds each
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

ROOT = Path(__file__).resolve().parent.parent
EMU = ROOT / "tpukit_torch" / "csrc" / "host_emu"
_LAUNCH = re.compile(r"(\w+)<<<([^>]*)>>>\(([^;]*)\);")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the CUDA source built with g++ against the emulator."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the kernel sources for the host")
    out = tmp_path_factory.mktemp("cuda_emu")
    libs = {}
    for name, sigs in (("flash_attention", fa._SIGNATURES),
                       ("fused_head_ce", fce._SIGNATURES),
                       ("moe_gemm", moe_gemm._SIGNATURES)):
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
# tiles; s45 is no multiple of the 16-row fragments.
@pytest.mark.parametrize("s,d,dtype,masked", [
    (48, 16, torch.float32, False),
    (130, 32, torch.float32, True),
    (130, 16, torch.bfloat16, True),
    (64, 32, torch.bfloat16, False),
    (80, 64, torch.bfloat16, True),
    (130, 128, torch.bfloat16, True),
    (45, 32, torch.bfloat16, True),
    (300, 16, torch.bfloat16, False),
], ids=["s48-d16-f32", "s130-d32-f32-mask", "s130-d16-bf16-mask", "s64-d32-bf16",
        "s80-d64-bf16-mask", "s130-d128-bf16-mask", "s45-d32-bf16-mask", "s300-d16-bf16"])
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
                                  "accumulator_as_a"])
def test_ptx_primitive_matches_plain(prim_lib, prim):
    """Each emulated tk_mma.cuh function against the PTX ISA's layout tables
    (written out here, lane by lane) and against torch.matmul in f32 of the
    same bf16 tiles. Products of bf16 are exact in f32, so only the order of
    16 f32 additions differs: atol 1e-5 at O(1) values, 2^-8 relative where
    the result is rounded to bf16 on the way (accumulator_as_a)."""
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


@pytest.mark.parametrize("n,dim,vocab,v_pad,dtype", [
    (100, 40, 300, 384, torch.float32),
    (70, 32, 250, 270, torch.float32),
    (200, 40, 300, 384, torch.bfloat16),
    (70, 32, 250, 270, torch.bfloat16),
], ids=["f32", "f32-ragged-vocab", "bf16", "bf16-ragged-vocab"])
def test_fused_head_ce_kernels_match_plain_version(emulated, n, dim, vocab, v_pad, dtype):
    h, w, tgt, g = _ce_inputs(n, dim, vocab, v_pad, dtype, seed=n + dim)
    lib = emulated["fused_head_ce"]
    lse, tl = torch.empty(n), torch.empty(n)
    best = torch.empty(n, dtype=torch.int32)
    w_c = w.to(dtype)  # the kernels take W in h's dtype, as the wrapper hands it over
    fce.launch_forward(lib, h, w_c, tgt, lse, tl, best, vocab, True, 0)
    ref_lse, ref_tl, ref_best = fce.head_terms_reference(h, w, tgt, vocab, True)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(tl, ref_tl, atol=2e-5, rtol=1e-5)
    assert torch.equal(best, ref_best)
    assert (best == 3).any() and not (best == 7).any()

    valid = (tgt != -100).float()
    g_lse, g_tgt = g * valid, -g * valid
    dh, dw = torch.empty_like(h), torch.empty(w.shape)
    fce.launch_backward(lib, h, w_c, tgt, lse, g_lse, g_tgt, dh, dw, vocab, 0)
    ref_dh, ref_dw = fce.head_terms_backward_reference(h, w, tgt, lse, g_lse, g_tgt, vocab)
    assert (dw[:, vocab:] == 0).all()
    torch.testing.assert_close(dw, ref_dw, atol=2e-5, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(dh, ref_dh, atol=2e-5, rtol=1e-4)
    else:
        _bf16_close(dh, ref_dh)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_gemm_kernels_match_plain_version(emulated, dtype):
    """The up/down and dh/dx/dWu/dWd kernels on an adversarial layout: a
    segment over two row tiles (130 rows), a 1-row segment, an empty expert,
    a padding tail, D and F that are no multiple of the tiles (40, 160)."""
    sizes, n, d, f = [130, 1, 0, 137], 268, 40, 160
    xs, (wu, bu, wd, bd), offs, g = _moe_inputs(sizes, n, d, f, dtype, seed=3)
    lib = emulated["moe_gemm"]
    m = xs.shape[0]
    h, ys = torch.empty((m, f), dtype=dtype), torch.zeros_like(xs)
    moe_gemm.launch_forward(lib, xs, wu, bu, wd, bd, offs, h, ys, 0)
    ref_y = moe_gemm.grouped_ffn_reference(xs, wu, bu, wd, bd, offs)

    dz1 = torch.empty((m, f), dtype=dtype)
    part = torch.empty((moe_gemm.row_tiles(lib, dtype, m, len(sizes)), f))
    dx = torch.zeros_like(xs)
    dwu, dbu = torch.empty(wu.shape), torch.empty(bu.shape)
    dwd, dbd = torch.empty(wd.shape), torch.empty(bd.shape)
    moe_gemm.launch_backward(lib, xs, g, ys, h, wu, wd, offs, dz1, part, dx, dwu, dbu, dwd, dbd,
                             0)
    refs = moe_gemm.grouped_ffn_backward_reference(xs, g, ref_y, wu, bu, wd, offs, h=h)

    ref_h = torch.relu(torch.cat([xs[s:t].float() @ wu[e].float() + bu[e].float()
                                  for e, s, t in moe_gemm._segments(offs, len(sizes))]))
    for got, ref in ((h, ref_h.to(dtype)), (ys, ref_y)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
        else:
            _bf16_close(got, ref)
    # dx is rounded to bf16 like y; the weight gradients come out in f32.
    # The bias gradients sum f32 terms (dz2 exactly, dz1 unrounded) that
    # differ only in summation order, so they keep the f32 bar in bf16 too:
    # a dbu summed from the rounded dz1 fails it. dW sums products of
    # round(dz1), which may land a bf16 ulp apart where the two f32 dh sums
    # straddle a rounding boundary: 2^-12 of the row's largest |value|.
    torch.testing.assert_close(dbu, refs[2], atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(dbd, refs[4], atol=5e-5, rtol=1e-4)
    if dtype == torch.float32:
        for got, ref in zip((dx, dwu, dwd), (refs[0], refs[1], refs[3])):
            torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    else:
        _bf16_close(dx, refs[0])
        for got, ref in ((dwu, refs[1]), (dwd, refs[3])):
            top = ref.abs().amax(-1, keepdim=True)
            assert ((got - ref).abs() <= 2.0**-12 * top + 1e-5 * ref.abs()).all()
    empty = sizes.index(0)
    assert all((t[empty] == 0).all() for t in (dwu, dbu, dwd, dbd))
    assert (dx[n:] == 0).all()
    assert dwu.abs().max() > 0 and dbu.abs().max() > 0
