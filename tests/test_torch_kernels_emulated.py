"""The port's CUDA kernel sources, built for the CPU with g++ against a host
emulation of the CUDA runtime (`tpukit_torch/csrc/host_emu/`: one
std::thread per CUDA thread, barriers for __syncthreads and the warp
shuffles), and held against their plain PyTorch versions at small ragged
shapes.

This checks each kernel's arithmetic, indexing, masking and
synchronisation on every CPU run, the tensor-core (WMMA) instances through
`host_emu/mma.h`; `chip_smoke.py` holds the same sources, built by nvcc,
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
        proc = subprocess.run(
            ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
             "-I", str(EMU), "-o", str(so), str(cpp)],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in sigs.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


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


@pytest.mark.parametrize("s,d,dtype,masked", [
    (48, 16, torch.float32, False),
    (130, 32, torch.float32, True),
    (130, 16, torch.bfloat16, True),
    (64, 32, torch.bfloat16, False),
    (80, 64, torch.bfloat16, True),
], ids=["s48-d16-f32", "s130-d32-f32-mask", "s130-d16-bf16-mask", "s64-d32-bf16",
        "s80-d64-bf16-mask"])
def test_flash_kernels_match_plain_version(emulated, s, d, dtype, masked):
    b, h = 2, 2
    scale = d**-0.5
    q, k, v, do, mask = _flash_inputs(b, h, s, d, dtype, masked, seed=s + d)
    bias = fa.pad_bias(mask, b, s, q.device)
    lib = emulated["flash_attention"]
    q_s = fa.prescale(q, scale)
    out, lse = torch.empty_like(q), torch.empty((b, h, s), dtype=torch.float32)
    fa.launch_forward(lib, q_s, k, v, bias, out, lse, 0)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, bias, scale)

    dcap = (do.float() * out.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fa.launch_backward(lib, q_s, k, v, bias, do, lse, dcap, dq, dk, dv, scale, 0)
    ref_grads = fa.flash_backward_reference(q, k, v, bias, out, lse, do, scale)

    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=1e-4)
        for got, ref in zip((dq, dk, dv), ref_grads):
            torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    else:
        _bf16_close(out, ref_out)
        for got, ref in zip((dq, dk, dv), ref_grads):
            _bf16_close(got, ref)


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
