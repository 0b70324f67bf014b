"""Fused LM head + cross-entropy: the CUDA kernels and their plain PyTorch
version (twin of `tpukit/ops/fused_head_ce.py:396` `fused_head_ce`,
kernels `_fused_fwd_arrays` :194 and `_fused_bwd_arrays` :235).

`fused_head_ce(h, w, targets, vocab_size, with_accuracy)` returns
`(loss_sum, count, correct)` of the head `h [N, dim] @ w [dim, V_pad]` and
the masked cross-entropy (targets -100 are ignored; pad columns
>= vocab_size are -1e9), without the `[N, V_pad]` logits on the kernel
path. Its per-row terms (lse, target logit, first-index argmax) come from
a `torch.autograd.Function`:

  - on a CPU tensor both directions run the plain version
    (`head_terms_reference`, `head_terms_backward_reference`), which
    materialises the logits;
  - on a CUDA tensor the forward launches `csrc/fused_head_ce.cu`'s forward
    kernel and the backward its dW and dH kernels, or raises.

W is rounded to h's dtype before the product, as tpukit's
`_prep` does (the wrapper hands the kernels that rounded copy); the
backward's d = softmax * g_lse + onehot * g_tgt is rounded to h's dtype
before both products; dW comes back in f32 and dH in h's dtype, summed over
the whole vocab in f32 and rounded once. In bf16 the kernels multiply on
the tensor cores, in f32 on the CUDA cores in true f32.

`launches` counts kernel launches per kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch

from tpukit_torch.ops import _cuda
from tpukit_torch.ops.layers import IGNORE_INDEX

NEG_INF = -1e9  # pad columns, as apply_head clamps them
_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # kind, h, w, targets, lse, tgt, best, N, dim, Vp, vocab, with_argmax, stream
    "tk_ce_fwd": (_I, [_I] + [_P] * 6 + [_I] * 5 + [_P]),
    # kind, h, w, targets, lse, g_lse, g_tgt, out, N, dim, Vp, vocab, stream
    "tk_ce_bwd_dw": (_I, [_I] + [_P] * 7 + [_I] * 4 + [_P]),
    "tk_ce_bwd_dh": (_I, [_I] + [_P] * 7 + [_I] * 4 + [_P]),
    "tk_ce_error_string": (ctypes.c_char_p, [_I]),
}

# kernel launches since import (or since a caller reset them)
launches = {"forward": 0, "backward_dw": 0, "backward_dh": 0}


def _logits(h, w, vocab_size: int):
    """f32 logits of h against W rounded to h's dtype; pad columns -1e9."""
    logits = torch.matmul(h.float(), w.to(h.dtype).float())
    if w.shape[1] != vocab_size:
        col = torch.arange(w.shape[1], device=h.device)
        logits = logits.masked_fill(col >= vocab_size, NEG_INF)
    return logits


def head_terms_reference(h, w, targets, vocab_size: int, with_argmax: bool):
    """The plain forward: per row `(lse f32, target logit f32, argmax
    int32)`; the argmax is the first index of the maximum, 0 without
    `with_argmax`; an ignored row's target logit is 0."""
    logits = _logits(h, w, vocab_size)
    lse = torch.logsumexp(logits, -1)
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    tgt = torch.where(valid, logits.gather(1, safe[:, None])[:, 0], 0.0)
    best = (logits.argmax(-1) if with_argmax else torch.zeros_like(targets)).to(torch.int32)
    return lse, tgt, best


def head_terms_backward_reference(h, w, targets, lse, g_lse, g_tgt, vocab_size: int):
    """The plain backward: `(dh in h's dtype, dw f32)` from the cotangents
    of lse and the target logit."""
    p = torch.exp(_logits(h, w, vocab_size) - lse[:, None])
    d = p * g_lse[:, None]
    rows = torch.arange(h.shape[0], device=h.device)
    valid = targets != IGNORE_INDEX
    d[rows[valid], targets[valid].long()] += g_tgt[valid]
    d = d.to(h.dtype).float()
    dh = torch.matmul(d, w.to(h.dtype).float().t())
    dw = torch.matmul(h.float().t(), d)
    return dh.to(h.dtype), dw


def _check(h, w, targets, vocab_size):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"fused_head_ce takes h [N, dim] and w [dim, V_pad], got "
                         f"{list(h.shape)} and {list(w.shape)}")
    if targets.shape != (h.shape[0],):
        raise ValueError(f"fused_head_ce: targets must be [{h.shape[0]}], got "
                         f"{list(targets.shape)}")
    if not 0 < vocab_size <= w.shape[1]:
        raise ValueError(f"fused_head_ce: vocab_size {vocab_size} outside (0, "
                         f"{w.shape[1]}]")
    if h.dtype not in _KIND:
        raise TypeError(f"fused_head_ce runs h in f32 or bf16, got {h.dtype}")
    for name, t in (("w", w), ("targets", targets)):
        if t.device != h.device:
            raise ValueError(f"fused_head_ce: {name} is on {t.device}, h on {h.device}")


def _check_cuda(h, w, targets):
    if targets.dtype != torch.int32:
        raise TypeError(f"fused_head_ce kernels take int32 targets, got {targets.dtype}")
    for name, t in (("h", h), ("w", w), ("targets", targets)):
        if not t.is_contiguous():
            raise ValueError(f"fused_head_ce kernels take a contiguous {name}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(code: int, lib, what: str) -> None:
    if code == 0:
        return
    if code == -1:
        msg = "no instance for this dtype"
    elif code == -2:
        msg = "shared memory over the 227 KB a block may use (dim too large)"
    else:
        msg = lib.tk_ce_error_string(code).decode()
    raise RuntimeError(f"fused_head_ce {what} kernel launch failed: {msg} ({code})")


def launch_forward(lib, h, w, targets, lse, tgt, best, vocab_size: int, with_argmax: bool,
                   stream: int) -> None:
    """The forward kernel; `w` is the head kernel in h's dtype."""
    n, dim = h.shape
    code = lib.tk_ce_fwd(_KIND[h.dtype], _ptr(h), _ptr(w), _ptr(targets), _ptr(lse),
                         _ptr(tgt), _ptr(best), n, dim, w.shape[1], vocab_size,
                         int(with_argmax), ctypes.c_void_p(stream))
    _raise_on(code, lib, "forward")


def launch_backward(lib, h, w, targets, lse, g_lse, g_tgt, dh, dw, vocab_size: int,
                    stream: int) -> None:
    """The dW kernel, then the dH kernel; `w` is the head kernel in h's
    dtype, `dw` f32."""
    n, dim = h.shape
    args = (_ptr(h), _ptr(w), _ptr(targets), _ptr(lse), _ptr(g_lse), _ptr(g_tgt))
    code = lib.tk_ce_bwd_dw(_KIND[h.dtype], *args, _ptr(dw), n, dim, w.shape[1], vocab_size,
                            ctypes.c_void_p(stream))
    _raise_on(code, lib, "dW")
    code = lib.tk_ce_bwd_dh(_KIND[h.dtype], *args, _ptr(dh), n, dim, w.shape[1], vocab_size,
                            ctypes.c_void_p(stream))
    _raise_on(code, lib, "dH")


def _forward_cuda(h, w, targets, vocab_size, with_argmax):
    _check_cuda(h, w, targets)
    n = h.shape[0]
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    tgt = torch.empty_like(lse)
    best = torch.empty((n,), dtype=torch.int32, device=h.device)
    lib = _cuda.load("fused_head_ce", _SIGNATURES)
    with torch.cuda.device(h.device):
        launch_forward(lib, h, w.to(h.dtype).contiguous(), targets, lse, tgt, best, vocab_size,
                       with_argmax, torch.cuda.current_stream().cuda_stream)
    launches["forward"] += 1
    return lse, tgt, best


def _backward_cuda(h, w, targets, lse, g_lse, g_tgt, vocab_size):
    _check_cuda(h, w, targets)
    dh = torch.empty_like(h)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    lib = _cuda.load("fused_head_ce", _SIGNATURES)
    with torch.cuda.device(h.device):
        launch_backward(lib, h, w.to(h.dtype).contiguous(), targets, lse,
                        g_lse.float().contiguous(),
                        g_tgt.float().contiguous(), dh, dw, vocab_size,
                        torch.cuda.current_stream().cuda_stream)
    launches["backward_dw"] += 1
    launches["backward_dh"] += 1
    return dh, dw


def _route(h) -> bool:
    """True for the plain version: a CPU tensor."""
    if h.device.type == "cpu":
        return True
    if h.device.type != "cuda":
        raise ValueError(f"fused_head_ce runs on cpu or cuda, got {h.device}")
    return False


class _HeadTerms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, targets, vocab_size, with_argmax):
        if _route(h):
            lse, tgt, best = head_terms_reference(h, w, targets, vocab_size, with_argmax)
        else:
            lse, tgt, best = _forward_cuda(h, w, targets, vocab_size, with_argmax)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.vocab_size = vocab_size
        ctx.mark_non_differentiable(best)
        return lse, tgt, best

    @staticmethod
    def backward(ctx, g_lse, g_tgt, _g_best):
        h, w, targets, lse = ctx.saved_tensors
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
        g_tgt = torch.zeros_like(lse) if g_tgt is None else g_tgt
        if _route(h):
            dh, dw = head_terms_backward_reference(h, w, targets, lse, g_lse, g_tgt,
                                                   ctx.vocab_size)
        else:
            dh, dw = _backward_cuda(h, w, targets, lse, g_lse, g_tgt, ctx.vocab_size)
        return dh, dw.to(w.dtype), None, None, None


def fused_head_ce(h, w, targets, vocab_size: int, with_accuracy: bool = False):
    """(loss_sum, count, correct) of the LM head + masked CE over hidden
    states `h [N, dim]` and the vocab-padded head kernel `w [dim, V_pad]`,
    targets `[N]` int32 (IGNORE_INDEX rows skipped). `correct` is 0 unless
    `with_accuracy`. CUDA tensors go through the kernels, CPU tensors
    through the plain version."""
    _check(h, w, targets, vocab_size)
    lse, tgt, best = _HeadTerms.apply(h, w, targets, int(vocab_size), bool(with_accuracy))
    valid = targets != IGNORE_INDEX
    loss_sum = torch.where(valid, lse - tgt, 0.0).sum()
    count = valid.sum().float()
    if with_accuracy:
        correct = (valid & (best == targets)).sum().float()
    else:
        correct = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss_sum, count, correct

