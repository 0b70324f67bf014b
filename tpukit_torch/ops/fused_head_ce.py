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
  - on a CUDA tensor the forward and the backward launch
    `csrc/fused_head_ce.cu`'s kernels, or raise.

W is rounded to h's dtype before the product, as tpukit's `_prep` does (the
wrapper hands the kernels that rounded copy); the backward's d = softmax *
g_lse + onehot * g_tgt is rounded to h's dtype before both products; dW
comes back in f32 and dH in h's dtype, summed over the whole vocab in f32
and rounded once.

bf16 runs the wgmma/TMA kernels: the forward's head product with the
vocab split across the card where the row tiles do not fill it, and a
combine kernel; the backward per chunk of token rows (at most 1 GiB of d
workspace): d formed once (`backward_d`), d W^T in vocab splits
(`backward_dh`) and their ordered sum (`backward_dh_combine`), and
h^T d (`backward_dw`). TMA wants 16-byte row strides: W's columns are
padded with zeros to a multiple of 8 (the pad columns are masked by vocab
as the model's own pad columns are), and a dim that is no multiple of 8
runs on h with zero columns and W with zero rows added up to one (exact:
they add 0 to every logit), the pad cut off dH and dW. f32 runs the
CUDA-core kernels (`*_f32`).

`launches` counts kernel launches per kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch

from tpukit_torch.ops import _cuda
from tpukit_torch.ops.layers import IGNORE_INDEX

NEG_INF = -1e9  # pad columns, as apply_head clamps them
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # h, w, targets, lse, tgt, best, N, dim, Vp, vocab, with_argmax, stream
    "tk_ce_fwd_f32": (_I, [_P] * 6 + [_I] * 5 + [_P]),
    # h, w, targets, lse, g_lse, g_tgt, out, N, dim, Vp, vocab, stream
    "tk_ce_bwd_dw_f32": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    "tk_ce_bwd_dh_f32": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    # N, Vp
    "tk_ce_fwd_splits": (_I, [_I, _I]),
    # N, dim, ldw, rows per chunk (0: the 1 GiB rule), out[3]
    "tk_ce_bwd_plan": (_I, [_I] * 4 + [_P]),
    # h, w, ldw, targets, part, part_idx, lse, tgt, best, N, dim, Vp, vocab,
    # with_argmax, stream
    "tk_ce_fwd_bf16": (_I, [_P, _P, _I] + [_P] * 6 + [_I] * 5 + [_P]),
    # h, w, ldw, targets, lse, g_lse, g_tgt, ws, part, dh, dw, N, dim, Vp,
    # vocab, rows per chunk, stream
    "tk_ce_bwd_bf16": (_I, [_P, _P, _I] + [_P] * 8 + [_I] * 5 + [_P]),
    "tk_ce_error_string": (ctypes.c_char_p, [_I]),
}

# kernel launches since import (or since a caller reset them)
launches = {"forward": 0, "forward_combine": 0, "backward_d": 0, "backward_dh": 0,
            "backward_dh_combine": 0, "backward_dw": 0, "forward_f32": 0,
            "backward_dw_f32": 0, "backward_dh_f32": 0}


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
    of lse and the target logit. The exponential is taken in f64 and
    rounded to f32, the correctly rounded value: torch's f32 `exp` differs
    by the CPU's vector ISA (AVX512 lands half an ulp off at some
    arguments), and a `d` near a bf16 rounding boundary then rounds to the
    other side of the kernel's."""
    p = torch.exp((_logits(h, w, vocab_size) - lse[:, None]).double()).float()
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
    if h.dtype not in (torch.float32, torch.bfloat16):
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
    msg = {-2: "shared memory over the 227 KB a block may use (dim too large)",
           -3: "the driver has no cuTensorMapEncodeTiled",
           -4: "a TMA tensor map could not be made",
           -5: "dim and the padded vocab must be multiples of 8"}.get(code)
    if msg is None:
        msg = lib.tk_ce_error_string(code).decode()
    raise RuntimeError(f"fused_head_ce {what} kernel launch failed: {msg} ({code})")


def kernel_weight(w, dtype):
    """The kernels' W: rounded to `dtype`; in bf16 its columns zero-padded
    to a multiple of 8 (no copy when they are already)."""
    w = w.to(dtype).contiguous()
    pad = -w.shape[1] % 8
    if dtype == torch.bfloat16 and pad:
        w = torch.nn.functional.pad(w, (0, pad))
    return w


def _dim_padded(h, wk):
    """bf16: h with zero columns and the kernels' W with zero rows up to a
    dim that is a multiple of 8 (no copy when it is one)."""
    pad = -h.shape[1] % 8
    if not pad:
        return h, wk
    return (torch.nn.functional.pad(h, (0, pad)),
            torch.nn.functional.pad(wk, (0, 0, 0, pad)))


def launch_forward(lib, h, w, targets, lse, tgt, best, vocab_size: int, with_argmax: bool,
                   stream: int) -> None:
    """The forward kernels; `w [dim, V_pad]` in h's dtype."""
    n, dim = h.shape
    v_pad = w.shape[1]
    s = ctypes.c_void_p(stream)
    if h.dtype == torch.float32:
        code = lib.tk_ce_fwd_f32(_ptr(h), _ptr(w), _ptr(targets), _ptr(lse), _ptr(tgt),
                                 _ptr(best), n, dim, v_pad, vocab_size, int(with_argmax), s)
        _raise_on(code, lib, "forward")
        return
    h, wk = _dim_padded(h, kernel_weight(w, h.dtype))
    dim = h.shape[1]
    splits = lib.tk_ce_fwd_splits(n, v_pad)
    part = torch.empty((4, splits, n), dtype=torch.float32, device=h.device)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=h.device)
    code = lib.tk_ce_fwd_bf16(_ptr(h), _ptr(wk), wk.shape[1], _ptr(targets), _ptr(part),
                              _ptr(part_idx), _ptr(lse), _ptr(tgt), _ptr(best), n, dim, v_pad,
                              vocab_size, int(with_argmax), s)
    _raise_on(code, lib, "forward")


def backward_plan(lib, n: int, dim: int, ldw: int, chunk_rows: int = 0) -> tuple[int, int, int]:
    """(rows per chunk, chunks, f32 elements of the dH partials) of the bf16
    backward."""
    out = (ctypes.c_int * 3)()
    lib.tk_ce_bwd_plan(n, dim, ldw, chunk_rows, out)
    return out[0], out[1], out[2]


def launch_backward(lib, h, w, targets, lse, g_lse, g_tgt, dh, dw, vocab_size: int,
                    stream: int, chunk_rows: int = 0) -> int:
    """The backward kernels; `w [dim, V_pad]` in h's dtype, `dw` f32 of
    w's shape. bf16: `chunk_rows` token rows per chunk, 0 for the 1 GiB
    workspace rule. Returns the number of chunks (1 for f32)."""
    n, dim = h.shape
    v_pad = w.shape[1]
    s = ctypes.c_void_p(stream)
    if h.dtype == torch.float32:
        args = (_ptr(h), _ptr(w), _ptr(targets), _ptr(lse), _ptr(g_lse), _ptr(g_tgt))
        _raise_on(lib.tk_ce_bwd_dw_f32(*args, _ptr(dw), n, dim, v_pad, vocab_size, s), lib, "dW")
        _raise_on(lib.tk_ce_bwd_dh_f32(*args, _ptr(dh), n, dim, v_pad, vocab_size, s), lib, "dH")
        return 1
    h, wk = _dim_padded(h, kernel_weight(w, h.dtype))
    out_dh, out_dw = dh, dw
    if h.shape[1] != dim:  # the kernels write the padded dH and dW; the pad is cut off below
        dim = h.shape[1]
        dh, dw = torch.empty_like(h), torch.empty((dim, v_pad), dtype=dw.dtype, device=dw.device)
    rows, chunks, part_elems = backward_plan(lib, n, dim, wk.shape[1], chunk_rows)
    ws = torch.empty((rows, wk.shape[1]), dtype=h.dtype, device=h.device)
    part = torch.empty((part_elems,), dtype=torch.float32, device=h.device)
    code = lib.tk_ce_bwd_bf16(_ptr(h), _ptr(wk), wk.shape[1], _ptr(targets), _ptr(lse),
                              _ptr(g_lse), _ptr(g_tgt), _ptr(ws), _ptr(part), _ptr(dh), _ptr(dw),
                              n, dim, v_pad, vocab_size, rows, s)
    _raise_on(code, lib, "backward")
    if dh is not out_dh:
        out_dh.copy_(dh[:, :out_dh.shape[1]])
        out_dw.copy_(dw[:out_dw.shape[0]])
    return chunks


def _forward_cuda(h, w, targets, vocab_size, with_argmax):
    _check_cuda(h, w, targets)
    n = h.shape[0]
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    tgt = torch.empty_like(lse)
    best = torch.empty((n,), dtype=torch.int32, device=h.device)
    lib = _cuda.load("fused_head_ce", _SIGNATURES)
    with torch.cuda.device(h.device):
        launch_forward(lib, h, w.to(h.dtype), targets, lse, tgt, best, vocab_size, with_argmax,
                       torch.cuda.current_stream().cuda_stream)
    if h.dtype == torch.float32:
        launches["forward_f32"] += 1
    else:
        launches["forward"] += 1
        launches["forward_combine"] += 1
    return lse, tgt, best


def _backward_cuda(h, w, targets, lse, g_lse, g_tgt, vocab_size):
    _check_cuda(h, w, targets)
    dh = torch.empty_like(h)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    lib = _cuda.load("fused_head_ce", _SIGNATURES)
    with torch.cuda.device(h.device):
        chunks = launch_backward(lib, h, w.to(h.dtype), targets, lse, g_lse.float().contiguous(),
                                 g_tgt.float().contiguous(), dh, dw, vocab_size,
                                 torch.cuda.current_stream().cuda_stream)
    if h.dtype == torch.float32:
        launches["backward_dw_f32"] += 1
        launches["backward_dh_f32"] += 1
    else:
        for kernel in ("backward_d", "backward_dh", "backward_dh_combine", "backward_dw"):
            launches[kernel] += chunks
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

