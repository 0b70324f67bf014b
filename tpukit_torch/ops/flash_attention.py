"""Causal flash attention: the CUDA kernels and their plain PyTorch version
(twin of `tpukit/ops/pallas_attention.py:753` `flash_causal_attention`,
kernels `_flash_forward` :215, `_flash_backward` :504 and
`_flash_backward_split` :437).

`flash_causal_attention(q, k, v, *, scale, pad_mask)` takes `[B, H, S, D]`
tensors and a `[B, S]` bool pad mask (True = padding) and returns the
causal attention output in v's dtype. It is a `torch.autograd.Function`:

  - on a CPU tensor both directions run the plain version
    (`flash_forward_reference`, `flash_backward_reference`);
  - on a CUDA tensor the forward launches `csrc/flash_attention.cu`'s
    forward kernel and the backward its D = rowsum(dO * O), dK/dV and dQ
    kernels (built with nvcc for sm_90a on first use; bf16 on the tensor
    cores, f32 on CUDA cores), or raises. There is no path from a CUDA
    tensor to the plain version. The wrappers allocate the outputs and the
    D buffer and run no PyTorch op on q, dO or O: the kernels take q
    unscaled with the scale and compute D themselves. A head dim without
    an instance (HEAD_DIMS) runs the next larger one on q, k, v (and dO,
    O) zero-padded to it, which adds 0 to every score and to D; the scale
    stays the caller's and the pad columns of the outputs are cut off.
    Head dims over 128 have no instance (`ops/attention.py`'s "auto" takes
    the xla path there).

Semantics (the kernels' and the plain version's): q is prescaled by
`scale` in its own dtype; scores in f32 plus the f32 pad bias (0 or
finfo(f32).min per key); keys after the query are left out, which for
every row with an unpadded key is tpukit's -1e9 select exactly, and makes
a fully padded row attend uniformly over j <= i as tpukit documents
(pallas_attention.py:11-19); softmax in f32 with the probabilities
rounded to v's dtype before the value product; the backward rebuilds
P = exp(s - lse), reads dO as f32 and rounds dS to q's dtype before the
dK and dQ products.

`launches` counts kernel launches per kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpukit_torch.ops import _cuda

HEAD_DIMS = (16, 32, 64, 128)  # head dims the CUDA library has instances for
_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # kind, D, q, k, v, bias, out, lse, BH, H, S, scale, stream
    "tk_flash_fwd": (_I, [_I, _I] + [_P] * 6 + [_I] * 3 + [ctypes.c_float, _P]),
    # kind, D, dout, out, dcap, rows, stream
    "tk_flash_bwd_dcap": (_I, [_I, _I] + [_P] * 3 + [_I, _P]),
    # kind, D, q, k, v, bias, dout, lse, dcap, dk, dv, BH, H, S, scale, stream
    "tk_flash_bwd_dkv": (_I, [_I, _I] + [_P] * 9 + [_I] * 3 + [ctypes.c_float, _P]),
    # kind, D, q, k, v, bias, dout, lse, dcap, dq, BH, H, S, scale, stream
    "tk_flash_bwd_dq": (_I, [_I, _I] + [_P] * 8 + [_I] * 3 + [ctypes.c_float, _P]),
    "tk_flash_error_string": (ctypes.c_char_p, [_I]),
}

# kernel launches since import (or since a caller reset them)
launches = {"forward": 0, "backward_dcap": 0, "backward_dkv": 0, "backward_dq": 0}


def pad_bias(pad_mask, batch: int, seq: int, device):
    """`[B, S]` bool (True = padding) -> `[B, S]` f32 additive key bias, 0
    or finfo(f32).min (tpukit's `_pad_bias`); None without a mask."""
    if pad_mask is None:
        return None
    if pad_mask.shape != (batch, seq):
        raise ValueError(f"pad_mask must be [{batch}, {seq}], got {list(pad_mask.shape)}")
    low = torch.finfo(torch.float32).min
    return torch.where(pad_mask.to(device=device, dtype=torch.bool),
                       torch.tensor(low, dtype=torch.float32, device=device),
                       torch.tensor(0.0, dtype=torch.float32, device=device)).contiguous()


def prescale(q, scale: float):
    """q * scale in q's dtype: the scale rounds to q's dtype first, as a
    weakly typed Python float does under jnp."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _masked_scores(q_s, k, bias, acc=torch.float32):
    """`[B, H, S, S]` scores in `acc` of the prescaled q against k, pad bias
    added, keys after the query set to -inf (left out)."""
    seq = q_s.shape[2]
    s = torch.matmul(q_s.to(acc), k.to(acc).transpose(-1, -2))
    if bias is not None:
        s = s + bias[:, None, None, :]
    pos = torch.arange(seq, device=q_s.device)
    return s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))


def flash_forward_reference(q, k, v, bias, scale: float):
    """The plain forward: `(out [B, H, S, D] in v's dtype, lse [B, H, S]
    f32)`, with the kernel's rounding points (one softmax over the whole
    row instead of the online update over key tiles)."""
    s = _masked_scores(prescale(q, scale), k, bias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(v.dtype), (m + torch.log(l))[..., 0]


def flash_backward_reference(q, k, v, bias, out, lse, d_out, scale: float,
                             acc=torch.float32):
    """The plain backward: `(dq, dk, dv)` in the inputs' dtypes, with the
    kernels' rounding points. `acc` is the dtype of its sums: f32, the
    kernels' own; a check may pass f64 for sums without rounding (the same
    rounding points to the inputs' dtype), against which a kernel's f32
    sums differ by their own error only: where dP - D cancels exactly (a
    query that sees one key) f32 sums taken in two orders leave two
    different residues, exact sums none."""
    q_s = prescale(q, scale)
    do = d_out.to(acc)
    dcap = (do * out.to(acc)).sum(-1, keepdim=True)
    p = torch.exp(_masked_scores(q_s, k, bias, acc) - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.to(acc).transpose(-1, -2))
    ds = p * (dp - dcap)
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), q_s.to(acc))
    dq = torch.matmul(ds.to(k.dtype).to(acc), k.to(acc)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash attention: {name} {list(t.shape)} {t.dtype} on "
                             f"{t.device} differs from q {list(q.shape)} {q.dtype} on "
                             f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash attention takes [B, H, S, D], got {list(q.shape)}")
    if q.dtype not in _KIND:
        raise TypeError(f"flash attention runs in f32 or bf16, got {q.dtype}")


def instance_dim(d: int) -> int:
    """The head dim of the kernel instance that runs head dim `d`: the
    smallest of HEAD_DIMS not below it."""
    for dd in HEAD_DIMS:
        if dd >= d:
            return dd
    raise ValueError(f"flash attention kernels take head_dim up to {HEAD_DIMS[-1]}, got {d}")


def _padded(t, dp: int):
    """`t [..., D]` zero-padded to `dp` columns (no copy at D = dp)."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _check_cuda(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("flash attention kernels take contiguous tensors")
        if t is not None and t.data_ptr() % 16:
            raise ValueError("flash attention kernels take 16-byte aligned tensors")
    instance_dim(tensors[0].shape[-1])


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _raise_on(code: int, lib, what: str) -> None:
    if code == 0:
        return
    if code == -1:
        msg = "no instance for this dtype and head dim"
    elif code == -2:
        msg = "shared memory over the 227 KB a block may use"
    else:
        msg = lib.tk_flash_error_string(code).decode()
    raise RuntimeError(f"flash attention {what} kernel launch failed: {msg} ({code})")


def launch_forward(lib, q, k, v, bias, out, lse, scale: float, stream: int) -> None:
    """The forward kernel on unscaled q: writes `out` and `lse` (through
    padded copies where the head dim has no instance)."""
    b, h, s, d = q.shape
    dp = instance_dim(d)
    target = out
    if dp != d:
        q, k, v = (_padded(t, dp) for t in (q, k, v))
        out = torch.empty_like(q)
    code = lib.tk_flash_fwd(_KIND[q.dtype], dp, _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out),
                            _ptr(lse), b * h, h, s, scale, ctypes.c_void_p(stream))
    _raise_on(code, lib, "forward")
    if dp != d:
        target.copy_(out[..., :d])


def launch_backward(lib, q, k, v, bias, d_out, out, lse, dcap, dq, dk, dv, scale: float,
                    stream: int) -> None:
    """The D = rowsum(dO * O) kernel into `dcap` ([B, H, S] f32 scratch),
    then the dK/dV kernel, then the dQ kernel, on unscaled q (through
    padded copies where the head dim has no instance)."""
    b, h, s, d = q.shape
    dp = instance_dim(d)
    targets = (dq, dk, dv)
    if dp != d:
        q, k, v, d_out, out = (_padded(t, dp) for t in (q, k, v, d_out, out))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    kind, st = _KIND[q.dtype], ctypes.c_void_p(stream)
    _raise_on(lib.tk_flash_bwd_dcap(kind, dp, _ptr(d_out), _ptr(out), _ptr(dcap), b * h * s, st),
              lib, "D")
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(d_out), _ptr(lse), _ptr(dcap))
    _raise_on(lib.tk_flash_bwd_dkv(kind, dp, *args, _ptr(dk), _ptr(dv), b * h, h, s, scale, st),
              lib, "dK/dV")
    _raise_on(lib.tk_flash_bwd_dq(kind, dp, *args, _ptr(dq), b * h, h, s, scale, st), lib, "dQ")
    if dp != d:
        for target, grad in zip(targets, (dq, dk, dv)):
            target.copy_(grad[..., :d])


def _forward_cuda(q, k, v, bias, scale):
    _check_cuda(q, k, v, bias)
    b, h, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _cuda.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        launch_forward(lib, q, k, v, bias, out, lse, scale,
                       torch.cuda.current_stream().cuda_stream)
    launches["forward"] += 1
    return out, lse


def _backward_cuda(q, k, v, bias, out, lse, d_out, scale):
    d_out = d_out.contiguous()
    _check_cuda(q, k, v, bias, out, d_out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dcap = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    lib = _cuda.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        launch_backward(lib, q, k, v, bias, d_out, out, lse, dcap, dq, dk, dv, scale,
                        torch.cuda.current_stream().cuda_stream)
    launches["backward_dcap"] += 1
    launches["backward_dkv"] += 1
    launches["backward_dq"] += 1
    return dq, dk, dv


def _route(q) -> bool:
    """True for the plain version: a CPU tensor."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, got {q.device}")
    return False


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        if _route(q):
            out, lse = flash_forward_reference(q, k, v, bias, scale)
        else:
            out, lse = _forward_cuda(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if _route(q):
            grads = flash_backward_reference(q, k, v, bias, out, lse, d_out, ctx.scale)
        else:
            grads = _backward_cuda(q, k, v, bias, out, lse, d_out, ctx.scale)
        return (*grads, None, None)


def flash_causal_attention(q, k, v, *, scale, pad_mask=None):
    """Causal attention of `q, k, v [B, H, S, D]` (f32 or bf16) with an
    optional `[B, S]` bool pad mask (True = padding). Returns `[B, H, S, D]`
    in v's dtype. CUDA tensors go through the kernels, CPU tensors through
    the plain version."""
    _check(q, k, v)
    b, _, s, _ = q.shape
    out, _ = _Flash.apply(q, k, v, pad_bias(pad_mask, b, s, q.device), float(scale))
    return out
