"""The port's causal attention against tpukit's on the same inputs (numpy
from a seed), forward and dq/dk/dv.

On the CPU the port's `flash_causal_attention` runs its plain version (the
CUDA kernels are held to that version by tests/test_torch_kernels_emulated.py
here and by chip_smoke.py on the card); tpukit's runs its Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them. Lengths: one
short block (S = 48), a padded length (S = 130), and a multi-block length
with tpukit's block pinned to 128 (S = 384) under both of its backwards,
the fused one (3 key blocks <= `_DQ_FUSED_MAX_NUM_K`) and the split one.

Bars are tests/test_flash_attention.py's: f32 forward atol 2e-5 / rtol 1e-4
(:38), gradients 5e-4 / 1e-3 (:70), bf16 forward 3e-2 (:201); the
forward is compared on non-padded query rows, and the loss zeroes padded
rows, as tpukit compares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.ops.pallas_attention as tk_pa
from tpukit.ops.attention import causal_attention as tk_causal_attention
from tpukit_torch import NotPortedError
from tpukit_torch.ops.attention import causal_attention
from tpukit_torch.ops.flash_attention import flash_causal_attention

D = 32
SCALE = D**-0.5


def _inputs(b, h, s, masked, seed):
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(b, h, s, D).astype(np.float32) for _ in range(3)]
    mask = np.zeros((b, s), dtype=bool)
    if masked:
        mask[0, s - s // 6:] = True  # trailing padding in row 0
    return qkv, mask


def _jax_grads(fn, qkv, mask):
    m = jnp.asarray(mask)

    def loss(q, k, v):
        out = fn(q, k, v, scale=SCALE, pad_mask=m)
        return jnp.sum(jnp.where(~m[:, None, :, None], out, 0.0) ** 2)

    out = fn(*(jnp.asarray(t) for t in qkv), scale=SCALE, pad_mask=m)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in qkv))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(fn, qkv, mask):
    m = torch.from_numpy(mask)
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in qkv)
    out = fn(q, k, v, scale=SCALE, pad_mask=m)
    loss = torch.where(~m[:, None, :, None], out, 0.0).square().sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _check(ours, ref, mask):
    valid = ~mask
    for b in range(mask.shape[0]):
        np.testing.assert_allclose(ours[0][b][:, valid[b]], ref[0][b][:, valid[b]],
                                   atol=2e-5, rtol=1e-4)
    for got, want, name in zip(ours[1], ref[1], "qkv"):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("s", [48, 130])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_flash_matches_tpukit(s, masked):
    qkv, mask = _inputs(2, 2, s, masked, seed=s)
    ref = _jax_grads(tk_pa.flash_causal_attention, qkv, mask)
    ours = _torch_grads(flash_causal_attention, qkv, mask)
    _check(ours, ref, mask)


@pytest.mark.parametrize("branch", ["fused", "split"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_flash_multiblock_matches_both_tpukit_backwards(monkeypatch, branch, masked):
    monkeypatch.setattr(tk_pa, "_BLOCK", 128)  # 384 tokens span 3 blocks
    monkeypatch.setattr(tk_pa, "_DQ_FUSED_MAX_NUM_K", 3 if branch == "fused" else 1)
    qkv, mask = _inputs(1, 2, 384, masked, seed=7)
    ref = _jax_grads(tk_pa.flash_causal_attention, qkv, mask)
    ours = _torch_grads(flash_causal_attention, qkv, mask)
    _check(ours, ref, mask)


def test_flash_bf16_forward_matches_tpukit():
    qkv, mask = _inputs(2, 2, 48, True, seed=1)
    ref = tk_pa.flash_causal_attention(*(jnp.asarray(t, jnp.bfloat16) for t in qkv),
                                       scale=SCALE, pad_mask=jnp.asarray(mask))
    ours = flash_causal_attention(*(torch.from_numpy(t).bfloat16() for t in qkv),
                                  scale=SCALE, pad_mask=torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    valid = ~mask
    for b in range(2):
        np.testing.assert_allclose(ours.float().numpy()[b][:, valid[b]],
                                   np.asarray(ref, np.float32)[b][:, valid[b]],
                                   atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_xla_path_matches_tpukit(dtype):
    """The eager twin of tpukit's XLA path, every row (its fully padded
    behaviour is tpukit's XLA one too). f32 at the forward bar; bf16 within
    one bf16 rounding (2^-8) of the largest output, since matmul outputs
    round to bf16 on both sides from f32 sums taken in different orders."""
    qkv, mask = _inputs(2, 2, 40, True, seed=3)
    mask[1, :] = True  # a fully padded row
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    ref = tk_causal_attention(*(jnp.asarray(t, jdt) for t in qkv), scale=SCALE,
                              pad_mask=jnp.asarray(mask), impl="xla")
    ours = causal_attention(*(torch.from_numpy(t).to(tdt) for t in qkv), scale=SCALE,
                            pad_mask=torch.from_numpy(mask), impl="xla")
    ref = np.asarray(ref, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(ours.float().numpy(), ref, atol=2**-8 * np.abs(ref).max())


def test_auto_picks_xla_on_the_cpu_and_context_parallel_is_not_ported():
    qkv, mask = _inputs(1, 2, 600, False, seed=4)
    q, k, v = (torch.from_numpy(t) for t in qkv)
    auto = causal_attention(q, k, v, scale=SCALE, impl="auto")
    xla = causal_attention(q, k, v, scale=SCALE, impl="xla")
    assert torch.equal(auto, xla)  # flash is chosen only for CUDA tensors
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotPortedError, match="item 15"):
            causal_attention(q, k, v, scale=SCALE, impl=impl)
