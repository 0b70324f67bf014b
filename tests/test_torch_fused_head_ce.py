"""The port's fused LM head + cross-entropy against tpukit's on the same
inputs: loss_sum, count, correct, dH and dW.

On the CPU the port's `fused_head_ce` runs its plain version (the CUDA
kernels are held to it by tests/test_torch_kernels_emulated.py and by
chip_smoke.py); tpukit's runs its Pallas kernels in interpret mode, as
tests/test_fused_head_ce.py runs them. Cases: IGNORE rows, a vocab with
pad columns (300 -> 384), a multi-tile vocab (tpukit's `_V_BLK` pinned to
128: three tiles, targets in tiles >= 1) and a first-index argmax tie.

Bars are tests/test_fused_head_ce.py's (:41,45,61): loss rtol 1e-5, grads
atol 2e-6 at f32; count and correct exactly. bf16: the loss within rtol 1e-5
as well (both sides take exact f32 products of the same bf16 values and
differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukit.ops.fused_head_ce as tk_fce
from tpukit_torch.ops.fused_head_ce import fused_head_ce
from tpukit_torch.ops.layers import cross_entropy_sum, masked_correct
from tpukit.ops import layers as tk_layers
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DIM, VOCAB = 32, 300
V_PAD = -(-VOCAB // 128) * 128


def _inputs(n, seed, low=0, tie=False):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, DIM).astype(np.float32)
    w = (rng.randn(DIM, V_PAD) * 0.1).astype(np.float32)
    tgt = rng.randint(low, VOCAB, n).astype(np.int32)
    tgt[::7] = -100
    if tie:
        # columns 5 and 9 equal and dominant: every row's argmax is the tie,
        # which must resolve to 5; half the targets point at 5
        w[:, 5] = w[:, 9] = 0.0
        h[:, 0] = 1.0 + np.abs(h[:, 0])
        w[0, 5] = w[0, 9] = 50.0
        tgt[1::2] = 5
    return h, w, tgt


def _tpukit(h, w, tgt):
    def loss(h, w):
        s, c, _ = tk_fce.fused_head_ce(h, w, jnp.asarray(tgt), VOCAB)
        return s / jnp.maximum(c, 1.0)

    s, c, correct = tk_fce.fused_head_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt),
                                         VOCAB, with_accuracy=True)
    gh, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    return float(s), float(c), float(correct), np.asarray(gh), np.asarray(gw)


def _port(h, w, tgt):
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    t = torch.from_numpy(tgt)
    s, c, correct = fused_head_ce(ht, wt, t, VOCAB, with_accuracy=True)
    gh, gw = torch.autograd.grad(s / torch.clamp(c, min=1.0), (ht, wt))
    return float(s.detach()), float(c), float(correct), gh.numpy(), gw.numpy()


def _check(ours, ref):
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    assert ours[1] == ref[1] and ours[2] == ref[2]
    np.testing.assert_allclose(ours[3], ref[3], atol=2e-6)
    np.testing.assert_allclose(ours[4], ref[4], atol=2e-6)
    assert (ours[4][:, VOCAB:] == 0).all()  # pad columns get no gradient


@pytest.mark.parametrize("n", [200, 37], ids=["wrapper", "ragged_rows"])
def test_matches_tpukit_with_ignore_rows_and_pad_columns(n):
    """200 rows, and 37: fewer than one of tpukit's token tiles and a
    count that no tile size divides."""
    h, w, tgt = _inputs(n, seed=n)
    _check(_port(h, w, tgt), _tpukit(h, w, tgt))


def test_multi_tile_vocab_matches_tpukit(monkeypatch):
    monkeypatch.setattr(tk_fce, "_V_BLK", 128)  # 300-vocab -> 3 tiles
    h, w, tgt = _inputs(64, seed=3, low=130)  # targets in tiles >= 1
    _check(_port(h, w, tgt), _tpukit(h, w, tgt))


def test_argmax_tie_takes_the_first_index(monkeypatch):
    monkeypatch.setattr(tk_fce, "_V_BLK", 128)
    h, w, tgt = _inputs(48, seed=5, tie=True)
    ours, ref = _port(h, w, tgt), _tpukit(h, w, tgt)
    _check(ours, ref)
    valid = tgt != -100
    assert ours[2] == float((tgt[valid] == 5).sum()) > 0


def test_bf16_loss_matches_tpukit():
    h, w, tgt = _inputs(200, seed=2)
    s_ref, c_ref, _ = tk_fce.fused_head_ce(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w),
                                           jnp.asarray(tgt), VOCAB)
    s, c, _ = fused_head_ce(torch.from_numpy(h).bfloat16(), torch.from_numpy(w),
                            torch.from_numpy(tgt), VOCAB)
    np.testing.assert_allclose(float(s), float(s_ref), rtol=1e-5)
    assert float(c) == float(c_ref)


def test_unfused_loss_and_accuracy_match_tpukit():
    """The full-logits path (`TPUKIT_FUSED_HEAD=0`): cross_entropy_sum with
    its hand-written backward, and masked_correct (held as tpukit's
    masked_accuracy: the count over the valid positions x 100)."""
    rng = np.random.RandomState(9)
    logits = rng.randn(4, 10, VOCAB).astype(np.float32)
    logits[0, 0, 3] = logits[0, 0, 8] = 9.0  # a tie: the first index wins
    tgt = rng.randint(0, VOCAB, (4, 10)).astype(np.int32)
    tgt[:, ::3] = -100
    tgt[0, 0] = 3
    jl, jt = jnp.asarray(logits), jnp.asarray(tgt)
    s_ref, c_ref = tk_layers.cross_entropy_sum(jl, jt)
    g_ref = jax.grad(lambda x: tk_layers.cross_entropy_sum(x, jt)[0])(jl)
    acc_ref = tk_layers.masked_accuracy(jl, jt)

    tl = torch.from_numpy(logits).requires_grad_()
    tt = torch.from_numpy(tgt)
    s, c = cross_entropy_sum(tl, tt)
    (g,) = torch.autograd.grad(s, (tl,))
    np.testing.assert_allclose(float(s.detach()), float(s_ref), rtol=1e-6)
    assert float(c) == float(c_ref)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-8, rtol=1e-5)
    acc = masked_correct(tl.detach(), tt) / c * 100.0
    np.testing.assert_allclose(float(acc), float(acc_ref), rtol=1e-6)
