"""The port's threefry (`tpukit_torch.random`) against `jax.random`, on the
CPU, under the partitionable layout tests/conftest.py sets.

Bars: integer bits, keys, uniforms and Bernoulli masks bit-equal (exact
arithmetic on both sides); Gumbel noise within 1e-6 absolute (`torch.log`
and XLA's `log` may round an ulp apart); categorical draws equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.ops.layers import dropout as tk_dropout
from tpukit_torch import random as tr
from tpukit_torch.ops.layers import dropout
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SHAPES = [(1,), (7,), (3, 5), (2, 3, 5), (4, 50304)]
SEEDS = [0, 1234, 2**31 - 1]


def _key(seed):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed)


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
], ids=["zeros", "pi"])
def test_threefry_known_answers(key, ctr, want):
    """Random123's threefry2x32-20 known answers."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = tr.threefry2x32(t(key[0]), t(key[1]), t(ctr[0]), t(ctr[1]))
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for data in (0, 7, 2**31 + 5):
        np.testing.assert_array_equal(tr.fold_in(tk, data).numpy(),
                                      np.asarray(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(tr.split(tk, 5).numpy(), np.asarray(jax.random.split(jk, 5)))
    np.testing.assert_array_equal(tr.split(tk).numpy(), np.asarray(jax.random.split(jk)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_gumbel_match_jax(shape):
    jk, tk = _key(1234)
    bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tr.random_bits(tk, shape).numpy(), bits)
    np.testing.assert_array_equal(tr.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    # the range gumbel draws from (tpukit samples only [0, 1) and this one;
    # over a wider range XLA:CPU may contract the scale and shift into one
    # fused multiply-add)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(tr.uniform(tk, shape, tiny, 1.0).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape, minval=tiny,
                                                                maxval=1.0)))
    np.testing.assert_array_equal(tr.bernoulli(tk, 0.9, shape).numpy(),
                                  np.asarray(jax.random.bernoulli(jk, 0.9, shape)))
    np.testing.assert_allclose(tr.gumbel(tk, shape).numpy(),
                               np.asarray(jax.random.gumbel(jk, shape)), atol=1e-6, rtol=0)


def test_per_row_keys_match_vmap():
    """A `[N, 2]` key draws each row's own stream, as `jax.vmap` does; the
    scalar uniform (shape ()) of a batch of keys too."""
    jk, _ = _key(5)
    keys = jax.random.split(jk, 6)
    tk = tr.as_key(np.asarray(keys))
    want = jax.vmap(lambda k: jax.random.bits(k, (4, 11), jnp.uint32))(keys)
    np.testing.assert_array_equal(tr.random_bits(tk, (4, 11)).numpy(),
                                  np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(tr.uniform(tk).numpy(),
                                  np.asarray(jax.vmap(jax.random.uniform)(keys)))
    cur = np.arange(6, dtype=np.int32) * 3 + 1
    np.testing.assert_array_equal(
        tr.fold_in(tk, torch.from_numpy(cur)).numpy(),
        np.asarray(jax.vmap(jax.random.fold_in)(keys, cur)))


@pytest.mark.parametrize("vocab", [97, 50304])
def test_categorical_matches_jax(vocab):
    """Per-row keys over `[16, V]` logits: the same tokens as
    `vmap(categorical)`, including rows with -inf (top-k masked) columns."""
    rng = np.random.RandomState(vocab)
    logits = rng.randn(16, vocab).astype(np.float32) * 2
    logits[::3, vocab // 2:] = -np.inf
    keys = jax.random.split(jax.random.PRNGKey(9), 16)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = tr.categorical(tr.as_key(np.asarray(keys)), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_offset_draws_rows_of_a_larger_array():
    """`offset` gives rows [r0, r0 + n) of a larger draw bit for bit: what
    a data-parallel rank's dropout mask takes of the global batch's."""
    tk = tr.PRNGKey(3)
    whole = tr.bernoulli(tk, 0.9, (8, 5, 6))
    for r0 in (0, 3, 6):
        part = tr.bernoulli(tk, 0.9, (2, 5, 6), offset=r0 * 30)
        assert torch.equal(part, whole[r0:r0 + 2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dropout_matches_tpukit(dtype):
    """`ops.layers.dropout` against tpukit's: the kept elements, the zeros
    and the `x / keep` scaling (in x's dtype) bit-equal."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.RandomState(2).randn(3, 17, 32).astype(np.float32)
    jk, tk = _key(77)
    want = tk_dropout(jnp.asarray(x, jdt), 0.1, jk, deterministic=False)
    got = dropout(torch.from_numpy(x).to(tdt), 0.1, tk)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert dropout(torch.from_numpy(x), 0.1, None) is not None
    assert torch.equal(dropout(torch.from_numpy(x), 0.0, tk), torch.from_numpy(x))
