"""The port's layers and block quantizer against tpukit's, on the same
numpy inputs: `linear` and `layer_norm` within atol 1e-6 in f32 (matmul
and reduction order differ between XLA and torch); int8 codes equal
exactly and scales bitwise; dequantized values within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.ops import layers as jax_layers
from tpukit.ops import quant_comm as jax_qc
from tpukit_torch.ops import layers
from tpukit_torch.ops import quant_comm as qc
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _np_params(rng, fan_in, fan_out, bias):
    p = {"kernel": rng.uniform(-0.3, 0.3, (fan_in, fan_out)).astype(np.float32)}
    if bias:
        p["bias"] = rng.uniform(-0.3, 0.3, (fan_out,)).astype(np.float32)
    return p


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_linear_matches_tpukit(bias):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype(np.float32)
    p = _np_params(rng, 32, 48, bias)
    out_j = jax_layers.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.float32)
    out_t = layers.linear(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6, rtol=0)


def test_linear_bf16_casts_like_tpukit():
    """bf16 compute: both operands and the bias are cast before the matmul
    and the add; the result stays bf16 (compared within a bf16 ulp)."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 32).astype(np.float32)
    p = _np_params(rng, 32, 16, True)
    out_j = jax_layers.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.bfloat16)
    out_t = layers.linear(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.bfloat16)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32)),
                               atol=1.6e-2, rtol=0)


def test_layer_norm_matches_tpukit():
    rng = np.random.RandomState(2)
    x = (rng.randn(6, 7, 32) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
         "bias": rng.uniform(-0.5, 0.5, 32).astype(np.float32)}
    out_j = jax_layers.layer_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    out_t = layers.layer_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6, rtol=0)
    # bf16 input still normalizes in f32 and returns f32
    out_b = layers.layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                              {k: torch.from_numpy(v) for k, v in p.items()})
    assert out_b.dtype == torch.float32


@pytest.mark.parametrize("shape,scale", [((5, 512), 1.0), ((3, 4, 256), 0.3),
                                         ((2, 1024), 100.0)],
                         ids=["rows", "lead_axes", "large"])
def test_quantize_blocks_matches_tpukit(shape, scale):
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    x.reshape(-1, 256)[0] = 0.0  # an all-zero block: scale 0, codes 0
    q_j, s_j = jax_qc.quantize_blocks(jnp.asarray(x))
    q_t, s_t = qc.quantize_blocks(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))
    d_j = jax_qc.dequantize_blocks(q_j, s_j)
    d_t = qc.dequantize_blocks(q_t, s_t)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6, rtol=0)


def test_quantize_rounds_half_to_even():
    """A block whose max is 127 has scale 1, so codes are round(x) exactly:
    halves go to the even neighbour, as `jnp.round` takes them."""
    x = np.zeros((1, 256), np.float32)
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    q_j, _ = jax_qc.quantize_blocks(jnp.asarray(x))
    q_t, _ = qc.quantize_blocks(torch.from_numpy(x))
    assert q_t[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
