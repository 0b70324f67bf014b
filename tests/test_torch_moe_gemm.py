"""The port's grouped-expert FFN (`tpukit_torch/ops/moe_gemm.py`) against
tpukit's, on the CPU: the plain version the port's wrapper runs for CPU
tensors against tpukit's Pallas kernel in interpret mode (as
tests/test_moe.py::test_grouped_ffn_kernel_unit runs it), forward and all
five cotangents, on adversarial segment layouts; and `sort_plan`'s
permutation and offsets, exactly.

Tolerances. f32: tpukit's own bars for this kernel (tests/test_moe.py:560,
575): forward atol 1e-5, cotangents atol 2e-4; both sides multiply exactly
and sum in f32 in other orders. bf16: both sides round h, dz1, y and dx to
bf16 at the same points, but where their f32 sums straddle a rounding
boundary a rounded value lands an ulp apart and moves what follows; each
element within 2^-6 (two bf16 ulps at the top of the binade) of the largest
|value| of its row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.model import GPTConfig as TkConfig
from tpukit.ops import moe_gemm as tk_moe_gemm
from tpukit.ops.moe_dispatch import _route_topk as tk_route_topk
from tpukit_torch.model import GPTConfig
from tpukit_torch.ops import moe_gemm

# (segment sizes, real rows n): the padded row count m is plan_rows(n)[1],
# the padding tail folds into the last segment. tpukit's own layout (an
# empty expert, a 3-row segment, a segment crossing the first 128 rows)
# and one with a 1-row segment, an empty one and segments over 128 rows.
LAYOUTS = {
    "tpukit-unit": ([50, 3, 0, 197], 250),
    "one-row-empty-long": ([130, 1, 0, 137], 268),
}


def _layout_inputs(sizes, n, dtype, seed=0):
    e, d, f = len(sizes), 32, 64
    _, m = tk_moe_gemm._plan_rows(n)
    rng = np.random.RandomState(seed)
    arrays = dict(
        xs=rng.randn(m, d), wu=rng.randn(e, d, f) * 0.1, bu=rng.randn(e, f) * 0.1,
        wd=rng.randn(e, f, d) * 0.1, bd=rng.randn(e, d) * 0.1)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    offs[-1] = m
    cot = rng.randn(m, d).astype(np.float32)
    cot[n:] = 0.0  # padding rows never receive a cotangent
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_in = {k: jnp.asarray(v).astype(jdt) for k, v in arrays.items()}
    torch_in = {k: torch.from_numpy(v).to(dtype) for k, v in arrays.items()}
    return jax_in, torch_in, offs, cot, n


def _bf16_close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max(-1, keepdims=True)
    err = np.abs(got - ref)
    assert (err <= 2.0**-6 * scale).all(), (what, float((err / np.maximum(scale, 1e-30)).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grouped_ffn_matches_tpukit_kernel(layout, dtype):
    sizes, n = LAYOUTS[layout]
    jin, tin, offs, cot, n = _layout_inputs(sizes, n, dtype)
    names = ("xs", "wu", "bu", "wd", "bd")
    joffs = jnp.asarray(offs)
    y_ref = tk_moe_gemm.grouped_ffn(*(jin[k] for k in names), joffs)
    jcot = jnp.asarray(cot).astype(jin["xs"].dtype)
    loss = lambda *a: jnp.sum((tk_moe_gemm.grouped_ffn(*a, joffs) * jcot).astype(jnp.float32))
    g_ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jin[k] for k in names))

    leaves = [tin[k].clone().requires_grad_(True) for k in names]
    y = moe_gemm.grouped_ffn(*leaves, torch.from_numpy(offs))
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot).to(dtype))

    assert y.dtype == dtype and all(g.dtype == dtype for g in grads)
    to_np = lambda t: t.detach().float().numpy()
    ref_np = lambda a: np.asarray(a.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(to_np(y)[:n], ref_np(y_ref)[:n], atol=1e-5)
        for name, g, r in zip(("dx", "dwu", "dbu", "dwd", "dbd"), grads, g_ref):
            np.testing.assert_allclose(to_np(g), ref_np(r), atol=2e-4, err_msg=name)
    else:
        _bf16_close(to_np(y)[:n], ref_np(y_ref)[:n], "y")
        for name, g, r in zip(("dx", "dwu", "dbu", "dwd", "dbd"), grads, g_ref):
            _bf16_close(to_np(g), ref_np(r), name)
    # the empty expert gets exact zero gradients, the padding rows exact zero dx
    empty = sizes.index(0)
    for g in grads[1:]:
        assert (g[empty] == 0).all()
    assert (grads[0][n:] == 0).all()


def test_plain_backward_is_the_autograd_of_its_forward():
    """The hand-written plain backward, in f32, against autograd through
    the same per-segment products (atol 1e-5, summation order only)."""
    jin, tin, offs, cot, n = _layout_inputs(*LAYOUTS["one-row-empty-long"], torch.float32)
    names = ("xs", "wu", "bu", "wd", "bd")
    leaves = [tin[k].clone().requires_grad_(True) for k in names]
    x, wu, bu, wd, bd = leaves
    rows = []
    for e in range(wu.shape[0]):
        s, t = int(offs[e]), int(offs[e + 1])
        h = torch.relu(x[s:t] @ wu[e] + bu[e])
        rows.append(torch.relu(h @ wd[e] + bd[e]))
    auto = torch.autograd.grad(torch.cat(rows), leaves, torch.from_numpy(cot))
    ys = moe_gemm.grouped_ffn_reference(*(tin[k] for k in names), torch.from_numpy(offs))
    mine = moe_gemm.grouped_ffn_backward_reference(
        tin["xs"], torch.from_numpy(cot), ys, tin["wu"], tin["bu"], tin["wd"],
        torch.from_numpy(offs))
    for name, a, b in zip(("dx", "dwu", "dbu", "dwd", "dbd"), mine, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("top_k,batch,seq", [(1, 3, 37), (2, 2, 40), (2, 4, 129)],
                         ids=["top1-padded", "top2", "top2-two-blocks"])
def test_sort_plan_matches_tpukit(top_k, batch, seq):
    """src, inv and offsets equal exactly, for routings from tpukit's own
    router; the flattened assignments are padded to tpukit's row blocks."""
    kw = dict(dim=16, head_dim=4, heads=4, num_layers=1, vocab_size=50,
              max_position_embeddings=seq, num_experts=4, router_top_k=top_k)
    tk_cfg = TkConfig(compute_dtype=jnp.float32, **kw)
    cfg = GPTConfig(compute_dtype=torch.float32, **kw)
    rng = np.random.RandomState(top_k + seq)
    x = rng.randn(batch, seq, 16).astype(np.float32)
    router = (rng.randn(16, 4) * 2).astype(np.float32)
    _, top_idx, _, _, _ = tk_route_topk(jnp.asarray(x), jnp.asarray(router), tk_cfg)
    want = tk_moe_gemm.sort_plan(tk_cfg, top_idx)
    got = moe_gemm.sort_plan(cfg, torch.from_numpy(np.array(top_idx)))
    for name, a, b in zip(("src", "inv", "offsets"), got, want):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert moe_gemm.plan_rows(batch * seq * top_k) == tk_moe_gemm._plan_rows(batch * seq * top_k)


def test_grouped_ffn_refuses_what_tpukit_refuses():
    with pytest.raises(ValueError, match="exceeds the supported 32"):
        moe_gemm.check_bank(33)
    x = torch.zeros(12, 8)
    bank = (torch.zeros(2, 8, 16), torch.zeros(2, 16), torch.zeros(2, 16, 8), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="whole number"):  # 12 rows: blocks of 16
        moe_gemm.grouped_ffn(x, *bank, torch.tensor([0, 6, 12], dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 offsets"):
        moe_gemm.grouped_ffn(torch.zeros(16, 8), *bank, torch.tensor([0, 8, 16]))
