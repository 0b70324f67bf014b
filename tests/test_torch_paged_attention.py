"""The port's paged-attention decode and page ops against tpukit's.

The port runs on the CPU, where `paged_attend` takes its plain PyTorch
version; tpukit's Pallas kernel runs in interpret mode, as
tests/test_paged_attention.py runs it. Inputs come from numpy with fixed
seeds and go to both sides. Tolerances: f32 and int8 1e-6 (tpukit measured
a ~5e-7 dot reassociation residual between its kernel and its own einsum,
tpukit/ops/paged_attention.py:20-30), bf16 1e-2 (about one bf16 ulp at the
outputs' magnitude).

Pools are compared without the null page 0: colliding masked writes land
there and are garbage by design (tpukit/serve/paged.py:175-187).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.ops import paged_attention as jax_pa
from tpukit.ops import quant_comm as jax_qc
from tpukit.serve import paged as jax_paged
from tpukit_torch.ops import paged_attention as pa
from tpukit_torch.ops import quant_comm as qc
from tpukit_torch.serve import paged
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

H, P, D, MP, N = 4, 8, 8, 3, 4  # tests/test_paged_attention.py:113
# cursors: 0 (the fresh token alone), mid-page, a page boundary, W - 1
STARTS = np.asarray([0, 5, 16, MP * P - 1], np.int32)


def _block_tables(n, mp, num_pages, starts, rng):
    """Ragged block tables: each row holds the pages its cursor needs,
    sometimes one more, zeros (the null page) after; page ids come from a
    shuffled pool and are reused across rows, as shared prefix pages are."""
    ids = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((n, mp), np.int32)
    k = 0
    for i, s in enumerate(starts):
        need = min(int(s) // P + 1 + int(rng.randint(2)), mp)
        for j in range(need):
            bt[i, j] = ids[k % len(ids)]
            k += 1
    bt[1, 0] = bt[0, 0]  # one page read by two rows
    return bt


def _operands(pool_dtype, head_dim=D, seed=0):
    rng = np.random.RandomState(seed)
    num_pages = N * MP + 1
    pk = rng.randn(num_pages, H, P, head_dim).astype(np.float32) * 0.5
    pv = rng.randn(num_pages, H, P, head_dim).astype(np.float32) * 0.5
    bt = _block_tables(N, MP, num_pages, STARTS, rng)
    q, kn, vn = (rng.randn(N, H, head_dim).astype(np.float32) for _ in range(3))
    return pk, pv, bt, q, kn, vn


def _both(pk, pv, bt, q, kn, vn, pool_dtype, cdt):
    """Run tpukit's kernel (interpret mode) and the port's on the same
    numpy operands; int8 pools are quantized by tpukit's quantizer and the
    same codes and scales go to the port."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    np_pages, h, p, d = pk.shape
    if pool_dtype == "int8":
        qk, sk = jax_qc.quantize_blocks(jnp.asarray(pk.reshape(np_pages, h, p * d)))
        qv, sv = jax_qc.quantize_blocks(jnp.asarray(pv.reshape(np_pages, h, p * d)))
        jk, jv = qk.reshape(pk.shape), qv.reshape(pv.shape)
        jsk, jsv = sk, sv
        tk, tv = (torch.from_numpy(np.array(x)) for x in (jk, jv))
        tsk, tsv = (torch.from_numpy(np.array(x)) for x in (sk, sv))
    else:
        jk, jv = jnp.asarray(pk, jdt[pool_dtype]), jnp.asarray(pv, jdt[pool_dtype])
        tk = torch.from_numpy(pk).to(tdt[pool_dtype])
        tv = torch.from_numpy(pv).to(tdt[pool_dtype])
        jsk = jsv = tsk = tsv = None
    jvec = [jnp.asarray(x, jdt[cdt]) for x in (q, kn, vn)]
    tvec = [torch.from_numpy(x).to(tdt[cdt]) for x in (q, kn, vn)]
    out_j = jax_pa.paged_attend(jk, jv, jsk, jsv, jnp.asarray(bt), jnp.asarray(STARTS),
                                *jvec)
    out_t = pa.paged_attend(tk, tv, tsk, tsv, torch.from_numpy(bt),
                            torch.from_numpy(STARTS), *tvec)
    assert out_t.dtype == tdt[cdt] and out_t.shape == (N, H, d)
    return np.asarray(out_j.astype(jnp.float32)), out_t.float().numpy()


@pytest.mark.parametrize("pool_dtype,cdt,head_dim,atol", [
    ("f32", "f32", D, 1e-6),
    ("f32", "bf16", D, 1e-2),
    ("bf16", "bf16", D, 1e-2),
    ("int8", "f32", 32, 1e-6),  # P 8 x D 32 = one 256-element quant block
    ("int8", "bf16", 32, 1e-2),
], ids=["f32", "f32_pages_bf16_compute", "bf16", "int8", "int8_bf16_compute"])
def test_paged_attend_matches_tpukit_kernel(pool_dtype, cdt, head_dim, atol):
    ops = _operands(pool_dtype, head_dim)
    out_j, out_t = _both(*ops, pool_dtype, cdt)
    np.testing.assert_allclose(out_t, out_j, atol=atol, rtol=0)


def test_paged_attend_cursor_zero_is_the_fresh_value():
    """At cursor 0 the window holds only the fresh token: softmax over one
    position is exactly 1, so the output is v_new bit for bit, whatever
    the block table points at."""
    pk, pv, bt, q, kn, vn = _operands("f32")
    out = pa.paged_attend(*(torch.from_numpy(x) for x in (pk, pv)), None, None,
                          torch.from_numpy(bt), torch.from_numpy(STARTS),
                          *(torch.from_numpy(x) for x in (q, kn, vn)))
    np.testing.assert_array_equal(out[0].numpy(), vn[0])


def test_paged_attend_cpu_path_does_not_launch():
    """On a CPU tensor the wrapper takes the plain version and counts no
    kernel launch, in any of its kernels."""
    before = dict(pa.launches)
    assert set(before) == {"scores", "values", "combine"}
    pk, pv, bt, q, kn, vn = _operands("f32")
    pa.paged_attend(*(torch.from_numpy(x) for x in (pk, pv)), None, None,
                    torch.from_numpy(bt), torch.from_numpy(STARTS),
                    *(torch.from_numpy(x) for x in (q, kn, vn)))
    assert pa.launches == before


# ---------------------------------------------------------------------------
# Page ops: gather_view, write_token, write_pages.
# ---------------------------------------------------------------------------


def _pools(kv, head_dim, seed):
    """One layer's pool (and scales) as (jax, torch) pairs from numpy."""
    rng = np.random.RandomState(seed)
    raw = rng.randn(N * MP + 1, H, P, head_dim).astype(np.float32)
    if kv == "f32":
        return (jnp.asarray(raw), None), (torch.from_numpy(raw.copy()), None)
    q, s = jax_qc.quantize_blocks(jnp.asarray(raw.reshape(N * MP + 1, H, P * head_dim)))
    q = q.reshape(raw.shape)
    return (q, s), (torch.from_numpy(np.asarray(q).copy()),
                    torch.from_numpy(np.asarray(s).copy()))


@pytest.mark.parametrize("kv,head_dim", [("f32", D), ("int8", 32)], ids=["f32", "int8"])
def test_gather_view_matches_tpukit(kv, head_dim):
    (jp, js), (tp, ts) = _pools(kv, head_dim, 1)
    bt = _block_tables(N, MP, N * MP + 1, STARTS, np.random.RandomState(2))
    view_j = jax_paged.gather_view(jp, js, jnp.asarray(bt), jnp.float32)
    view_t = paged.gather_view(tp, ts, torch.from_numpy(bt), torch.float32)
    np.testing.assert_allclose(view_t.numpy(), np.asarray(view_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kv,head_dim", [("f32", D), ("int8", 32)], ids=["f32", "int8"])
def test_write_token_matches_tpukit(kv, head_dim):
    (jp, js), (tp, ts) = _pools(kv, head_dim, 3)
    rng = np.random.RandomState(4)
    bt = np.arange(1, N * MP + 1, dtype=np.int32).reshape(N, MP)  # writable pages are private
    val = rng.randn(N, H, head_dim).astype(np.float32)
    mask = np.asarray([True, True, False, True])  # a frozen lane writes page 0
    jp2, js2 = jax_paged.write_token(jp, js, jnp.asarray(bt), jnp.asarray(STARTS),
                                     jnp.asarray(val), jnp.asarray(mask))
    paged.write_token(tp, ts, torch.from_numpy(bt), torch.from_numpy(STARTS),
                      torch.from_numpy(val), torch.from_numpy(mask))
    if kv == "int8":
        np.testing.assert_array_equal(tp[1:].numpy(), np.asarray(jp2)[1:])
        np.testing.assert_array_equal(ts[1:].numpy(), np.asarray(js2)[1:])
    else:
        np.testing.assert_array_equal(tp[1:].numpy(), np.asarray(jp2)[1:])


@pytest.mark.parametrize("kv,head_dim", [("f32", D), ("int8", 32)], ids=["f32", "int8"])
def test_write_pages_matches_tpukit(kv, head_dim):
    (jp, js), (tp, ts) = _pools(kv, head_dim, 5)
    rng = np.random.RandomState(6)
    c = 2 * P
    bt = np.arange(1, N * MP + 1, dtype=np.int32).reshape(N, MP)
    bt[3, 1:] = 0  # a lane allocated one page: its chunk's second page -> page 0
    starts = np.asarray([0, P, 0, 0], np.int32)
    vals = rng.randn(N, H, c, head_dim).astype(np.float32)
    mask = np.asarray([True, True, False, True])
    jp2, js2 = jax_paged.write_pages(jp, js, jnp.asarray(bt), jnp.asarray(starts),
                                     jnp.asarray(vals), jnp.asarray(mask))
    paged.write_pages(tp, ts, torch.from_numpy(bt), torch.from_numpy(starts),
                      torch.from_numpy(vals), torch.from_numpy(mask))
    np.testing.assert_array_equal(tp[1:].numpy(), np.asarray(jp2)[1:])
    if kv == "int8":
        np.testing.assert_array_equal(ts[1:].numpy(), np.asarray(js2)[1:])


def test_int8_pool_bytes_and_layout_checks():
    from tpukit.model import GPTConfig as JaxConfig
    from tpukit_torch.model import GPTConfig

    tcfg = GPTConfig(dim=32, head_dim=32, heads=4, num_layers=2, vocab_size=97,
                     max_position_embeddings=64, compute_dtype=torch.float32)
    jcfg = JaxConfig(dim=32, head_dim=32, heads=4, num_layers=2, vocab_size=97,
                     max_position_embeddings=64, compute_dtype=jnp.float32)
    for kv in ("f32", "bf16", "int8"):
        assert paged.pool_bytes(tcfg, 13, P, kv) == jax_paged.pool_bytes(jcfg, 13, P, kv)
    with pytest.raises(ValueError, match="quant block"):
        paged.validate_kv_layout(tcfg.replace(head_dim=8), P, "int8")
    cache = paged.init_paged_cache(tcfg, 13, P, MP, N, "int8", device="cpu")
    assert cache["ks"].shape == (2, 13, 4, 1) and cache["k"].dtype == torch.int8
    assert qc.packed_bytes(P * 32) == jax_qc.packed_bytes(P * 32)
