"""The port's `tpukit_torch/ops/quant_comm.py` against tpukit's
`tpukit/ops/quant_comm.py` in one process: the quantizer and the packed
wire row, the stochastic quantizer with the same key, the closed-form byte
counts, the gradient bucket plan, the collectives at a world of one, the
stochastic-rounding key of the sites without a step key, and which
strategies refuse `--comm_dtype` / `--grad_buckets` (tpukit's `ValueError`s).
The collectives over gloo ranks, the hand-placed `DataParallel` / `FSDP`
steps and the quantized MoE exchange ride the spawns of
`tests/test_torch_distributed.py` and `tests/test_torch_expert_parallel.py`.

Bars: the quantizer, the packed rows, the stochastic draws, the plans and
the closed forms are equal to tpukit's (bit for bit where they are
arrays); unbiasedness as `tests/test_quant_comm.py:168` states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpukit.compat import shard_map
from tpukit.mesh import create_mesh as tk_create_mesh
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.model.gpt import init_params as tk_init_params
from tpukit.ops import quant_comm as tkq
from tpukit_torch import random as tk_random
from tpukit_torch.flags import NOT_CARRIED, check_carried, parse_flags
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.ops import quant_comm as qc
from tpukit_torch.ops.moe_dispatch import ExpertGrid
from tpukit_torch.pipeline import Pipeline
from tpukit_torch.shardings import (FSDP, ContextParallel, DataParallel, ExpertParallel,
                                    SingleDevice, TensorParallel, fsdp_shard_dim)
from tpukit_torch.train import build_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=211,
            max_position_embeddings=32)
GPT2_SMALL = dict(dim=768, head_dim=64, heads=12, num_layers=12, vocab_size=50257,
                  max_position_embeddings=512)


def _rows(n_rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.01, 10.0, size=(n_rows, 1))
    x = (rng.randn(n_rows, n) * scale).astype(np.float32)
    x[0, : min(n, 300)] = 0.0  # an all-zero block: scale 0, exact zeros
    return x


@pytest.mark.parametrize("n", [1, 255, 257, 700, 1000])
@pytest.mark.parametrize("block", [64, 256])
def test_quantizer_and_packed_row_match_tpukit(n, block):
    """Round-to-nearest `quantize_blockwise` / `dequantize_blockwise`
    (against tpukit's eager functions), `pack_quantized` and
    `unpack_dequantized` (against them compiled, as tpukit's wire runs) at
    sizes that are no multiple of the block: bit-equal, the packed row
    `packed_bytes(n)` long."""
    x = _rows(3, n, seed=n + block)
    q, s = qc.quantize_blockwise(torch.from_numpy(x), block=block)
    tq, ts = tkq.quantize_blockwise(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(tq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ts))
    back = qc.dequantize_blockwise(q, s, x.shape, block=block)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(tkq.dequantize_blockwise(tq, ts, x.shape, block)))
    # tpukit's wire runs compiled, where XLA takes `amax / 127` as `amax *
    # f32(1 / 127)`; `pack_quantized` follows the compiled program
    packed = qc.pack_quantized(torch.from_numpy(x), block)
    tpacked = np.asarray(jax.jit(tkq.pack_quantized, static_argnums=1)(jnp.asarray(x), block))
    assert packed.dtype == torch.int8 and packed.shape == (3, qc.packed_bytes(n, block))
    np.testing.assert_array_equal(packed.numpy(), tpacked)
    np.testing.assert_array_equal(qc.unpack_dequantized(packed, n, block).numpy(),
                                  np.asarray(tkq.unpack_dequantized(jnp.asarray(tpacked), n,
                                                                    block)))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_stochastic_quantizer_matches_tpukit_with_the_same_key(seed):
    """`floor(v + U[0, 1))` with `U` from the port's threefry: with the same
    key, the stochastic quantizer and the stochastic packed row are tpukit's
    bit for bit, and differ from round-to-nearest."""
    x = _rows(4, 700, seed=3)
    key, tkey = tk_random.PRNGKey(seed), jax.random.PRNGKey(seed)
    xb = np.pad(x, ((0, 0), (0, 768 - 700)))
    q, s = qc.quantize_blocks(torch.from_numpy(xb), rng=key)
    tq, ts = tkq.quantize_blocks(jnp.asarray(xb), rng=tkey)
    np.testing.assert_array_equal(q.numpy(), np.asarray(tq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ts))
    assert not np.array_equal(q.numpy(), qc.quantize_blocks(torch.from_numpy(xb))[0].numpy())
    np.testing.assert_array_equal(
        qc.pack_quantized(torch.from_numpy(x), rng=key).numpy(),
        np.asarray(jax.jit(lambda v, k: tkq.pack_quantized(v, rng=k))(jnp.asarray(x), tkey)))


def test_stochastic_rounding_unbiased():
    """Twin of `tests/test_quant_comm.py:168`: stochastic rounding lands on
    one of the two adjacent levels, and the mean over 200 keys is nearer
    the true value than round-to-nearest (or within 1e-4 of it)."""
    x = torch.full((1, 256), 0.3217, dtype=torch.float32)
    q, s = qc.quantize_blocks(x)
    det = qc.dequantize_blocks(q, s)
    acc = np.zeros((1, 256), np.float64)
    draws = 200
    step = float(s[0, 0])
    for i in range(draws):
        qi, si = qc.quantize_blocks(x, rng=tk_random.PRNGKey(i))
        back = qc.dequantize_blocks(qi, si).numpy()
        assert (np.abs(back - x.numpy()) < step + 1e-7).all()
        acc += back
    mean_err = abs(acc.mean() / draws - 0.3217)
    det_err = abs(float(det.mean()) - 0.3217)
    assert mean_err < det_err or mean_err < 1e-4


@pytest.mark.parametrize("block", [64, 256])
def test_roundtrip_error_bound(block):
    """Twin of `tests/test_quant_comm.py:128`: the round trip is within
    half a step (`max|block| / 254`) element-wise; zero blocks are exact."""
    rng = np.random.RandomState(0)
    x = (rng.randn(5 * block + 17) * rng.uniform(0.01, 10)).astype(np.float32)
    q, scales = qc.quantize_blockwise(torch.from_numpy(x), block=block)
    back = qc.dequantize_blockwise(q, scales, x.shape, block=block).numpy()
    padded = np.pad(x, (0, -(-x.size // block) * block - x.size)).reshape(-1, block)
    bound = np.repeat(np.abs(padded).max(axis=1) / 253.9, block)[: x.size]
    assert (np.abs(back - x) <= bound).all()
    qz, sz = qc.quantize_blockwise(torch.zeros(2 * block), block=block)
    assert (qz == 0).all() and (qc.dequantize_blockwise(qz, sz, (2 * block,), block) == 0).all()


def test_closed_forms_match_tpukit():
    """`wire_itemsize`, `packed_bytes` and every `expected_*` equal
    tpukit's over a table of sizes, worlds, dtypes and backends."""
    sizes = [1, 255, 256, 257, 1000, 4097, 124_439_808]
    for dtype in ("f32", "bf16", "int8"):
        for backend in (None, "cpu", "tpu"):
            assert qc.wire_itemsize(dtype, backend) == tkq.wire_itemsize(dtype, backend)
        for world in (1, 2, 3, 4, 8):
            for backend in (None, "cpu"):
                for n in sizes:
                    assert qc.packed_bytes(n) == tkq.packed_bytes(n)
                    assert (qc.expected_all_reduce(n, world, dtype, backend=backend)
                            == tkq.expected_all_reduce(n, world, dtype, backend=backend))
                    assert (qc.expected_reduce_scatter(n, world, dtype, backend=backend)
                            == tkq.expected_reduce_scatter(n, world, dtype, backend=backend))
                for buckets in ([], [0], sizes[:3], sizes, [8 * 1000, 8 * 4097]):
                    assert (qc.expected_bucketed_all_reduce(buckets, world, dtype,
                                                            backend=backend)
                            == tkq.expected_bucketed_all_reduce(buckets, world, dtype,
                                                                backend=backend))
                    assert (qc.expected_bucketed_reduce_scatter(buckets, world, dtype,
                                                                backend=backend)
                            == tkq.expected_bucketed_reduce_scatter(buckets, world, dtype,
                                                                    backend=backend))


def _tk_paths(tree) -> list[str]:
    return ["/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("shape", ["tiny", "tiny-moe", "gpt2-small"])
def test_grad_bucket_plan_matches_tpukit(shape):
    """`grad_bucket_plan` on the port's tree (built in its own key order)
    gives tpukit's buckets, leaf for leaf by path, at N = 1..8, whole and
    restricted to FSDP's sharded leaves at worlds 4 and 8."""
    kw = {"tiny": TINY, "tiny-moe": {**TINY, "num_experts": 4},
          "gpt2-small": GPT2_SMALL}[shape]
    tk_tree = jax.eval_shape(lambda: tk_init_params(jax.random.PRNGKey(0),
                                                    TkGPTConfig(**kw)))
    ours = gpt.init_params(GPTConfig(**kw), device="meta")
    tk_names = _tk_paths(tk_tree)
    our_names = ["/".join(path) for path, _ in qc.sorted_items(ours)]
    assert our_names == tk_names
    from tpukit.shardings import FSDP as TkFSDP
    for world in (None, 4, 8):
        include = tk_include = None
        if world is not None:
            spec = TkFSDP(tk_create_mesh({"data": world}, jax.devices()[:world])).param_spec
            tk_include = {i for i, leaf in enumerate(jax.tree_util.tree_leaves(tk_tree))
                          if "data" in tuple(spec(leaf.shape))}
            include = {i for i, (_, leaf) in enumerate(qc.sorted_items(ours))
                       if fsdp_shard_dim(tuple(leaf.shape), world) is not None}
            assert include == tk_include
        for n in range(1, 9):
            plan = qc.grad_bucket_plan(ours, n, include=include)
            tk_plan = tkq.grad_bucket_plan(tk_tree, n, include=tk_include)
            assert [[our_names[i] for i in b] for b in plan] == \
                [[tk_names[i] for i in b] for b in tk_plan], (world, n)


def test_world_of_one_collectives_match_tpukit():
    """At a world of one the wrappers keep the quantize numerics and skip
    the collectives (tpukit :252-254): `quantized_all_reduce` and
    `bucket_all_reduce` at int8 and bf16, `quantized_all_gather` at int8,
    bit-equal to tpukit's on a 1-device mesh; f32 is the identity."""
    x = _rows(700, 3, seed=9)
    mesh = tk_create_mesh({"data": 1}, jax.devices()[:1])

    def block(v):
        out = {}
        for dt in ("int8", "bf16"):
            out[f"ar/{dt}"] = tkq.quantized_all_reduce(v, "data", 1, dt)
            out[f"bar/{dt}"] = tkq.bucket_all_reduce(v, "data", 1, dt)
        out["ag/int8"] = tkq.quantized_all_gather(v, "data", 1, 0, "int8")
        return out

    ref = jax.jit(shard_map(block, mesh=mesh, in_specs=(P(),), out_specs=P(),
                            check_vma=False))(jnp.asarray(x))
    t = torch.from_numpy(x)
    for dt in ("int8", "bf16"):
        np.testing.assert_array_equal(qc.quantized_all_reduce(t, None, 1, dt).numpy(),
                                      np.asarray(ref[f"ar/{dt}"]))
        np.testing.assert_array_equal(qc.bucket_all_reduce(t, None, 1, dt).numpy(),
                                      np.asarray(ref[f"bar/{dt}"]))
    np.testing.assert_array_equal(qc.quantized_all_gather(t, None, 1, 0, "int8").numpy(),
                                  np.asarray(ref["ag/int8"]))
    assert torch.equal(qc.bucket_all_reduce(t, None, 1, "f32"), t)
    assert torch.equal(qc.quantized_all_reduce(t, None, 1, "f32"), t)


def test_fallback_key_folds_rank_and_sum_as_tpukit():
    """The key of a stochastic site without a step key: `PRNGKey(0x51C0)`
    folded with the rank and with the bits of the tensor's f32 sum. Where
    both sums are exact (small integers) the keys are tpukit's bit for
    bit; in general the summation orders differ, so the noise is held
    statistically (above) and by the trajectory gates."""
    from tpukit import compat  # noqa: F401  (tpukit's shard_map shim)

    sample = np.arange(-40, 88, dtype=np.float32).reshape(4, 32)
    mesh = tk_create_mesh({"data": 1}, jax.devices()[:1])
    tk_key = jax.jit(shard_map(lambda s: tkq._fallback_key("data", s)[None], mesh=mesh,
                               in_specs=(P(),), out_specs=P(), check_vma=False))(
        jnp.asarray(sample))
    ours = qc.fallback_key(0, torch.from_numpy(sample))
    np.testing.assert_array_equal(ours.numpy().astype(np.uint32),
                                  np.asarray(jax.random.key_data(tk_key)
                                             if jnp.issubdtype(tk_key.dtype,
                                                               jax.dtypes.prng_key)
                                             else tk_key)[0])
    assert not torch.equal(qc.fallback_key(1, torch.from_numpy(sample)), ours)


def test_comm_dtype_refusals_match_tpukit():
    """Twin of `tests/test_quant_comm.py:412`: a bogus comm dtype at config
    construction; `--comm_dtype int8` and `--grad_buckets 2` on every
    strategy without a hand-placed wire (single, TP, CP, the pipeline);
    the hand-placed wire with an MoE config under DataParallel and FSDP;
    the xla dispatch under ExpertParallel: each raises tpukit's
    `ValueError`. The wired combinations pass."""
    with pytest.raises(ValueError, match="comm_dtype"):
        GPTConfig(comm_dtype="int4")
    with pytest.raises(ValueError, match="grad_buckets"):
        GPTConfig(grad_buckets=-1)
    cfg = GPTConfig(**TINY, comm_dtype="int8")
    buckets = GPTConfig(**TINY, grad_buckets=2)
    for strategy in (SingleDevice(), ContextParallel(seq=8), TensorParallel(model=4),
                     Pipeline(stages=4)):
        with pytest.raises(ValueError, match="--comm_dtype int8: .* has no wired quantized"):
            strategy.validate_config(cfg)
        with pytest.raises(ValueError, match="--grad_buckets 2: .* has no hand-placed"):
            strategy.validate_config(buckets)
    moe_int8 = GPTConfig(**TINY, comm_dtype="int8", num_experts=4)
    moe_buckets = GPTConfig(**TINY, grad_buckets=2, num_experts=4)
    for make in (DataParallel, FSDP):
        for moe_cfg in (moe_int8, moe_buckets):
            with pytest.raises(ValueError, match="ExpertParallel"):
                make().validate_config(moe_cfg)
        make().validate_config(cfg)
        make().validate_config(buckets)
        make().validate_config(GPTConfig(**TINY, num_experts=4))  # f32: DDP/FSDP2 run MoE
    grid = ExpertGrid(data=2, expert=4)
    with pytest.raises(ValueError, match="moe_dispatch"):
        ExpertParallel(grid, dispatch="xla").validate_config(moe_int8)
    with pytest.raises(ValueError, match="moe_dispatch"):
        ExpertParallel(grid, dispatch="xla").validate_config(moe_buckets)
    for dispatch in ("a2a", "pallas"):
        ExpertParallel(grid, dispatch=dispatch).validate_config(moe_int8)
        ExpertParallel(grid, dispatch=dispatch).validate_config(moe_buckets)


def test_comm_flags_are_carried():
    """`--comm_dtype`, `--quant_stochastic` and `--grad_buckets` parse with
    tpukit's defaults, pass `check_carried` and reach the config."""
    assert not {"comm_dtype", "quant_stochastic", "grad_buckets"} & set(NOT_CARRIED)
    flags = parse_flags([])
    assert (flags.comm_dtype, flags.quant_stochastic, flags.grad_buckets) == ("f32", False, 0)
    flags = parse_flags(["--comm_dtype", "int8", "--quant_stochastic", "--grad_buckets", "3"],
                        num_experts=True)
    check_carried(flags)
    cfg = build_config(flags, 211)
    assert (cfg.comm_dtype, cfg.quant_stochastic, cfg.grad_buckets) == ("int8", True, 3)
    with pytest.raises(SystemExit):
        parse_flags(["--comm_dtype", "int4"])


# -- the deferred weight products of the bucket step ------------------------


def _world_of_one_step(cfg, strategy):
    params = strategy.setup(gpt.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(4, 16)).astype(np.int64))
    batch = {"input_ids": ids, "position_ids": torch.arange(16).expand(4, 16).contiguous(),
             "mask": torch.zeros(4, 16, dtype=torch.bool)}
    batch["mask"][1, 11:] = True
    targets = torch.roll(ids, -1, 1)
    targets[1, 11:] = -100
    return params, batch, targets


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@pytest.mark.parametrize("n_buckets,compute", [(1, "f32"), (2, "f32"), (3, "f32"), (5, "f32"),
                                               (3, "bf16")])
def test_deferred_weight_products_are_bit_equal(n_buckets, compute):
    """`ops/deferred.Deferral` on the hand-placed step's objective (a world
    of one): the activation-gradient chain with every weight product in
    place but those of the most read bucket of `grad_bucket_plan`, which
    run at its end, each bucket handed over inside the backward's graph
    task, the last one last. Every leaf's gradient is bit-equal to one
    `torch.autograd.grad` of the same objective, at 1, 2, 3 and 5 buckets;
    so are `DataParallel`'s and `FSDP`'s deferred bucket steps (which
    `value_and_grad` takes from two ranks up) and their steps at a world
    of one."""
    from tpukit_torch import mesh
    from tpukit_torch.ops import deferred
    from tpukit_torch.shardings import leaves

    dtype = torch.float32 if compute == "f32" else torch.bfloat16
    cfg = GPTConfig(**TINY, compute_dtype=dtype, grad_buckets=n_buckets)
    with mesh.scoped_runtime():
        mesh.initialize_runtime("cpu")
        st = DataParallel()
        params, batch, targets = _world_of_one_step(cfg, st)
        objective, _ = st._local_objective(params, cfg, batch, targets, None)
        ref = torch.autograd.grad(objective, leaves(params))

        order = st._jax_order(params)
        buckets = [[order[j] for j in idxs]
                   for idxs in qc.grad_bucket_plan(params, n_buckets)]
        d, last = st._deferral(params, cfg, buckets, leaves(params))
        with d.active():
            objective, _ = st._local_objective(d.capture(params), cfg, batch, targets, None)
        assert d._products and all(any(k in d.late for k, _ in p.slots) for p in d._products)
        seen, midway = [], []

        def on_bucket(b, got):
            seen.append((b, sorted(got), torch._C._current_graph_task_id() != -1))

        got = d.backward(objective, buckets, last, on_bucket,
                         on_midway=lambda: midway.append(len(seen)))
        issue = [b for b in range(len(buckets)) if b != last] + [last]
        assert seen == [(b, sorted(buckets[b]), True) for b in issue]
        assert midway == [len(buckets) - 1]
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        for cls in (DataParallel, FSDP):
            st = cls()
            params, batch, targets = _world_of_one_step(cfg, st)
            steps = [st.value_and_grad(params, cfg, batch, targets)[1]]
            if n_buckets >= 2:
                steps.append(st._bucket_step(params, cfg, batch, targets, None)[1])
            for grads in steps:
                for a, b in zip(leaves(grads), ref):
                    assert torch.equal(_local(a), b), cls.__name__


def test_late_bucket_is_the_most_read():
    """`deferred.late_bucket`: the bucket the forward reads most (the later
    on a tie), whose products are deferred and whose wire goes last."""
    from tpukit_torch.ops import deferred

    assert deferred.late_bucket([9, 8, 4, 9]) == 3
    assert deferred.late_bucket([5, 1, 2]) == 0
    assert deferred.late_bucket([3]) == 0


def test_a_leaf_read_inside_and_outside_a_deferred_op_raises():
    """A leaf whose gradient would be split between a deferred op and a
    read outside one (a tied weight, a second use of a norm) raises rather
    than losing the part read outside; so does a leaf read by two deferred
    ops. A leaf read only outside deferred ops keeps its whole gradient."""
    from tpukit_torch.ops import deferred

    w = torch.randn(3, 4, requires_grad=True)
    v = torch.randn(4, requires_grad=True)
    x = torch.randn(2, 3)
    mm = lambda x, p: torch.matmul(x, p["kernel"])

    def step(second_read):
        d = deferred.Deferral([w, v], late=[0])
        tree = d.capture({"kernel": w, "bias": v})
        with d.active():
            y = deferred.run(mm, x, {"kernel": tree["kernel"]}) + tree["bias"]
            y = second_read(y, tree)
        return d.backward(y.square().sum(), [[1], [0]], 1, lambda b, got: None)

    grads = step(lambda y, tree: y)
    ref = torch.autograd.grad((torch.matmul(x, w) + v).square().sum(), [w, v])
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    with pytest.raises(ValueError, match="both by a deferred op and outside one"):
        step(lambda y, tree: y @ tree["kernel"].T)
    with pytest.raises(ValueError, match="read by two deferred ops"):
        step(lambda y, tree: deferred.run(lambda x, p: x @ p["k"].T, y, {"k": tree["kernel"]}))


def test_remat_keeps_the_blocking_bucket_step():
    """With `--remat_layers` a recomputed layer rebuilds its graph in the
    backward, so no product is deferred: DataParallel and FSDP declare no
    overlap and run the blocking step, whose gradients equal the deferred
    bucket step's without remat (`_bucket_step`, which `value_and_grad`
    takes from two ranks up), bit for bit."""
    from tpukit_torch import mesh
    from tpukit_torch.shardings import leaves

    cfg = GPTConfig(**TINY, compute_dtype=torch.float32, grad_buckets=3)
    with mesh.scoped_runtime():
        mesh.initialize_runtime("cpu")
        for cls in (DataParallel, FSDP):
            st = cls()
            params, batch, targets = _world_of_one_step(cfg, st)
            assert st.overlap_comm(cfg, params) is not None
            assert st.overlap_comm(cfg.replace(remat_layers=True), params) is None
            _, deferred_grads = st._bucket_step(params, cfg, batch, targets, None)
            _, remat_grads = st.value_and_grad(params, cfg.replace(remat_layers=True), batch,
                                               targets)
            for a, b in zip(leaves(deferred_grads), leaves(remat_grads)):
                assert torch.equal(_local(a), _local(b)), cls.__name__
