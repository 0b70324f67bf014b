"""The port's mixture of experts against tpukit's, on the CPU: routing,
capacity and the kept mask, the load-balance aux, every dispatch's output,
the model's loss and every gradient through `SingleDevice` and
`ExpertParallel` on a 1 x 1 grid, five AdamW steps, recipe 8 end to end,
MoE serving, and the errors of what is not ported.

The fixture is tests/test_moe.py's: dim 32, 4 heads x 8, 2 layers, 4
experts, S 32, f32. tpukit's parameters go into the port through the
bridge; inputs are numpy from fixed seeds. The port's grouped-expert
kernels run their plain versions here (CPU tensors), tpukit's Pallas
kernels run in interpret mode. Tolerances are stated where they are used.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.data import WordTokenizer as JaxWordTokenizer
from tpukit.data import get_tokenizer as tk_get_tokenizer
from tpukit.data import synthetic_stories as jax_synthetic_stories
from tpukit.flags import parse_flags as tk_parse_flags
from tpukit.mesh import create_mesh
from tpukit.model import GPTConfig as TkConfig
from tpukit.model import gpt as tk_gpt
from tpukit.ops import moe_dispatch as tk_dispatch
from tpukit.serve import ServeConfig as JaxServeConfig
from tpukit.serve import ServeEngine as JaxServeEngine
from tpukit.serve import synthetic_request_stream as jax_stream
from tpukit.shardings import ExpertParallel as TkExpertParallel
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import TrainState as TkTrainState
from tpukit.train import fit as tk_fit
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit.train import make_step_fns
import tpukit_torch
from tpukit_torch import NotPortedError, checkpoint
from tpukit_torch.bridge import params_from_numpy, params_to_numpy
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.ops import moe_dispatch, moe_gemm
from tpukit_torch.ops.moe_dispatch import ExpertGrid
from tpukit_torch.recipes import moe as moe_recipe
from tpukit_torch.serve import __main__ as serve_main
from tpukit_torch.serve.engine import ServeConfig, ServeEngine
from tpukit_torch.shardings import ExpertParallel, SingleDevice, leaves
from tpukit_torch.train import create_train_state, train_step

BATCH, SEQ = 16, 32
ROOT = Path(__file__).resolve().parent.parent
FIXTURE = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=211,
               max_position_embeddings=SEQ, num_experts=4)


def _cfgs(**kw):
    kw = {**FIXTURE, **kw}
    return TkConfig(compute_dtype=jnp.float32, **kw), GPTConfig(compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def tk_params():
    tk_cfg, _ = _cfgs()
    return tk_gpt.init_params(jax.random.PRNGKey(0), tk_cfg)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda t: t[0], tree["layers"])


def _x(seed, b=3, s=SEQ, d=32):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    """tests/test_moe.py's batch: 16 rows, row 0 padded from position 28."""
    rng = np.random.RandomState(11)
    ids = rng.randint(3, FIXTURE["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
    mask = np.zeros((BATCH, SEQ), dtype=bool)
    mask[0, 28:] = True
    targets = np.roll(ids, -1, axis=1).astype(np.int32)
    targets[mask] = -100
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(SEQ, dtype=np.int32), ids.shape))
    return {"input_ids": ids, "position_ids": pos, "mask": mask}, targets


def _tensors(model_batch, targets):
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in model_batch.items()},
            torch.from_numpy(targets))


# ------------------------------------------------------------- routing ----


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_matches_tpukit(tk_params, top_k):
    """The discrete choice exactly (top_idx, assign), the f32 probabilities
    within rtol 1e-6 (XLA's and torch's exp and sums differ by an ulp)."""
    tk_cfg, cfg = _cfgs(router_top_k=top_k)
    router = _layer0(tk_params)["ffn"]["router"]["kernel"]
    x = _x(1)
    want = tk_dispatch._route_topk(jnp.asarray(x), router, tk_cfg)
    got = moe_dispatch._route_topk(torch.from_numpy(x), torch.from_numpy(np.array(router)),
                                   cfg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 3])
def test_ties_go_to_the_lower_expert_as_in_jax(top_k):
    """A zero router gives every expert the same probability: jax.lax.top_k
    takes the lower indices first, and so must the port (torch.topk
    promises no order among ties)."""
    tk_cfg, cfg = _cfgs(router_top_k=top_k)
    x = _x(2)
    zero = np.zeros((32, 4), np.float32)
    want = tk_dispatch._route_topk(jnp.asarray(x), jnp.asarray(zero), tk_cfg)[1]
    got = moe_dispatch._route_topk(torch.from_numpy(x), torch.from_numpy(zero), cfg)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == np.arange(top_k)).all()


@pytest.mark.parametrize("top_k,capacity", [(1, 0), (2, 0), (1, 2), (2, 3)])
def test_capacity_and_kept_mask_match_tpukit(tk_params, top_k, capacity):
    """moe_capacity, the kept mask and the dispatch one-hot, exactly; the
    fixture with capacity 2 or 3 drops tokens."""
    tk_cfg, cfg = _cfgs(router_top_k=top_k, moe_capacity=capacity)
    for width in (SEQ, 5):
        assert moe_dispatch.moe_capacity(cfg, width) == tk_dispatch.moe_capacity(tk_cfg, width)
    router = _layer0(tk_params)["ffn"]["router"]["kernel"]
    x = _x(3)
    want = tk_dispatch._route(jnp.asarray(x), router, tk_cfg)
    got = moe_dispatch._route(torch.from_numpy(x), torch.from_numpy(np.array(router)), cfg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kept = moe_dispatch._kept_mask(got[4], moe_dispatch.moe_capacity(cfg, SEQ))
    np.testing.assert_array_equal(
        kept.numpy(), np.asarray(tk_dispatch._kept_mask(want[4], tk_dispatch.moe_capacity(
            tk_cfg, SEQ))))
    pallas_kept = moe_gemm.pallas_kept_mask(cfg.replace(moe_dispatch="pallas"),
                                            torch.from_numpy(x),
                                            torch.from_numpy(np.array(router)))
    from tpukit.ops.moe_gemm import pallas_kept_mask as tk_pallas_kept_mask
    np.testing.assert_array_equal(pallas_kept.numpy(), np.asarray(tk_pallas_kept_mask(
        tk_cfg.replace(moe_dispatch="pallas"), jnp.asarray(x), router)))
    if capacity:
        assert kept.sum() < got[4].sum()


@pytest.mark.parametrize("mask_pads", [True, False])
@pytest.mark.parametrize("padded", [True, False])
def test_aux_stats_match_tpukit(tk_params, mask_pads, padded):
    """(num, den) with and without a pad mask, with moe_aux_mask_pads on
    and off; an all-pad row included (rtol 1e-6)."""
    tk_cfg, cfg = _cfgs(moe_aux_mask_pads=mask_pads, router_top_k=2)
    router = _layer0(tk_params)["ffn"]["router"]["kernel"]
    x = _x(4)
    pad = None
    if padded:
        pad = np.zeros((3, SEQ), bool)
        pad[0, 20:] = True
        pad[2, :] = True
    _, _, _, probs, assign = tk_dispatch._route_topk(jnp.asarray(x), router, tk_cfg)
    want = tk_dispatch._aux_stats(probs, assign, None if pad is None else jnp.asarray(pad),
                                  tk_cfg)
    got = moe_dispatch._aux_stats(torch.from_numpy(np.array(probs)),
                                  torch.from_numpy(np.array(assign)),
                                  None if pad is None else torch.from_numpy(pad), cfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


DISPATCHES = {
    "xla": {},
    "a2a-1x1": dict(moe_dispatch="a2a"),
    "pallas-dropless": dict(moe_dispatch="pallas"),
    "pallas-capacity": dict(moe_dispatch="pallas", moe_capacity=2),
    "pallas-1x1": dict(moe_dispatch="pallas", mesh=True),
}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("name", list(DISPATCHES))
def test_dispatch_output_and_aux_match_tpukit(tk_params, name, top_k):
    """Each dispatch's FFN output (atol 1e-5, f32 summation order) and aux
    (rtol 1e-6) on one layer, with a pad mask; the exchange block on a
    (data 1, expert 1) grid against tpukit's on a 1 x 1 mesh."""
    kw = dict(DISPATCHES[name])
    mesh = kw.pop("mesh", False) or kw.get("moe_dispatch") == "a2a"
    tk_cfg, cfg = _cfgs(router_top_k=top_k, **kw)
    if mesh:
        tk_cfg = tk_cfg.replace(moe_mesh=create_mesh({"data": 1, "expert": 1}))
        cfg = cfg.replace(moe_mesh=ExpertGrid(1, 1))
    layer = _layer0(tk_params)
    x = _x(5)
    pad = np.zeros((3, SEQ), bool)
    pad[1, 25:] = True
    want, want_aux = tk_gpt._apply_moe_ffn(layer, tk_cfg, jnp.asarray(x), None, True,
                                           pad_mask=jnp.asarray(pad))
    got, aux = gpt._apply_moe_ffn(_bridge(layer), cfg, torch.from_numpy(x),
                                  torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


# ----------------------------------------------------------- the model ----

STRATEGIES = {
    "single-xla": (lambda: TkSingleDevice(), lambda: SingleDevice(), {}),
    "single-pallas-dropless": (lambda: TkSingleDevice(), lambda: SingleDevice(),
                               dict(moe_dispatch="pallas")),
    "ep1x1-pallas": (lambda: TkExpertParallel(create_mesh({"data": 1, "expert": 1}),
                                              dispatch="pallas"),
                     lambda: ExpertParallel(ExpertGrid(1, 1), dispatch="pallas"), {}),
    "ep1x1-a2a": (lambda: TkExpertParallel(create_mesh({"data": 1, "expert": 1})),
                  lambda: ExpertParallel(ExpertGrid(1, 1)), {}),
}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_loss_and_every_gradient_match_tpukit(tk_params, batch, name, top_k):
    """`value_and_grad`: the pure-CE loss (abs 1e-5) and the gradient of
    CE + 0.01 x aux for every parameter, router and experts included (atol
    5e-5 / rtol 1e-4): tests/test_moe.py:457-462's bars."""
    make_tk, make_port, kw = STRATEGIES[name]
    tk_cfg, cfg = _cfgs(router_top_k=top_k, **kw)
    model_batch, targets = batch
    tk_strategy = make_tk()
    jb = {k: jnp.asarray(v) for k, v in model_batch.items()}
    tk_loss, tk_grads = jax.jit(lambda p: tk_strategy.value_and_grad(
        p, tk_cfg, jb, jnp.asarray(targets)))(tk_params)

    params = _bridge(tk_params)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, grads = make_port().value_and_grad(params, cfg, *_tensors(model_batch, targets))
    assert abs(float(loss) - float(tk_loss)) < 1e-5
    ours = params_to_numpy(grads)
    ref = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, tk_grads)))
    flat = jax.tree_util.tree_leaves_with_path(ours)
    assert len(flat) == len(ref)
    for path, g in flat:
        np.testing.assert_allclose(g, ref[path], atol=5e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(ours["layers"]["ffn"]["router"]["kernel"]).max() > 0
    assert np.abs(ours["layers"]["ffn"]["experts"]["up"]["kernel"]).max() > 0


def test_init_params_tree_matches_tpukit(tk_params):
    _, cfg = _cfgs()
    ours = params_to_numpy(gpt.init_params(cfg, seed=0, device="cpu"))
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, tk_params))
    got = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype


def test_five_adamw_steps_match_tpukit(batch):
    """Five steps of ExpertParallel on a 1 x 1 grid with the pallas
    dispatch against tpukit's jitted step on a 1 x 1 mesh, lr 1e-3: losses
    within rtol 1e-5 (tests/test_torch_train.py's AdamW bar: optax and torch
    round the same update in other orders), parameters within atol 1e-5
    (measured: at most 1.73e-6 on every leaf but one element of the q
    kernels, 2.98e-6, whose gradient is near zero, where AdamW's m /
    sqrt(v) magnifies summation-order noise; parameters move by up to
    5e-3)."""
    tk_cfg, cfg = _cfgs()
    model_batch, targets = batch
    opt = tk_make_optimizer(1e-3)
    tk_strategy = TkExpertParallel(create_mesh({"data": 1, "expert": 1}), dispatch="pallas")
    init = tk_gpt.init_params(jax.random.PRNGKey(3), tk_cfg)
    tk_state = TkTrainState(params=jax.tree.map(jnp.copy, init), opt_state=opt.init(init),
                            step=jnp.int32(0))
    step_fn, _, _ = make_step_fns(tk_cfg, opt, tk_strategy, jax.eval_shape(lambda: tk_state))
    state = create_train_state(_bridge(init), 1e-3)
    strategy = ExpertParallel(dispatch="pallas")
    rng = np.random.RandomState(6)
    for _ in range(5):
        rows = rng.permutation(BATCH)[:8]
        mb = {k: np.ascontiguousarray(v[rows]) for k, v in model_batch.items()}
        tgt = targets[rows]
        tk_state, tk_loss = step_fn(tk_state, {k: jnp.asarray(v) for k, v in mb.items()},
                                    jnp.asarray(tgt))
        loss = train_step(state, cfg, strategy, *_tensors(mb, tgt))
        np.testing.assert_allclose(float(loss), float(tk_loss), rtol=1e-5)
    ours = params_to_numpy(state.params)
    ref = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, tk_state.params)))
    for path, a in jax.tree_util.tree_leaves_with_path(ours):
        np.testing.assert_allclose(a, ref[path], atol=1e-5, err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------- recipe ----

RECIPE_ARGS = [
    "--batch_size", "8", "--epochs", "1", "--sequence_length", "64", "--dim", "32",
    "--head_dim", "8", "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
    "--dataset_slice", "80", "--num_workers", "0", "--disable_amp", "--num_experts", "4",
    "--moe_dispatch", "pallas",
]


@pytest.fixture(scope="module")
def tpukit_recipe(tmp_path_factory):
    """tpukit's `fit` with ExpertParallel on a 1 x 1 mesh and the pallas
    dispatch (main-moe.py on one device) once for the module: its window
    losses (JSONL), eval metrics, sample texts and initial parameters."""
    out = tmp_path_factory.mktemp("tpukit_moe_recipe")
    log = out / "metrics.jsonl"
    flags = tk_parse_flags(RECIPE_ARGS + ["--metrics_log", str(log), "--prefetch", "0"],
                           num_experts=True)
    cwd = os.getcwd()
    os.chdir(out)
    try:
        import tpukit.train as tk_train

        texts = []
        real = tk_train.generate_samples

        def capture(*a, **kw):
            texts.extend(real(*a, **kw))
            return texts[-3:]

        tk_train.generate_samples = capture
        try:
            result = tk_fit(flags, TkExpertParallel(create_mesh({"data": 1, "expert": 1}),
                                                    dispatch="pallas"))
        finally:
            tk_train.generate_samples = real
    finally:
        os.chdir(cwd)
    records = [json.loads(line) for line in log.read_text().splitlines()]
    tk_cfg = TkConfig(dim=32, head_dim=8, heads=4, num_layers=2,
                      vocab_size=tk_get_tokenizer().vocab_size, max_position_embeddings=64,
                      compute_dtype=jnp.float32, num_experts=4)
    init = tk_gpt.init_params(jax.random.PRNGKey(flags.seed), tk_cfg)
    return dict(windows=[r["loss"] for r in records if r.get("kind") == "train"],
                eval=result.metrics["eval"], texts=texts, init=init)


def test_recipe_matches_tpukit_fit(tpukit_recipe, tmp_path, monkeypatch):
    """`python -m tpukit_torch.recipes.moe --num_experts 4 --moe_dispatch
    pallas --device cpu` from tpukit's initial parameters (a port checkpoint
    at step 0, `--resume`) against tpukit's `fit`: train window losses within
    rtol 1e-4 (f32, nine AdamW steps), eval loss and accuracy within bf16
    bands (both evaluate in bf16: rtol 2e-2, 1.5 accuracy points), the three
    greedy sample texts equal."""
    monkeypatch.chdir(tmp_path)
    state = create_train_state(_bridge(tpukit_recipe["init"]), 1e-3)
    start = checkpoint.save(state, directory=str(tmp_path / "init"))
    result = moe_recipe.main(RECIPE_ARGS + ["--device", "cpu", "--resume", str(start)])
    ours = [w["loss"] for w in result.metrics["train_windows"]]
    assert len(ours) == len(tpukit_recipe["windows"]) >= 1
    np.testing.assert_allclose(ours, tpukit_recipe["windows"], rtol=1e-4)
    np.testing.assert_allclose(result.metrics["eval"]["loss"], tpukit_recipe["eval"]["loss"],
                               rtol=2e-2)
    assert abs(result.metrics["eval"]["accuracy"] - tpukit_recipe["eval"]["accuracy"]) <= 1.5
    assert result.metrics["samples"] == tpukit_recipe["texts"]
    assert result.config.num_experts == 4 and result.config.moe_dispatch == "xla"
    assert result.checkpoint_path.exists()


def test_pick_grid_matches_main_moe():
    spec = importlib.util.spec_from_file_location("tk_main_moe", ROOT / "main-moe.py")
    main_moe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(main_moe)
    for n, e in ((1, 8), (8, 8), (8, 4), (6, 4), (4, 6)):
        assert moe_recipe.pick_grid(n, e) == main_moe.pick_grid(n, e)
    assert moe_recipe.pick_grid(moe_recipe.DEVICES, 8) == {"data": 1, "expert": 1}


# -------------------------------------------------------------- serving ----


def test_moe_serving_tokens_match_tpukit():
    """Greedy f32 token streams of an MoE GPT with the dropless pallas
    dispatch, fused decoding, through both engines, identical per request."""
    tok = JaxWordTokenizer(jax_synthetic_stories(64))
    kw = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tok.vocab_size,
              max_position_embeddings=96, num_experts=4, moe_dispatch="pallas")
    jcfg = TkConfig(compute_dtype=jnp.float32, **kw)
    tcfg = GPTConfig(compute_dtype=torch.float32, **kw)
    jp = tk_gpt.init_params(jax.random.PRNGKey(2), jcfg)
    reqs = jax_stream(tok, 6, seed=4, max_new_tokens=8, buckets=(8, 16))
    serve_kw = dict(slots=3, buckets=(8, 16), max_new_tokens=8, page_size=8, decode_quantum=3,
                    fused_decode=True)
    eos = int(tok.eos_token_id)
    jeng = JaxServeEngine(jp, jcfg, JaxServeConfig(window_steps=8, **serve_kw), eos_id=eos)
    teng = ServeEngine(_bridge(jp), tcfg, ServeConfig(**serve_kw), eos_id=eos, device="cpu")
    outs_j = {c.rid: np.asarray(c.ids) for c in jeng.run(list(reqs), max_wall_s=300)}
    outs_t = {c.rid: np.asarray(c.ids) for c in teng.run(list(reqs), max_wall_s=300)}
    assert outs_t.keys() == outs_j.keys() == set(range(6))
    for rid in outs_j:
        np.testing.assert_array_equal(outs_t[rid], outs_j[rid], err_msg=f"rid {rid}")


def test_serve_entry_point_runs_moe_on_the_cpu(capsys):
    assert serve_main.main([
        "--device", "cpu", "--num_layers", "1", "--dim", "32", "--head_dim", "8",
        "--heads", "4", "--sequence_length", "64", "--requests", "3", "--slots", "2",
        "--page_size", "8", "--buckets", "16", "--max_new_tokens", "4", "--fused_decode",
        "--num_experts", "4", "--moe_top_k", "2", "--moe_dispatch", "pallas"]) == 0
    assert "served 3 requests" in capsys.readouterr().out


# --------------------------------------------------- what is not ported ----


def test_expert_axis_over_one_rank_is_not_ported(tk_params):
    with pytest.raises(NotPortedError, match="item 13"):
        ExpertParallel(ExpertGrid(data=1, expert=2), dispatch="pallas")
    with pytest.raises(NotPortedError, match="item 13"):
        ExpertParallel(ExpertGrid(data=2, expert=1))
    _, cfg = _cfgs(moe_dispatch="a2a", moe_mesh=ExpertGrid(1, 2))
    with pytest.raises(NotPortedError, match="item 13"):
        gpt._apply_moe_ffn(_bridge(_layer0(tk_params)), cfg, torch.from_numpy(_x(6)))


def test_config_validation_matches_tpukit():
    for kw in (dict(router_top_k=5), dict(router_top_k=0), dict(moe_dispatch="ring")):
        with pytest.raises(ValueError):
            TkConfig(**{**FIXTURE, **kw})
        with pytest.raises(ValueError):
            GPTConfig(**{**FIXTURE, **kw})
    with pytest.raises(ValueError, match="requires an MoE config"):
        ExpertParallel().validate_config(GPTConfig())


def test_recipe_and_moe_serving_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        moe_recipe.main(RECIPE_ARGS[:-1] + ["xla"])
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        serve_main.main(["--num_experts", "8", "--moe_dispatch", "pallas"])
