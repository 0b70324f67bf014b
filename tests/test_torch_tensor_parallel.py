"""Recipe 6 of the port (`TensorParallel`, `recipes/tp.py`) and the
serving grid, against tpukit's, without processes: the placement rules
leaf for leaf against tpukit's `TensorParallel._spec_for` (its
`tests/test_tensor_parallel.py` configs, the undividable one included),
the grid pickers against `main-tp.py`'s and tpukit's `pick_serve_grid`,
tpukit's refusals and messages, the Megatron operators at a group of one,
and the TP step in a world of one against `SingleDevice`. The gloo worlds
of 2 and 4 ranks are in `tests/test_torch_distributed.py` (training) and
`tests/test_torch_serve.py` (serving).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.mesh import create_mesh as tk_create_mesh
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.model import init_params as tk_init_params
from tpukit.serve.fleet import pick_serve_grid as tk_pick_serve_grid
from tpukit.shardings import TensorParallel as TkTensorParallel
from tpukit_torch import mesh
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.ops import layers, paged_attention
from tpukit_torch.recipes import tp
from tpukit_torch.serve.engine import ServeConfig, ServeEngine
from tpukit_torch.serve.fleet import pick_serve_grid
from tpukit_torch.shardings import SingleDevice, TensorParallel, leaves
from tpukit_torch.train import create_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
TP_CONFIG = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=160,
                 max_position_embeddings=32)  # tests/test_tensor_parallel.py's
# tests/test_tensor_parallel.py::test_tp_undividable_dims_replicate's
UNDIVIDABLE = dict(dim=30, head_dim=6, heads=5, num_layers=1, vocab_size=151, ffn_mult=3,
                   max_position_embeddings=16, vocab_pad_multiple=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("kw", [TP_CONFIG, UNDIVIDABLE], ids=["tp_config", "undividable"])
def test_spec_dim_matches_tpukit(kw, model):
    """`TensorParallel.spec_dim` of every leaf, on tpukit's shapes, is the
    dimension tpukit's `state_sharding` shards over `model` (None where it
    replicates, as every leaf of the undividable config at 8)."""
    cfg = TkGPTConfig(**kw, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: tk_init_params(jax.random.PRNGKey(0), cfg))
    sharding = TkTensorParallel(tk_create_mesh({"model": model}, jax.devices()[:model])
                                ).state_sharding(shapes)
    ours = TensorParallel(model=model)
    for name, leaf in _flat(shapes).items():
        spec = _flat(sharding)[name].spec
        want = next((i for i, a in enumerate(spec) if a == "model"), None)
        assert ours.spec_dim(tuple(name.split("/")), leaf.shape) == want, name
    if kw is UNDIVIDABLE and model == 8:
        assert all(ours.spec_dim(tuple(n.split("/")), l.shape) is None
                   for n, l in _flat(shapes).items())


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pick_grid_matches_main_tp():
    main_tp = _load(ROOT / "main-tp.py", "main_tp")
    for n in range(1, 17):
        for heads in (1, 2, 3, 4, 5, 6, 8, 12, 16):
            assert tp.pick_grid(n, heads) == main_tp.pick_grid(n, heads), (n, heads)


def test_pick_serve_grid_matches_tpukit(capsys):
    for n in (1, 2, 3, 4, 6, 8):
        for heads in (1, 2, 4, 5, 6, 12):
            for slots in (1, 2, 3, 4, 6, 16):
                for paged in (False, True):
                    assert pick_serve_grid(n, heads, slots, paged) == tk_pick_serve_grid(
                        n, heads, slots, paged), (n, heads, slots, paged)
    capsys.readouterr()
    pick_serve_grid(8, 12, 16, paged=True, announce=False)
    assert capsys.readouterr().out == ""


def test_tp_refuses_moe_with_tpukit_message():
    cfg = GPTConfig(**TP_CONFIG, num_experts=4)
    tk_cfg = TkGPTConfig(**TP_CONFIG, num_experts=4)
    with pytest.raises(ValueError) as tk_err:
        TkTensorParallel(tk_create_mesh({"model": 2}, jax.devices()[:2])).validate_config(tk_cfg)
    with pytest.raises(ValueError) as err:
        TensorParallel(model=2).validate_config(cfg)
    assert str(err.value) == str(tk_err.value)


@pytest.fixture()
def world_of_one():
    mesh.initialize_runtime("cpu")
    try:
        yield
    finally:
        mesh.shutdown_runtime()


def _batch(vocab=160, rows=4, seq=32):
    rng = np.random.RandomState(11)
    ids = rng.randint(3, vocab, size=(rows, seq)).astype(np.int64)
    mask = np.zeros((rows, seq), dtype=bool)
    mask[1, 25:] = True
    targets = np.roll(ids, -1, axis=1)
    targets[mask] = -100
    batch = {"input_ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask),
             "position_ids": torch.arange(seq).expand(rows, seq).contiguous()}
    return batch, torch.from_numpy(targets)


def test_tp_world_of_one_is_the_unfused_single_device_step(world_of_one, monkeypatch):
    """In a world of one every Megatron operator is the identity: 3 f32
    steps of `TensorParallel` give the bits of `SingleDevice`'s unfused
    path (`TPUKIT_FUSED_HEAD=0`, three q/k/v products), and the losses of
    its default path within rtol 1e-5."""
    cfg = GPTConfig(**TP_CONFIG, compute_dtype=torch.float32)
    batch, targets = _batch()
    strategy = TensorParallel()
    tp_state = create_train_state(gpt.init_params(cfg, seed=0, device="cpu"), 1e-3, strategy)
    plain = create_train_state(gpt.init_params(cfg, seed=0, device="cpu"), 1e-3)
    fused = create_train_state(gpt.init_params(cfg, seed=0, device="cpu"), 1e-3)
    for _ in range(3):
        loss = float(train_step(tp_state, cfg, strategy, batch, targets))
        with monkeypatch.context() as m:
            m.setenv("TPUKIT_FUSED_HEAD", "0")
            want = float(train_step(plain, cfg.replace(fuse_qkv=False), SingleDevice(), batch,
                                    targets))
        assert loss == want
        np.testing.assert_allclose(
            loss, float(train_step(fused, cfg, SingleDevice(), batch, targets)), rtol=1e-5)
    for a, b in zip(leaves(tp_state.params), leaves(plain.params)):
        assert torch.equal(a, b)
    assert strategy.model_size == 1 and strategy.full_params(tp_state.params) is not None


def test_megatron_operators_at_a_group_of_one():
    x = torch.randn(2, 3, 8)
    for tp in (None, layers.ModelGroup()):
        assert layers.copy_to_model(x, tp) is x
        assert layers.reduce_from_model(x, tp) is x
        assert layers.gather_from_model(x, -1, tp) is x
    table = torch.randn(10, 4)
    ids = torch.tensor([[1, 9]])
    assert torch.equal(layers.vocab_parallel_embedding(table, ids, None), table[ids])
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert layers.vocab_parallel_argmax(logits, 4, 8).tolist() == [5]
    with pytest.raises(ValueError, match="cotangent"):
        layers.vocab_parallel_ce(logits, torch.tensor([1]), 0, cotangent="summed")


def test_fused_paged_attention_is_paged_attend_on_a_rank_s_heads():
    """The TP wrapper calls `paged_attend` on the heads it is given and
    raises tpukit's error where the heads do not divide the model degree."""
    torch.manual_seed(0)
    n, h, p, d, mp, pages = 2, 2, 4, 8, 3, 7
    pool_k, pool_v = torch.randn(pages, h, p, d), torch.randn(pages, h, p, d)
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    start = torch.tensor([5, 9], dtype=torch.int32)
    q, k, v = torch.randn(n, h, d), torch.randn(n, h, d), torch.randn(n, h, d)
    want = paged_attention.paged_attend(pool_k, pool_v, None, None, bt, start, q, k, v)
    got = paged_attention.fused_paged_attention(pool_k, pool_v, None, None, bt, start, q, k, v,
                                                tp=layers.ModelGroup(size=2), heads=4)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="heads=6 must divide model=4"):
        paged_attention.fused_paged_attention(pool_k, pool_v, None, None, bt, start, q, k, v,
                                              tp=layers.ModelGroup(size=4), heads=6)


class _Grid:
    """A stand-in for a `(data, model)` mesh: the engine reads its sizes
    before anything else."""

    def __init__(self, data, model):
        self.sizes = (data, model)

    def size(self, dim=None):
        return self.sizes[0] * self.sizes[1] if dim is None else self.sizes[dim]


@pytest.mark.parametrize("grid,serve,match", [
    ((2, 1), dict(page_size=8), "paged serving requires a model-only grid"),
    ((4, 2), dict(slots=3), "multiple of the mesh's data axis"),
], ids=["paged-data2", "slots"])
def test_engine_refuses_what_tpukit_refuses(grid, serve, match):
    cfg = GPTConfig(**{**TP_CONFIG, "max_position_embeddings": 64}, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        ServeEngine(gpt.init_params(cfg, device="cpu"), cfg,
                    ServeConfig(**{"buckets": (8,), **serve}), eos_id=1, device="cpu",
                    mesh=_Grid(*grid))


def test_tp_mesh_in_a_world_of_one(world_of_one):
    grid = mesh.create_tp_mesh(1, 1, "cpu")
    assert grid.mesh_dim_names == ("data", "model") and list(grid.get_coordinate()) == [0, 0]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.create_tp_mesh(1, 2, "cpu")


def test_tp_recipe_trains_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """`python -m tpukit_torch.recipes.tp --device cpu` as a plain module (a
    world of one): it trains, evaluates, samples and checkpoints, and
    leaves no process group behind."""
    monkeypatch.chdir(tmp_path)
    result = tp.main(["--batch_size", "4", "--epochs", "1", "--sequence_length", "32",
                      "--dim", "32", "--head_dim", "8", "--heads", "4", "--num_layers", "1",
                      "--dataset_slice", "8", "--num_workers", "0", "--disable_amp",
                      "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    assert np.isfinite(result.metrics["eval"]["loss"]) and len(result.metrics["samples"]) == 3
    assert result.checkpoint_path.exists()
