"""Recipe 1 of the port against tpukit on the same weights and data: the
model's logits and every parameter gradient, the data path, five AdamW
steps, the recipe end to end, checkpoints, the bridge, the device rule and
the flags.

Everything runs on the CPU, where the port's kernels take their plain
versions and tpukit's Pallas kernels run in interpret mode. Weights are
tpukit's `init_params`, bridged; inputs are numpy from fixed seeds.
Tolerances are stated where they are used.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit import batching as tk_batching
from tpukit import data as tk_data
from tpukit import loader as tk_loader
from tpukit.flags import build_parser as tk_build_parser
from tpukit.flags import parse_flags as tk_parse_flags
from tpukit.model import gpt as tk_gpt
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import fit as tk_fit
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit.train import make_step_fns
from tpukit.train import TrainState as TkTrainState
import tpukit_torch
from tpukit_torch import NotPortedError, checkpoint, data, loader
from tpukit_torch.batching import prepare_batch
from tpukit_torch.bridge import params_from_numpy, params_to_numpy
from tpukit_torch.flags import NOT_CARRIED, build_parser, parse_flags
from tpukit_torch.model import gpt
from tpukit_torch.recipes import single
from tpukit_torch.shardings import SingleDevice, leaves
from tpukit_torch.train import create_train_state, train_step

CPU = torch.device("cpu")


def _port_config(tk_cfg, **kw):
    return gpt.GPTConfig(
        dim=tk_cfg.dim, head_dim=tk_cfg.head_dim, heads=tk_cfg.heads,
        num_layers=tk_cfg.num_layers, vocab_size=tk_cfg.vocab_size,
        max_position_embeddings=tk_cfg.max_position_embeddings,
        compute_dtype=torch.float32, **kw)


def _bridge(tk_params):
    return params_from_numpy(jax.tree.map(np.asarray, tk_params), device="cpu")


def _raw_batch(rng, vocab, b=3, s=25):
    """Token ids below `vocab` with trailing pad (id 2) on two rows."""
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), dtype=np.int32)
    ids[1, 18:], mask[1, 18:] = 2, 0
    ids[2, 9:], mask[2, 9:] = 2, 0
    return {"input_ids": ids, "attention_mask": mask}


def _tensors(model_batch, targets):
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in model_batch.items()},
            torch.from_numpy(targets))


# ---------------------------------------------------------------- model ----


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_tpukit(tiny_config, tiny_params, impl):
    """Logits and hidden states, f32, at tpukit's own model bar
    (tests/test_flash_attention.py:84, atol 1e-4 / rtol 1e-4), every
    position: the padded query rows still see unpadded keys."""
    rng = np.random.RandomState(0)
    mb, _ = tk_batching.prepare_batch(_raw_batch(rng, tiny_config.vocab_size), 2)
    tk_cfg = tiny_config.replace(attention_impl=impl)
    cfg = _port_config(tiny_config, attention_impl=impl)
    params = _bridge(tiny_params)
    args = (mb["input_ids"], mb["position_ids"], mb["mask"])
    tb, _ = _tensors(mb, np.zeros(1, np.int32))
    targs = (tb["input_ids"], tb["position_ids"], tb["mask"])
    np.testing.assert_allclose(gpt.forward(params, cfg, *targs).numpy(),
                               np.asarray(tk_gpt.forward(tiny_params, tk_cfg, *args)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gpt.forward_hidden(params, cfg, *targs).numpy(),
                               np.asarray(tk_gpt.forward_hidden(tiny_params, tk_cfg, *args)),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", ["fused-qkv", "unfused-qkv-remat"])
def test_loss_and_every_gradient_match_tpukit(tiny_config, tiny_params, variant):
    """`loss_fn` (fused head on both sides: the port's plain version against
    tpukit's Pallas kernel) and the gradient of every parameter. f32: loss
    rtol 1e-5, gradients atol 1e-5 / rtol 1e-4 (summation order through two
    layers); accuracy exactly."""
    rng = np.random.RandomState(1)
    mb, tgt = tk_batching.prepare_batch(_raw_batch(rng, tiny_config.vocab_size), 2)
    kw = {} if variant == "fused-qkv" else dict(fuse_qkv=False, remat_layers=True)
    tk_cfg = tiny_config.replace(**kw)
    cfg = _port_config(tiny_config, **kw)

    strategy = TkSingleDevice()
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    tk_loss, tk_grads = jax.value_and_grad(
        lambda p: strategy.loss_fn(p, tk_cfg, jb, jnp.asarray(tgt))[0])(tiny_params)
    _, tk_acc = strategy.loss_fn(tiny_params, tk_cfg, jb, jnp.asarray(tgt), with_accuracy=True)

    params = _bridge(tiny_params)
    for p in leaves(params):
        p.requires_grad_(True)
    tb, tt = _tensors(mb, tgt)
    loss, grads = SingleDevice().value_and_grad(params, cfg, tb, tt)
    _, acc = SingleDevice().loss_fn(params, cfg, tb, tt, with_accuracy=True)
    np.testing.assert_allclose(float(loss), float(tk_loss), rtol=1e-5)
    assert float(acc) == pytest.approx(float(tk_acc), abs=1e-4)
    ours, ref = params_to_numpy(grads), jax.tree.map(np.asarray, tk_grads)
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_ours) == len(flat_ref)
    for path, g in flat_ours:
        np.testing.assert_allclose(g, flat_ref[path], atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_unfused_head_path_matches_fused(tiny_config, tiny_params, monkeypatch):
    """`TPUKIT_FUSED_HEAD=0` routes the loss through full logits; same loss."""
    rng = np.random.RandomState(2)
    tb, tt = _tensors(*prepare_batch(_raw_batch(rng, tiny_config.vocab_size), 2))
    cfg, params = _port_config(tiny_config), _bridge(tiny_params)
    fused, _ = SingleDevice().loss_fn(params, cfg, tb, tt, with_accuracy=True)
    monkeypatch.setenv("TPUKIT_FUSED_HEAD", "0")
    unfused, _ = SingleDevice().loss_fn(params, cfg, tb, tt, with_accuracy=True)
    np.testing.assert_allclose(float(unfused), float(fused), rtol=1e-6)


def test_dropout_is_not_ported():
    with pytest.raises(NotPortedError, match="item 9"):
        gpt.GPTConfig(dropout=0.1)


# ----------------------------------------------------------------- data ----


def test_prepare_batch_matches_tpukit():
    raw = _raw_batch(np.random.RandomState(3), 50)
    ours, ref = prepare_batch(raw, 2), tk_batching.prepare_batch(raw, 2)
    for k in ref[0]:
        assert ours[0][k].dtype == ref[0][k].dtype and np.array_equal(ours[0][k], ref[0][k])
    assert ours[1].dtype == ref[1].dtype and np.array_equal(ours[1], ref[1])


def test_dataset_and_tokenizer_padding_match_tpukit():
    tok, tk_tok = data.get_tokenizer(), tk_data.get_tokenizer()
    tok.pad_token_id = tk_tok.pad_token_id = 2
    for split in range(2):
        ours = data.transform_dataset(data.get_dataset("40")[split], tok, max_length=24)
        ref = tk_data.transform_dataset(tk_data.get_dataset(slice_size="40")[split], tk_tok,
                                        max_length=24)
        assert ours.input_ids.dtype == np.int32 and ours.input_ids.shape == ref.input_ids.shape
        assert np.array_equal(ours.input_ids, ref.input_ids)
        assert np.array_equal(ours.attention_mask, ref.attention_mask)
    assert data._parse_slice(4096, "50%") == tk_data._parse_slice(4096, "50%") == 2048


@pytest.mark.parametrize("pad_mode", ["wrap", "empty"])
@pytest.mark.parametrize("replicas", [1, 3])
def test_loader_batches_match_tpukit_over_two_epochs(pad_mode, replicas):
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 50, size=(37, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    ours_ds, ref_ds = data.ArrayDataset(ids, mask), tk_data.ArrayDataset(ids, mask)
    kw = dict(shuffle=True, seed=5, pad_to_batch=True, pad_mode=pad_mode, pad_fill=2,
              num_replicas=replicas, rank=replicas - 1)
    ours, ref = loader.DataLoader(ours_ds, 8, **kw), tk_loader.DataLoader(ref_ds, 8, **kw)
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ours) == len(ref)
        for x, y in zip(a, b):
            assert x["real_rows"] == y["real_rows"]
            assert np.array_equal(x["input_ids"], y["input_ids"])
            assert np.array_equal(x["attention_mask"], y["attention_mask"])
    for r in range(3):
        assert np.array_equal(loader.distributed_indices(37, 3, r, seed=1, epoch=1),
                              tk_loader.distributed_indices(37, 3, r, seed=1, epoch=1))


# ------------------------------------------------------------- training ----


def test_five_adamw_steps_match_tpukit(tiny_config, tiny_params):
    """Five steps of the port's `train_step` against tpukit's jitted
    `make_step_fns` step, f32, from the same parameters on the same batches
    (lr 1e-3). torch's AdamW applies the decay as p * (1 - lr wd) before the
    Adam update and divides by sqrt(v) / sqrt(bias correction); optax adds
    lr wd p to the update and takes sqrt(v_hat): the same arithmetic in
    another rounding order. Losses within rtol 1e-5 (measured 1.0e-7);
    parameters within atol 2e-6 after five steps (measured 1.19e-6, about 2
    ulp of the largest parameters, while parameters moved by up to
    5.0e-3)."""
    tk_cfg = tiny_config
    cfg = _port_config(tiny_config)
    opt = tk_make_optimizer(1e-3)
    tk_params = jax.tree.map(jnp.copy, tiny_params)  # the jitted step donates its state
    tk_state = TkTrainState(params=tk_params, opt_state=opt.init(tk_params),
                            step=jnp.int32(0))
    step_fn, _, _ = make_step_fns(tk_cfg, opt, TkSingleDevice(),
                                  jax.eval_shape(lambda: tk_state))
    state = create_train_state(_bridge(tiny_params), 1e-3)
    rng = np.random.RandomState(6)
    for _ in range(5):
        mb, tgt = tk_batching.prepare_batch(_raw_batch(rng, tiny_config.vocab_size), 2)
        tk_state, tk_loss = step_fn(tk_state, {k: jnp.asarray(v) for k, v in mb.items()},
                                    jnp.asarray(tgt))
        loss = train_step(state, cfg, SingleDevice(), *_tensors(mb, tgt))
        np.testing.assert_allclose(float(loss), float(tk_loss), rtol=1e-5)
    assert state.step == int(tk_state.step) == 5
    ours = params_to_numpy(state.params)
    ref = jax.tree.map(np.asarray, tk_state.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, atol=2e-6, err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------- recipe ----

RECIPE_ARGS = [
    "--batch_size", "8", "--epochs", "1", "--sequence_length", "64", "--dim", "32",
    "--head_dim", "8", "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
    "--dataset_slice", "80", "--num_workers", "0", "--disable_amp",
]


@pytest.fixture(scope="module")
def tpukit_recipe(tmp_path_factory):
    """tpukit's `fit` once for the module: its window losses (JSONL), eval
    metrics, sample texts and initial parameters."""
    out = tmp_path_factory.mktemp("tpukit_recipe")
    log = out / "metrics.jsonl"
    flags = tk_parse_flags(RECIPE_ARGS + ["--metrics_log", str(log), "--prefetch", "0"])
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
            result = tk_fit(flags, TkSingleDevice())
        finally:
            tk_train.generate_samples = real
    finally:
        os.chdir(cwd)
    records = [json.loads(line) for line in log.read_text().splitlines()]
    tok = tk_data.get_tokenizer()
    tk_cfg = tk_gpt.GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2,
                              vocab_size=tok.vocab_size, max_position_embeddings=64,
                              compute_dtype=jnp.float32)
    init = tk_gpt.init_params(jax.random.PRNGKey(flags.seed), tk_cfg)
    return dict(windows=[r["loss"] for r in records if r.get("kind") == "train"],
                eval=result.metrics["eval"], texts=texts, init=init, config=tk_cfg)


def test_recipe_matches_tpukit_fit(tpukit_recipe, tmp_path, monkeypatch):
    """`python -m tpukit_torch.recipes.single --device cpu` from tpukit's
    initial parameters (a port checkpoint at step 0, `--resume`) against
    tpukit's `fit` on the fixture corpus: train window losses within f32
    bars (rtol 1e-4 after nine AdamW steps), eval loss and accuracy within
    bf16 bands (both evaluate in bf16: rtol 2e-2, 1.5 accuracy points), and
    the three greedy sample texts equal."""
    monkeypatch.chdir(tmp_path)
    cfg = _port_config(tpukit_recipe["config"])
    state = create_train_state(_bridge(tpukit_recipe["init"]), 1e-3)
    start = checkpoint.save(state, directory=str(tmp_path / "init"))
    result = single.main(RECIPE_ARGS + ["--device", "cpu", "--resume", str(start)])
    ours = [w["loss"] for w in result.metrics["train_windows"]]
    assert len(ours) == len(tpukit_recipe["windows"]) >= 1
    np.testing.assert_allclose(ours, tpukit_recipe["windows"], rtol=1e-4)
    np.testing.assert_allclose(result.metrics["eval"]["loss"], tpukit_recipe["eval"]["loss"],
                               rtol=2e-2)
    assert abs(result.metrics["eval"]["accuracy"] - tpukit_recipe["eval"]["accuracy"]) <= 1.5
    assert result.metrics["samples"] == tpukit_recipe["texts"]
    assert result.config == cfg.replace(max_position_embeddings=64)
    assert result.checkpoint_path.exists()
    assert result.checkpoint_path.with_suffix(".json").exists()


# ----------------------------------------------------------- checkpoint ----


def test_checkpoint_round_trip_and_resume(tiny_config, tiny_params, tmp_path, monkeypatch):
    cfg = _port_config(tiny_config)
    state = create_train_state(_bridge(tiny_params), 1e-3)
    batch = _tensors(*prepare_batch(_raw_batch(np.random.RandomState(7), 97), 2))
    for _ in range(2):
        train_step(state, cfg, SingleDevice(), *batch)
    path = checkpoint.save(state, flags=parse_flags(["--device", "cpu"]),
                           directory=str(tmp_path))
    assert path.name == "checkpoint-2.pt"
    assert json.loads(path.with_suffix(".json").read_text())["device"] == "cpu"

    # the port's own init: the same tree with its keys in another order
    other = create_train_state(gpt.init_params(cfg, seed=3, device="cpu"), 1e-3)
    checkpoint.restore(path, other)
    assert other.step == 2

    def same(x, y):
        a = dict(zip(checkpoint.paths(x.params), leaves(x.params)))
        b = dict(zip(checkpoint.paths(y.params), leaves(y.params)))
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)

    same(other, state)
    # the restored optimizer continues exactly as the original one
    train_step(state, cfg, SingleDevice(), *batch)
    train_step(other, cfg, SingleDevice(), *batch)
    same(other, state)

    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path / "missing.pt", other)
    small = create_train_state(gpt.init_params(cfg.replace(num_layers=1), device="cpu"), 1e-3)
    with pytest.raises(ValueError, match="another parameter tree"):
        checkpoint.restore(path, small)


def test_recipe_resume_continues_from_the_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = RECIPE_ARGS[:] + ["--device", "cpu"]
    args[args.index("--dataset_slice") + 1] = "16"
    first = single.main(args + ["--checkpoint_every", "1"])
    assert first.state.step == 2
    assert (tmp_path / "checkpoints" / "checkpoint-1.pt").exists()  # periodic
    second = single.main(args + ["--resume", str(first.checkpoint_path)])
    assert second.state.step == 4
    assert (tmp_path / "checkpoints" / "checkpoint-4.pt").exists()
    assert not (tmp_path / "checkpoints" / "checkpoint-3.pt").exists()


# ---------------------------------------------------------- bridge etc. ----


def test_bridge_round_trip(tiny_params):
    tree = jax.tree.map(np.asarray, tiny_params)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


def test_recipe_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        single.main(RECIPE_ARGS)


def test_every_tpukit_flag_parses():
    tk_parser = tk_build_parser()
    ours = {a.dest: a for a in build_parser()._actions}
    for action in tk_parser._actions:
        if action.dest == "help":
            continue
        assert action.dest in ours, action.dest
        assert ours[action.dest].default == action.default, action.dest
    assert parse_flags([]).device == "cuda"


@pytest.mark.parametrize("argv,item", [
    (["--chaos_spec", "nan_loss@3"], "item 17"),
    (["--on_anomaly", "rollback"], "item 17"),
    (["--heartbeat_dir", "hb"], "item 17"),
    (["--async_checkpoint"], "item 17"),
    (["--comm_dtype", "int8"], "item 16"),
    (["--grad_buckets", "2"], "item 16"),
    (["--metrics_log", "m.jsonl"], "item 18"),
    (["--dropout", "0.1"], "item 9"),
    (["--checkpoint_format", "sharded"], "item 6"),
    (["--resume", "latest"], "item 17"),
])
def test_flags_not_carried_raise_with_their_roadmap_item(argv, item):
    with pytest.raises(NotPortedError, match=item):
        single.main(argv + ["--device", "cpu"])
    assert set(NOT_CARRIED) <= set(vars(parse_flags([])))
