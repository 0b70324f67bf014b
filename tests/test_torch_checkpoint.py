"""Checkpoints between the port and tpukit, on the CPU at `tiny_config`
sizes: the port's standard-library msgpack codec against msgpack and flax,
tpukit's consolidated and sharded formats written by one package and read
by the other (whole train states and params-only reads, bit for bit, with
tpukit's I/O ledger), training resumed across the packages, `latest_any`'s
pick and the named errors.

Train states are stepped by tpukit's jitted `make_step_fns` step (f32, lr
1e-3) and by the port's `train_step` on the same batches; resumed steps are
held at `tests/test_torch_train.py`'s AdamW bars (losses rtol 1e-4 over 4
steps, parameters atol 2e-6).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import msgpack as mp
import numpy as np
import pytest
import torch
from flax import serialization

from tpukit import batching as tk_batching
from tpukit import checkpoint as tkc
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import TrainState as TkTrainState
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit.train import make_step_fns
from tpukit_torch import checkpoint as ckpt
from tpukit_torch import msgpack as codec
from tpukit_torch.bridge import params_from_numpy
from tpukit_torch.model import gpt
from tpukit_torch.shardings import SingleDevice, leaves, paths
from tpukit_torch.train import create_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LR = 1e-3


def _port_cfg(tk_cfg, **kw):
    return gpt.GPTConfig(dim=tk_cfg.dim, head_dim=tk_cfg.head_dim, heads=tk_cfg.heads,
                         num_layers=tk_cfg.num_layers, vocab_size=tk_cfg.vocab_size,
                         max_position_embeddings=tk_cfg.max_position_embeddings,
                         compute_dtype=torch.float32, **kw)


def _batches(vocab, n, seed=6):
    """`n` (model batch, targets) pairs: token ids with trailing pad."""
    rng, out = np.random.RandomState(seed), []
    for _ in range(n):
        ids = rng.randint(3, vocab, size=(3, 25)).astype(np.int32)
        mask = np.ones_like(ids)
        ids[1, 18:], mask[1, 18:] = 2, 0
        out.append(tk_batching.prepare_batch({"input_ids": ids, "attention_mask": mask}, 2))
    return out


def _port_batch(mb, tgt):
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in mb.items()},
            torch.from_numpy(tgt))


class _Tk:
    """tpukit's f32 train state and its jitted step."""

    def __init__(self, cfg, params):
        self.opt = tk_make_optimizer(LR)
        params = jax.tree.map(jnp.copy, params)  # the jitted step donates its state
        self.state = TkTrainState(params=params, opt_state=self.opt.init(params),
                                  step=jnp.int32(0))
        self.fn = make_step_fns(cfg, self.opt, TkSingleDevice(),
                                jax.eval_shape(lambda: self.state))[0]

    def step(self, mb, tgt) -> float:
        self.state, loss = self.fn(self.state, {k: jnp.asarray(v) for k, v in mb.items()},
                                   jnp.asarray(tgt))
        return float(loss)


def _flat(tree) -> dict:
    """A jax tree of dicts as {"a/b/c": numpy array}."""
    return {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_state_equals_tk(state, tk_state) -> None:
    """The port's train state holds tpukit's bit for bit: parameters, AdamW's
    exp_avg = mu, exp_avg_sq = nu, step and count."""
    adam = tk_state.opt_state[0]
    want = {"p": _flat(tk_state.params), "mu": _flat(adam.mu), "nu": _flat(adam.nu)}
    for n, p in zip(paths(state.params), leaves(state.params)):
        st = state.optimizer.state[p]
        for key, got in (("p", p), ("mu", st["exp_avg"]), ("nu", st["exp_avg_sq"])):
            assert np.array_equal(got.detach().numpy(), want[key][n]), (key, n)
        assert int(st["step"]) == int(adam.count)
    assert state.step == int(tk_state.step)


@pytest.fixture(scope="module")
def stepped(tiny_config, tiny_params):
    """tpukit's state and the port's, each two steps from the same
    parameters on the same batches."""
    tk = _Tk(tiny_config, tiny_params)
    state = create_train_state(params_from_numpy(jax.tree.map(np.asarray, tiny_params), "cpu"),
                               LR)
    cfg = _port_cfg(tiny_config)
    for mb, tgt in _batches(tiny_config.vocab_size, 2):
        tk.step(mb, tgt)
        train_step(state, cfg, SingleDevice(), *_port_batch(mb, tgt))
    return tk, state


def _fresh(tiny_config, seed=3):
    return create_train_state(gpt.init_params(_port_cfg(tiny_config), seed=seed, device="cpu"),
                              LR)


# ---------------------------------------------------------------- codec ----

_VALUES = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
           -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 0.1, -2.5e300,
           "", "a" * 31, "b" * 32, "é" * 200, "c" * 70000, b"", b"\x00" * 255, b"x" * 256,
           b"y" * 70000, list(range(15)), list(range(16)), list(range(70000)),
           {f"k{i}": i for i in range(15)}, {f"k{i}": [i] for i in range(16)},
           {f"k{i}": i for i in range(70000)}, [[], {}, [None]]]


@pytest.mark.parametrize("value", _VALUES, ids=lambda v: type(v).__name__ + str(len(
    v) if hasattr(v, "__len__") else repr(v)))
def test_codec_matches_msgpack(value):
    """Every msgpack type and width the port writes encodes as msgpack-python
    encodes it (`use_bin_type=True`, as flax packs), and decodes back."""
    blob = mp.packb(value, use_bin_type=True)
    assert codec.packb(value) == blob
    got = codec.unpackb(blob)

    def plain(v):
        if isinstance(v, memoryview):
            return bytes(v)
        if isinstance(v, list):
            return [plain(x) for x in v]
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v

    assert plain(got) == value


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 255, 256, 65536])
def test_codec_ext_types_of_every_length(n):
    """fixext 1-16 and ext 8/16/32: an unknown ext code comes back as `Ext`
    and re-encodes to the same bytes; float32 decodes."""
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    blob = mp.packb(mp.ExtType(42, data))
    assert codec.unpackb(blob) == codec.Ext(42, data)
    assert codec.packb(codec.Ext(42, data)) == blob
    assert codec.unpackb(mp.packb(1.5, use_single_float=True)) == 1.5


def test_codec_reads_flax_train_state_and_flax_reads_it(tiny_config, stepped):
    """`flax.serialization.to_bytes` of a stepped tpukit `TrainState`
    decodes into tensors bit-equal to its leaves (scalars as 0-dim int32,
    bfloat16 as torch.bfloat16, numpy and complex scalars), and flax's
    `msgpack_restore` reads the codec's encoding of what it decoded."""
    tk, _ = stepped
    extra = {"bf16": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
             "npscalar": np.float32(2.5), "complex": 1 + 2j, "empty": np.zeros((0, 3), np.int64)}
    blob = serialization.to_bytes({**serialization.to_state_dict(tk.state), "extra": extra})
    got = codec.unpackb(blob)
    ref = serialization.msgpack_restore(blob)
    assert set(got["opt_state"]) == {"0", "1", "2"} and got["opt_state"]["1"] == {}
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()
    assert got["extra"]["bf16"].dtype == torch.bfloat16
    assert got["extra"]["complex"] == 1 + 2j

    def check(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                check(a[k], b[k])
        elif isinstance(b, complex):
            assert a == b
        else:
            b = np.asarray(b)
            if b.dtype == jnp.bfloat16:
                a, b = a.view(torch.int16), b.view(np.int16)
            assert np.array_equal(np.asarray(a), b) and tuple(a.shape) == b.shape

    check(got, ref)
    back = serialization.msgpack_restore(codec.packb(got))
    check(codec.unpackb(serialization.msgpack_serialize(back)), ref)


def test_codec_chunked_arrays_both_ways(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes, chunked by flax (its limit lowered
    to 64 bytes) decode whole; chunked by the codec (its limit lowered the
    same way) flax reads whole."""
    import flax.serialization as fs

    tree = {"a": np.arange(100, dtype=np.float32).reshape(4, 25), "b": {"c": np.arange(7)}}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    blob = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = codec.unpackb(blob)
    assert np.array_equal(got["a"].numpy(), tree["a"]) and got["a"].shape == (4, 25)
    assert np.array_equal(got["b"]["c"].numpy(), tree["b"]["c"])
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    ours = codec.packb(got)
    assert b"__msgpack_chunked_array__" in ours
    back = fs.msgpack_restore(ours)
    assert np.array_equal(back["a"], tree["a"]) and np.array_equal(back["b"]["c"], tree["b"]["c"])


# ---------------------------------------------- tpukit writes, port reads --


@pytest.mark.parametrize("fmt", ["consolidated", "sharded"])
def test_tpukit_checkpoint_restores_in_the_port(tiny_config, stepped, tmp_path, fmt):
    """tpukit's `save` / `save_sharded` of a stepped state restore into a
    fresh port state bit for bit (`restore_any`), and `restore_params`
    gives its parameters bit for bit with tpukit's own `info` ledger."""
    tk, _ = stepped
    path = (tkc.save if fmt == "consolidated" else
            lambda s, d: tkc.save_sharded(s, d))(tk.state, tmp_path)
    assert ckpt.verify_checkpoint(path) == tkc.verify_checkpoint(path) == (True, "verified")
    state = _fresh(tiny_config)
    ckpt.restore_any(path, state)
    _assert_state_equals_tk(state, tk.state)
    params, info = ckpt.restore_params(path, gpt.init_params(_port_cfg(tiny_config),
                                                             device="meta"), "cpu")
    want = _flat(tk.state.params)
    for n, p in zip(paths(params), leaves(params)):
        assert np.array_equal(p.numpy(), want[n]), n
    assert info == tkc.restore_params(path, tk.state.params)[1]
    assert info["format"] == fmt
    if fmt == "sharded":  # the optimizer's two moments skipped
        assert info["bytes_skipped"] > 2 * info["bytes_read"] > 0


@pytest.mark.parametrize("fmt", ["consolidated", "sharded"])
def test_port_resumes_from_tpukit_as_tpukit_does(tiny_config, stepped, tmp_path, fmt):
    """Four more steps from tpukit's checkpoint, in each package from its
    own restore of it, on the same batches: losses within rtol 1e-4,
    parameters within atol 2e-6 (AdamW continues from count 2, so the bias
    corrections hold the count to torch's step)."""
    tk, _ = stepped
    path = (tkc.save if fmt == "consolidated" else
            lambda s, d: tkc.save_sharded(s, d))(tk.state, tmp_path)
    other = _Tk(tiny_config, tk.state.params)
    restored = (tkc.restore(other.state, path) if fmt == "consolidated"
                else tkc.restore_sharded(path, other.state))
    other.state = jax.tree.map(jnp.asarray, restored)
    state = _fresh(tiny_config)
    ckpt.restore_any(path, state)
    cfg = _port_cfg(tiny_config)
    for mb, tgt in _batches(tiny_config.vocab_size, 4, seed=9):
        tk_loss = other.step(mb, tgt)
        loss = train_step(state, cfg, SingleDevice(), *_port_batch(mb, tgt))
        np.testing.assert_allclose(float(loss), tk_loss, rtol=1e-4)
    assert state.step == int(other.state.step) == 6
    want = _flat(other.state.params)
    for n, p in zip(paths(state.params), leaves(state.params)):
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-6, err_msg=n)


# ---------------------------------------------- port writes, tpukit reads --


@pytest.mark.parametrize("fmt", ["consolidated", "sharded"])
def test_port_checkpoint_restores_in_tpukit(tiny_config, stepped, tmp_path, fmt):
    """The port's `save_consolidated` / `save_sharded` pass tpukit's
    `verify_checkpoint` and restore in tpukit (`restore` or
    `restore_sharded`, and `restore_params`) bit for bit; the port reads its
    own back the same, and its `info` equals tpukit's."""
    tk, state = stepped
    path = ckpt.save_auto(state, fmt, directory=tmp_path)
    assert path.name == f"checkpoint-step000000002.{'msgpack' if fmt == 'consolidated' else 'sharded'}"
    assert tkc.verify_checkpoint(path) == (True, "verified")
    restored = (tkc.restore(tk.state, path) if fmt == "consolidated"
                else tkc.restore_sharded(path, tk.state))
    _assert_state_equals_tk(state, restored)
    params, info = tkc.restore_params(path, tk.state.params)
    want = dict(zip(paths(state.params), leaves(state.params)))
    for n, v in _flat(params).items():
        assert np.array_equal(v, want[n].detach().numpy()), n
    assert ckpt.restore_params(path, gpt.init_params(_port_cfg(tiny_config), device="meta"),
                               "cpu")[1] == info
    again = _fresh(tiny_config)
    ckpt.restore_any(path, again)
    _assert_state_equals_tk(again, restored)


def test_fresh_state_saves_optax_init(tiny_config, tiny_params, tmp_path):
    """Before the first step AdamW has no state: the port writes optax's
    init (zero moments, count 0), which tpukit restores."""
    path = ckpt.save_consolidated(_fresh(tiny_config), tmp_path)
    restored = tkc.restore(_Tk(tiny_config, tiny_params).state, path)
    assert int(restored.step) == int(restored.opt_state[0].count) == 0
    assert not any(np.any(v) for v in _flat(restored.opt_state[0].mu).values())


def test_pipeline_padding_adapts_between_layouts(tiny_config, stepped, tmp_path):
    """tpukit's `_adapt_layer_axis`: a stack identity-padded from 2 to 3
    layers (an uneven pipeline's layout) restores into the 2-layer tree, and
    the 2-layer checkpoint into a 3-layer tree with a zero layer; a
    non-zero extra layer is refused with the vocab-pad hint."""
    _, state = stepped
    path = ckpt.save_consolidated(state, tmp_path)
    three = _fresh(tiny_config.replace(num_layers=3))
    ckpt.restore_any(path, three)
    for n, p in zip(paths(three.params), leaves(three.params)):
        if n.startswith("layers/"):
            assert not p[2].any(), n
    padded = ckpt.save_sharded(three, tmp_path / "padded")
    two = _fresh(tiny_config)
    ckpt.restore_any(padded, two)
    want = dict(zip(paths(state.params), leaves(state.params)))
    for n, p in zip(paths(two.params), leaves(two.params)):
        assert torch.equal(p, want[n]), n
    with torch.no_grad():
        three.params["layers"]["attn"]["q"]["kernel"][2] += 1.0
    bad = ckpt.save_sharded(three, tmp_path / "bad")
    with pytest.raises(ValueError, match="vocab_pad_multiple"):
        ckpt.restore_any(bad, _fresh(tiny_config))


# ------------------------------------------------ latest and the errors ----


def test_latest_any_matches_tpukit_and_skips_corrupt(tiny_config, stepped, tmp_path):
    """Over a directory holding both formats, `latest_any` picks what
    tpukit's picks; a checksum-mismatching newest one is skipped with a
    warning by both; the port's `.pt` is ordered by step with them and
    counts as unverified legacy."""
    tk, state = stepped
    tkc.save(tk.state, tmp_path)  # step 2
    first = tk.state.replace(step=jnp.int32(1))
    tkc.save_sharded(first, tmp_path)
    assert ckpt.latest_any(tmp_path) == tkc.latest_any(tmp_path)
    assert ckpt.latest_any(tmp_path).name == "checkpoint-step000000002.msgpack"
    newer = tkc.save_sharded(tk.state.replace(step=jnp.int32(5)), tmp_path)
    assert ckpt.latest_any(tmp_path) == tkc.latest_any(tmp_path) == newer
    shard = newer / "shard-00000.npz"
    shard.write_bytes(b"bitrot" + shard.read_bytes()[6:])
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        mine = ckpt.latest_any(tmp_path)
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        assert mine == tkc.latest_any(tmp_path)
    assert mine.name == "checkpoint-step000000002.msgpack"
    side = tkc.checksum_sidecar(mine)
    side.write_text("0" * 64)
    with pytest.warns(UserWarning, match="checksum mismatch"):
        assert ckpt.latest_any(tmp_path).name == "checkpoint-step000000001.sharded"
    pt = ckpt.save(state, directory=tmp_path)  # checkpoint-2.pt
    with pytest.warns(UserWarning):
        assert ckpt.latest_any(tmp_path) == pt
    assert ckpt.verify_checkpoint(pt) == (True, "unverified (no checksum sidecar; legacy)")
    assert ckpt.latest_any(tmp_path / "none") is None


def test_resume_metadata_is_read_as_tpukit_wrote_it(tiny_config, stepped, tmp_path):
    """tpukit's meta sidecar (`<file>.meta.json`, `resume.json` in a sharded
    directory) reads back through the port's `read_meta`; the port writes
    one only when a save is given `meta` (as `fit` gives every save), so
    these read as None, as tpukit reads them."""
    tk, state = stepped
    meta = {"epoch": 1, "batch": 3, "preempted": True}
    for path in (tkc.save(tk.state, tmp_path, meta=meta),
                 tkc.save_sharded(tk.state, tmp_path, meta=meta)):
        assert ckpt.meta_path(path) == tkc.meta_path(path)
        assert ckpt.read_meta(path) == tkc.read_meta(path) == meta
    for path in (ckpt.save_consolidated(state, tmp_path / "port"),
                 ckpt.save_sharded(state, tmp_path / "port")):
        assert ckpt.read_meta(path) is None and tkc.read_meta(path) is None


def test_named_errors(tiny_config, stepped, tmp_path):
    """tpukit's error texts: no `params` subtree, the vocab-pad hint on a
    shape mismatch, a missing shard file (and `verify_checkpoint` naming
    it), a leaf count that differs from the model's."""
    tk, state = stepped
    template = gpt.init_params(_port_cfg(tiny_config), device="meta")
    blob = tmp_path / "checkpoint-step000000001.msgpack"
    blob.write_bytes(codec.packb({"weights": np.zeros(3, np.float32)}))
    with pytest.raises(ValueError, match="has no 'params' subtree"):
        ckpt.restore_params(blob, template)
    with pytest.raises(ValueError, match="has no 'params' subtree"):
        ckpt.restore_any(blob, _fresh(tiny_config))
    path = ckpt.save_consolidated(state, tmp_path / "c")
    other = gpt.init_params(_port_cfg(tiny_config).replace(vocab_pad_multiple=1), device="meta")
    with pytest.raises(ValueError, match="vocab_pad_multiple"):
        ckpt.restore_params(path, other)
    with pytest.raises(ValueError, match="vocab_pad_multiple"):
        ckpt.restore_any(path, create_train_state(gpt.init_params(
            _port_cfg(tiny_config).replace(vocab_pad_multiple=1), device="cpu"), LR))
    moe = gpt.init_params(_port_cfg(tiny_config).replace(num_experts=2), device="meta")
    sharded = ckpt.save_sharded(state, tmp_path / "s")
    with pytest.raises(ValueError, match="must equal the training run's"):
        ckpt.restore_params(sharded, moe)
    with pytest.raises(ValueError, match="must equal the training run's"):
        ckpt.restore_params(path, moe)
    (sharded / "shard-00000.npz").unlink()
    assert ckpt.verify_checkpoint(sharded) == tkc.verify_checkpoint(sharded)
    assert ckpt.verify_checkpoint(sharded)[1] == "missing shard files ['shard-00000.npz']"
    with pytest.raises(FileNotFoundError, match="missing shard files"):
        ckpt.restore_any(sharded, _fresh(tiny_config))


def test_sharded_geometry_check_matches_tpukit(tiny_config, stepped, tmp_path):
    """A manifest that no longer fits its shards (a leaf's recorded shape
    changed after the save) fails both packages' `verify_checkpoint` with
    the same detail; a missing block shows as missing elements on
    restore."""
    _, state = stepped
    path = ckpt.save_sharded(state, tmp_path)
    manifest = json.loads((path / "manifest.json").read_text())
    bad = tmp_path / "bad.sharded"
    shutil.copytree(path, bad)
    manifest["leaves"][0]["shape"] = [manifest["leaves"][0]["shape"][0] * 2,
                                      *manifest["leaves"][0]["shape"][1:]]
    (bad / "manifest.json").write_text(json.dumps(manifest))
    ok, detail = ckpt.verify_checkpoint(bad)
    assert (ok, detail) == tkc.verify_checkpoint(bad)
    assert not ok and detail.startswith("world mismatch") and "elements" in detail
    with pytest.raises(ValueError, match="a shard-\\*.npz file is missing"):
        ckpt.restore_params(bad, gpt.init_params(_port_cfg(tiny_config), device="meta"))
