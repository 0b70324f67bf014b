"""Recipe 7 of the port (`ContextParallel`, the ring and Ulysses attention of
`tpukit_torch/ring_attention.py`) against tpukit's, on gloo worlds of 2 and
4 ranks on the CPU.

One spawn per world size (`tests/torch_cp_worker.py`, which imports only
`tpukit_torch`) runs every case of that size; the pytest process computes
tpukit's results for the same case on a mesh of as many fake CPU devices
while the ranks run.

Attention: `tests/test_ring_attention.py`'s inputs (`qkvm`: B 2, H 4, S 64,
D 8, row 0 padded from position 50) through the port's contiguous ring,
zigzag ring and Ulysses on a `seq` group of the whole world, against
tpukit's functions under `shard_map` on a `{"seq": P}` mesh, at that
file's bars: outputs within atol 1e-5 / rtol 1e-4, and the gradients of
`sum(where(valid, out, 0) ** 2)` within atol 1e-4 / rtol 1e-3. A ring
whose backward keeps each block's dk/dv on the rank that computed it must
fail the gradient bar.

Strategies: `tests/test_ring_attention.py`'s config and batch (dim 32,
4 heads x 8, 2 layers, vocab 151, S 32, batch 8, row 0 padded from 28) and
tpukit's initial parameters (`create_train_state(PRNGKey(0))`, bridged):
one step of `ContextParallel` on seq 2, seq 4, data 2 x seq 2, Ulysses
seq 2 and seq 4, and seq 2 at dropout 0.1 (step 0's key of seed 0, as
`tests/test_dropout.py`'s "cp" case draws masks), against tpukit's
`ContextParallel` on the same grid: loss, gradients and the parameters
after AdamW within atol 5e-5 / rtol 1e-4 (`test_cp_matches_single`'s
bar), the bf16 eval after the step within 1e-2 and 1.0 point; the step on
host-permuted batches (`host_batch_fn`, at S 33) within 1e-6 of the step
permuting inside (`test_cp_host_permuted_matches_injit`'s bar). Also
here: `zigzag_order` against tpukit's, tpukit's refusals with its
messages, the flags of `main-ring.py`, and recipe 7 on the CPU in a world
of one and on 2 gloo ranks.
"""

import contextlib
import fcntl
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpukit.compat import shard_map
from tpukit.flags import build_parser as tk_build_parser
from tpukit.mesh import create_mesh as tk_create_mesh
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.ring_attention import ring_causal_attention as tk_ring
from tpukit.ring_attention import ulysses_attention as tk_ulysses
from tpukit.ring_attention import zigzag_order as tk_zigzag_order
from tpukit.shardings import ContextParallel as TkContextParallel
from tpukit.train import create_train_state as tk_create_train_state
from tpukit.train import make_optimizer as tk_make_optimizer
import tpukit_torch
from tpukit_torch import checkpoint
from tpukit_torch.flags import NOT_CARRIED, build_parser, check_carried, parse_flags
from tpukit_torch.model import gpt
from tpukit_torch.recipes import ring, single
from tpukit_torch.ring_attention import zigzag_order
from tpukit_torch.shardings import ContextParallel
from tpukit_torch.train import create_train_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_cp_worker.py"
SPAWN_TIMEOUT = 240  # seconds a world may take; a hung collective fails the test
B, H, S, D = 2, 4, 64, 8  # tests/test_ring_attention.py's attention inputs
SCALE = D**-0.5
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
STEP_TOL = dict(atol=5e-5, rtol=1e-4)
BATCH, SEQ = 8, 32
CONFIG = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=151)


def _case(label, data, seq, attention="ring", dropout=0.0, host_permute=False,
          positions=SEQ):
    return dict(label=label, data=data, seq=seq, attention=attention, dropout=dropout,
                host_permute=host_permute, positions=positions)


# world -> the strategy cases its spawn runs; "hosted" and "injit" are held
# to each other, the rest to tpukit
CASES = {
    2: [_case("seq2", 1, 2), _case("ulysses2", 1, 2, "ulysses"),
        _case("dropout2", 1, 2, dropout=0.1)],
    4: [_case("seq4", 1, 4), _case("d2s2", 2, 2), _case("ulysses4", 1, 4, "ulysses"),
        _case("hosted", 1, 4, host_permute=True, positions=SEQ + 1),
        _case("injit", 1, 4, positions=SEQ + 1)],
}
TK_LABELS = [(w, c["label"]) for w, cs in CASES.items() for c in cs
             if c["label"] not in ("hosted", "injit")]
KINDS = ("contiguous", "zigzag", "ulysses")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _qkvm():
    """`tests/test_ring_attention.py`'s `qkvm`."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    mask = np.zeros((B, S), dtype=bool)
    mask[0, 50:] = True
    return q, k, v, mask


def _batch():
    """`tests/test_ring_attention.py`'s `batch`."""
    rng = np.random.RandomState(5)
    ids = rng.randint(3, CONFIG["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
    mask = np.zeros((BATCH, SEQ), dtype=bool)
    mask[0, 28:] = True
    targets = np.roll(ids, -1, axis=1).astype(np.int32)
    targets[mask] = -100
    positions = np.ascontiguousarray(np.broadcast_to(np.arange(SEQ, dtype=np.int32), ids.shape))
    return {"input_ids": ids, "position_ids": positions, "mask": mask}, targets


def _tk_cfg(positions=SEQ, dropout=0.0):
    return TkGPTConfig(**CONFIG, max_position_embeddings=positions, compute_dtype=jnp.float32,
                       dropout=dropout)


def _tk_attention(world: int) -> dict:
    """tpukit's ring (contiguous, zigzag) and Ulysses on a `{"seq": world}`
    mesh: outputs and the gradients of the masked square sum, in the
    natural order."""
    q, k, v, mask = (jnp.asarray(t) for t in _qkvm())
    mesh = tk_create_mesh({"seq": world}, jax.devices()[:world])
    spec = P(None, None, "seq")
    out = {}
    for kind in KINDS:
        order = zigzag_order(S, world) if kind == "zigzag" else np.arange(S)
        inv = np.argsort(order)

        def local(q, k, v, m, kind=kind):
            if kind == "ulysses":
                return tk_ulysses(q, k, v, scale=SCALE, axis_name="seq", pad_mask=m)
            return tk_ring(q, k, v, scale=SCALE, axis_name="seq", pad_mask=m, layout=kind)

        def attend(q, k, v, local=local, order=order, inv=inv):
            o = shard_map(local, mesh=mesh, in_specs=(spec, spec, spec, P(None, "seq")),
                          out_specs=spec, check_vma=False)(
                q[:, :, order], k[:, :, order], v[:, :, order], mask[:, order])
            return o[:, :, inv]

        def loss(q, k, v, attend=attend):
            return jnp.sum(jnp.where(~mask[:, None, :, None], attend(q, k, v), 0.0) ** 2)

        o = attend(q, k, v)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        out[kind] = dict(out=np.asarray(o), **{f"d{n}": np.asarray(g)
                                                for n, g in zip("qkv", grads)})
    return out


@jax.jit
def _tk_adamw(grads, params):
    """tpukit's first AdamW step (`make_optimizer(1e-3)`)."""
    opt = tk_make_optimizer(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, updates)


def _tk_step(world: int, case: dict, params, batch, targets) -> dict:
    """tpukit's `ContextParallel` on the case's grid: loss and gradients of
    its `value_and_grad` (dropout: step 0's key of seed 0, as its trainer
    folds it), the parameters after AdamW, the bf16 eval after it."""
    cfg = _tk_cfg(case["positions"], case["dropout"])
    axes = ({"seq": case["seq"]} if case["data"] == 1
            else {"data": case["data"], "seq": case["seq"]})
    strat = TkContextParallel(tk_create_mesh(axes, jax.devices()[:world]),
                              attention=case["attention"])
    rng = jax.random.fold_in(jax.random.PRNGKey(0 ^ 0x5EED), 0) if case["dropout"] else None
    loss, grads = jax.jit(lambda p: strat.value_and_grad(p, cfg, batch, targets, rng=rng))(
        params)
    stepped = _tk_adamw(grads, params)
    ecfg = cfg.replace(compute_dtype=jnp.bfloat16)
    ev_loss, ev_acc = jax.jit(lambda p: strat.loss_fn(p, ecfg, batch, targets,
                                                      with_accuracy=True))(stepped)
    return dict(loss=float(loss), grads=_flat(_np(grads)), params=_flat(_np(stepped)),
                eval_loss=float(ev_loss), eval_acc=float(ev_acc))


def _run_world(world: int, work: Path) -> dict:
    """One spawn of `world` ranks running every case of that world in
    `work`, and tpukit's results computed while they run."""
    q, k, v, mask = _qkvm()
    model_batch, targets = _batch()
    init = _np(tk_create_train_state(jax.random.PRNGKey(0), _tk_cfg(),
                                     tk_make_optimizer(1e-3)).params)
    np.savez(work / "inputs.npz", **{"attn/q": q, "attn/k": k, "attn/v": v, "attn/mask": mask,
                                     "attn/scale": np.float64(SCALE)},
             config=json.dumps(CONFIG), cases=json.dumps(CASES[world]), targets=targets,
             **model_batch, **{f"param/{n}": t for n, t in _flat(init).items()})
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [(subprocess.Popen([sys.executable, str(WORKER), str(work / "inputs.npz"),
                                str(work), str(world), str(r)],
                               stdout=open(work / f"rank{r}.log", "w"), stderr=subprocess.STDOUT,
                               env=env), work / f"rank{r}.log") for r in range(world)]
    try:
        refs = dict(attention=_tk_attention(world))
        for case in CASES[world]:
            if case["label"] not in ("hosted", "injit"):
                refs[case["label"]] = _tk_step(world, case, init, model_batch, targets)
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p, _ in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {world}-rank world did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log.read_text()[-4000:]}"
    return dict(got=dict(np.load(work / "result.npz")), refs=refs)


@contextlib.contextmanager
def _shared(tmp_path_factory, name: str):
    """Under pytest-xdist, a file every worker of this run reads `name`
    from, held under a lock while one worker makes it; None otherwise."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        yield None
        return
    root = tmp_path_factory.getbasetemp().parent / f"torch_cp_{run}"
    root.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield root / f"{name}.pkl"
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """`worlds(n)`: the n-rank spawn's results and tpukit's, once a test
    run (shared between xdist workers)."""
    cache: dict = {}

    def run(world: int) -> dict:
        if world not in cache:
            with _shared(tmp_path_factory, f"world{world}") as path:
                if path is not None and path.exists():
                    cache[world] = pickle.loads(path.read_bytes())
                else:
                    cache[world] = _run_world(world, tmp_path_factory.mktemp(f"cp{world}"))
                    if path is not None:
                        path.write_bytes(pickle.dumps(cache[world]))
        return cache[world]

    return run


@pytest.mark.parametrize("seq_len,ring_size", [(64, 2), (64, 4), (32, 8), (8193 - 1, 4),
                                               (2048, 4), (12, 3)])
def test_zigzag_order_equals_tpukit(seq_len, ring_size):
    np.testing.assert_array_equal(zigzag_order(seq_len, ring_size),
                                  tk_zigzag_order(seq_len, ring_size))
    with pytest.raises(ValueError, match="zigzag needs"):
        zigzag_order(seq_len + 1, ring_size)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_attention_matches_tpukit(worlds, world, kind):
    """The port's ring (contiguous, zigzag) and Ulysses over `world` gloo
    ranks against tpukit's under `shard_map`: outputs at OUT_TOL, the
    gradients at GRAD_TOL (`tests/test_ring_attention.py`'s bars)."""
    run = worlds(world)
    got, ref = run["got"], run["refs"]["attention"][kind]
    np.testing.assert_allclose(got[f"attn/{kind}/out"], ref["out"], **OUT_TOL)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[f"attn/{kind}/{name}"], ref[name], **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_whose_grads_stay_put_fails_the_bar(worlds, world):
    """The negative control: with each block's dk/dv kept on the rank that
    computed it, the forward is the same, dq too, and dk/dv fail the
    gradient bar."""
    run = worlds(world)
    got, ref = run["got"], run["refs"]["attention"]["zigzag"]
    np.testing.assert_allclose(got["attn/control/out"], ref["out"], **OUT_TOL)
    np.testing.assert_allclose(got["attn/control/dq"], ref["dq"], **GRAD_TOL)
    for name in ("dk", "dv"):
        assert not np.allclose(got[f"attn/control/{name}"], ref[name], **GRAD_TOL), name


@pytest.mark.parametrize("world,label", TK_LABELS, ids=[lab for _, lab in TK_LABELS])
def test_cp_step_matches_tpukit(worlds, world, label):
    """One step of the port's `ContextParallel` on gloo ranks against
    tpukit's on the same grid: loss, gradients and stepped parameters at
    STEP_TOL, bf16 eval within 1e-2 and 1.0 point."""
    run = worlds(world)
    got, ref = run["got"], run["refs"][label]
    assert abs(float(got[f"{label}/loss"]) - ref["loss"]) < STEP_TOL["atol"]
    assert abs(float(got[f"{label}/eval_loss"]) - ref["eval_loss"]) < 1e-2
    assert abs(float(got[f"{label}/eval_acc"]) - ref["eval_acc"]) < 1.0
    for kind in ("grad", "param"):
        want = ref["grads" if kind == "grad" else "params"]
        names = {k[len(f"{label}/{kind}/"):] for k in got if k.startswith(f"{label}/{kind}/")}
        assert names == set(want)
        for name, value in want.items():
            np.testing.assert_allclose(got[f"{label}/{kind}/{name}"], value, **STEP_TOL,
                                       err_msg=f"{kind} {name}")


def test_cp_dropout_masks_matter(worlds):
    """At dropout 0.1 the masks move the loss (the case above holds it to
    tpukit's)."""
    got = worlds(2)["got"]
    assert abs(float(got["dropout2/loss"]) - float(got["seq2/loss"])) > 1e-4


def test_cp_host_permuted_matches_injit(worlds):
    """The zigzag permutation applied to the host batch (`host_batch_fn`,
    as `fit` applies it) gives the step that permutes inside the loss,
    within 1e-6."""
    got = worlds(4)["got"]
    for key in ("loss", "eval_loss", "eval_acc"):
        assert abs(float(got[f"hosted/{key}"]) - float(got[f"injit/{key}"])) < 1e-6, key
    for k in got:
        if k.startswith("hosted/param/"):
            np.testing.assert_allclose(got[k], got["injit/" + k[len("hosted/"):]], atol=1e-6,
                                       rtol=0, err_msg=k)


def _refusal(make_tk, make_port, call):
    with pytest.raises(ValueError) as theirs:
        call(make_tk())
    with pytest.raises(ValueError) as ours:
        call(make_port())
    assert str(ours.value) == str(theirs.value)


def test_cp_refusals_carry_tpukit_messages():
    """MoE, an undividable sequence (at validation and in the loss) and
    undividable heads under Ulysses raise tpukit's ValueErrors, word for
    word."""
    mesh = lambda n: tk_create_mesh({"seq": n}, jax.devices()[:n])
    cfg33 = lambda: dict(max_position_embeddings=33)
    tk_cfg = lambda **kw: TkGPTConfig(**CONFIG, compute_dtype=jnp.float32,
                                      **{**cfg33(), **kw})
    cfg = lambda **kw: gpt.GPTConfig(**CONFIG, compute_dtype=torch.float32, **{**cfg33(), **kw})
    _refusal(lambda: (TkContextParallel(mesh(8)), tk_cfg(num_experts=4)),
             lambda: (ContextParallel(seq=8), cfg(num_experts=4)),
             lambda sc: sc[0].validate_config(sc[1]))
    _refusal(lambda: (TkContextParallel(mesh(5)), tk_cfg()),
             lambda: (ContextParallel(seq=5), cfg()),
             lambda sc: sc[0].validate_config(sc[1]))
    _refusal(lambda: (TkContextParallel(mesh(8), attention="ulysses"), tk_cfg()),
             lambda: (ContextParallel(seq=8, attention="ulysses"), cfg()),
             lambda sc: sc[0].validate_config(sc[1]))
    model_batch, targets = _batch()
    tb = {k: torch.from_numpy(v) for k, v in model_batch.items()}
    _refusal(lambda: (TkContextParallel(mesh(5)), tk_cfg(max_position_embeddings=SEQ)),
             lambda: (ContextParallel(seq=5), cfg(max_position_embeddings=SEQ)),
             lambda sc: sc[0].loss_fn(None, sc[1],
                                      tb if isinstance(sc[0], ContextParallel) else model_batch,
                                      torch.from_numpy(targets)
                                      if isinstance(sc[0], ContextParallel) else targets))
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        ContextParallel(attention="flash")


def test_ring_flags_parse_as_main_ring():
    """`--cp_attention` parses as `main-ring.py`'s parser has it (every flag
    with tpukit's default) and is carried; the strategy's host permutation
    is on only with the zigzag layout."""
    ours = {a.dest: a for a in build_parser(cp_attention=True)._actions}
    for action in tk_build_parser(cp_attention=True)._actions:
        if action.dest != "help":
            assert ours[action.dest].default == action.default, action.dest
            assert ours[action.dest].choices == action.choices, action.dest
    flags = parse_flags(["--cp_attention", "ulysses"], cp_attention=True)
    assert flags.cp_attention == "ulysses" and "cp_attention" not in NOT_CARRIED
    check_carried(flags)
    cfg = gpt.GPTConfig(**CONFIG, max_position_embeddings=SEQ + 1)
    assert ContextParallel(seq=4, host_permute=True).host_batch_fn(cfg) is not None
    assert ContextParallel(seq=4).host_batch_fn(cfg) is None
    assert ContextParallel(seq=4, attention="ulysses", host_permute=True).host_batch_fn(cfg) \
        is None
    assert ContextParallel(seq=1, host_permute=True).host_batch_fn(cfg) is None


RECIPE_ARGS = ["--epochs", "1", "--sequence_length", "65", "--dim", "32", "--head_dim", "8",
               "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
               "--dataset_slice", "80", "--num_workers", "0", "--disable_amp", "--batch_size",
               "8", "--device", "cpu"]


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """Recipe 1 in this process: the reference of recipe 7's runs."""
    work = tmp_path_factory.mktemp("single")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        return single.main(RECIPE_ARGS)
    finally:
        os.chdir(cwd)


def test_ring_recipe_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        ring.main([a for a in RECIPE_ARGS if a not in ("--device", "cpu")])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_ring_recipe_trains_on_the_cpu_when_asked(attention, single_run, tmp_path, monkeypatch):
    """`python -m tpukit_torch.recipes.ring --device cpu` as a plain module
    (a world of one): it trains, evaluates, samples and checkpoints as
    recipe 1 does (window losses within rtol 1e-4), and leaves no process
    group behind."""
    monkeypatch.chdir(tmp_path)
    result = ring.main(RECIPE_ARGS + ["--cp_attention", attention])
    assert not torch.distributed.is_initialized()
    assert len(result.metrics["samples"]) == 3 and result.checkpoint_path.exists()
    np.testing.assert_allclose([w["loss"] for w in result.metrics["train_windows"]],
                               [w["loss"] for w in single_run.metrics["train_windows"]],
                               rtol=1e-4)
    np.testing.assert_allclose(result.metrics["eval"]["loss"],
                               single_run.metrics["eval"]["loss"], rtol=2e-2)


def test_ring_recipe_on_two_ranks_matches_single_device(single_run, tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    tpukit_torch.recipes.ring --device cpu` (seq 2, the zigzag ring over
    the host-permuted batch) against recipe 1 on the same rows: one set of
    rank-0 lines, the window loss within rtol 1e-4 (plus the print's half
    unit), eval within the bf16 bands (rtol 2e-2, 1.5 points), and a
    checkpoint that restores into a `SingleDevice` state."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "tpukit_torch.recipes.ring", *RECIPE_ARGS]
    try:
        proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"recipe 7 on 2 ranks did not finish in {SPAWN_TIMEOUT} s")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    windows = [float(l.rsplit("loss: ", 1)[1]) for l in lines if l.startswith("[training]")]
    evals = [l for l in lines if l.startswith("[validation]")]
    assert len(evals) == 1 and sum(l.startswith("throughput") for l in lines) == 1, proc.stdout
    ref = single_run.metrics
    assert len(windows) == len(ref["train_windows"]) >= 1
    np.testing.assert_allclose(windows, [w["loss"] for w in ref["train_windows"]], rtol=1e-4,
                               atol=5e-4)
    loss = float(evals[0].split("loss: ")[1].split(",")[0])
    acc = float(evals[0].split("accuracy: ")[1])
    np.testing.assert_allclose(loss, ref["eval"]["loss"], rtol=2e-2)
    assert abs(acc - ref["eval"]["accuracy"]) <= 1.5
    path = tmp_path / "checkpoints" / f"checkpoint-{single_run.state.step}.pt"
    other = create_train_state(gpt.init_params(single_run.config, device="cpu"), 1e-3)
    checkpoint.restore(path, other)
    assert other.step == single_run.state.step
