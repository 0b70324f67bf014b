"""Recipes 4 and 5 of the port (`Pipeline`, `Pipeline1F1B`, the (data,
stage) grid) against tpukit's, on gloo worlds of 2, 3 and 4 ranks on the
CPU.

One spawn per world size (`tests/torch_pipe_worker.py`, which imports only
`tpukit_torch`) runs every case of that size in sequence; the pytest
process computes tpukit's results for the same case on a mesh of as many
fake CPU devices, `{"stage": S}` or `{"data": D, "stage": S}`, from the
same parameters (tpukit's `init_params(PRNGKey(0))`, bridged) and the same
batch (`tests/test_strategies.py`'s: dim 32, 4 heads x 8, 4 layers, vocab
211 padded to 256, S 32, batch 16, trailing padding on every third row).
tpukit's step is its `value_and_grad` (jitted) followed by its AdamW
update, as `make_step_fns` composes them, and its bf16 eval after it.

Bars: the loss within 1e-5 of tpukit's; every gradient leaf, in tpukit's
layout (identity-padded, chunk-permuted at V > 1), within atol 5e-5 / rtol
1e-4 of tpukit's; the parameters after one AdamW step at
`tests/test_strategies.py:74-85`'s bars (atol 5e-5 / rtol 1e-4); the bf16
eval loss within 1e-2 and its accuracy within 1.0 point. Dense cases
without dropout are also held to tpukit's `SingleDevice` loss and
gradients on the global batch, and the padded slots' gradients must be
exactly 0. The gradients scaled by the stage count must fail the gradient
bar (the stage-fold a wrong treatment of the replicated loss would give).
"""

import contextlib
import dataclasses
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

from tpukit import checkpoint as tk_checkpoint
from tpukit import pipeline_schedule as tk_schedule
from tpukit.flags import build_parser as tk_build_parser
from tpukit.mesh import create_mesh as tk_create_mesh
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.model.gpt import init_params as tk_init_params
from tpukit.pipeline import Pipeline as TkPipeline
from tpukit.pipeline import Pipeline1F1B as TkPipeline1F1B
from tpukit.shardings import SingleDevice as TkSingleDevice
from tpukit.train import TrainState as TkTrainState
from tpukit.train import make_optimizer as tk_make_optimizer
import tpukit_torch
from tpukit_torch import NotPortedError, checkpoint, pipeline_schedule
from tpukit_torch.bridge import params_from_numpy
from tpukit_torch.flags import NOT_CARRIED, build_parser, check_carried, parse_flags
from tpukit_torch.model import gpt
from tpukit_torch.pipeline import Pipeline, Pipeline1F1B
from tpukit_torch.recipes import pipe, pipe_ddp, single
from tpukit_torch.shardings import SingleDevice, leaves, paths
from tpukit_torch.train import build_config, create_train_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_pipe_worker.py"
BATCH, SEQ = 16, 32
CONFIG = dict(dim=32, head_dim=8, heads=4, num_layers=4, vocab_size=211,
              max_position_embeddings=SEQ)
SPAWN_TIMEOUT = 240  # seconds a world may take; a hung collective fails the test
TOL = dict(atol=5e-5, rtol=1e-4)


def _case(label, world, schedule, stage, micro, data=1, virtual=1, layers=4, experts=0,
          top_k=1, dropout=0.0, ckpt=False, ref=None):
    """A case; `ref` names the tpukit schedule its reference runs, when it
    is not the case's own."""
    return dict(label=label, world=world, schedule=schedule, stage=stage, data=data,
                micro=micro, virtual=virtual, layers=layers, experts=experts, top_k=top_k,
                dropout=dropout, checkpoint=ckpt, params="moe" if experts else "dense",
                ref=ref or schedule)


# tpukit's GPipe and 1F1B take the same step where no dropout key differs
# (its own tests hold both to SingleDevice, and MoE to one reference), and
# on the CPU its dense GPipe step compiles 3-5x longer than its 1F1B one,
# its MoE 1F1B (interleaved machine) step 1.5-2.5x longer than its MoE
# GPipe one: dense GPipe cases without dropout share the 1F1B reference
# on the same mesh, except the first (held, with the dropout case, whose
# keys are GPipe's own, to tpukit's GPipe), and MoE 1F1B cases the GPipe
# one.
CASES = [
    _case("gpipe-s2-m4", 2, "gpipe", 2, 4, ckpt=True),
    _case("1f1b-s2-m4", 2, "1f1b", 2, 4),
    _case("1f1b-s2-v2", 2, "1f1b", 2, 2, virtual=2, ckpt=True),
    _case("moe-top1-gpipe-s2", 2, "gpipe", 2, 4, experts=4, top_k=1),
    _case("moe-top1-1f1b-s2", 2, "1f1b", 2, 4, experts=4, top_k=1, ref="gpipe"),
    _case("moe-top2-1f1b-s2", 2, "1f1b", 2, 4, experts=4, top_k=2, ref="gpipe"),
    _case("dropout-gpipe-s2", 2, "gpipe", 2, 4, dropout=0.1),
    _case("dropout-1f1b-s2", 2, "1f1b", 2, 4, dropout=0.1),
    _case("uneven-gpipe-s3", 3, "gpipe", 3, 4, ckpt=True, ref="1f1b"),
    _case("uneven-1f1b-s3", 3, "1f1b", 3, 4),
    _case("gpipe-s4-m8", 4, "gpipe", 4, 8, ref="1f1b"),
    _case("1f1b-s4-m8", 4, "1f1b", 4, 8),
    _case("gpipe-d2-s2", 4, "gpipe", 2, 4, data=2, ref="1f1b"),
    _case("1f1b-d2-s2", 4, "1f1b", 2, 4, data=2),
]
BY_LABEL = {c["label"]: c for c in CASES}
LABELS = [c["label"] for c in CASES]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def global_batch():
    """`tests/test_strategies.py`'s batch, built the same way."""
    rng = np.random.RandomState(7)
    ids = rng.randint(3, CONFIG["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
    mask = np.zeros((BATCH, SEQ), dtype=bool)
    for row in range(0, BATCH, 3):
        mask[row, rng.randint(SEQ // 2, SEQ):] = True
    targets = np.roll(ids, -1, axis=1).astype(np.int32)
    targets[mask] = -100
    positions = np.ascontiguousarray(np.broadcast_to(np.arange(SEQ, dtype=np.int32), ids.shape))
    return {"input_ids": ids, "position_ids": positions, "mask": mask}, targets


def _tk_cfg(case) -> TkGPTConfig:
    return TkGPTConfig(**{**CONFIG, "num_layers": case["layers"]}, compute_dtype=jnp.float32,
                       num_experts=case["experts"], router_top_k=case["top_k"],
                       virtual_stages=case["virtual"], dropout=case["dropout"])


@pytest.fixture(scope="module")
def param_sets():
    """tpukit's initial parameters (natural layout), dense and MoE."""
    init = jax.jit(tk_init_params, static_argnums=1)
    return {name: _np(init(jax.random.PRNGKey(0), _tk_cfg(
        _case("", 0, "gpipe", 1, 1, experts=experts))))
        for name, experts in (("dense", 0), ("moe", 4))}


_EVALS: dict = {}  # tpukit's jitted single-device eval, one a config


def _tk_eval(cfg, params, batch, targets):
    """tpukit's `SingleDevice` bf16 eval (loss, accuracy) of parameters in
    the natural layout (MoE through the dropless pallas dispatch, as the
    pipeline's eval runs it; dropless routing is per token, so the
    micro-batching does not change it)."""
    cfg = cfg.replace(compute_dtype=jnp.bfloat16, dropout=0.0, virtual_stages=1,
                      moe_dispatch="pallas" if cfg.num_experts else cfg.moe_dispatch)
    if cfg not in _EVALS:
        _EVALS[cfg] = jax.jit(lambda p, b, t: TkSingleDevice().loss_fn(p, cfg, b, t,
                                                                      with_accuracy=True))
    loss, acc = _EVALS[cfg](params, batch, targets)
    return float(loss), float(acc)


@jax.jit
def _tk_adamw(grads, params):
    """tpukit's first AdamW step (`make_optimizer(1e-3)`, as its train step
    applies it)."""
    opt = tk_make_optimizer(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, updates)


def _tk_step(case, params, batch, targets) -> dict:
    """tpukit's results for one case: loss and gradients of its
    `value_and_grad`, the parameters after its AdamW update (both in its
    layout), and the bf16 eval of those parameters."""
    cfg = _tk_cfg(case)
    axes = ({"stage": case["stage"]} if case["data"] == 1
            else {"data": case["data"], "stage": case["stage"]})
    mesh = tk_create_mesh(axes, jax.devices()[:case["world"]])
    cls = TkPipeline1F1B if case["ref"] == "1f1b" else TkPipeline
    strat = cls(mesh, num_microbatches=case["micro"],
                moe_dispatch="pallas" if case["experts"] else None)
    packed = strat.prepare_params(params, cfg)
    rng = jax.random.fold_in(jax.random.PRNGKey(0 ^ 0x5EED), 0) if case["dropout"] else None
    loss, grads = jax.jit(lambda p: strat.value_and_grad(p, cfg, batch, targets, rng=rng))(
        packed)
    stepped = _tk_adamw(grads, packed)
    natural = strat.inference_params(stepped, cfg)
    natural = {**natural, "layers": jax.tree.map(lambda t: t[:cfg.num_layers],
                                                 natural["layers"])}
    ev_loss, ev_acc = _tk_eval(cfg, natural, batch, targets)
    return dict(loss=float(loss), grads=_flat(_np(grads)), params=_flat(_np(stepped)),
                eval_loss=ev_loss, eval_acc=ev_acc)


def _start(world: int, inputs: Path, out: Path) -> list:
    """Start `world` ranks of the worker, each writing its log to a file."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [(subprocess.Popen([sys.executable, str(WORKER), str(inputs), str(out), str(world),
                               str(r)], stdout=open(out / f"rank{r}.log", "w"),
                              stderr=subprocess.STDOUT, env=env), out / f"rank{r}.log")
            for r in range(world)]


def _finish(world: int, procs: list, timeout: float = SPAWN_TIMEOUT) -> None:
    """Wait for the ranks; kill them all when one fails or the world
    outlives `timeout`."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a {world}-rank world did not finish in {timeout} s")
    for r, (p, log) in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log.read_text()[-4000:]}"


@contextlib.contextmanager
def _shared(tmp_path_factory, name: str):
    """Under pytest-xdist, a file every worker of this run reads `name`
    from, held under a lock while one worker makes it (the pattern of
    xdist's docs, with `fcntl` in place of `filelock`); None otherwise."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        yield None
        return
    root = tmp_path_factory.getbasetemp().parent / f"torch_pipeline_{run}"
    root.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield root / f"{name}.pkl"
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, global_batch, param_sets):
    """`worlds(n)`: one spawn of n ranks running every case of that world,
    and tpukit's results for each; each world runs once a test run (once a
    module, and shared between xdist workers)."""
    cache: dict = {}

    def run(world: int) -> dict:
        if world not in cache:
            with _shared(tmp_path_factory, f"world{world}") as path:
                if path is not None and path.exists():
                    cache[world] = pickle.loads(path.read_bytes())
                else:
                    cache[world] = _run_world(world)
                    if path is not None:
                        path.write_bytes(pickle.dumps(cache[world]))
        return cache[world]

    def _run_world(world: int) -> dict:
        cases = [c for c in CASES if c["world"] == world]
        model_batch, targets = global_batch
        work = tmp_path_factory.mktemp(f"pipe_world{world}")
        np.savez(work / "inputs.npz", config=json.dumps(CONFIG), cases=json.dumps(cases),
                 targets=targets, **model_batch,
                 **{f"{name}/param/{k}": v for name, tree in param_sets.items()
                    for k, v in _flat(tree).items()})
        procs = _start(world, work / "inputs.npz", work)
        refs, shared = {}, {}
        for c in cases:  # while the ranks run
            key = tuple(v for k, v in sorted(c.items())
                        if k not in ("label", "schedule", "checkpoint"))
            if key not in shared:
                shared[key] = _tk_step(c, param_sets[c["params"]], model_batch, targets)
            refs[c["label"]] = shared[key]
        _finish(world, procs)
        return dict(got=dict(np.load(work / "result.npz")), refs=refs)

    return run


def _port_cfg(**kw):
    return gpt.GPTConfig(**{**CONFIG, **kw}, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def single_refs(global_batch, param_sets):
    """On the global batch, from the dense parameters, in the natural
    layout: tpukit's and the port's `SingleDevice` gradients and
    parameters after one AdamW step, and tpukit's loss."""
    model_batch, targets = global_batch
    cfg = _tk_cfg(_case("", 0, "gpipe", 1, 1))
    tk_loss, tk_grads = jax.jit(lambda p: TkSingleDevice().value_and_grad(
        p, cfg, model_batch, targets))(param_sets["dense"])
    tk_params = _tk_adamw(tk_grads, param_sets["dense"])
    state = create_train_state(params_from_numpy(param_sets["dense"], "cpu"), 1e-3)
    batch = {k: torch.from_numpy(v) for k, v in model_batch.items()}
    _, grads = SingleDevice().value_and_grad(state.params, _port_cfg(), batch,
                                             torch.from_numpy(targets))
    for p, g in zip(leaves(state.params), leaves(grads)):
        p.grad = g
    state.optimizer.step()
    return dict(tk_loss=float(tk_loss), tk_grads=_flat(_np(tk_grads)),
                tk_params=_flat(_np(tk_params)), grads={n: g.numpy() for n, g in zip(paths(grads), leaves(grads))},
                params={n: p.detach().numpy() for n, p in zip(paths(state.params),
                                                              leaves(state.params))})


def _nest(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    tree: dict = {}
    for name, v in flat.items():
        *keys, last = name.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _layout(case, flat: dict) -> dict:
    """A natural-layout tree (flat, numpy) in the case's layout: the stack
    identity-padded and, at V > 1, chunk-permuted (the port's
    `prepare_params`, held to tpukit's in
    `test_layout_round_trip_matches_tpukit`)."""
    cfg = _port_cfg(num_layers=case["layers"], virtual_stages=case["virtual"])
    out = Pipeline1F1B(stages=case["stage"]).prepare_params(
        params_from_numpy(_nest(flat), "cpu"), cfg)
    return {n: t.numpy() for n, t in zip(paths(out), leaves(out))}


def _tree(got: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in got.items() if k.startswith(prefix + "/")}


def _assert_grads(grads: dict, ref: dict, scale: float = 1.0) -> None:
    assert grads.keys() == ref.keys()
    for name, want in ref.items():
        np.testing.assert_allclose(grads[name] * scale, want, **TOL, err_msg=name)


def _single_reference(case) -> bool:
    """A dense case without dropout: its step is the single-device step."""
    return not case["experts"] and not case["dropout"]


@pytest.mark.parametrize("label", LABELS)
def test_step_matches_tpukit(worlds, single_refs, label):
    """One step of the port's pipeline on its gloo world against tpukit's on
    the same mesh: the loss, every gradient leaf, the parameters after
    AdamW, and the bf16 eval after the step.

    The fixture's dense parameters put relu inputs within rounding of 0
    (`tests/test_torch_distributed.py` met them first): there the port's
    and tpukit's single-device steps already differ, the gradients by
    8.3e-5 on 3 elements of `layers/ffn/down/kernel`, and one element of
    `layers/ffn/up/kernel` whose gradient is near 0 in both (-9.2e-8 and
    -3.8e-6) by 9.5e-5 after AdamW's first step, g / (|g| + eps). In the
    dense cases the elements where the two single-device steps disagree so
    are held to the port's single-device step; every other element to
    tpukit's pipeline step."""
    case = BY_LABEL[label]
    run = worlds(case["world"])
    got, ref = run["got"], run["refs"][label]
    assert abs(float(got[f"{label}/loss"]) - ref["loss"]) < 1e-5
    grads, params = _tree(got, f"{label}/grad"), _tree(got, f"{label}/param")
    assert grads.keys() == params.keys() == ref["grads"].keys() == ref["params"].keys()
    flip_g = {n: np.zeros(v.shape, bool) for n, v in ref["grads"].items()}
    flip_p = dict(flip_g)
    if _single_reference(case):
        g, tk_g = _layout(case, single_refs["grads"]), _layout(case, single_refs["tk_grads"])
        p, tk_p = _layout(case, single_refs["params"]), _layout(case, single_refs["tk_params"])
        flip_g = {n: ~np.isclose(g[n], tk_g[n], **TOL) for n in g}
        flip_p = {n: ~np.isclose(p[n], tk_p[n], **TOL) for n in p}
        for name in g:
            np.testing.assert_allclose(grads[name][flip_g[name]], g[name][flip_g[name]], **TOL,
                                       err_msg=name)
            np.testing.assert_allclose(params[name][flip_p[name]], p[name][flip_p[name]],
                                       **TOL, err_msg=name)
    assert sum(int(f.sum()) for f in flip_g.values()) <= 3
    assert sum(int(f.sum()) for f in flip_p.values()) <= 4
    for name, want in ref["grads"].items():
        keep_g, keep_p = ~flip_g[name], ~flip_p[name]
        np.testing.assert_allclose(grads[name][keep_g], want[keep_g], **TOL, err_msg=name)
        np.testing.assert_allclose(params[name][keep_p], ref["params"][name][keep_p], **TOL,
                                   err_msg=name)
    assert abs(float(got[f"{label}/eval_loss"]) - ref["eval_loss"]) < 1e-2
    assert abs(float(got[f"{label}/eval_acc"]) - ref["eval_acc"]) < 1.0


@pytest.mark.parametrize("label", [c["label"] for c in CASES if _single_reference(c)])
def test_grads_match_single_device(worlds, single_refs, label):
    """Dense cases without dropout against the port's `SingleDevice` on the
    global batch (and the loss against tpukit's): the gradients once the
    chunk permutation is undone and the padded slots cut off; the padded
    slots' gradients are exactly 0."""
    case = BY_LABEL[label]
    got = worlds(case["world"])["got"]
    assert abs(float(got[f"{label}/loss"]) - single_refs["tk_loss"]) < 1e-5
    grads = params_from_numpy(_nest(_tree(got, f"{label}/grad")), "cpu")
    cfg = _port_cfg(num_layers=case["layers"], virtual_stages=case["virtual"])
    natural = Pipeline1F1B(stages=case["stage"]).inference_params(grads, cfg)
    n = case["layers"]
    for name, t in zip(paths(natural), leaves(natural)):
        have = t.numpy()
        if name.startswith("layers/"):
            assert not have[n:].any(), name
            have = have[:n]
        np.testing.assert_allclose(have, single_refs["grads"][name], **TOL, err_msg=name)


@pytest.mark.parametrize("label", LABELS)
def test_global_norms_sum_the_stages(worlds, label):
    """Each rank's `global_norms` of its stage pieces, summed over the stage
    (and data replica 0's) ranks by one all-reduce, is the norm of the
    gradients and of the parameters before the step, each gathered whole
    (rtol 1e-5)."""
    case = BY_LABEL[label]
    got = worlds(case["world"])["got"]
    grads = _tree(got, f"{label}/grad")
    grad = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    np.testing.assert_allclose(float(got[f"{label}/grad_norm"]), grad, rtol=1e-5)
    np.testing.assert_allclose(float(got[f"{label}/param_norm"]),
                               float(got[f"{label}/whole_param_norm"]), rtol=1e-5)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_stage_scaled_grads_fail_the_bar(worlds, world):
    """Negative control: every case's gradients scaled by its stage count
    (what a replicated loss summed on every stage without tpukit's
    treatment of its cotangent would give) miss the gradient bar."""
    run = worlds(world)
    for label, ref in run["refs"].items():
        with pytest.raises(AssertionError):
            _assert_grads(_tree(run["got"], f"{label}/grad"), ref["grads"],
                          scale=BY_LABEL[label]["stage"])


@pytest.mark.parametrize("label", [c["label"] for c in CASES if c["checkpoint"]])
def test_checkpoint_restores_into_the_same_strategy(worlds, label):
    """A whole checkpoint of the stepped pipeline state, in tpukit's layout,
    restores into a fresh state of the same strategy bit for bit on every
    rank (parameters, AdamW moments, step)."""
    got = worlds(BY_LABEL[label]["world"])["got"]
    assert int(got[f"{label}/restored_exactly"]) == 1
    payload = checkpoint.load(str(got[f"{label}/checkpoint"]))
    params = _tree(got, f"{label}/param")
    for name, leaf in zip(paths(payload["params"]), leaves(payload["params"])):
        assert np.array_equal(leaf.numpy(), params[name]), name


@pytest.mark.parametrize("label", [c["label"] for c in CASES if c["checkpoint"]])
def test_sharded_pipeline_checkpoint_restores_in_tpukit(worlds, param_sets, label):
    """The stepped pipeline state in tpukit's sharded layout, written by the
    stage ranks' pieces (the stack padded and, at V > 1, chunk-permuted):
    tpukit's `verify_checkpoint` passes, and its `restore_sharded` into a
    train state of that layout gives the parameters (rank 0's `full_params`)
    bit for bit, at step and count 1."""
    case = BY_LABEL[label]
    got = worlds(case["world"])["got"]
    path = Path(str(got[f"{label}/sharded"]))
    assert tk_checkpoint.verify_checkpoint(path) == (True, "verified")
    assert json.loads((path / "manifest.json").read_text())["nprocs"] == case["world"]
    params = _nest(_layout(case, _flat(param_sets[case["params"]])))
    opt = tk_make_optimizer(1e-3)
    template = TkTrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0))
    restored = tk_checkpoint.restore_sharded(path, template)
    assert int(restored.step) == int(restored.opt_state[0].count) == 1
    want = _tree(got, f"{label}/param")
    for name, leaf in _flat(_np(restored.params)).items():
        assert np.array_equal(leaf, want[name]), name


def test_even_checkpoint_restores_into_single_device(worlds):
    """GPipe's 2-stage checkpoint (V = 1, even split: tpukit's layout is the
    natural one) restores into a `SingleDevice` state bit for bit."""
    got = worlds(2)["got"]
    state = create_train_state(gpt.init_params(gpt.GPTConfig(**CONFIG), seed=3, device="cpu"),
                               1e-3)
    checkpoint.restore(str(got["gpipe-s2-m4/checkpoint"]), state)
    assert state.step == 1
    params = _tree(got, "gpipe-s2-m4/param")
    for name, p in zip(paths(state.params), leaves(state.params)):
        assert np.array_equal(p.detach().numpy(), params[name]), name


RECIPE_ARGS = ["--epochs", "1", "--sequence_length", "64", "--dim", "32", "--head_dim", "8",
               "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
               "--dataset_slice", "80", "--num_workers", "0", "--disable_amp", "--device", "cpu"]


@pytest.fixture(scope="module")
def single_recipe(tmp_path_factory):
    """Recipe 1 in this process at batch 8, the reference of both runs."""
    work = tmp_path_factory.mktemp("single")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        return single.main(RECIPE_ARGS + ["--batch_size", "8"])
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("recipe,ranks,argv", [
    ("pipe", 2, ["--batch_size", "8"]),
    ("pipe_ddp", 4, ["--batch_size", "4", "--microbatches", "4", "--schedule", "1f1b"]),
], ids=["pipe-2-ranks", "pipe_ddp-2x2-ranks"])
def test_recipe_matches_single_device(recipe, ranks, argv, single_recipe, tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node N -m
    tpukit_torch.recipes.<recipe> --device cpu`: recipe 4 on 2 stage ranks
    (GPipe, M = "4x" = 8) at batch 8, and recipe 5 on a (data 2, stage 2)
    grid (1F1B, M = 4) at batch 4 a replica, against recipe 1 at batch 8
    from the same seed: one set of rank-0 lines, the window loss within
    rtol 1e-4, eval within the bf16 bands of `test_torch_distributed.py`
    (rtol 2e-2, 1.5 accuracy points), and a whole checkpoint that restores
    into a `SingleDevice` state."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(ranks), "-m", f"tpukit_torch.recipes.{recipe}", *RECIPE_ARGS, *argv]
    try:
        proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"recipe {recipe} on {ranks} ranks did not finish in {SPAWN_TIMEOUT} s")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    windows = [float(l.rsplit("loss: ", 1)[1]) for l in lines if l.startswith("[training]")]
    evals = [l for l in lines if l.startswith("[validation]")]
    assert len(evals) == 1 and sum(l.startswith("throughput") for l in lines) == 1, proc.stdout
    ref = single_recipe.metrics
    assert len(windows) == len(ref["train_windows"]) >= 1
    np.testing.assert_allclose(windows, [w["loss"] for w in ref["train_windows"]], rtol=1e-4,
                               atol=5e-4)
    loss = float(evals[0].split("loss: ")[1].split(",")[0])
    acc = float(evals[0].split("accuracy: ")[1])
    np.testing.assert_allclose(loss, ref["eval"]["loss"], rtol=2e-2)
    assert abs(acc - ref["eval"]["accuracy"]) <= 1.5
    path = tmp_path / "checkpoints" / f"checkpoint-{single_recipe.state.step}.pt"
    other = create_train_state(gpt.init_params(single_recipe.config, device="cpu"), 1e-3)
    checkpoint.restore(path, other)
    assert other.step == single_recipe.state.step


# ------------------------------------------------- without processes ----


@pytest.mark.parametrize("recipe", [pipe, pipe_ddp], ids=["pipe", "pipe_ddp"])
def test_pipeline_recipes_refuse_the_cpu_unless_asked(recipe, monkeypatch):
    """Without a card and without `--device cpu` both recipes raise
    `CudaUnavailableError` and leave no process group up."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        recipe.main([a for a in RECIPE_ARGS if a not in ("--device", "cpu")])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("s,v,m,fwd_only", [
    (1, 1, 4, False), (2, 1, 4, False), (4, 1, 8, False), (3, 1, 4, False), (2, 2, 4, False),
    (2, 4, 8, False), (4, 2, 4, False), (4, 3, 5, False), (2, 2, 3, False), (2, 1, 4, True),
    (4, 1, 8, True), (2, 2, 4, True), (4, 4, 16, True),
])
def test_schedule_tables_equal_tpukit(s, v, m, fwd_only):
    """The port's copy of the schedule authority emits tpukit's tables."""
    ours = pipeline_schedule.build_schedule(s, v, m, include_backward=not fwd_only)
    ref = tk_schedule.build_schedule(s, v, m, include_backward=not fwd_only)
    assert ([dataclasses.astuple(t) for t in ours.ticks]
            == [dataclasses.astuple(t) for t in ref.ticks])
    assert ours.depth == ref.depth
    assert ours.stats.keys() == ref.stats.keys()
    for k, want in ref.stats.items():
        assert ours.stats[k] == want or (np.isnan(want) and np.isnan(ours.stats[k])), k
    assert pipeline_schedule.bubble_table(s) == tk_schedule.bubble_table(s)


@pytest.mark.parametrize("s,m", [(2, 4), (4, 8), (3, 5)])
def test_flat_table_is_the_flat_1f1b_order(s, m):
    """At one virtual stage the table is tpukit's flat machine's order:
    micro m forwards at stage s on tick m + s and backwards there on tick
    m + 2S - 2 - s; ingest t, head t - (S - 1), transpose t - (2S - 2)."""
    ticks = pipeline_schedule.cached_schedule(s, 1, m).ticks
    assert len(ticks) == m + 2 * s - 2
    for t, tk in enumerate(ticks):
        for d in range(s):
            f, b = t - d, t - (2 * s - 2 - d)
            assert tk.fwd[d] == ((0, f, tk.fwd[d][2]) if 0 <= f < m else None)
            assert tk.bwd[d] == ((0, b, tk.bwd[d][2]) if 0 <= b < m else None)
        assert (tk.ingest, tk.head, tk.emb) == tuple(
            x if 0 <= x < m else -1 for x in (t, t - (s - 1), t - (2 * s - 2)))


@pytest.mark.parametrize("s,v,layers", [(2, 2, 4), (2, 4, 8), (3, 1, 4), (4, 2, 12)])
def test_layout_round_trip_matches_tpukit(s, v, layers):
    """`prepare_params` pads and chunk-permutes the stack as tpukit's does
    (`_chunk_perm` equal), and `inference_params` undoes it exactly."""
    case = _case("", s, "1f1b", s, 4, virtual=v, layers=layers)
    cfg = _tk_cfg(case)
    tk_params = jax.jit(tk_init_params, static_argnums=1)(jax.random.PRNGKey(1), cfg)
    strat = TkPipeline1F1B(tk_create_mesh({"stage": s}, jax.devices()[:s]),
                           num_microbatches=4)
    ours = Pipeline1F1B(num_microbatches=4, stages=s)
    padded = ours.padded_layers(layers, v)
    assert padded == strat.padded_layers(layers, v)
    assert ours._chunk_perm(padded, v) == strat._chunk_perm(padded, v)
    port_cfg = gpt.GPTConfig(**{**CONFIG, "num_layers": layers}, virtual_stages=v)
    packed = ours.prepare_params(params_from_numpy(_np(tk_params), "cpu"), port_cfg)
    want = _flat(_np(strat.prepare_params(tk_params, cfg)))
    got = {n: p.numpy() for n, p in zip(paths(packed), leaves(packed))}
    assert got.keys() == want.keys()
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    back = ours.inference_params(packed, port_cfg)
    ref = _flat(_np(strat.inference_params(strat.prepare_params(tk_params, cfg), cfg)))
    for name, p in zip(paths(back), leaves(back)):
        assert np.array_equal(p.numpy(), ref[name]), name


@pytest.mark.parametrize("make,cfg_kw,match", [
    (lambda: Pipeline(num_microbatches=4, stages=2), dict(virtual_stages=2),
     "needs the 1f1b schedule"),
    (lambda: Pipeline1F1B(num_microbatches=4, stages=2), dict(virtual_stages=4, num_layers=4),
     "maximum virtual_stages here is 2"),
    (lambda: Pipeline1F1B(num_microbatches=4, stages=2, moe_dispatch="xla"),
     dict(num_experts=4), "moe_dispatch='xla'"),
    (lambda: Pipeline(num_microbatches=4, stages=2, moe_dispatch="a2a"),
     dict(num_experts=4), "moe_dispatch='a2a'"),
], ids=["gpipe-interleave", "too-many-virtual", "moe-xla", "moe-a2a"])
def test_rejections_match_tpukit(make, cfg_kw, match, global_batch):
    """tpukit's refusals, by its words, from `validate_config` and from the
    schedules themselves; tpukit refuses the same configs."""
    model_batch, targets = global_batch
    strategy, cfg = make(), _port_cfg(**cfg_kw)
    with pytest.raises(ValueError, match=match):
        strategy.validate_config(cfg)
    params = gpt.init_params(cfg.replace(virtual_stages=1), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in model_batch.items()}
    for call in (strategy.loss_fn, strategy.value_and_grad):
        with pytest.raises(ValueError, match=match):
            call(params, cfg, batch, torch.from_numpy(targets))
    tk_cls = TkPipeline1F1B if isinstance(strategy, Pipeline1F1B) else TkPipeline
    tk = tk_cls(tk_create_mesh({"stage": 2}, jax.devices()[:2]), num_microbatches=4,
                moe_dispatch=strategy.moe_dispatch)
    tk_cfg = TkGPTConfig(**{**CONFIG, **cfg_kw}, compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match=match):
        tk.validate_config(tk_cfg)


def test_unpadded_stack_is_refused(global_batch):
    """Twin of tpukit's `test_pipeline_rejects_unpadded_params`: 4 layers
    on 3 stages need the identity-padded stack of 6."""
    model_batch, targets = global_batch
    cfg = _port_cfg()
    params = gpt.init_params(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in model_batch.items()}
    strategy = Pipeline(num_microbatches=4, stages=3)
    with pytest.raises(ValueError, match="identity-padded"):
        strategy.loss_fn(params, cfg, batch, torch.from_numpy(targets))
    with pytest.raises(ValueError, match="identity-padded"):
        Pipeline1F1B(num_microbatches=4, stages=3).value_and_grad(
            params, cfg, batch, torch.from_numpy(targets))
    # a stage's block of 2 layers, and 16 rows that 3 micro-batches do not divide
    layers = params["layers"]
    block = {**params, "layers": params_from_numpy(_nest(
        {n: t.numpy()[:2] for n, t in zip(paths(layers), leaves(layers))}), "cpu")}
    with pytest.raises(ValueError, match="must divide into 3 microbatches"):
        Pipeline(num_microbatches=3, stages=2).loss_fn(block, cfg, batch,
                                                       torch.from_numpy(targets))


def test_microbatch_counts_follow_tpukit():
    """int, None (= the stage count) and "<k>x" (k x the stage count)."""
    assert Pipeline(stages=4).num_microbatches == 4
    assert Pipeline("4x", stages=3).num_microbatches == 12
    assert Pipeline(8, stages=2, data=2).batch_divisor == 16
    for bad in ("4", "x", "0x"):
        with pytest.raises(ValueError):
            Pipeline(bad, stages=2)
    with pytest.raises(RuntimeError, match="bring up the runtime"):
        Pipeline().num_stages


def test_pipeline_flags_parse():
    """`--microbatches`, `--schedule` (also `--pipeline_schedule`) and
    `--virtual_stages` parse as tpukit's pipeline parser has them, and are
    carried; every other flag of `NOT_CARRIED` still raises. `--comm_dtype`
    and `--grad_buckets` are carried, and the pipeline refuses them with
    tpukit's `ValueError` (`tpukit/pipeline.py:223`: no hand-placed wire);
    `--log_grad_norms` is carried and the pipeline takes it (tpukit's
    `global_norms` sum over the stages)."""
    argv = ["--microbatches", "8", "--pipeline_schedule", "1f1b", "--virtual_stages", "2",
            "--num_experts", "4", "--moe_dispatch", "pallas"]
    flags = pipe.pipeline_flags(argv)
    assert (flags.microbatches, flags.pipeline_schedule, flags.virtual_stages) == (8, "1f1b", 2)
    assert pipe.pipeline_flags(["--schedule", "1f1b"]).pipeline_schedule == "1f1b"
    check_carried(flags)
    assert not {"microbatches", "pipeline_schedule", "virtual_stages"} & set(NOT_CARRIED)
    ours = {a.dest: a.default for a in build_parser(pipeline_schedule=True, num_experts=True,
                                                    default_experts=0)._actions}
    for action in tk_build_parser(pipeline_schedule=True, num_experts=True,
                                  default_experts=0)._actions:
        if action.dest != "help":
            assert ours[action.dest] == action.default, action.dest
    strategy = pipe.make_strategy(flags, stages=2)
    assert isinstance(strategy, Pipeline1F1B) and strategy.num_microbatches == 8
    assert strategy.moe_dispatch == "pallas"
    assert pipe.make_strategy(parse_flags([]), stages=2).num_microbatches == 8  # "4x"
    assert pipe_ddp.pick_grid(8, 8) == {"data": 2, "stage": 4}
    assert pipe_ddp.pick_grid(4, 6) == {"data": 2, "stage": 2}
    assert pipe_ddp.pick_grid(3, 4) == {"data": 3, "stage": 1}
    check_carried(dataclasses.replace(flags, keep_checkpoints=2))  # item 17: carried
    for name, value in (("comm_dtype", "int8"), ("log_grad_norms", True),
                        ("grad_buckets", 2)):
        changed = dataclasses.replace(flags, **{name: value})
        if name in NOT_CARRIED:
            with pytest.raises(NotPortedError):
                check_carried(changed)
            continue
        check_carried(changed)
        if name == "log_grad_norms":
            strategy.validate_config(build_config(changed, 211))
            continue
        with pytest.raises(ValueError, match=f"--{name} .*the {strategy.name} strategy has no"):
            strategy.validate_config(build_config(changed, 211))
