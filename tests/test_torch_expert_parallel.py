"""Recipe 8 over more than one rank (`ExpertParallel` on `(data, expert)` grids
of gloo ranks, the token all-to-all of `tpukit_torch/ops/moe_dispatch.py`)
and MoE configs under `DataParallel` and `FSDP`, against tpukit's, on the
CPU.

One spawn per world size (`tests/torch_ep_worker.py`, which imports only
`tpukit_torch`) runs every case of that size; the pytest process computes
tpukit's results for the same cases on meshes of as many fake CPU devices
while the ranks run (shared between xdist workers, as
`tests/test_torch_context_parallel.py` shares its worlds).

The fixture is `tests/test_moe.py`'s: dim 32, 4 heads x 8, 2 layers, vocab
211, 4 experts, S 32, batch 16, f32, row 0 padded from position 28, and
tpukit's initial parameters (`create_train_state(PRNGKey(0))`, bridged).
A second batch ("allpad") pads row 13 whole, so the last rank holds a row
with no real token (`row_real = 0`) and the ranks' aux denominators differ:
there the aux of each rank's own statistics, averaged, is not the global
aux. The bars are `tests/test_moe.py:76-84`'s: the loss within 1e-5, the
bf16 eval after the step within 1e-2 (and 1.0 point of accuracy), the
parameters after one AdamW step (lr 1e-3) within atol 5e-5 / rtol 1e-4 of
tpukit's step on the same grid and dispatch. The gradients are held to the
port's own `SingleDevice` on the global batch at GRAD_TOL
(`tests/test_torch_distributed.py:74`): the grid sums the same terms in
another order.

Grids: (data 1, expert 2) on 2 ranks, (1, 4) and (2, 2) on 4; dispatches
"a2a", "pallas" (the grouped FFN's plain version on the CPU) and "xla"
(the bank gathered over `expert`, the meshless einsums, as GSPMD runs
them), each at top-1 and top-2 on (1, 2) and at one of them on each grid
of 4 (and a2a at both on (2, 2), the control's reference);
`expert_capacity_factor` 0.25, where tokens drop.
Negative controls: the aux of each rank's own statistics averaged over the
ranks (on the all-pad batch) and the expert gradients left unsummed over
`data` (at data 2) must fail the bars. Also here: the placement and the
per-rank bytes against tpukit's `ExpertParallel.state_sharding` at worlds
2, 4 and 8; the all-to-alls a training step against tpukit's
`expected_a2a`; checkpoints of all three formats between the (2, 2) grid,
`SingleDevice` and tpukit; MoE under `DataParallel` and `FSDP` (dispatches
"xla" and the meshless "pallas") on 2 and 4 ranks against tpukit's at
`tests/test_strategies.py`'s bars; recipe 8 under `torch.distributed.run`
on 2 ranks; what recipe 8 still refuses.
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
import pytest
import torch

from tpukit import checkpoint as tk_checkpoint
from tpukit.mesh import create_mesh as tk_create_mesh
from tpukit.model import GPTConfig as TkGPTConfig
from tpukit.ops.moe_dispatch import expected_a2a
from tpukit.shardings import FSDP as TkFSDP
from tpukit.shardings import DataParallel as TkDataParallel
from tpukit.shardings import ExpertParallel as TkExpertParallel
from tpukit.train import create_train_state as tk_create_train_state
from tpukit.train import make_optimizer as tk_make_optimizer
from tpukit.train import make_step_fns
import tpukit_torch
from tpukit_torch import checkpoint, mesh
from tpukit_torch.bridge import params_from_numpy
from tpukit_torch.model import GPTConfig, gpt
from tpukit_torch.ops.moe_dispatch import ExpertGrid
from tpukit_torch.recipes import moe as moe_recipe
from tpukit_torch.shardings import (ExpertParallel, SingleDevice, ep_placement, leaves, paths,
                                    unflatten)
from tpukit_torch.train import create_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_ep_worker.py"
SPAWN_TIMEOUT = 240  # seconds a world may take; a hung collective fails the test
BATCH, SEQ = 16, 32
CONFIG = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=211,
              max_position_embeddings=SEQ, num_experts=4)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-7, rtol=1e-5)
LR = 1e-3


def _ep(label, data, expert, dispatch, top_k=1, batch="main", **kw):
    return dict(kind="ep", label=label, data=data, expert=expert, dispatch=dispatch,
                top_k=top_k, batch=batch, **kw)


def _dp(kind, dispatch, top_k=1, batch="main"):
    return dict(kind=kind, label=f"{kind}/{dispatch}", dispatch=dispatch, top_k=top_k,
                batch=batch)


def _grid_cases(data, expert, top_k=None):
    """Every dispatch on the grid, at top-1 and top-2, or at the top-k
    `top_k` gives each (a dispatch -> top-k dict)."""
    return [_ep(f"d{data}e{expert}/{d}/top{k}", data, expert, d, k)
            for d in ("a2a", "pallas", "xla") for k in (1, 2)
            if top_k is None or top_k[d] == k]


# world -> the cases its spawn runs; tpukit runs the same step for every
# case but the controls, which are held to the reference named in CONTROLS
CASES = {
    2: _grid_cases(1, 2) + [
        _ep("d1e2/a2a/top1/cap", 1, 2, "a2a", 1, capacity=0.25, count_a2a=True),
        _ep("d1e2/pallas/top2/cap", 1, 2, "pallas", 2, capacity=0.25),
        _ep("d1e2/a2a/top1/allpad", 1, 2, "a2a", 1, "allpad"),
        _ep("control/rank_mean_aux", 1, 2, "a2a", 1, "allpad", control="rank_mean_aux"),
        _dp("ddp", "xla"), _dp("ddp", "pallas"), _dp("fsdp", "xla"), _dp("fsdp", "pallas", 2,
                                                                          "allpad"),
        _ep("d1e2/a2a/top1/int8", 1, 2, "a2a", 1, comm="int8", count_a2a=True),
        _ep("d1e2/a2a/top1/bf16", 1, 2, "a2a", 1, comm="bf16"),
        _ep("d1e2/a2a/top1/int8b2", 1, 2, "a2a", 1, comm="int8", buckets=2),
    ] + [_ep(f"traj/d1e2/{name}", 1, 2, "a2a", 1, traj=True, **kw) for name, kw in (
        ("f32", {}), ("int8", dict(comm="int8")), ("bf16", dict(comm="bf16")),
        ("int8sr", dict(comm="int8", stochastic=True)))],
    # each dispatch at top-1 on one grid and top-2 on the other
    4: _grid_cases(1, 4, dict(a2a=1, pallas=2, xla=1))
    + _grid_cases(2, 2, dict(a2a=2, pallas=1, xla=2)) + [
        _ep("d2e2/a2a/top1", 2, 2, "a2a", 1),
        _ep("d2e2/a2a/top2/cap", 2, 2, "a2a", 2, capacity=0.25, count_a2a=True),
        _ep("d1e4/xla/top1/cap", 1, 4, "xla", 1, capacity=0.25),
        _ep("d2e2/pallas/top1/allpad", 2, 2, "pallas", 1, "allpad", checkpoint=True),
        _ep("control/no_data_sum", 2, 2, "a2a", 1, control="no_data_sum"),
        _dp("ddp", "xla", 1, "allpad"), _dp("ddp", "pallas", 2), _dp("fsdp", "xla", 2),
        _dp("fsdp", "pallas"),
        _ep("d2e2/a2a/top1/int8", 2, 2, "a2a", 1, comm="int8", count_a2a=True),
        _ep("d2e2/a2a/top1/bf16", 2, 2, "a2a", 1, comm="bf16"),
    ],
}
CONTROLS = {"control/rank_mean_aux": "d1e2/a2a/top1/allpad",
            "control/no_data_sum": "d2e2/a2a/top1"}
# the quantized exchange's one-step cases, held to tpukit's within the EP
# band of tests/test_quant_comm.py (their own test, below)
QUANT_LABELS = [(w, c["label"]) for w, cs in CASES.items() for c in cs
                if c.get("comm") and not c.get("traj") and not c.get("buckets")]
STEP_LABELS = [(w, c["label"]) for w, cs in CASES.items() for c in cs
               if c["label"] not in CONTROLS and not c.get("comm") and not c.get("traj")]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batches() -> dict:
    """`tests/test_moe.py`'s batch ("main") and the same rows with row 13
    padded whole ("allpad")."""
    rng = np.random.RandomState(11)
    ids = rng.randint(3, CONFIG["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
    positions = np.ascontiguousarray(np.broadcast_to(np.arange(SEQ, dtype=np.int32), ids.shape))
    out = {}
    for name, whole_rows in (("main", ()), ("allpad", (13,))):
        mask = np.zeros((BATCH, SEQ), dtype=bool)
        mask[0, 28:] = True
        for r in whole_rows:
            mask[r, :] = True
        targets = np.roll(ids, -1, axis=1).astype(np.int32)
        targets[mask] = -100
        out[name] = ({"input_ids": ids, "position_ids": positions, "mask": mask}, targets)
    return out


def _tk_cfg(case: dict) -> TkGPTConfig:
    kw = dict(router_top_k=case["top_k"], expert_capacity_factor=case.get("capacity", 1.25),
              comm_dtype=case.get("comm", "f32"))
    if case["kind"] != "ep":
        kw["moe_dispatch"] = case["dispatch"]
    return TkGPTConfig(**CONFIG, compute_dtype=jnp.float32, **kw)


def _port_cfg(case: dict) -> GPTConfig:
    kw = dict(router_top_k=case["top_k"], expert_capacity_factor=case.get("capacity", 1.25))
    if case["kind"] != "ep" and case["dispatch"] == "pallas":
        kw["moe_dispatch"] = "pallas"  # meshless: the dropless sorted dataflow
    return GPTConfig(**CONFIG, compute_dtype=torch.float32, **kw)


def _tk_mesh(case: dict, world: int):
    devices = jax.devices()[:world]
    if case["kind"] == "ep":
        return tk_create_mesh({"data": case["data"], "expert": case["expert"]}, devices)
    return tk_create_mesh({"data": world}, devices)


def _tk_strategy(case: dict, world: int):
    if case["kind"] == "ep":
        return TkExpertParallel(_tk_mesh(case, world), dispatch=case["dispatch"])
    return {"ddp": TkDataParallel, "fsdp": TkFSDP}[case["kind"]](_tk_mesh(case, world))


def _tk_one_step(case: dict, world: int, batches: dict) -> dict:
    """tpukit's `tests/test_moe.py:_one_step` on the case's grid: the
    parameters after one jitted AdamW step (lr 1e-3) from PRNGKey(0), the
    loss, the bf16 eval after the step."""
    model_batch, targets = batches[case["batch"]]
    cfg, strategy = _tk_cfg(case), _tk_strategy(case, world)
    opt = tk_make_optimizer(LR)
    state = tk_create_train_state(jax.random.PRNGKey(0), cfg, opt, strategy)
    train_fn, eval_fn, _ = make_step_fns(cfg, opt, strategy, jax.eval_shape(lambda: state))
    new_state, loss = train_fn(state, model_batch, targets)
    eval_loss, eval_acc = eval_fn(new_state, model_batch, targets)
    return dict(params=_flat(_np(new_state.params)), loss=float(loss),
                eval_loss=float(eval_loss), eval_acc=float(eval_acc))


def _single_grads(case: dict, init: dict, batches: dict) -> dict:
    """The port's `SingleDevice` gradients on the global batch."""
    model_batch, targets = batches[case["batch"]]
    params = params_from_numpy(init, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    _, grads = SingleDevice().value_and_grad(
        params, _port_cfg(case), {k: torch.from_numpy(v) for k, v in model_batch.items()},
        torch.from_numpy(targets))
    return {n: g.numpy() for n, g in zip(paths(grads), leaves(grads))}


def _single_checkpoints(init: dict, batches: dict, work: Path) -> dict:
    """A `SingleDevice` state stepped once on the main batch (top-1), as the
    port's `.pt` and tpukit's sharded layout, for the (2, 2) grid to
    restore; its parameters and AdamW moments."""
    model_batch, targets = batches["main"]
    state = create_train_state(params_from_numpy(init, "cpu"), LR)
    train_step(state, GPTConfig(**CONFIG, compute_dtype=torch.float32), SingleDevice(),
               {k: torch.from_numpy(v) for k, v in model_batch.items()},
               torch.from_numpy(targets))
    names = paths(state.params)
    whole = {f"param/{n}": p.detach().numpy() for n, p in zip(names, leaves(state.params))}
    for n, p in zip(names, leaves(state.params)):
        for k in ("exp_avg", "exp_avg_sq"):
            whole[f"opt/{n}/{k}"] = state.optimizer.state[p][k].numpy()
    return dict(pt=checkpoint.save(state, directory=work / "single_pt"),
                sharded=checkpoint.save_sharded(state, directory=work / "single_sharded"),
                whole=whole, step=state.step)


def _run_world(world: int, work: Path) -> dict:
    """One spawn of `world` ranks running every case of that world in
    `work`, and tpukit's results computed while they run."""
    batches = _batches()
    tk_cfg = TkGPTConfig(**CONFIG, compute_dtype=jnp.float32)
    init = _np(tk_create_train_state(jax.random.PRNGKey(0), tk_cfg, tk_make_optimizer(LR)).params)
    extra, single = {}, None
    if any(c.get("checkpoint") for c in CASES[world]):
        mesh22 = tk_create_mesh({"data": 2, "expert": 2}, jax.devices()[:4])
        tk_state = tk_create_train_state(jax.random.PRNGKey(0), tk_cfg, tk_make_optimizer(LR),
                                         TkExpertParallel(mesh22))
        extra["tk_ep_sharded"] = str(tk_checkpoint.save_sharded(tk_state,
                                                                directory=work / "tk_ep"))
        single = _single_checkpoints(init, batches, work)
        extra.update(single_pt=str(single["pt"]), single_sharded=str(single["sharded"]))
    np.savez(work / "inputs.npz", config=json.dumps(CONFIG), cases=json.dumps(CASES[world]),
             **{f"{b}/{k}": v for b, (mb, t) in batches.items()
                for k, v in {**mb, "targets": t}.items()},
             **{f"param/{n}": t for n, t in _flat(init).items()}, **extra)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [(subprocess.Popen([sys.executable, str(WORKER), str(work / "inputs.npz"),
                                str(work), str(world), str(r)],
                               stdout=open(work / f"rank{r}.log", "w"), stderr=subprocess.STDOUT,
                               env=env), work / f"rank{r}.log") for r in range(world)]
    try:
        refs, grads = {}, {}
        for case in CASES[world]:
            label = case["label"]
            if label in CONTROLS or case.get("traj") or case.get("buckets"):
                continue
            refs[label] = _tk_one_step(case, world, batches)
            if not case.get("comm"):
                grads[label] = _single_grads(case, init, batches)
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
    return dict(got=dict(np.load(work / "result.npz")), refs=refs, grads=grads, init=init,
                single=None if single is None else dict(whole=single["whole"],
                                                        step=single["step"]),
                tk_init=init if single is not None else None)


@contextlib.contextmanager
def _shared(tmp_path_factory, name: str):
    """Under pytest-xdist, a file every worker of this run reads `name`
    from, held under a lock while one worker makes it; None otherwise."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        yield None
        return
    root = tmp_path_factory.getbasetemp().parent / f"torch_ep_{run}"
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
                    cache[world] = _run_world(world, tmp_path_factory.mktemp(f"ep{world}"))
                    if path is not None:
                        path.write_bytes(pickle.dumps(cache[world]))
        return cache[world]

    return run


def _tree(got: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in got.items() if k.startswith(prefix + "/")}


def _hold_step(got: dict, label: str, ref: dict, grads: dict) -> None:
    """The case's loss, eval, stepped parameters against tpukit's, its
    gradients against the port's single device's."""
    assert abs(float(got[f"{label}/loss"]) - ref["loss"]) < 1e-5
    assert abs(float(got[f"{label}/eval_loss"]) - ref["eval_loss"]) < 1e-2
    assert abs(float(got[f"{label}/eval_acc"]) - ref["eval_acc"]) < 1.0
    params, ours = _tree(got, f"{label}/param"), _tree(got, f"{label}/grad")
    assert params.keys() == ref["params"].keys() == ours.keys() == grads.keys()
    for name, want in grads.items():
        np.testing.assert_allclose(ours[name], want, **GRAD_TOL, err_msg=f"grad {name}")
    for name, want in ref["params"].items():
        np.testing.assert_allclose(params[name], want, **PARAM_TOL, err_msg=f"param {name}")


@pytest.mark.parametrize("world,label", STEP_LABELS, ids=[f"{w}-{lab}" for w, lab in STEP_LABELS])
def test_step_matches_tpukit(worlds, world, label):
    """One step of the port's `ExpertParallel` (or of `DataParallel` /
    `FSDP` with an MoE config) on gloo ranks against tpukit's on the same
    grid, dispatch, routing and capacity: loss within 1e-5, bf16 eval
    within 1e-2 and 1.0 point, parameters after AdamW at atol 5e-5 / rtol
    1e-4; gradients at GRAD_TOL of the port's single device's."""
    run = worlds(world)
    _hold_step(run["got"], label, run["refs"][label], run["grads"][label])


def test_capacity_factor_really_drops_tokens():
    """At `expert_capacity_factor` 0.25 the per-row capacity drops tokens on
    this fixture: the FFN output differs from the one with room for every
    token (`tests/test_moe.py:109-140`'s check)."""
    cfg = GPTConfig(**CONFIG, compute_dtype=torch.float32, expert_capacity_factor=0.25)
    layers = gpt.init_params(cfg, seed=0, device="cpu")["layers"]
    layer0 = unflatten(layers, [t[0] for t in leaves(layers)])
    x = torch.from_numpy(np.random.RandomState(3).randn(2, SEQ, cfg.dim).astype(np.float32))
    tight, _ = gpt._apply_moe_ffn(layer0, cfg, x)
    ample, _ = gpt._apply_moe_ffn(layer0, cfg.replace(expert_capacity_factor=4.0), x)
    assert float((tight - ample).abs().max()) > 1e-6


@pytest.mark.parametrize("world", [2, 4])
def test_aux_of_an_all_pad_row_is_global(worlds, world):
    """On the all-pad batch the ranks' aux denominators differ (the last
    rank holds a row with no real token), so the mean of the ranks' own
    aux is not the global one; the step there matches tpukit's (above), and
    with the aux averaged per rank (the negative control, world 2) the
    gradients fail the bar."""
    model_batch, _ = _batches()["allpad"]
    real_rows = (~model_batch["mask"]).any(axis=1).reshape(world, -1).sum(axis=1)
    assert len(set(real_rows.tolist())) > 1
    if world != 2:
        return
    run = worlds(world)
    got, ref = run["got"], run["grads"][CONTROLS["control/rank_mean_aux"]]
    control = _tree(got, "control/rank_mean_aux/grad")
    assert abs(float(got["control/rank_mean_aux/loss"])
               - run["refs"][CONTROLS["control/rank_mean_aux"]]["loss"]) < 1e-5  # aux is not CE
    with pytest.raises(AssertionError):
        for name, want in ref.items():
            np.testing.assert_allclose(control[name], want, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("world,label", STEP_LABELS, ids=[f"w{w}-{x}" for w, x in STEP_LABELS])
def test_global_norms_count_each_expert_once(worlds, world, label):
    """`global_norms` under EP (an expert's pieces on the data replica that
    writes them, the trunk's once) and MoE under DDP / FSDP: the grad norm
    is that of the gradients gathered whole, the param norm that of the
    initial parameters (rtol 1e-5)."""
    got = worlds(world)["got"]
    grads = _tree(got, f"{label}/grad")
    grad = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    np.testing.assert_allclose(float(got[f"{label}/grad_norm"]), grad, rtol=1e-5)
    np.testing.assert_allclose(float(got[f"{label}/param_norm"]),
                               float(got[f"{label}/whole_param_norm"]), rtol=1e-5)


def test_expert_gradients_unsummed_over_data_fail_the_bar(worlds):
    """The negative control at (data 2, expert 2): each data replica's
    expert gradients left as it computed them miss the gradient bar, and
    its stepped experts tpukit's parameter bar, which the real step meets."""
    run = worlds(4)
    got, label = run["got"], CONTROLS["control/no_data_sum"]
    grads, params = _tree(got, "control/no_data_sum/grad"), _tree(got, "control/no_data_sum/param")
    name = "layers/ffn/experts/up/kernel"
    assert not np.allclose(grads[name], run["grads"][label][name], **GRAD_TOL)
    with pytest.raises(AssertionError):
        for name, want in run["refs"][label]["params"].items():
            np.testing.assert_allclose(params[name], want, **PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_count_matches_expected_a2a(worlds, world):
    """A training step of the a2a dispatch (f32, layers unscanned) runs 4 x
    num_layers `all_to_all_single`, each moving tpukit's
    `expected_a2a(...)["buffer_bytes"]` on a rank."""
    case = next(c for c in CASES[world] if c.get("count_a2a"))
    got = worlds(world)["got"][f"{case['label']}/a2a_bytes"]
    want = expected_a2a(_tk_cfg(case), case["data"], case["expert"], BATCH, SEQ)
    assert want["train"]["count"] == 4 * CONFIG["num_layers"]
    assert got.tolist() == [want["buffer_bytes"]] * want["train"]["count"]


EP_FIRST_STEP_TOL = 1e-2  # tests/test_quant_comm.py:306, int8 activations
FINAL_LOSS_TOL = 2e-2


@pytest.mark.parametrize("world,label", QUANT_LABELS, ids=[f"{w}-{lab}" for w, lab in QUANT_LABELS])
def test_quantized_exchange_step_matches_tpukit(worlds, world, label):
    """`ExpertParallel` with an int8 or a bf16 exchange (`--comm_dtype`) on
    gloo ranks against tpukit's `ExpertParallel(dispatch="a2a")` with the
    same payload: the loss, and the bf16 eval after one AdamW step, within
    the EP first-step band of `tests/test_quant_comm.py` (1e-2); the
    exchange really moved another payload than f32 (the loss differs from
    the f32 step's)."""
    run = worlds(world)
    got, ref = run["got"], run["refs"][label]
    assert abs(float(got[f"{label}/loss"]) - ref["loss"]) < EP_FIRST_STEP_TOL
    assert abs(float(got[f"{label}/eval_loss"]) - ref["eval_loss"]) < EP_FIRST_STEP_TOL
    f32 = label.rsplit("/", 1)[0]
    assert float(got[f"{label}/loss"]) != float(got[f"{f32}/loss"])


def test_exchange_grad_buckets_change_no_bits(worlds):
    """`--grad_buckets 2` under `ExpertParallel` changes no dataflow (tpukit
    `shardings.py:1290-1305`): the int8 step's loss, gradients and stepped
    parameters are the bits of the step without buckets."""
    got = worlds(2)["got"]
    a, b = "d1e2/a2a/top1/int8", "d1e2/a2a/top1/int8b2"
    assert float(got[f"{a}/loss"]) == float(got[f"{b}/loss"])
    for kind in ("grad", "param"):
        mine, theirs = _tree(got, f"{b}/{kind}"), _tree(got, f"{a}/{kind}")
        assert mine.keys() == theirs.keys()
        for name in mine:
            np.testing.assert_array_equal(mine[name], theirs[name], err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_exchange_bytes_match_expected_a2a(worlds, world):
    """An int8 exchange's training step runs tpukit's `expected_a2a` count
    (4 x num_layers `all_to_all_single`), each moving its packed bytes (`E`
    / expert destinations of `packed_bytes` rows)."""
    case = next(c for c in CASES[world] if c.get("count_a2a") and c.get("comm") == "int8")
    got = worlds(world)["got"][f"{case['label']}/a2a_bytes"]
    want = expected_a2a(_tk_cfg(case), case["data"], case["expert"], BATCH, SEQ)
    count = want["train"]["count"]
    assert count == 4 * CONFIG["num_layers"]
    assert got.tolist() == [want["train"]["bytes"] // count] * count
    f32 = expected_a2a(_tk_cfg({**case, "comm": "f32"}), case["data"], case["expert"], BATCH,
                       SEQ)
    assert want["train"]["bytes"] <= 0.30 * f32["train"]["bytes"]


@pytest.mark.parametrize("name", ["int8", "bf16", "int8sr"])
def test_quantized_exchange_trajectory_tracks_f32(worlds, name):
    """`tests/test_quant_comm.py`'s gate on (data 1, expert 2): six steps of
    the quantized exchange (stochastic rounding too, whose keys cannot be
    tpukit's) against the port's own f32 exchange, the first loss within
    the EP band 1e-2, the last within 2e-2, and the loss falling."""
    got = worlds(2)["got"]
    quant, ref = got[f"traj/d1e2/{name}/traj"], got["traj/d1e2/f32/traj"]
    assert np.isfinite(quant).all()
    assert abs(quant[0] - ref[0]) < EP_FIRST_STEP_TOL, (quant, ref)
    assert abs(quant[-1] - ref[-1]) < FINAL_LOSS_TOL, (quant, ref)
    assert quant[-1] < quant[0]


def _tk_specs(world: int) -> tuple[dict, dict]:
    """tpukit's `ExpertParallel.state_sharding` of the fixture's parameters
    on `pick_grid(world, 4)`: leaf -> its spec, and the per-device bytes of
    the parameters and both AdamW moments (the largest over devices)."""
    grid = moe_recipe.pick_grid(world, CONFIG["num_experts"])
    mesh_ = tk_create_mesh(grid, jax.devices()[:world])
    cfg = TkGPTConfig(**CONFIG, compute_dtype=jnp.float32)
    state = jax.eval_shape(lambda: tk_create_train_state(
        jax.random.PRNGKey(0), cfg, tk_make_optimizer(LR), TkExpertParallel(mesh_)))
    sharding = TkExpertParallel(mesh_).state_sharding(state)
    specs = {n: s.spec for n, s in _flat(sharding.params).items()}
    per_device = 0
    for tree, sh in ((state.params, sharding.params), (state.opt_state[0].mu,
                                                       sharding.opt_state[0].mu),
                     (state.opt_state[0].nu, sharding.opt_state[0].nu)):
        for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)):
            per_device += int(np.prod(s.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return specs, per_device


@pytest.mark.parametrize("world", [2, 4, 8])
def test_placement_matches_tpukit(world):
    """`ep_placement` of every leaf on recipe 8's grid of the world equals
    tpukit's spec: the expert dimension over `expert`, a trunk dimension
    over the whole grid (`("data", "expert")`), or nothing."""
    grid = moe_recipe.pick_grid(world, CONFIG["num_experts"])
    specs, _ = _tk_specs(world)
    cfg = GPTConfig(**CONFIG)
    params = gpt.init_params(cfg, device="meta")
    assert set(specs) == set(paths(params))
    for name, p in zip(paths(params), leaves(params)):
        spec = tuple(specs[name]) + (None,) * (p.dim() - len(specs[name]))
        place = ep_placement(tuple(name.split("/")), tuple(p.shape), grid["data"],
                             grid["expert"])
        if place is None:
            assert all(a is None for a in spec), name
        elif place[0] == "expert":
            assert spec[place[1]] == "expert", name
        else:
            assert spec[place[1]] in (("data", "expert"), ("expert",), "expert") and \
                sum(a is not None for a in spec) == 1, name


@pytest.mark.parametrize("world", [2, 4, 8])
def test_per_rank_bytes_match_tpukit(world):
    """A rank's parameters and AdamW moments take the bytes a device holds
    under tpukit's `ExpertParallel`: 3 x 4 bytes a local element."""
    grid = moe_recipe.pick_grid(world, CONFIG["num_experts"])
    _, want = _tk_specs(world)
    params = gpt.init_params(GPTConfig(**CONFIG), device="meta")
    ours = 0
    for name, p in zip(paths(params), leaves(params)):
        place = ep_placement(tuple(name.split("/")), tuple(p.shape), grid["data"],
                             grid["expert"])
        n = 1 if place is None else (grid["expert"] if place[0] == "expert" else world)
        ours += 3 * 4 * p.numel() // n
    assert ours == want


def _equal_state(got: dict, prefix: str, want: dict) -> None:
    for key, v in want.items():
        assert np.array_equal(got[f"{prefix}/{key}"], v), key


@pytest.mark.parametrize("fmt", ["pt", "consolidated", "sharded"])
def test_ep_checkpoint_restores_into_single_device_and_tpukit(worlds, fmt):
    """The stepped (2, 2) state in each format (the port's `.pt`, tpukit's
    consolidated and sharded: every rank its trunk pieces, data replica 0's
    ranks their experts) restores bit for bit into a port `SingleDevice`
    state (parameters, AdamW moments, step) and, in tpukit's two formats,
    into tpukit's."""
    got = worlds(4)["got"]
    label = next(c["label"] for c in CASES[4] if c.get("checkpoint"))
    path = Path(str(got[f"{label}/{fmt}"]))
    stepped = _tree(got, f"{label}/stepped")
    other = create_train_state(gpt.init_params(GPTConfig(**CONFIG), seed=3, device="cpu"), LR)
    checkpoint.restore_any(path, other)
    assert other.step == 1
    names = paths(other.params)
    for n, p in zip(names, leaves(other.params)):
        assert np.array_equal(p.detach().numpy(), stepped[f"param/{n}"]), n
        for k in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(other.optimizer.state[p][k].numpy(), stepped[f"opt/{n}/{k}"])
    if fmt == "pt":
        return
    assert checkpoint.verify_checkpoint(path) == tk_checkpoint.verify_checkpoint(path) \
        == (True, "verified")
    tk_cfg = TkGPTConfig(**CONFIG, compute_dtype=jnp.float32)
    template = tk_create_train_state(jax.random.PRNGKey(0), tk_cfg, tk_make_optimizer(LR))
    restored = jax.tree.map(np.asarray, tk_checkpoint.restore_any(path, template)[0])
    adam = restored.opt_state[0]
    assert int(restored.step) == int(adam.count) == 1
    for n, v in _flat(restored.params).items():
        assert np.array_equal(v, stepped[f"param/{n}"]), n
    for moment, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for n, v in _flat(tree).items():
            assert np.array_equal(v, stepped[f"opt/{n}/{moment}"]), (n, moment)


def test_ep_sharded_checkpoint_restores_into_ep(worlds):
    """A fresh (2, 2) state restores the grid's own sharded checkpoint bit
    for bit on every rank (parameters, moments, step); the manifest names
    four shard files, each written."""
    got = worlds(4)["got"]
    label = next(c["label"] for c in CASES[4] if c.get("checkpoint"))
    assert int(got[f"{label}/sharded_restored_exactly"]) == 1
    path = Path(str(got[f"{label}/sharded"]))
    assert json.loads((path / "manifest.json").read_text())["nprocs"] == 4
    assert all(len(np.load(path / f"shard-{r:05d}.npz").files) > 0 for r in range(4))


@pytest.mark.parametrize("source", ["tk_ep_sharded", "single_pt", "single_sharded"])
def test_checkpoints_restore_into_ep(worlds, source):
    """tpukit's own (2, 2) `ExpertParallel` state in its sharded layout (its
    initial state: step 0, zero moments), and a stepped `SingleDevice`
    state as the port's `.pt` and in tpukit's sharded layout, restored into
    (2, 2) states: each rank's pieces, gathered, are the source's tensors
    bit for bit."""
    run = worlds(4)
    got = run["got"]
    label = next(c["label"] for c in CASES[4] if c.get("checkpoint"))
    prefix = f"{label}/from_{source}"
    if source == "tk_ep_sharded":
        assert int(got[f"{prefix}/step"]) == 0
        _equal_state(got, prefix, {f"param/{n}": v for n, v in _flat(run["tk_init"]).items()})
        assert not any(np.any(v) for k, v in got.items() if k.startswith(f"{prefix}/opt/"))
        return
    assert int(got[f"{prefix}/step"]) == run["single"]["step"] == 1
    _equal_state(got, prefix, run["single"]["whole"])


def test_ep_grid_and_mesh_refuse_what_they_cannot_run():
    """Grids need their ranks, experts their axis, dispatches their names."""
    mesh.initialize_runtime("cpu")
    try:
        assert mesh.create_ep_mesh(1, 1, "cpu").mesh_dim_names == ("data", "expert")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            mesh.create_ep_mesh(1, 2, "cpu")
        state_params = gpt.init_params(GPTConfig(**CONFIG), device="cpu")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            ExpertParallel(ExpertGrid(data=2, expert=2)).setup(state_params)
    finally:
        mesh.shutdown_runtime()
    with pytest.raises(ValueError, match="must divide over the 3-way expert axis"):
        ExpertParallel(ExpertGrid(data=1, expert=3)).validate_config(GPTConfig(**CONFIG))
    with pytest.raises(ValueError, match="'xla', 'a2a' or 'pallas'"):
        ExpertParallel(dispatch="ring")
    with pytest.raises(ValueError, match="grid sizes"):
        ExpertGrid(data=0)


RECIPE_ARGS = ["--epochs", "1", "--sequence_length", "64", "--dim", "32", "--head_dim", "8",
               "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
               "--dataset_slice", "80", "--num_workers", "0", "--disable_amp", "--batch_size",
               "8", "--num_experts", "4", "--moe_dispatch", "pallas", "--device", "cpu"]


@pytest.mark.parametrize("argv", [["--comm_dtype", "bf16"], ["--comm_dtype", "int8"],
                                  ["--grad_buckets", "2"],
                                  ["--comm_dtype", "int8", "--moe_dispatch", "xla"],
                                  ["--grad_buckets", "2", "--moe_dispatch", "xla"]],
                         ids=["comm_bf16", "comm_int8", "grad_buckets", "comm_int8_xla",
                              "grad_buckets_xla"])
def test_moe_recipe_refuses_what_is_not_ported(argv, tmp_path, monkeypatch):
    """Item 16 is ported: recipe 8 runs the bf16 and int8 exchange payloads
    and grad buckets with the pallas dispatch, as tpukit's `ExpertParallel`
    does (a world of one here: its 1 x 1 grid exchanges nothing), and
    refuses them with the xla dispatch with tpukit's `ValueError`
    (`tpukit/shardings.py:1200-1214`); nothing is left running."""
    monkeypatch.chdir(tmp_path)
    args = RECIPE_ARGS[:]
    args[args.index("--dataset_slice") + 1] = "16"
    if "xla" in argv:
        with pytest.raises(ValueError, match="needs the hand-placed exchange"):
            moe_recipe.main(args + argv)
    else:
        result = moe_recipe.main(args + argv)
        assert np.isfinite(result.metrics["eval"]["loss"])
        assert result.config.comm_dtype == (argv[1] if argv[0] == "--comm_dtype" else "f32")
    assert not torch.distributed.is_initialized()


def test_moe_recipe_on_two_ranks_matches_one(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    tpukit_torch.recipes.moe --device cpu` (a (data 1, expert 2) grid: the
    global batch of 8 split 4 a rank, 2 experts a rank behind the
    all-to-all) against the same recipe as a world of one (1 x 1) in this
    process: one set of rank-0 lines, both ranks exit 0, the window loss
    within rtol 1e-4 (plus half a unit of the print's third decimal), eval
    within the bf16 bands (rtol 2e-2, 1.5 points), and a checkpoint that
    restores into a `SingleDevice` state."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "tpukit_torch.recipes.moe", *RECIPE_ARGS]
    (tmp_path / "two").mkdir()
    proc = subprocess.Popen(cmd, cwd=tmp_path / "two", env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        ref = moe_recipe.main(RECIPE_ARGS)
    finally:
        os.chdir(cwd)
    try:
        out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"recipe 8 on 2 ranks did not finish in {SPAWN_TIMEOUT} s")
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    lines = out.splitlines()
    windows = [float(l.rsplit("loss: ", 1)[1]) for l in lines if l.startswith("[training]")]
    evals = [l for l in lines if l.startswith("[validation]")]
    assert len(evals) == 1 and sum(l.startswith("throughput") for l in lines) == 1, out
    assert len(windows) == len(ref.metrics["train_windows"]) >= 1
    np.testing.assert_allclose(windows, [w["loss"] for w in ref.metrics["train_windows"]],
                               rtol=1e-4, atol=5e-4)
    loss = float(evals[0].split("loss: ")[1].split(",")[0])
    acc = float(evals[0].split("accuracy: ")[1])
    np.testing.assert_allclose(loss, ref.metrics["eval"]["loss"], rtol=2e-2)
    assert abs(acc - ref.metrics["eval"]["accuracy"]) <= 1.5
    path = tmp_path / "two" / "checkpoints" / f"checkpoint-{ref.state.step}.pt"
    other = create_train_state(gpt.init_params(ref.config, device="cpu"), LR)
    checkpoint.restore(path, other)
    assert other.step == ref.state.step


def test_moe_recipe_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError):
        moe_recipe.main([a for a in RECIPE_ARGS if a not in ("--device", "cpu")])
    assert not torch.distributed.is_initialized()
