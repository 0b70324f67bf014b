"""One rank of a gloo world on the CPU, for tests/test_torch_expert_parallel.py.

    python tests/torch_ep_worker.py <inputs.npz> <out dir> <world> <rank>

Imports `tpukit_torch` only, never `jax` or `tpukit`. `inputs.npz` holds the
model config (`config`, JSON), the initial parameters (`param/<path>`), two
global batches (`<batch>/input_ids`, `/position_ids`, `/mask`, `/targets`:
"main", and "allpad", whose last rank holds an all-pad row), the cases of
this world (`cases`, JSON) and the paths of the checkpoints the
checkpoint case restores.

Every case builds its strategy on the whole world and takes one step from
the initial parameters: `value_and_grad`, one AdamW step (lr 1e-3), the
bf16 eval after it. Rank r takes rows [r B / N, (r + 1) B / N) of the
global batch, N the ranks that hold different rows (every rank under
`ExpertParallel`, as tpukit's `P(("data", "expert"))` splits them; every
rank of the `data` mesh under `DataParallel` and `FSDP`). Rank 0 records
the global loss, the global grad and param norms before the step
(`obs.global_norms`, beside the initial parameters' norm), the gradients
and the stepped parameters gathered whole,
and the eval loss and accuracy weighted over the ranks, under
`<label>/...`.

Case kinds (`kind`):
  - "ep": `ExpertParallel` on a `(data, expert)` grid with a dispatch,
    top-k, capacity factor and batch; `control` "rank_mean_aux" averages
    each rank's own aux over the ranks in place of the aux of the summed
    statistics, "no_data_sum" leaves the expert gradients unsummed over
    `data` (the negative controls); `count_a2a` records the
    `all_to_all_single` calls of the `value_and_grad` and the bytes each
    moved; `checkpoint` writes the stepped state in the three formats
    (`<out>/ep_<fmt>`), records its AdamW moments whole, restores its own
    sharded checkpoint into a fresh state (bit for bit on every rank?), and
    restores tpukit's EP checkpoint and the single-device `.pt` and sharded
    checkpoints into fresh states (`<label>/from_<source>/...`);
  - "ddp", "fsdp": the strategy on the whole world with the MoE config's
    dispatch ("xla" or the meshless "pallas").

`comm` sets the config's `comm_dtype` (the exchange's payload), `buckets`
its `grad_buckets`, `stochastic` its `quant_stochastic`; a case with
`traj` takes six AdamW steps on the same batch instead and records the
losses (`<label>/traj`).

Rank 0 writes everything to `<out>/result.npz`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpukit_torch import checkpoint, mesh  # noqa: E402
from tpukit_torch.bridge import params_from_numpy  # noqa: E402
from tpukit_torch.model import GPTConfig  # noqa: E402
from tpukit_torch.obs import global_norms  # noqa: E402
from tpukit_torch.ops import moe_dispatch  # noqa: E402
from tpukit_torch.ops.moe_dispatch import ExpertGrid  # noqa: E402
from tpukit_torch.shardings import (  # noqa: E402
    FSDP,
    DataParallel,
    ExpertParallel,
    gather_full,
    leaves,
    paths,
)
from tpukit_torch.train import create_train_state, eval_step, train_step  # noqa: E402

LR = 1e-3


class NoDataSumEP(ExpertParallel):
    """The negative control: expert gradients left as each data replica
    computed them, not summed over `data`."""

    def _reduce(self, grads: list) -> list:
        out = super()._reduce(grads)
        return [g if self._kind(i) == "expert" else o
                for i, (g, o) in enumerate(zip(grads, out))]


def _rank_mean_aux(num, den, cfg):
    """The negative control's aux: each rank's own `E num / max(den, 1)`,
    averaged over the ranks."""
    aux = cfg.num_experts * num / torch.clamp(den, min=1.0)
    rows = cfg.moe_rows
    return moe_dispatch._RowSum.apply(aux / rows.size, rows.group)


def _nest(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}, in the order of `flat`."""
    tree: dict = {}
    for name, v in flat.items():
        *keys, last = name.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _whole(strategy, name: str, t: torch.Tensor) -> np.ndarray:
    """A leaf (or a tensor shaped like it) whole: a collective."""
    if isinstance(strategy, ExpertParallel):
        t = strategy.gather_leaf(name, t)
    return gather_full(t).detach().cpu().numpy()


def _state_whole(prefix: str, strategy, state) -> dict:
    """`{prefix/param/...}` and `{prefix/opt/<path>/<moment>}`, whole."""
    names = paths(state.params)
    out = {f"{prefix}/param/{n}": _whole(strategy, n, p)
           for n, p in zip(names, leaves(state.params))}
    for p, n in zip(leaves(state.params), names):
        st = state.optimizer.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{prefix}/opt/{n}/{k}"] = _whole(strategy, n, st[k])
    return out


def _strategy(case: dict):
    if case["kind"] == "ep":
        make = NoDataSumEP if case.get("control") == "no_data_sum" else ExpertParallel
        return make(ExpertGrid(data=case["data"], expert=case["expert"]),
                    dispatch=case["dispatch"])
    return {"ddp": DataParallel, "fsdp": FSDP}[case["kind"]]()


def _config(base: dict, case: dict) -> GPTConfig:
    kw = dict(router_top_k=case["top_k"], expert_capacity_factor=case.get("capacity", 1.25),
              comm_dtype=case.get("comm", "f32"), grad_buckets=case.get("buckets", 0),
              quant_stochastic=case.get("stochastic", False))
    if case["kind"] != "ep":
        kw["moe_dispatch"] = case["dispatch"]
    return GPTConfig(**base, compute_dtype=torch.float32, **kw)


def _init(data) -> dict:
    return _nest({k[len("param/"):]: data[k] for k in data.files if k.startswith("param/")})


def _count_a2a():
    """Wrap `dist.all_to_all_single`: (calls, bytes each, restore)."""
    calls: list = []
    real = dist.all_to_all_single

    def counted(output, input, *args, **kwargs):
        calls.append(output.numel() * output.element_size())
        return real(output, input, *args, **kwargs)

    dist.all_to_all_single = counted
    return calls, lambda: setattr(dist, "all_to_all_single", real)


TRAJ_STEPS = 6  # tests/test_quant_comm.py's horizon


def run_case(case: dict, data, base: dict, world: int, rank: int, out: Path) -> dict:
    cfg = _config(base, case)
    strategy = _strategy(case)
    strategy.validate_config(cfg)
    state = create_train_state(params_from_numpy(_init(data), "cpu"), LR, strategy, cfg)
    b = case["batch"]
    model_batch = {k: data[f"{b}/{k}"] for k in ("input_ids", "position_ids", "mask")}
    targets = data[f"{b}/targets"]
    rows = targets.shape[0] // world
    take = slice(rank * rows, (rank + 1) * rows)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[take])) for k, v in model_batch.items()}
    tgt = torch.from_numpy(np.ascontiguousarray(targets[take]))
    label = case["label"]
    res: dict = {}
    if case.get("traj"):  # six AdamW steps on the same batch: the losses
        losses = [float(train_step(state, cfg, strategy, batch, tgt)) for _ in range(TRAJ_STEPS)]
        return {f"{label}/traj": np.array(losses)}
    aux, calls, restore = moe_dispatch._aux, None, None
    if case.get("control") == "rank_mean_aux":
        moe_dispatch._aux = _rank_mean_aux
    if case.get("count_a2a"):
        calls, restore = _count_a2a()
    try:
        loss, grads = strategy.value_and_grad(state.params, cfg, batch, tgt)
    finally:
        moe_dispatch._aux = aux
        if restore is not None:
            restore()
    if calls is not None:
        res[f"{label}/a2a_bytes"] = np.array(calls, dtype=np.int64)
    res.update({f"{label}/{k}": np.float64(v) for k, v in
                global_norms(grads, params=state.params, strategy=strategy).items()})
    res[f"{label}/whole_param_norm"] = np.sqrt(sum(
        float(np.sum(data[k].astype(np.float64) ** 2)) for k in data.files
        if k.startswith("param/")))
    names = paths(state.params)
    res.update({f"{label}/grad/{n}": _whole(strategy, n, g)
                for n, g in zip(names, leaves(grads))})
    for p, g in zip(leaves(state.params), leaves(grads)):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    ev_loss, ev_acc = eval_step(state, cfg, strategy, batch, tgt)
    weight = float((tgt != -100).sum())
    ev_loss, ev_acc, weight = strategy.all_sum([float(ev_loss) * weight,
                                                float(ev_acc) * weight, weight])
    res.update({f"{label}/loss": float(loss), f"{label}/eval_loss": ev_loss / weight,
                f"{label}/eval_acc": ev_acc / weight})
    res.update({f"{label}/param/{n}": _whole(strategy, n, p)
                for n, p in zip(names, leaves(state.params))})
    if case.get("checkpoint"):
        res.update(_checkpoints(case, data, cfg, state, out))
    return res


def _checkpoints(case: dict, data, cfg, state, out: Path) -> dict:
    label, strategy = case["label"], state.strategy
    res = _state_whole(f"{label}/stepped", strategy, state)
    res[f"{label}/pt"] = str(checkpoint.save(state, directory=out / "ep_pt"))
    res[f"{label}/consolidated"] = str(checkpoint.save_consolidated(state, out / "ep_consolidated"))
    sharded = checkpoint.save_sharded(state, out / "ep_sharded")
    res[f"{label}/sharded"] = str(sharded)
    fresh = create_train_state(params_from_numpy(_init(data), "cpu"), LR, _strategy(case), cfg)
    checkpoint.restore_any(sharded, fresh)
    same = all(torch.equal(a, b) for a, b in zip(leaves(fresh.params), leaves(state.params)))
    for a, b in zip(leaves(fresh.params), leaves(state.params)):
        sa, sb = fresh.optimizer.state[a], state.optimizer.state[b]
        same = same and all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))
    flag = torch.tensor([int(same and fresh.step == state.step)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    res[f"{label}/sharded_restored_exactly"] = np.int64(flag.item())
    for source in ("tk_ep_sharded", "single_pt", "single_sharded"):
        other = create_train_state(params_from_numpy(_init(data), "cpu"), LR, _strategy(case),
                                   cfg)
        checkpoint.restore_any(str(data[source]), other)
        res[f"{label}/from_{source}/step"] = np.int64(other.step)
        res.update(_state_whole(f"{label}/from_{source}", other.strategy, other))
    return res


def main() -> None:
    src, out, world, rank = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    mesh.initialize_runtime("cpu", address=f"file://{out / 'store'}", world_size=world,
                            rank=rank)
    data = np.load(src)
    base = json.loads(str(data["config"]))
    result: dict = {}
    for case in json.loads(str(data["cases"])):
        result.update(run_case(case, data, base, world, rank, out))
    if rank == 0:
        np.savez(out / "result.npz", **result)
    mesh.sync_global_devices()
    mesh.shutdown_runtime()


if __name__ == "__main__":
    main()
