"""One rank of a gloo world on the CPU, for tests/test_torch_pipeline.py.

    python tests/torch_pipe_worker.py <inputs.npz> <out dir> <world> <rank>

Imports `tpukit_torch` only, never `jax` or `tpukit`. `inputs.npz` holds
the model config (`config`, JSON), the cases this world runs (`cases`,
JSON: schedule, data x stage grid, micro-batches, virtual stages, layers,
experts, top-k, dropout, the parameter set), the initial parameters of
each set (`<set>/param/<path>`, tpukit's natural layout) and the global
batch (`input_ids`, `position_ids`, `mask`, `targets`). Data replica d
takes, of each of the M micro-batches of the global batch, rows
[d B / (M D), (d + 1) B / (M D)), as tpukit's `P(None, "data")` splits
them. For each case, in order, every rank builds the strategy and its
train state (`create_train_state(..., strategy, cfg)`), takes the
gradients of one step with `value_and_grad` (dropout: step 0's key of seed
0) and their global grad and param norms (`obs.global_norms`, summed over
the stages; the parameters' norm gathered whole beside them), one AdamW step (lr 1e-3) and the bf16 eval after it; rank 0
records the global loss, the norms, the gradients and the parameters in
tpukit's layout
(`full_params`: padded, chunk-permuted at V > 1), the eval loss and
accuracy summed over the data replicas, and, for the cases that ask,
writes a checkpoint of the stepped state, the port's `.pt`
(`<out>/<label>_ckpt`) and tpukit's sharded layout (`<out>/<label>_sharded`,
each stage rank of data replica 0 writing its pieces), restores each into
a fresh state of the same strategy and records whether every rank's
parameters and AdamW state came back bit for bit. Rank 0 writes
everything to `<out>/result.npz`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpukit_torch import checkpoint, mesh  # noqa: E402
from tpukit_torch.bridge import params_from_numpy  # noqa: E402
from tpukit_torch.model import GPTConfig  # noqa: E402
from tpukit_torch.obs import global_norms  # noqa: E402
from tpukit_torch.pipeline import Pipeline, Pipeline1F1B  # noqa: E402
from tpukit_torch.shardings import leaves, paths  # noqa: E402
from tpukit_torch.train import create_train_state, dropout_key, eval_step  # noqa: E402

LR = 1e-3


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


def replica_rows(n: int, micro: int, data: int, index: int) -> np.ndarray:
    """The global rows data replica `index` of `data` holds, micro by micro."""
    per = n // micro // data
    return np.concatenate([np.arange(m * (n // micro) + index * per,
                                     m * (n // micro) + (index + 1) * per)
                           for m in range(micro)])


def _state_arrays(state) -> list:
    """This rank's parameters and AdamW state, as arrays."""
    out = [p.detach().numpy().copy() for p in leaves(state.params)]
    for _, st in sorted(state.optimizer.state_dict()["state"].items()):
        out += [np.asarray(st[k]).copy() for k in sorted(st)]
    return out


def run_case(case: dict, data, base: dict, out: Path, result: dict) -> None:
    """One case of this world, its results into `result` (see above)."""
    label = case["label"]
    cls = Pipeline1F1B if case["schedule"] == "1f1b" else Pipeline
    strategy = cls(num_microbatches=case["micro"], data=case["data"], stages=case["stage"],
                   moe_dispatch="pallas" if case["experts"] else None)
    cfg = GPTConfig(**{**base, "num_layers": case["layers"], "num_experts": case["experts"],
                       "router_top_k": case["top_k"], "virtual_stages": case["virtual"],
                       "dropout": case["dropout"]}, compute_dtype=torch.float32)
    prefix = f"{case['params']}/param/"
    init = _nest({k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)})
    rows = replica_rows(len(data["targets"]), strategy.num_microbatches, case["data"],
                        strategy.data_rank())
    batch = {k: torch.from_numpy(np.ascontiguousarray(data[k][rows]))
             for k in ("input_ids", "position_ids", "mask")}
    targets = torch.from_numpy(np.ascontiguousarray(data["targets"][rows]))
    count = float((targets != -100).sum())

    state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy, cfg)
    rng = dropout_key(0, 0, "cpu") if case["dropout"] else None
    loss, grads = strategy.value_and_grad(state.params, cfg, batch, targets, rng=rng)
    norms = global_norms(grads, params=state.params, strategy=strategy)
    norms["whole_param_norm"] = np.sqrt(sum(
        float(np.sum(p.double().numpy() ** 2))
        for p in leaves(strategy.full_params(state.params))))
    full_grads = strategy.full_params(grads)
    for p, g in zip(leaves(state.params), leaves(grads)):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    ev_loss, ev_acc = eval_step(state, cfg, strategy, batch, targets)
    total_loss, total_acc, total = strategy.all_sum(
        [float(ev_loss) * count, float(ev_acc) * count, count])
    full_params = strategy.full_params(state.params)
    result[f"{label}/loss"] = np.float64(loss)
    result.update({f"{label}/{k}": np.float64(v) for k, v in norms.items()})
    result[f"{label}/eval_loss"] = np.float64(total_loss / total)
    result[f"{label}/eval_acc"] = np.float64(total_acc / total)
    for name, g in zip(paths(full_grads), leaves(full_grads)):
        result[f"{label}/grad/{name}"] = g.numpy().copy()
    for name, p in zip(paths(full_params), leaves(full_params)):
        result[f"{label}/param/{name}"] = p.numpy().copy()
    if case.get("checkpoint"):
        path = checkpoint.save(state, directory=out / f"{label}_ckpt")
        sharded = checkpoint.save_sharded(state, directory=out / f"{label}_sharded")
        same = True
        for written in (path, sharded):
            fresh = create_train_state(params_from_numpy(init, "cpu"), LR,
                                       cls(num_microbatches=case["micro"], data=case["data"],
                                           stages=case["stage"]), cfg)
            checkpoint.restore_any(written, fresh)
            same &= all(np.array_equal(a, b) for a, b in zip(_state_arrays(state),
                                                             _state_arrays(fresh)))
            same &= fresh.step == state.step
        flags = torch.tensor([int(same)])
        torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MIN)
        result[f"{label}/restored_exactly"] = np.int64(flags.item())
        result[f"{label}/checkpoint"] = str(path)
        result[f"{label}/sharded"] = str(sharded)


def main() -> None:
    src, out, world, rank = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    mesh.initialize_runtime("cpu", address=f"file://{out / 'store'}", world_size=world,
                            rank=rank)
    data = np.load(src)
    base = json.loads(str(data["config"]))
    result: dict = {}
    for case in json.loads(str(data["cases"])):
        run_case(case, data, base, out, result)
    if rank == 0:
        np.savez(out / "result.npz", **result)
    mesh.sync_global_devices()
    mesh.shutdown_runtime()


if __name__ == "__main__":
    main()
