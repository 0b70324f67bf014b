"""One rank of a gloo world on the CPU, for tests/test_torch_distributed.py.

    python tests/torch_dist_worker.py <inputs.npz> <out dir> <world> <rank>

Imports `tpukit_torch` only, never `jax` or `tpukit`. `inputs.npz` holds the
initial parameters (`param/<path>`), the global batch (`input_ids`,
`position_ids`, `mask`, `targets`), the model config (`config`, JSON) and
the paths of a checkpoint written by `SingleDevice`, as the port's `.pt`
(`single_ckpt`) and in tpukit's sharded layout (`single_sharded`). Rank r
takes rows [r B / world, (r + 1) B / world), as tpukit's `P("data")`
splits them. For `DataParallel` and `FSDP` each it takes one AdamW step
(lr 1e-3) and records the global loss, the gradients, the bf16 eval loss
and accuracy after the step and the parameters, all gathered whole; then
the averaged-per-rank-mean objective of plain DDP (the negative control),
an FSDP checkpoint of the stepped state (`<out>/fsdp_ckpt`), the
single-device checkpoint restored into a fresh FSDP state, each
strategy's stepped state in tpukit's sharded layout (`<out>/<label>_sharded`,
every rank writing its blocks) and whether a fresh state of the same
strategy restores it bit for bit on every rank, the single-device sharded
checkpoint restored into a fresh FSDP state, and each
strategy's loss and gradients at dropout 0.1 with step 0's key of seed 0
(`dropout/...`). Rank 0 writes everything to `<out>/result.npz`.
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
from tpukit_torch.shardings import DataParallel, FSDP, gather_full, leaves  # noqa: E402
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


def _gathered(prefix: str, tree: dict) -> dict:
    """`{prefix/path: whole numpy array}` of a tree (a collective under FSDP)."""
    return {f"{prefix}/{n}": gather_full(t).detach().cpu().numpy()
            for n, t in zip(checkpoint.paths(tree), leaves(tree))}


def _opt_state(prefix: str, state) -> dict:
    names = checkpoint.paths(state.params)
    out = {}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"{prefix}/{names[i]}/{k}"] = gather_full(v).detach().cpu().numpy()
    return out


def _local_state(state) -> list:
    """This rank's parameters and AdamW moments, as it holds them."""
    out = list(leaves(state.params))
    for p in leaves(state.params):
        st = state.optimizer.state[p]
        out += [st["exp_avg"], st["exp_avg_sq"]]
    return out


def main() -> None:
    src, out, world, rank = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    mesh.initialize_runtime("cpu", address=f"file://{out / 'store'}", world_size=world,
                            rank=rank)
    data = np.load(src)
    cfg = GPTConfig(**json.loads(str(data["config"])), compute_dtype=torch.float32)
    init = _nest({k[len("param/"):]: data[k] for k in data.files if k.startswith("param/")})
    rows = slice(rank * len(data["targets"]) // world, (rank + 1) * len(data["targets"]) // world)
    batch = {k: torch.from_numpy(np.ascontiguousarray(data[k][rows]))
             for k in ("input_ids", "position_ids", "mask")}
    targets = torch.from_numpy(np.ascontiguousarray(data["targets"][rows]))
    count = float((targets != -100).sum())
    result = {}

    for label, make in (("ddp", DataParallel), ("fsdp", FSDP)):
        strategy = make()
        state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
        loss, grads = strategy.value_and_grad(state.params, cfg, batch, targets)
        result.update(_gathered(f"{label}/grad", grads))
        for p, g in zip(leaves(state.params), leaves(grads)):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        ev_loss, ev_acc = eval_step(state, cfg, strategy, batch, targets)
        total_loss, total_acc, total = strategy.all_sum(
            [float(ev_loss) * count, float(ev_acc) * count, count])
        result[f"{label}/loss"] = np.float64(loss)
        result[f"{label}/eval_loss"] = np.float64(total_loss / total)
        result[f"{label}/eval_acc"] = np.float64(total_acc / total)
        result.update(_gathered(f"{label}/param", state.params))
        path = checkpoint.save_sharded(state, directory=out / f"{label}_sharded")
        fresh = create_train_state(params_from_numpy(init, "cpu"), LR, make())
        checkpoint.restore_any(path, fresh)
        same = fresh.step == state.step and all(
            torch.equal(a.to_local() if hasattr(a, "to_local") else a,
                        b.to_local() if hasattr(b, "to_local") else b)
            for a, b in zip(_local_state(state), _local_state(fresh)))
        flags = torch.tensor([int(same)])
        torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MIN)
        result[f"{label}/sharded_restored_exactly"] = np.int64(flags.item())
        result[f"{label}/sharded"] = str(path)
        if label == "fsdp":
            result["fsdp/replicated"] = np.array(
                [n for n, p in zip(checkpoint.paths(state.params), leaves(state.params))
                 if any(p is q for q in strategy.replicated)], dtype=str)
            result.update(_opt_state("fsdp/opt", state))
            checkpoint.save(state, directory=out / "fsdp_ckpt")
            restored = create_train_state(params_from_numpy(init, "cpu"), LR, FSDP())
            checkpoint.restore(str(data["single_ckpt"]), restored)
            result.update(_gathered("restored/param", restored.params))
            result.update(_opt_state("restored/opt", restored))
            from_sharded = create_train_state(params_from_numpy(init, "cpu"), LR, FSDP())
            checkpoint.restore_any(str(data["single_sharded"]), from_sharded)
            result.update(_gathered("restored_sharded/param", from_sharded.params))
            result.update(_opt_state("restored_sharded/opt", from_sharded))

    # dropout: each rank draws its rows of the global batch's masks
    for label, make in (("ddp", DataParallel), ("fsdp", FSDP)):
        strategy = make()
        state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
        loss, grads = strategy.value_and_grad(state.params, cfg.replace(dropout=0.1), batch,
                                              targets, rng=dropout_key(0, 0, "cpu"))
        result[f"dropout/{label}/loss"] = np.float64(loss)
        result.update(_gathered(f"dropout/{label}/grad", grads))

    # plain DDP's objective: each rank's own mean, averaged over the ranks
    strategy = DataParallel()
    state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
    local, _ = strategy.loss_fn(state.params, cfg, batch, targets)
    local.backward()
    result["naive/loss"] = np.float64(strategy.all_sum([float(local)])[0] / world)
    result.update({f"naive/grad/{n}": p.grad.detach().numpy().copy()
                   for n, p in zip(checkpoint.paths(state.params), leaves(state.params))})

    if rank == 0:
        np.savez(out / "result.npz", **result)
    mesh.sync_global_devices()
    mesh.shutdown_runtime()


if __name__ == "__main__":
    main()
