"""One rank of a gloo world on the CPU, for tests/test_torch_context_parallel.py.

    python tests/torch_cp_worker.py <inputs.npz> <out dir> <world> <rank>

Imports `tpukit_torch` only, never `jax` or `tpukit`. `inputs.npz` holds
the attention inputs (`attn/q`, `attn/k`, `attn/v` `[B, H, S, D]`,
`attn/mask` `[B, S]`), the model config (`config`, JSON), the initial
parameters (`param/<path>`), the global batch (`input_ids`,
`position_ids`, `mask`, `targets`) and the strategy cases of this world
(`cases`, JSON: data x seq grid, attention, dropout, the model's position
table).

Attention: on the whole world as one `seq` group, for the contiguous ring,
the zigzag ring (the inputs permuted by `zigzag_order` first) and Ulysses,
each rank runs its shard, differentiates `sum(where(valid, out, 0) ** 2)`
over its rows, and rank 0 records the output and dq, dk, dv gathered whole
(in the natural order); then the zigzag ring again with the backward's
dk/dv accumulators kept on the rank that computed them (`_pass_home`
replaced by the identity: the negative control).

Strategies: for each case `ContextParallel` on its grid (data replica d
takes rows [d B / D, (d + 1) B / D) of the global batch, as tpukit's
`P("data", "seq")` splits them) takes the gradients of one step with
`value_and_grad` (dropout: step 0's key of seed 0), one AdamW step (lr
1e-3) and the bf16 eval after it; rank 0 records the global loss, the
gradients, the parameters and the eval loss and accuracy weighted over the
data replicas. A case with `host_permute` permutes the batch with the
strategy's `host_batch_fn` first, as `fit` does. Rank 0 writes everything
to `<out>/result.npz`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpukit_torch import mesh, ring_attention  # noqa: E402
from tpukit_torch.bridge import params_from_numpy  # noqa: E402
from tpukit_torch.model import GPTConfig  # noqa: E402
from tpukit_torch.shardings import ContextParallel, leaves, paths  # noqa: E402
from tpukit_torch.train import create_train_state, dropout_key, eval_step  # noqa: E402

LR = 1e-3
KINDS = ("contiguous", "zigzag", "ulysses")


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


def _gather(t: torch.Tensor, dim: int, world: int) -> np.ndarray:
    """Every rank's `t` concatenated along `dim`, in rank order."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim).numpy()


def attention_cases(data, world: int, rank: int) -> dict:
    q, k, v = (torch.from_numpy(data[f"attn/{n}"]) for n in "qkv")
    mask = torch.from_numpy(data["attn/mask"])
    seq_len, scale = q.shape[2], float(data["attn/scale"])
    grid = mesh.create_cp_mesh(1, world, "cpu")
    sg = ring_attention.SeqGroup.of(grid)
    s_local = seq_len // world
    cols = slice(rank * s_local, (rank + 1) * s_local)
    res = {}

    def run(kind: str, label: str):
        order = (ring_attention.zigzag_order(seq_len, world) if kind == "zigzag"
                 else np.arange(seq_len))
        qs, ks, vs = (t[:, :, order][:, :, cols].clone().requires_grad_(True)
                      for t in (q, k, v))
        ms = mask[:, order][:, cols]
        if kind == "ulysses":
            out = ring_attention.ulysses_attention(qs, ks, vs, scale=scale, seq=sg, pad_mask=ms)
        else:
            out = ring_attention.ring_causal_attention(qs, ks, vs, scale=scale, seq=sg,
                                                       pad_mask=ms, layout=kind)
        loss = (torch.where(~ms[:, None, :, None], out, 0.0) ** 2).sum()
        loss.backward()
        inv = np.argsort(order)
        for name, t in (("out", out.detach()), ("dq", qs.grad), ("dk", ks.grad),
                        ("dv", vs.grad)):
            res[f"attn/{label}/{name}"] = _gather(t, 2, world)[:, :, inv]

    for kind in KINDS:
        run(kind, kind)
    home = ring_attention._pass_home
    ring_attention._pass_home = lambda dkv, seq: ([], dkv)  # kept where computed
    try:
        run("zigzag", "control")
    finally:
        ring_attention._pass_home = home
    return res


def strategy_case(case: dict, data, base: dict, rank: int) -> dict:
    cfg = GPTConfig(**{**base, "max_position_embeddings": case["positions"]},
                    compute_dtype=torch.float32, dropout=case["dropout"])
    strategy = ContextParallel(data=case["data"], seq=case["seq"], attention=case["attention"],
                               host_permute=case["host_permute"])
    init = _nest({k[len("param/"):]: data[k] for k in data.files if k.startswith("param/")})
    state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy, cfg)
    model_batch = {k: data[k] for k in ("input_ids", "position_ids", "mask")}
    targets = data["targets"]
    permute = strategy.host_batch_fn(cfg)
    if case["host_permute"]:
        assert permute is not None, "the zigzag layout should be active"
        model_batch, targets = permute(model_batch, targets)
    rows = targets.shape[0] // case["data"]
    d = strategy.data_rank()
    take = slice(d * rows, (d + 1) * rows)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[take])) for k, v in model_batch.items()}
    tgt = torch.from_numpy(np.ascontiguousarray(targets[take]))
    rng = dropout_key(0, 0, "cpu") if case["dropout"] else None
    loss, grads = strategy.value_and_grad(state.params, cfg, batch, tgt, rng=rng)
    for p, g in zip(leaves(state.params), leaves(grads)):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    ev_loss, ev_acc = eval_step(state, cfg, strategy, batch, tgt)
    weight = float((tgt != -100).sum())
    ev_loss, ev_acc, weight = strategy.all_sum([float(ev_loss) * weight,
                                                float(ev_acc) * weight, weight])
    label = case["label"]
    res = {f"{label}/loss": float(loss), f"{label}/eval_loss": ev_loss / weight,
           f"{label}/eval_acc": ev_acc / weight}
    names = paths(state.params)
    res.update({f"{label}/grad/{n}": g.detach().numpy() for n, g in zip(names, leaves(grads))})
    res.update({f"{label}/param/{n}": p.detach().numpy()
                for n, p in zip(names, leaves(state.params))})
    return res


def main() -> None:
    src, out, world, rank = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    mesh.initialize_runtime("cpu", address=f"file://{out / 'store'}", world_size=world,
                            rank=rank)
    data = np.load(src)
    result = attention_cases(data, world, rank)
    base = json.loads(str(data["config"]))
    for case in json.loads(str(data["cases"])):
        result.update(strategy_case(case, data, base, rank))
    if rank == 0:
        np.savez(out / "result.npz", **result)
    mesh.sync_global_devices()
    mesh.shutdown_runtime()


if __name__ == "__main__":
    main()
