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
single-device checkpoint restored into a fresh FSDP state (and its state
checksum, `fsdp/checksum`), each strategy's global grad and param norms
before the step (`<label>/grad_norm`, `<label>/param_norm`), each
strategy's stepped state in tpukit's sharded layout (`<out>/<label>_sharded`,
every rank writing its blocks) and whether a fresh state of the same
strategy restores it bit for bit on every rank, the single-device sharded
checkpoint restored into a fresh FSDP state, and each
strategy's loss and gradients at dropout 0.1 with step 0's key of seed 0
(`dropout/...`).

`TensorParallel` runs in the same world on its own config (`tp/config`,
`tp/param/...`, `tp/input_ids`, ...): on each `(data, model)` grid of
`TP_GRIDS[world]` one AdamW step's loss, gradients, global grad and param
norms (`obs.global_norms` over the model pieces), bf16 eval and
parameters, all gathered whole, the split dimension of every leaf, the
stepped state in tpukit's sharded and consolidated layouts, tpukit's own
TP checkpoint (`tp/tk_sharded`) restored into a fresh state; on the first
grid also the head's cotangent summed over `model` (the negative control,
`TensorParallel` with the pipeline's "shared" contract) and dropout 0.1;
then one step of each of `TP_ODD[world]`'s configs, whose heads or
dimensions do not divide the model degree (`tp/odd/<name>/...`); and the
single-device checkpoints (`single_ckpt`, `single_sharded`) restored into
TP states of the whole world's model degree (`tp/single_<fmt>/...`, with
the state checksum).

With `quant/x` in the inputs the world also runs the quantized
collectives and gradient wires (`_quantized`, `--comm_dtype`,
`--grad_buckets`, `--quant_stochastic`): each collective of
`tpukit_torch/ops/quant_comm.py` on this rank's slice of `quant/x`,
`quant/y`, `quant/z` and `quant/e` (the exchange's `[E, B, C, D]`
buffers, with the cotangent `quant/ct` of its backward), every rank's
output gathered (`quant/<fn>/<dtype>`); every rank's exact local
gradients, without and with dropout 0.1 (`qlocal/<tag>/<path>`, stacked);
one `value_and_grad` of each case
of `QUANT_STEPS[world]` (`qstep/<label>/...`: the global loss and the
gradients whole; the c10d collectives of the step, their calls and
bytes, where the case counts); and
`QUANT_STEPS`' trajectories, six AdamW steps on the global batch
(`qtraj/<label>`). Then every audited world of `python -m
tpukit_torch.analysis` in this world (`audit_worlds`: `audit/<name>`, each
rank's measured collectives, plan and findings), and in the world of 2 the
bench twin's multi-rank records (`bench_records`: `bench/<record>`).

With `serve/config` in the inputs the world serves instead: the serving
cases of `tests/test_torch_serve.py` (`serve_main`), written to
`<out>/result.npz` by rank 0 as `<case>/<rid>` token arrays.

Rank 0 writes everything to `<out>/result.npz`.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpukit_torch import checkpoint, mesh  # noqa: E402
from tpukit_torch.bridge import params_from_numpy  # noqa: E402
from tpukit_torch.model import GPTConfig, gpt  # noqa: E402
from tpukit_torch.obs import format_checksum, global_norms, make_state_checksum  # noqa: E402
from tpukit_torch.ops import quant_comm  # noqa: E402
from tpukit_torch.ops.layers import vocab_parallel_argmax  # noqa: E402
from tpukit_torch.analysis.comm_ir import comm_bytes  # noqa: E402
from tpukit_torch.shardings import (  # noqa: E402
    FSDP,
    DataParallel,
    TensorParallel,
    gather_full,
    leaves,
    unflatten,
)
from tpukit_torch.train import (  # noqa: E402
    create_train_state,
    dropout_key,
    eval_step,
    train_step,
)

LR = 1e-3
TP_GRIDS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}  # world -> its (data, model) grids
# world -> configs whose heads or dims do not divide the model degree (the
# whole world): heads 5 x 6 (inner 30, FFN 120, vocab 151 unpadded) and
# heads 2 x 16 (inner 32)
TP_ODD = {2: {"h5": dict(dim=30, head_dim=6, heads=5, vocab_pad_multiple=1, vocab_size=151)},
          4: {"h5": dict(dim=30, head_dim=6, heads=5, vocab_pad_multiple=1, vocab_size=151),
              "h2": dict(dim=32, head_dim=16, heads=2, vocab_size=160)}}


class SharedCotangentTP(TensorParallel):
    """The negative control: the vocab-parallel CE's backward sums the
    head's cotangent over `model`, as the pipeline's contract does."""

    ce_cotangent = "shared"


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
    if "serve/config" in data.files:
        result = serve_main(data, out)
        if rank == 0:
            np.savez(out / "result.npz", **result)
        mesh.sync_global_devices()
        mesh.shutdown_runtime()
        return
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
        norms = global_norms(grads, params=state.params, strategy=strategy)
        result.update({f"{label}/{k}": np.float64(v) for k, v in norms.items()})
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
            result["fsdp/checksum"] = format_checksum(make_state_checksum()(restored))
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

    if "tp/config" in data.files:
        result.update(_tensor_parallel(data, out, world))
        # the single-device checkpoints, in both layouts, into TP states of
        # the DP config (vocab 211, padded to 256, splits over the model)
        for fmt, path in (("pt", data["single_ckpt"]), ("sharded", data["single_sharded"])):
            strategy = TensorParallel()
            state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
            checkpoint.restore_any(str(path), state)
            result.update(_tp_whole(f"tp/single_{fmt}", strategy, state))
            result[f"tp/single_{fmt}/step"] = np.int64(state.step)
            result[f"tp/single_{fmt}/checksum"] = format_checksum(make_state_checksum()(state))

    if "quant/x" in data.files:
        result.update(_quantized(data, init, cfg, batch, targets, world, rank))
        result.update(audit_worlds(world))
        if world == 2:
            result.update(bench_records(world))

    if rank == 0:
        np.savez(out / "result.npz", **result)
    mesh.sync_global_devices()
    mesh.shutdown_runtime()


# world -> the one-step cases (label, strategy, config fields, options):
# "rng" passes step 0's key of seed 0, "count" records the step's
# collectives, "control" names a negative control
QUANT_STEPS = {
    2: [("ddp/int8", "ddp", dict(comm_dtype="int8"), dict(count=True)),
        ("ddp/bf16", "ddp", dict(comm_dtype="bf16"), dict(count=True)),
        ("ddp/f32b3", "ddp", dict(grad_buckets=3), dict(count=True)),
        ("ddp/int8b3", "ddp", dict(comm_dtype="int8", grad_buckets=3), dict(count=True)),
        ("ddp/int8sr", "ddp", dict(comm_dtype="int8", quant_stochastic=True, dropout=0.1),
         dict(rng=True)),
        ("fsdp/int8", "fsdp", dict(comm_dtype="int8"), dict(count=True)),
        ("fsdp/bf16", "fsdp", dict(comm_dtype="bf16"), dict(count=True)),
        ("fsdp/f32b3", "fsdp", dict(grad_buckets=3), dict(count=True)),
        ("control/ddp_reducer", "ddp", dict(comm_dtype="int8"), dict(control="reducer")),
        ("control/insertion_order", "ddp", dict(comm_dtype="int8"),
         dict(control="insertion_order"))],
    4: [(f"{kind}/f32b{n}", kind, dict(grad_buckets=n),
         dict(count=kind == "fsdp" and n == 3)) for kind in ("ddp", "fsdp")
        for n in (1, 2, 3, 5)],
}
# world -> the trajectories: label -> (strategy, config fields)
QUANT_TRAJ = {
    2: {},
    4: {"ddp/f32": ("ddp", {}), "ddp/int8": ("ddp", dict(comm_dtype="int8")),
        "ddp/bf16": ("ddp", dict(comm_dtype="bf16")),
        "ddp/int8sr": ("ddp", dict(comm_dtype="int8", quant_stochastic=True)),
        "fsdp/f32": ("fsdp", {}), "fsdp/int8": ("fsdp", dict(comm_dtype="int8")),
        "fsdp/int8sr": ("fsdp", dict(comm_dtype="int8", quant_stochastic=True))},
}
TRAJ_STEPS = 6


class ReducerLeftRunningDP(DataParallel):
    """The negative control: the hand-placed wire applied on top of DDP's
    own reduction (the f32 path's `.backward()` through the wrapper, then
    the quantized psum of what DDP left)."""

    def value_and_grad(self, params, cfg, batch, targets, rng=None):
        loss, grads = super().value_and_grad(params, cfg.replace(comm_dtype="f32"), batch,
                                             targets, rng=rng)
        return loss, quant_comm.quantized_psum_tree(grads, self.mesh.get_group(), self.world,
                                                    cfg.comm_dtype)


class InsertionOrderDP(DataParallel):
    """The negative control: the payload flattened in the tree's insertion
    order, not tpukit's sorted-key order."""

    def value_and_grad(self, params, cfg, batch, targets, rng=None):
        objective, _ = self._local_objective(params, cfg, batch, targets, rng)
        flat = list(torch.autograd.grad(objective, leaves(params)))
        red = quant_comm.quantized_all_reduce(torch.cat([g.reshape(-1) for g in flat]),
                                              self.mesh.get_group(), self.world, cfg.comm_dtype)
        parts = red.split([g.numel() for g in flat])
        return self._global_loss(objective), unflatten(
            params, [p.view_as(g) for p, g in zip(parts, flat)])


def _gather_out(t: torch.Tensor, world: int) -> np.ndarray:
    """Every rank's `t`, stacked in rank order (on every rank)."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts).numpy()


def _collectives(data, world: int, rank: int) -> dict:
    res = {}
    x, y, z = (torch.from_numpy(data[f"quant/{k}"][rank]) for k in ("x", "y", "z"))
    e, ct = torch.from_numpy(data["quant/e"][rank]), torch.from_numpy(data["quant/ct"][rank])
    for dtype in ("int8", "bf16"):
        outs = {
            "all_reduce": quant_comm.quantized_all_reduce(x, None, world, dtype),
            "reduce_scatter": quant_comm.quantized_reduce_scatter(y, None, world, 1, dtype),
            "all_gather": quant_comm.quantized_all_gather(z, None, world, 0, dtype),
            "bucket_all_reduce": quant_comm.bucket_all_reduce(x, None, world, dtype),
            "combine": quant_comm.exchange_all_to_all(
                torch.from_numpy(data["quant/h"][rank]), None, world, "combine", dtype),
        }
        leaf = e.clone().requires_grad_(True)
        sent = quant_comm.exchange_all_to_all(leaf, None, world, "dispatch", dtype)
        (sent * ct).sum().backward()
        outs.update(dispatch=sent.detach(), dispatch_grad=leaf.grad)
        for name, t in outs.items():
            res[f"quant/{name}/{dtype}"] = _gather_out(t, world)
    res["quant/bucket_all_reduce/f32"] = _gather_out(
        quant_comm.bucket_all_reduce(x, None, world, "f32"), world)
    return res


def _port_order(init: dict, cfg) -> dict:
    """`init` rebuilt in the key order of the port's own `init_params` (the
    tree a recipe trains), not the sorted order tpukit's arrays came in: the
    hand-placed wire must flatten it in tpukit's order all the same."""
    template = gpt.init_params(cfg, device="meta")
    flat = dict(zip(checkpoint.paths(init), leaves(init)))
    return unflatten(template, [flat[n] for n in checkpoint.paths(template)])


def _quantized(data, init, cfg, batch, targets, world: int, rank: int) -> dict:
    res = _collectives(data, world, rank)
    init = _port_order(init, cfg)
    rng = dropout_key(0, 0, "cpu")
    # every rank's exact f32 local gradients (its rows' CE sum over the
    # global count), before any wire: what each rank puts on it
    for tag, fields, key in (("plain", {}, None), ("dropout", dict(dropout=0.1), rng)):
        strategy = DataParallel()
        state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
        objective, _ = strategy._local_objective(state.params, cfg.replace(**fields), batch,
                                                 targets, key)
        grads = torch.autograd.grad(objective, leaves(state.params))
        for name, g in zip(checkpoint.paths(state.params), grads):
            res[f"qlocal/{tag}/{name}"] = _gather_out(g.detach(), world)
    make = {"ddp": DataParallel, "fsdp": FSDP,
            "reducer": ReducerLeftRunningDP, "insertion_order": InsertionOrderDP}
    for label, kind, fields, opts in QUANT_STEPS[world]:
        strategy = make[opts.get("control", kind)]()
        qcfg = cfg.replace(**fields)
        strategy.validate_config(qcfg)
        state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)

        def step():
            return strategy.value_and_grad(state.params, qcfg, batch, targets,
                                           rng=rng if opts.get("rng") else None)

        out: list = []
        calls = comm_bytes(lambda: out.append(step()))
        loss, grads = out[0]
        res[f"qstep/{label}/loss"] = np.float64(loss)
        res.update(_gathered(f"qstep/{label}/grad", grads))
        if opts.get("count"):
            res[f"qstep/{label}/calls"] = json.dumps(calls)
            res[f"qstep/{label}/closed"] = json.dumps(strategy.grad_comm(qcfg, state.params))
    for label, (kind, fields) in QUANT_TRAJ[world].items():
        strategy = {"ddp": DataParallel, "fsdp": FSDP}[kind]()
        qcfg = cfg.replace(**fields)
        state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
        losses = [float(train_step(state, qcfg, strategy, batch, targets))
                  for _ in range(TRAJ_STEPS)]
        res[f"qtraj/{label}"] = np.array(losses)
    return res


def audit_worlds(world: int) -> dict:
    """Every world of `python -m tpukit_torch.analysis` (`WORLDS`) run in
    this world: `audit/<name>`, JSON of every rank's measured collectives
    (`collective_summary` of its trace), its plan and its lint findings;
    for the worlds that declare overlap, also each collective's op, issue
    point and backward ops left (`calls`), and the clock's model backward
    ops (`bwd`, their ordinals) with the step's op count (`ops`), from
    which a test can rebuild the trace."""
    from tpukit_torch.analysis import __main__ as audit
    from tpukit_torch.analysis import collective_summary, lint_trace

    res = {}
    for name in audit.WORLDS:
        ctx = audit.build_world(name, world, torch.device("cpu"))
        plan, trace = ctx["plan"], ctx["trace"]
        rec = {"measured": collective_summary(trace),
               "plan": None if plan is None else dict(
                   ops=plan.ops, wire=plan.wire, exhaustive=plan.exhaustive,
                   overlap=plan.overlap),
               "findings": [f.to_record() for f in lint_trace(trace, plan=plan)]}
        if plan is not None and plan.overlap:
            wire = {c.node for c in trace.calls if c.node is not None}
            rec["calls"] = [dict(op=c.op, fn=c.fn, dtype=c.dtype, bytes=c.bytes,
                                 group=c.group, ops_at_issue=c.ops_at_issue,
                                 in_backward=c.in_backward,
                                 left=trace.backward_left(c) if c.in_backward else 0)
                            for c in trace.collectives()]
            rec["bwd"] = [o for o, node in trace._bwd if node not in wire]
            rec["ops"] = trace.ops
        gathered = [None] * world
        dist.all_gather_object(gathered, rec)
        res[f"audit/{name}"] = json.dumps(gathered)
    return res


# the bench twin's multi-rank records, at the tiny shape
# tests/test_torch_bench.py holds against tpukit's (`BENCH_TINY` there)
BENCH_TINY = dict(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=211,
                  max_position_embeddings=17)
BENCH_STEPS = 2


def bench_records(world: int) -> dict:
    """`tpukit_torch.bench`'s records that need several ranks, run in this
    world at `BENCH_TINY` (f32), rank 0's as JSON: `bench/quant_comm`,
    `bench/comm_overlap`, `bench/elastic_restore`; and a serving record
    through `on_rank_zero`, as the entry point runs them in a world of N
    (`bench/serving_on_rank_zero`: rank 0's record, and which ranks got
    None, gathered after the wait)."""
    from tpukit_torch.bench import __main__ as bench_main
    from tpukit_torch.bench import records, serving

    cfg = bench_main.bench_config(**BENCH_TINY, compute_dtype=torch.float32)
    dev = torch.device("cpu")
    rec = bench_main.on_rank_zero(lambda: serving.bench_serve_trace_overhead(
        cfg.replace(max_position_embeddings=64), world, requests=2, slots=2, max_new=2,
        device=dev))
    got_none = [None] * world
    dist.all_gather_object(got_none, rec is None)
    return {
        "bench/serving_on_rank_zero": json.dumps({"record": rec, "got_none": got_none}),
        "bench/quant_comm": json.dumps(records.bench_quant_comm(cfg, world, steps=BENCH_STEPS,
                                                                device=dev)),
        "bench/comm_overlap": json.dumps(records.bench_comm_overlap(
            cfg, world, steps=BENCH_STEPS, device=dev)),
        "bench/elastic_restore": json.dumps(records.bench_elastic_restore(cfg, world,
                                                                          device=dev)),
    }


def _step(state, strategy, cfg, batch, targets, rng=None, norms: dict | None = None):
    """(loss, gradients gathered whole) of one AdamW step, taken; `norms`
    receives the global grad and param norms before the update."""
    loss, grads = strategy.value_and_grad(state.params, cfg, batch, targets, rng=rng)
    if norms is not None:
        norms.update({k: np.float64(v) for k, v in
                      global_norms(grads, params=state.params, strategy=strategy).items()})
    names = checkpoint.paths(state.params)
    whole = {n: strategy.gather_leaf(n, g).detach().cpu().numpy()
             for n, g in zip(names, leaves(grads))}
    for p, g in zip(leaves(state.params), leaves(grads)):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return float(loss), whole


def _tp_whole(prefix: str, strategy, state, opt: bool = True) -> dict:
    """The parameters (and AdamW moments) of a TP state, gathered whole."""
    names = checkpoint.paths(state.params)
    out = {f"{prefix}/param/{n}": strategy.gather_leaf(n, p).detach().numpy()
           for n, p in zip(names, leaves(state.params))}
    for i, st in (state.optimizer.state_dict()["state"].items() if opt else ()):
        for k, v in st.items():
            out[f"{prefix}/opt/{names[i]}/{k}"] = strategy.gather_leaf(names[i], v).numpy()
    return out


def _tensor_parallel(data, out: Path, world: int) -> dict:
    res = {}
    cfg = GPTConfig(**json.loads(str(data["tp/config"])), compute_dtype=torch.float32)
    init = _nest({k[len("tp/param/"):]: data[k] for k in data.files
                  if k.startswith("tp/param/")})
    every = {k: torch.from_numpy(data[f"tp/{k}"]) for k in ("input_ids", "position_ids", "mask")}
    every_t = torch.from_numpy(data["tp/targets"])
    for d, m in TP_GRIDS[world]:
        label = f"tp/d{d}m{m}"
        strategy = TensorParallel(data=d, model=m)
        state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
        per = len(every_t) // d
        rows = slice(strategy.data_rank() * per, (strategy.data_rank() + 1) * per)
        batch, targets = {k: v[rows] for k, v in every.items()}, every_t[rows]
        count = float((targets != -100).sum())
        norms = {}
        res[f"{label}/loss"], grads = _step(state, strategy, cfg, batch, targets, norms=norms)
        res.update({f"{label}/grad/{n}": g for n, g in grads.items()})
        res.update({f"{label}/{k}": v for k, v in norms.items()})
        ev_loss, ev_acc = eval_step(state, cfg, strategy, batch, targets)
        total_loss, total_acc, total = strategy.all_sum(
            [float(ev_loss) * count, float(ev_acc) * count, count])
        res[f"{label}/eval_loss"] = np.float64(total_loss / total)
        res[f"{label}/eval_acc"] = np.float64(total_acc / total)
        res.update(_tp_whole(label, strategy, state))
        dims = [(n, -1 if dim is None else dim) for n, dim in strategy._dims.items()]
        res[f"{label}/dims/names"] = np.array([n for n, _ in dims], dtype=str)
        res[f"{label}/dims/dim"] = np.array([dim for _, dim in dims])
        res[f"{label}/sharded"] = str(checkpoint.save_sharded(state, out / f"d{d}m{m}_sharded"))
        res[f"{label}/consolidated"] = str(
            checkpoint.save_consolidated(state, out / f"d{d}m{m}_consolidated"))
        fresh_strategy = TensorParallel(data=d, model=m)
        fresh = create_train_state(params_from_numpy(init, "cpu"), LR, fresh_strategy)
        checkpoint.restore_any(str(data["tp/tk_sharded"]), fresh)
        res.update(_tp_whole(f"{label}/tk_restored", fresh_strategy, fresh))
        if (d, m) == TP_GRIDS[world][0]:
            # ties across the shards go to the lowest global index
            r = strategy.mesh.get_local_rank("model")
            local = torch.zeros((3, 8))
            local[0, 5] = 1.0
            local[2, 2] = 1.0 if r == 0 else 2.0
            res["tp/argmax"] = vocab_parallel_argmax(local, r * 8, 8 * m,
                                                     strategy.mesh.get_group("model")).numpy()
            shared = SharedCotangentTP(data=d, model=m)
            state = create_train_state(params_from_numpy(init, "cpu"), LR, shared)
            _, grads = _step(state, shared, cfg, batch, targets)
            res.update({f"tp/shared/grad/{n}": g for n, g in grads.items()})
            strategy = TensorParallel(data=d, model=m)
            state = create_train_state(params_from_numpy(init, "cpu"), LR, strategy)
            res["tp/dropout/loss"], grads = _step(state, strategy, cfg.replace(dropout=0.1),
                                                  batch, targets, rng=dropout_key(0, 0, "cpu"))
            res.update({f"tp/dropout/grad/{n}": g for n, g in grads.items()})
    for name, shape in TP_ODD[world].items():
        ocfg = GPTConfig(**{**json.loads(str(data["tp/config"])), **shape},
                         compute_dtype=torch.float32)
        strategy = TensorParallel()
        state = create_train_state(gpt.init_params(ocfg, seed=0, device="cpu"), LR, strategy)
        ids = every["input_ids"] % ocfg.vocab_size
        tgt = torch.where(every_t == -100, every_t, every_t % ocfg.vocab_size)
        loss, grads = _step(state, strategy, ocfg, {**every, "input_ids": ids}, tgt)
        res[f"tp/odd/{name}/loss"] = loss
        res.update({f"tp/odd/{name}/grad/{n}": g for n, g in grads.items()})
        res.update(_tp_whole(f"tp/odd/{name}", strategy, state, opt=False))
        res[f"tp/odd/{name}/split"] = np.array(
            [n for n, dim in strategy._dims.items() if dim is not None], dtype=str)
    return res


# case -> (grid (data, model), engine options, parameter set)
SERVE_CASES = {
    "ring": ((1, 2), {}, "dense"),
    "ring-sampled": ((1, 2), dict(temperature=0.8, top_k=40), "dense"),
    "paged": ((1, 2), dict(page_size=4, fused_decode=True), "dense"),
    "paged-sampled": ((1, 2), dict(page_size=4, fused_decode=True, temperature=0.8, top_k=40),
                      "dense"),
    "paged-unfused": ((1, 2), dict(page_size=4), "dense"),
    "ring-data2": ((2, 1), {}, "dense"),
    "ring-data2-sampled": ((2, 1), dict(temperature=0.8, top_k=40), "dense"),
    "moe-data2": ((2, 1), {}, "moe"),
    "checkpoint": ((1, 2), dict(page_size=4, fused_decode=True), "checkpoint"),
}


def serve_main(data, out: Path) -> dict:
    """Serve `serve/ids/<rid>` (seeded `serve/seed/<rid>`) on every case of `SERVE_CASES` (the world's
    grid, `TensorParallel`'s shards of a dense model, an MoE model whole),
    then `python -m tpukit_torch.serve`'s `main` in this world with
    `serve/cli`, `serve/cli_idle` (a grid that leaves a rank idle),
    `serve/cli_obs` and `serve/cli_obs_ring` (the telemetry flags, paged on
    model 2 and the ring on data 2) as its argv, each rank in
    `<out>/<key>/rank<r>` (rank 0's printouts kept as `<key>/stdout`)."""
    import contextlib
    import io

    from tpukit_torch.serve import __main__ as serve_cli
    from tpukit_torch.serve.engine import Request, ServeConfig, ServeEngine

    base = json.loads(str(data["serve/config"]))
    serve_kw = json.loads(str(data["serve/serve"]))
    reqs = [Request(rid=int(k.rsplit("/", 1)[1]), ids=tuple(int(t) for t in data[k]),
                    max_new_tokens=serve_kw["max_new_tokens"],
                    seed=int(data[k.replace("/ids/", "/seed/")]))
            for k in data.files if k.startswith("serve/ids/")]
    sets = {name: _nest({k[len(f"serve/{name}/"):]: data[k] for k in data.files
                         if k.startswith(f"serve/{name}/")}) for name in ("dense", "moe")}
    res = {}
    for case, ((d, m), kw, which) in SERVE_CASES.items():
        cfg = GPTConfig(**base, compute_dtype=torch.float32)
        if which == "moe":
            cfg = cfg.replace(num_experts=4, moe_dispatch="pallas")
        if which == "checkpoint":
            params, _ = checkpoint.restore_params(str(data["serve/checkpoint"]),
                                                  gpt.init_params(cfg, device="meta"), "cpu")
        else:
            params = params_from_numpy(sets[which], "cpu")
        grid = mesh.create_tp_mesh(d, m, "cpu")
        if which != "moe":
            params = TensorParallel(mesh=grid).setup(params)
        engine = ServeEngine(params, cfg, ServeConfig(**{**serve_kw, **kw}),
                             eos_id=int(data["serve/eos"]), device="cpu", mesh=grid)
        for c in engine.run(list(reqs), max_wall_s=300):
            res[f"{case}/{c.rid}"] = np.asarray(c.ids)
        res[f"{case}/kv_bytes"] = np.int64(engine.kv_bytes)
    for key in ("cli", "cli_idle", "cli_obs", "cli_obs_ring"):
        # each rank in a directory of its own: the telemetry flags' relative
        # paths show which ranks write
        work = out / key / f"rank{dist.get_rank()}"
        work.mkdir(parents=True)
        cwd = os.getcwd()
        os.chdir(work)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                serve_cli.main([str(a) for a in data[f"serve/{key}"]])
        finally:
            os.chdir(cwd)
        res[f"{key}/stdout"] = buf.getvalue()
    return res


if __name__ == "__main__":
    main()
