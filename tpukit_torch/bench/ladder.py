"""The bench's shared harness and the single-card ladder (twin of
`tools/bench_ladder.py`).

Every record of `python -m tpukit_torch.bench` builds its step through
`setup_step` and times it through `time_windows`, on batches from
`make_batch`, as tpukit's `bench.py` does through this module's twin.

The ladder measures one card's share of each rung tpukit's `BASELINE.md`
names (GPT-small and GPT-medium whole; the 16-layer stage slices of
GPT-large and GPT-XL that one stage of a 4- or 8-stage pipeline runs) at
head_dim 64, bf16, AdamW. A rung's `remat` is applied as given
(`remat_layers`); its `scan` has no meaning in the eager port, which runs
the layer stack unrolled, and the rung's `config` says it was ignored.
"""

from __future__ import annotations

import time

import numpy as np
import torch

LADDER = [
    # name, dim, heads, head_dim, layers, seq, batch, remat, scan (tpukit's)
    ("gpt-small-dim768", 768, 12, 64, 12, 512, 64, False, False),
    ("gpt-medium-dim1024", 1024, 16, 64, 24, 512, 32, True, False),
    ("gpt-large-slice-dim1280", 1280, 20, 64, 16, 512, 32, True, False),
    ("gpt-xl-slice-dim1600", 1600, 25, 64, 16, 512, 32, True, True),
]


def make_batch(rng, vocab: int, batch: int, seq: int):
    """Synthetic (model_batch, targets) of the whole batch in the
    trainer's input format, numpy, as tpukit's `make_batch` makes them:
    uniform token ids, positions 0..seq-1, no padding, targets the ids
    rolled by one."""
    ids = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    model_batch = {
        "input_ids": ids,
        "position_ids": np.ascontiguousarray(
            np.broadcast_to(np.arange(seq, dtype=np.int32), ids.shape)),
        "mask": np.zeros_like(ids, dtype=bool),
    }
    return model_batch, np.roll(ids, -1, axis=1).astype(np.int32)


class Step:
    """`train.train_step` of one config and strategy as tpukit's jitted
    step is called: `step(state, model_batch, targets) -> (state, loss)`
    on the whole batch (numpy); each rank takes its rows of it
    (`Strategy.row_shard`) and keeps them on the device, so a repeated
    batch moves once."""

    def __init__(self, cfg, strategy, device):
        self.cfg, self.strategy, self.device = cfg, strategy, device
        self._placed: tuple | None = None

    def place(self, model_batch: dict, targets: np.ndarray) -> tuple[dict, torch.Tensor]:
        if self._placed is not None and self._placed[0] is model_batch:
            return self._placed[1]
        from tpukit_torch.train import to_device

        shards, shard = self.strategy.row_shards, self.strategy.row_shard()
        n = targets.shape[0]
        rows = slice(shard * n // shards, (shard + 1) * n // shards)
        placed = to_device({k: v[rows] for k, v in model_batch.items()},
                           targets[rows], self.device)
        self._placed = (model_batch, placed)
        return placed

    def __call__(self, state, model_batch: dict, targets: np.ndarray):
        from tpukit_torch.train import train_step

        batch, t = self.place(model_batch, targets)
        return state, train_step(state, self.cfg, self.strategy, batch, t)


def setup_step(cfg, strategy=None, lr=1e-4, seed: int = 0, device=None,
               params: dict | None = None):
    """The state and step of `cfg` under `strategy` (`SingleDevice` by
    default): parameters from `init_params(seed)` (or `params`, a tree of
    tensors such as `bridge.params_from_numpy` makes), AdamW at `lr` (a
    float, or a schedule `count -> rate` such as
    `train.cosine_decay_schedule`, as tpukit's takes an optax schedule),
    the strategy's layout. Returns `(step, state)` for `time_windows`; the
    kernels build and load at the first step, in its warm-up."""
    from tpukit_torch import resolve_device
    from tpukit_torch.model import init_params
    from tpukit_torch.shardings import SingleDevice
    from tpukit_torch.train import create_train_state

    device = resolve_device(device)
    strategy = strategy if strategy is not None else SingleDevice()
    strategy.validate_config(cfg)
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    state = create_train_state(params, lr, strategy, cfg)
    return Step(cfg, strategy, device), state


def time_windows(step_fn, state, model_batch, targets, steps: int, windows: int,
                 warmup: int = 3):
    """Warm up (the kernels' build and load), then time `windows` windows
    of `steps` steps. Returns (window times, state, last loss). Each window
    ends in a host read of the loss, which waits for the card; callers
    report the fastest window as the steady state and may report the
    spread."""
    last, loss = None, None
    for _ in range(warmup):
        state, loss = step_fn(state, model_batch, targets)
    if warmup:
        last = float(loss)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step_fn(state, model_batch, targets)
        last = float(loss)
        times.append(time.perf_counter() - t0)
    return times, state, last


def bench_shape(name, dim, heads, head_dim, layers, seq, batch, remat, scan, steps=8,
                windows=3, device=None) -> dict:
    """One rung on this card: tokens/s, MFU against the card's peak bf16
    rate (None where the card is not in `obs.meter`'s table), the step's
    milliseconds."""
    from tpukit_torch import resolve_device
    from tpukit_torch.model import GPTConfig
    from tpukit_torch.obs import peak_flops_per_chip, train_flops_per_token
    from tpukit_torch.obs.meter import device_kind

    device = resolve_device(device)
    cfg = GPTConfig(dim=dim, head_dim=head_dim, heads=heads, num_layers=layers,
                    vocab_size=50257, max_position_embeddings=seq,
                    compute_dtype=torch.bfloat16, remat_layers=remat)
    step, state = setup_step(cfg, device=device)
    model_batch, targets = make_batch(np.random.RandomState(0), cfg.vocab_size, batch, seq)
    times, state, _ = time_windows(step, state, model_batch, targets, steps, windows, warmup=2)
    best = min(times)
    tps = steps * batch * seq / best
    peak = peak_flops_per_chip(device_kind(device))
    mfu = tps * train_flops_per_token(cfg, seq) / peak if peak else None
    del state
    return {
        "shape": name,
        "config": (f"dim{dim} hd{head_dim}x{heads} L{layers} seq{seq} b{batch}"
                   + (" remat" if remat else "")
                   + (" unrolled (scan ignored: eager)" if scan else " unrolled")),
        "tokens_per_sec_per_chip": round(tps, 1),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "step_ms": round(best / steps * 1e3, 2),
    }


def free_cache() -> None:
    """Hand the card's cached blocks back between records."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_ladder(steps=8, windows=3, only=None, batch=None, device=None) -> list:
    """Every rung, never raising: a rung that fails lands in the list as
    `{"shape", "error"}`."""
    out = []
    for name, dim, heads, hd, layers, seq, b, remat, scan in LADDER:
        if only and only not in name:
            continue
        try:
            out.append(bench_shape(name, dim, heads, hd, layers, seq, batch or b, remat, scan,
                                   steps, windows, device))
        except Exception as exc:
            out.append({"shape": name, "error": repr(exc)})
        finally:
            free_cache()
    return out
