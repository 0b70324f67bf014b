"""The serving grid (twin of `tpukit/serve/fleet.py:91-125`,
`pick_serve_grid`). The rest of tpukit's `fleet.py` (the router,
disaggregated prefill, autoscale) is ROADMAP.md item 19."""

from __future__ import annotations


def pick_serve_grid(n_devices: int, heads: int, slots: int, paged: bool = False,
                    announce: bool = True) -> dict:
    """(data x model) serving grid: the largest model degree <= 4 dividing
    both the device count and the head count (the KV ring shards heads
    over `model`; main-tp.py's rule), remaining devices data-parallel,
    shrunk to the largest divisor of the slot count, since slots shard
    over `data`. Paged serving requires a model-only grid (the page pool
    and block tables are the same on every data replica) and therefore
    drops the <= 4 cap: `model` grows to the largest head-dividing degree,
    and `announce` prints when devices stay idle."""
    if paged:
        for model in range(min(n_devices, heads), 0, -1):
            if heads % model == 0:
                if model < n_devices and announce:
                    print(f"paged serving uses a model-only grid: "
                          f"model={model} of {n_devices} devices "
                          f"(model degree is capped by heads={heads})")
                return {"data": 1, "model": model}
    for model in (4, 2, 1):
        if n_devices % model == 0 and heads % model == 0:
            data = n_devices // model
            while data > 1 and slots % data:
                data -= 1
            return {"data": data, "model": model}
    return {"data": 1, "model": 1}
