"""Live device memory gauges (twin of `live_memory_stats`,
`tpukit/obs/xla.py:230`).

`torch.cuda.memory_stats()` under tpukit's keys, as `tools/report.py`
reads them (the `hbm` block of a `train` record): `bytes_in_use` is the
caching allocator's `allocated_bytes.all.current`, `peak_bytes_in_use` its
`allocated_bytes.all.peak`, `bytes_limit` the card's total memory. The
allocator keeps these counters on the host, so reading them never waits on
the device's queue (the watchdog's bundle reads them while a stream may be
wedged). The rest of tpukit's `xla.py` (HLO cost and memory analysis, the
collective byte counts) has no counterpart in an eager port.
"""

from __future__ import annotations

import torch


def live_memory_stats(device=None) -> dict | None:
    """The gauges of a CUDA device, or None on the CPU (as tpukit's on a
    backend without `memory_stats()`)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }
