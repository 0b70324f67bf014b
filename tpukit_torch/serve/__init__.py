"""Serving stack of the port: the paged KV cache (`paged`), the decode
programs over the ring or the pages (`decode`), speculative decoding
(`spec`), the continuous-batching engine (`engine`), the fleet router over
engine replicas (`fleet`) and the durable request ledger with its fleet of
worker processes (`ledger`).

`python -m tpukit_torch.serve` is the entry point (`__main__.py`). The
names tpukit's `serve/__init__.py` exports resolve on first use, so
importing this package imports nothing and `tpukit_torch.ops` can use
`serve.paged` without an import cycle through the engine.
"""

import importlib

_EXPORTS = {
    "decode_loop": "decode", "decode_step": "decode", "prefill_chunk_paged": "decode",
    "prefill_slots": "decode",
    "STREAM_PROFILES": "engine", "Completion": "engine", "Request": "engine",
    "ServeConfig": "engine", "ServeEngine": "engine", "synthetic_request_stream": "engine",
    "FleetConfig": "fleet", "FleetRouter": "fleet", "pick_serve_grid": "fleet",
    "ProcessFleet": "ledger", "RequestLedger": "ledger", "serve_from_ledger": "ledger",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
