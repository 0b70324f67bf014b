"""Serving stack of the port: the paged KV cache (`paged`), the decode
programs over the ring or the pages (`decode`), speculative decoding
(`spec`) and the continuous-batching engine (`engine`).

`python -m tpukit_torch.serve` is the entry point (`__main__.py`). This
package module imports nothing, so `tpukit_torch.ops` can use
`serve.paged` without an import cycle through the engine.
"""
