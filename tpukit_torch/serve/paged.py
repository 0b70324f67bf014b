"""Paged KV cache: fixed-size pages and per-slot block tables (twin of
`tpukit/serve/paged.py:80-446`).

  - Page pools `[L, num_pages, H, P, D]` for K and for V; page 0 is the
    reserved NULL page, the sink of masked writes, so a block-table row of
    zeros is always safe to dereference.
  - Block tables `[N, pages_per_slot]` int32: logical position `q` of slot
    `b` lives in page `bt[b, q // P]` at offset `q % P`.
  - int8 pools quantize each (page, head) row `[P * D]` in 256-element
    blocks (`ops.quant_comm`), with f32 scale sidecars `[L, NP, H, blocks]`.

The write-safety invariants are the JAX package's: a slot's writable pages
are its own (shared prefix pages are capped at `(prompt_len - 1) // P`),
masked rows write to page 0, and reads past a slot's cursor are masked by
the causal window.

Unlike the JAX functions, which return new pools, `write_token` and
`write_pages` update the pools IN PLACE: a decode tick then moves one
token's K/V instead of copying the pool. Each layer reads its pools before
it writes them, so the results are the same.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

import torch

from tpukit_torch import resolve_device
from tpukit_torch.ops import quant_comm

KV_DTYPES = ("f32", "bf16", "int8")

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


def storage_dtype(kv_dtype: str) -> torch.dtype:
    """torch storage dtype of a non-quantized page pool."""
    if kv_dtype not in _STORAGE:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return _STORAGE[kv_dtype]


def validate_kv_layout(cfg, page_size: int, kv_dtype: str,
                       block: int = quant_comm.DEFAULT_BLOCK) -> None:
    """Reject at construction a layout the int8 quantizer cannot tile:
    each head's flattened `[P, D]` page row must be a multiple of `block`."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    if kv_dtype == "int8":
        row = page_size * cfg.head_dim
        if row % block:
            raise ValueError(
                f"kv_dtype=int8 requires the page payload per head "
                f"(page_size {page_size} x head_dim {cfg.head_dim} = {row} "
                f"elements) to be a multiple of quant_comm's {block}-element "
                f"quant block — use a page size that tiles into {block}s "
                f"(e.g. page_size {-(-block // cfg.head_dim)})"
            )


def scale_blocks(cfg, page_size: int, block: int = quant_comm.DEFAULT_BLOCK) -> int:
    """f32 scales per (page, head) row of an int8 pool."""
    return (page_size * cfg.head_dim) // block


def init_paged_cache(cfg, num_pages: int, page_size: int, pages_per_slot: int,
                     slots: int, kv_dtype: str = "f32", device=None) -> dict:
    """The paged cache: K/V pools `[L, num_pages, H, P, D]` (int8 adds the
    `ks`/`vs` scale sidecars `[L, num_pages, H, blocks]`) and the block
    tables `bt [slots, pages_per_slot]` int32, all zeros. Under tensor
    parallelism the pools and scales hold the rank's heads
    (`cfg.local_heads`); the block tables are the same on every rank."""
    device = resolve_device(device)
    validate_kv_layout(cfg, page_size, kv_dtype)
    shape = (cfg.num_layers, num_pages, cfg.local_heads, page_size, cfg.head_dim)
    bt = torch.zeros((slots, pages_per_slot), dtype=torch.int32, device=device)
    if kv_dtype == "int8":
        sshape = (cfg.num_layers, num_pages, cfg.local_heads, scale_blocks(cfg, page_size))
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device),
            "bt": bt,
        }
    dt = storage_dtype(kv_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "bt": bt}


def pool_bytes(cfg, num_pages: int, page_size: int, kv_dtype: str) -> int:
    """Closed-form device bytes of the K+V pools on one rank, its heads
    under tensor parallelism (int8 pays one byte per element plus the f32
    scale per 256-element block)."""
    per_head_row = page_size * cfg.head_dim
    if kv_dtype == "int8":
        row_bytes = quant_comm.packed_bytes(per_head_row)
    else:
        row_bytes = per_head_row * storage_dtype(kv_dtype).itemsize
    return 2 * cfg.num_layers * num_pages * cfg.local_heads * row_bytes


# -- device-side page ops (called per layer from gpt.forward_cached) --------


def gather_view(pool, scales, bt, out_dtype):
    """Dereference the block tables: `pool [NP, H, P, D]` gathered through
    `bt [N, MP]` into the per-row view `[N, H, MP*P, D]` in `out_dtype`.
    int8 pools dequantize after the gather."""
    idx = bt.long()
    v = pool[idx]  # [N, MP, H, P, D]
    n, mp, h, p, d = v.shape
    if scales is not None:
        v = quant_comm.dequantize_blocks(
            v.reshape(n, mp, h, p * d), scales[idx]
        ).reshape(n, mp, h, p, d)
    return v.to(out_dtype).permute(0, 2, 1, 3, 4).reshape(n, h, mp * p, d)


def write_token(pool, scales, bt, start, val, write_mask) -> None:
    """Decode-tick write-back, in place: row `b`'s fresh K (or V)
    `val [N, H, D]` lands at position `start[b]`, page `bt[b, start // P]`,
    offset `start % P`. Rows with `write_mask` False go to the null page.
    int8 pools dequantize the touched page row, insert the value and
    requantize the whole row."""
    n = start.shape[0]
    p = pool.shape[2]
    start = start.long()
    off = start % p
    pids = bt.long().gather(1, (start // p)[:, None])[:, 0]
    pids = torch.where(write_mask, pids, torch.zeros_like(pids))
    if scales is None:
        pool[pids, :, off, :] = val.to(pool.dtype)
        return
    h, d = pool.shape[1], pool.shape[3]
    deq = quant_comm.dequantize_blocks(
        pool[pids].reshape(n, h, p * d), scales[pids]
    ).reshape(n, h, p, d)
    hit = torch.arange(p, device=pool.device)[None, None, :, None] == off[:, None, None, None]
    deq = torch.where(hit, val[:, :, None, :].float(), deq)
    q, s = quant_comm.quantize_blocks(deq.reshape(n, h, p * d))
    pool[pids] = q.reshape(n, h, p, d)
    scales[pids] = s


def write_pages(pool, scales, bt, start, vals, write_mask) -> None:
    """Prefill-chunk write-back, in place: `vals [N, H, C, D]` covers
    positions `[start[b], start[b] + C)`, with `start` page-aligned and C a
    page multiple, so the write is whole pages. Masked lanes, and chunk
    pages past a lane's allocation (block-table zeros), go to page 0."""
    n, h, c, d = vals.shape
    p = pool.shape[2]
    npg = c // p
    first = start.long() // p
    j = torch.arange(npg, device=start.device)
    pids = bt.long().gather(1, first[:, None] + j[None, :])
    pids = torch.where(write_mask[:, None], pids, torch.zeros_like(pids)).reshape(-1)
    rows = vals.reshape(n, h, npg, p, d).permute(0, 2, 1, 3, 4).reshape(n * npg, h, p, d)
    if scales is None:
        pool[pids] = rows.to(pool.dtype)
        return
    q, s = quant_comm.quantize_blocks(rows.float().reshape(n * npg, h, p * d))
    pool[pids] = q.reshape(n * npg, h, p, d)
    scales[pids] = s


# -- page handoff (the fleet's disaggregated prefill) ------------------------
# The device-to-device page copy of the prefill -> decode handoff (twin of
# `tpukit/serve/paged.py:243-272`): `extract_pages` gathers the source
# pool's page rows (every layer, every head) into a dense block, the caller
# moves the block to the destination engine's device, and `insert_pages`
# scatters it into the destination pool. Works on K/V pools `[L, NP, H, P,
# D]` and int8 scale sidecars `[L, NP, H, blocks]` alike: the page axis is
# axis 1. Plain indexing, as tpukit computes it outside any kernel.


def extract_pages(pool, ids):
    """`pool[:, ids]`: the page rows to hand off, `[L, n, ...]`."""
    return pool[:, ids]


def insert_pages(pool, ids, block):
    """Write a handed-off block into `pool` at page rows `ids`, cast to the
    pool's dtype, in place; returns the pool. The destination pages are
    freshly allocated (refcount 1), so no reader sees the write."""
    pool[:, ids] = block.to(pool.dtype)
    return pool


# -- host-side page allocator + shared-prefix registry ----------------------


@dataclasses.dataclass
class PageStats:
    """Counters the engine reports in its summary."""

    prefix_hits: int = 0
    prefix_pages_reused: int = 0
    prefix_lookups: int = 0
    reclaimed: int = 0


class PageAllocator:
    """Host-side bookkeeping for the page pool: a free list over pages
    `1..num_pages-1` (0 is the null page), per-page refcounts, and the
    shared-prefix registry.

    The registry is a chain keyed by `(parent_page_id, chunk_tokens)`: a
    page is reachable only through its registered parent, so matching is
    exact, and freeing a parent purges its subtree. Registered pages whose
    refcount drops to 0 are RETAINED in an LRU and reclaimed only when an
    allocation would otherwise fail."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages={num_pages} must be >= 2 (page 0 is the "
                f"reserved null page)"
            )
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = deque(range(1, num_pages))
        self.refcount = [0] * num_pages
        self._registry: dict[tuple, int] = {}  # (parent, chunk) -> page
        self._key_of: dict[int, tuple] = {}  # page -> its registry key
        self._parent: dict[int, int] = {}  # page -> parent page (0 = root)
        self._children: dict[int, set] = {}  # page -> registered children
        self._retained: OrderedDict[int, None] = OrderedDict()  # refcount-0 LRU
        self.stats = PageStats()

    # ---- accounting ----

    @property
    def free_pages(self) -> int:
        """Pages allocatable WITHOUT evicting retained prefix pages."""
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages an `alloc` could produce (free + reclaimable retained)."""
        return len(self._free) + len(self._retained)

    @property
    def live_pages(self) -> int:
        """Pages referenced by at least one slot."""
        return (self.num_pages - 1) - len(self._free) - len(self._retained)

    @property
    def occupancy(self) -> float:
        """Live fraction of the allocatable pool."""
        return self.live_pages / max(self.num_pages - 1, 1)

    # ---- allocate / release ----

    def alloc(self, n: int) -> list[int] | None:
        """`n` exclusive pages (refcount 1 each), or None if the pool cannot
        cover them even after reclaiming retained prefix pages in LRU order.
        Feasibility is checked BEFORE any reclaim, so a doomed allocation
        leaves the registry untouched."""
        if len(self._free) + len(self._retained) < n:
            return None
        while len(self._free) < n and self._retained:
            self._purge(next(iter(self._retained)))
            self.stats.reclaimed += 1
        if len(self._free) < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            self.refcount[p] = 1
        return out

    def claim(self, pages: list[int]) -> None:
        """Take a reader reference on shared pages (a prefix hit). A
        retained page comes back live."""
        for p in pages:
            if p in self._retained:
                del self._retained[p]
            self.refcount[p] += 1

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page. A registered page at refcount 0 is
        retained for future prefix hits; an unregistered one is freed."""
        for p in pages:
            if p <= 0:
                continue
            self.refcount[p] -= 1
            if self.refcount[p] < 0:
                raise AssertionError(f"page {p} refcount went negative")
            if self.refcount[p] == 0:
                if p in self._key_of:
                    self._retained[p] = None
                else:
                    self._free.append(p)

    def _purge(self, pid: int) -> None:
        """Remove `pid`'s registration and its whole registered subtree.
        Retained pages in the subtree return to the free list; live ones
        lose their registration and free at their last release."""
        key = self._key_of.pop(pid, None)
        if key is not None:
            self._registry.pop(key, None)
        parent = self._parent.pop(pid, None)
        if parent is not None and parent in self._children:
            self._children[parent].discard(pid)
        if pid in self._retained:
            del self._retained[pid]
            self._free.append(pid)
        for child in list(self._children.pop(pid, ())):
            self._purge(child)

    # ---- shared-prefix registry ----

    def _chunk(self, ids, i: int) -> tuple:
        p = self.page_size
        return tuple(int(t) for t in ids[i * p : (i + 1) * p])

    def lookup_prefix(self, ids, max_pages: int) -> list[int]:
        """Longest registered chain matching `ids` page by page, capped at
        `max_pages` (the caller passes `(prompt_len - 1) // P`). Returned
        pages are NOT yet claimed."""
        self.stats.prefix_lookups += 1
        out: list[int] = []
        parent = 0
        for i in range(max_pages):
            pid = self._registry.get((parent, self._chunk(ids, i)))
            if pid is None:
                break
            out.append(pid)
            parent = pid
        return out

    def register(self, ids, pages: list[int]) -> None:
        """Publish `pages[i] = K/V of ids[i*P:(i+1)*P]` once a slot's prefill
        is complete. Already-registered chunks keep their first page, and
        deeper chunks chain from it, so one popular prefix converges to one
        chain."""
        parent = 0
        for i, pid in enumerate(pages):
            key = (parent, self._chunk(ids, i))
            existing = self._registry.get(key)
            if existing is not None:
                parent = existing
                continue
            if pid in self._key_of:  # already published under another chain
                parent = pid
                continue
            self._registry[key] = pid
            self._key_of[pid] = key
            self._parent[pid] = parent
            self._children.setdefault(parent, set()).add(pid)
            parent = pid

    def registered_pages(self) -> int:
        return len(self._key_of)
