"""Continuous-batching serving engine over the paged KV cache (twin of
`tpukit/serve/engine.py`, its paged path).

The host scheduler: a free list of decode lanes (`slots`), page-aware
admission (a request holds `ceil(min(prompt + budget, width) / P)` pages
from admission to eviction), shared-prefix reuse through the page
registry, chunked prefill between decode quanta, and eviction on EOS or
length. With `fused_decode` every decode tick runs the paged-attention
kernel once per layer and each quantum is a `decode_loop_window` that can
stop early; without it, a quantum is `decode_step` over the gathered view.
Token streams are the same either way.

Not in this slice (ROADMAP.md): the ring cache (`page_size == 0`),
seeded sampling, speculative decoding, request tracing, the metrics plane,
deadlines and the fleet hooks.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from tpukit_torch import NotPortedError, resolve_device
from tpukit_torch.data import synthetic_stories
from tpukit_torch.model import gpt
from tpukit_torch.serve import decode as serve_decode
from tpukit_torch.serve import paged as paged_lib


@dataclasses.dataclass(frozen=True)
class Request:
    """One request: a tokenized prompt, its decode budget, the seed of its
    sampling key (unused by greedy decoding) and its arrival offset in
    seconds from the start of the stream."""

    rid: int
    ids: tuple[int, ...]
    max_new_tokens: int = 20
    seed: int = 0
    arrival_s: float = 0.0


@dataclasses.dataclass
class Completion:
    """A finished request. `ids` holds prompt + generated tokens; times are
    run-relative seconds. `pages` is the request's page footprint,
    `prefix_pages` how many of them were shared-prefix hits, `active_s`
    when its prefill finished and decoding began."""

    rid: int
    ids: np.ndarray
    prompt_len: int
    generated: int
    reason: str  # "eos" | "length"
    arrival_s: float
    admit_s: float
    done_s: float
    pages: int = 0
    prefix_pages: int = 0
    active_s: float = 0.0

    @property
    def e2e_s(self) -> float:
        """End-to-end latency including queue wait."""
        return self.done_s - self.arrival_s

    @property
    def per_token_s(self) -> float:
        """Decode-resident seconds per generated token."""
        return (self.done_s - self.admit_s) / max(self.generated, 1)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape. `buckets` is the declared prompt-length set; prompts
    longer than `max(buckets)` are rejected at admission. The logical slot
    width is `max(buckets) + max_new_tokens`.
    `decode_quantum` is the number of ticks per dispatch (the window size
    with `fused_decode`). `page_size` must divide every bucket; `num_pages`
    0 sizes the pool like a ring (slots x pages-per-slot + the null page);
    `prefill_chunk` 0 is one page. Decoding is greedy: seeded sampling
    waits for a token-exact port of jax.random's threefry (ROADMAP.md,
    queue A item 'Seeded sampling')."""

    slots: int = 8
    buckets: tuple[int, ...] = (16, 32, 64)
    max_new_tokens: int = 20
    decode_quantum: int = 4
    page_size: int = 16
    num_pages: int = 0
    kv_dtype: str = "f32"
    prefill_chunk: int = 0
    fused_decode: bool = False

    def __post_init__(self):
        if self.page_size < 0:
            raise ValueError(f"page_size={self.page_size} must be >= 0")
        if self.page_size == 0:
            raise NotPortedError(
                "page_size=0 selects tpukit's ring KV cache, which is not in "
                "the port yet (ROADMAP.md, queue A item 'Ring-cache serving'); "
                "serve with --page_size > 0"
            )
        if self.slots < 1:
            raise ValueError(f"slots={self.slots} must be >= 1")
        if self.decode_quantum < 1:
            raise ValueError(f"decode_quantum={self.decode_quantum} must be >= 1")
        b = tuple(self.buckets)
        if not b or list(b) != sorted(set(b)) or b[0] < 1:
            raise ValueError(
                f"buckets={self.buckets} must be unique, ascending and >= 1"
            )
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={self.max_new_tokens} must be >= 1")
        if self.kv_dtype not in paged_lib.KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {paged_lib.KV_DTYPES}, got {self.kv_dtype!r}"
            )
        bad = [x for x in b if x % self.page_size]
        if bad:
            raise ValueError(
                f"page_size={self.page_size} must divide every bucket "
                f"width (buckets {bad} don't tile) — admit chunks are "
                f"page-aligned whole-page writes"
            )
        if self.prefill_chunk and self.prefill_chunk % self.page_size:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be a multiple of "
                f"page_size={self.page_size} — chunks write whole pages"
            )
        if self.prefill_chunk:
            bad = [x for x in b if x % self.prefill_chunk]
            if bad:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must divide every "
                    f"bucket width (buckets {bad} don't tile) — a partial "
                    f"tail chunk would write past its bucket row"
                )
        if self.num_pages and self.num_pages - 1 < self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one "
                f"worst-case request ({self.pages_per_slot} pages for "
                f"width {self.width}, plus the reserved null page)"
            )

    @property
    def width(self) -> int:
        return max(self.buckets) + self.max_new_tokens

    @property
    def pages_per_slot(self) -> int:
        """Block-table width: pages covering the worst-case sequence."""
        return -(-self.width // self.page_size)

    @property
    def padded_width(self) -> int:
        """Per-slot width of the paged view (width rounded up to pages)."""
        return self.pages_per_slot * self.page_size

    @property
    def chunk(self) -> int:
        """Chunked-prefill chunk actually used."""
        return self.prefill_chunk or self.page_size


@dataclasses.dataclass
class _Lane:
    req: Request
    admit_s: float
    prompt_len: int
    bucket: int
    # the lane's pages (shared prefix first), how many lead pages are
    # shared hits, the next prefill chunk start, where prefill ends, and
    # when decoding began
    pages: list[int] = dataclasses.field(default_factory=list)
    shared: int = 0
    next_chunk: int = 0
    prefill_end: int = 0
    phase: str = "prefill"  # "decode" once the last chunk is dispatched
    active_s: float = 0.0


def _pct(vals, q) -> float | None:
    return float(np.percentile(np.asarray(vals), q)) if vals else None


class ServeEngine:
    """Host-side continuous-batching loop over the `decode` programs, on
    one device. `params` is the model tree (`gpt.init_params`, or tpukit's
    through `bridge.params_from_numpy`) on `device`."""

    def __init__(self, params, cfg: gpt.GPTConfig, serve: ServeConfig,
                 eos_id: int, device=None):
        self.device = resolve_device(device)
        if serve.padded_width > cfg.max_position_embeddings:
            raise ValueError(
                f"paged slot width {serve.padded_width} (max bucket "
                f"{max(serve.buckets)} + max_new_tokens {serve.max_new_tokens}, "
                f"in whole pages) exceeds the position table "
                f"({cfg.max_position_embeddings})"
            )
        paged_lib.validate_kv_layout(cfg, serve.page_size, serve.kv_dtype)
        self.params = params
        self.cfg = cfg.replace(fused_decode=True) if serve.fused_decode else cfg
        self.serve = serve
        self.eos_id = int(eos_id)
        n, w = serve.slots, serve.padded_width
        dev = self.device
        self.num_pages = serve.num_pages or n * serve.pages_per_slot + 1
        self.cache = paged_lib.init_paged_cache(
            cfg, self.num_pages, serve.page_size, serve.pages_per_slot, n,
            serve.kv_dtype, device=dev,
        )
        self.allocator = paged_lib.PageAllocator(self.num_pages, serve.page_size)
        self.kv_bytes = paged_lib.pool_bytes(cfg, self.num_pages, serve.page_size,
                                             serve.kv_dtype)
        self._bt = np.zeros((n, serve.pages_per_slot), np.int32)
        self._bt_dirty = False
        self.buf = torch.zeros((n, w), dtype=torch.int32, device=dev)
        self.cursors = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.limits = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._free = deque(range(n))
        self._lanes: dict[int, _Lane] = {}
        self._pending: deque[Request] = deque()
        self.completions: list[Completion] = []
        self.buckets_used: set[int] = set()
        self.steps = 0
        self.admitted = 0
        self.max_live = 0
        self.evicted = {"eos": 0, "length": 0}
        self._gen_total = 0
        self._walls = {"prefill": 0.0, "decode": 0.0, "sync": 0.0}
        self.last_summary: dict | None = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---- scheduling ------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest declared bucket that fits the prompt."""
        for b in self.serve.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest declared "
            f"bucket ({max(self.serve.buckets)}) — truncate upstream or "
            f"declare a larger bucket"
        )

    def _admit_paged_one(self, req: Request, now: float) -> bool:
        """Admit one request, or return False when the pool cannot cover
        its worst case yet (head-of-line admission control). The prefix
        walk is capped at `(prompt_len - 1) // P` pages (the last prompt
        position's page stays private: the first decode tick rewrites it)
        and aligned down to the prefill chunk. Shared pages are claimed
        before the private allocation so its reclaim cannot take them."""
        plen = len(req.ids)
        if plen < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        bucket = self.bucket_for(plen)
        p, c = self.serve.page_size, self.serve.chunk
        limit = min(plen + req.max_new_tokens, self.serve.width)
        total = -(-limit // p)
        matched = self.allocator.lookup_prefix(req.ids, (plen - 1) // p)
        s_tokens = (len(matched) * p // c) * c
        shared = matched[: s_tokens // p]
        self.allocator.claim(shared)
        fresh = self.allocator.alloc(total - len(shared))
        if fresh is None:
            self.allocator.release(shared)
            return False
        slot = self._free.popleft()
        pages = list(shared) + fresh
        self._bt[slot] = 0
        self._bt[slot, : len(pages)] = pages
        self._bt_dirty = True
        # only chunks that hold prompt tokens are prefilled
        self._lanes[slot] = _Lane(
            req, now, plen, bucket, pages=pages, shared=len(shared),
            next_chunk=s_tokens, prefill_end=-(-plen // c) * c,
        )
        self.admitted += 1
        self.max_live = max(self.max_live, len(self._lanes))
        self.buckets_used.add(bucket)
        if shared:
            self.allocator.stats.prefix_hits += 1
            self.allocator.stats.prefix_pages_reused += len(shared)
        return True

    def _dispatch_prefill_chunks(self, now: float) -> None:
        """Advance every prefilling lane by one chunk in one batched call,
        padded to a power of two by repeating the last entry. Lanes that
        finish their prompt start decoding and register their full prompt
        pages in the prefix registry."""
        c = self.serve.chunk
        entries = []
        for slot, lane in self._lanes.items():
            if lane.phase != "prefill":
                continue
            start = lane.next_chunk
            seg = lane.req.ids[start : start + c]
            row = np.zeros((c,), np.int32)
            row[: len(seg)] = seg
            entries.append((slot, lane, start, row, start + c >= lane.prefill_end))
        if not entries:
            return
        a = 1 << (len(entries) - 1).bit_length()
        rows = np.zeros((a, c), np.int32)
        slots = np.zeros((a,), np.int32)
        starts = np.zeros((a,), np.int32)
        last = np.zeros((a,), bool)
        plens = np.zeros((a,), np.int32)
        lims = np.zeros((a,), np.int32)
        for i in range(a):
            slot, lane, start, row, is_last = entries[min(i, len(entries) - 1)]
            rows[i], slots[i], starts[i], last[i] = row, slot, start, is_last
            plens[i] = lane.prompt_len
            lims[i] = min(lane.prompt_len + lane.req.max_new_tokens, self.serve.width)
        self._refresh_bt()
        t0 = time.perf_counter()
        serve_decode.prefill_chunk_paged(
            self.params, self.cfg, self.buf, self.cache, self.cursors,
            self.active, self.limits, self._tensor(slots), self._tensor(rows),
            self._tensor(starts), self._tensor(last), self._tensor(plens),
            self._tensor(lims),
        )
        self._walls["prefill"] += time.perf_counter() - t0
        for slot, lane, start, row, is_last in entries:
            lane.next_chunk = start + c
            if is_last:
                lane.phase = "decode"
                lane.active_s = now
                reg = (lane.prompt_len - 1) // self.serve.page_size
                self.allocator.register(lane.req.ids, lane.pages[:reg])

    def _refresh_bt(self) -> None:
        """Copy the host block tables to the device when they changed."""
        if self._bt_dirty:
            self.cache["bt"] = self._tensor(self._bt.copy())
            self._bt_dirty = False

    def _step(self) -> None:
        """One decode quantum. Fused: a `decode_loop_window` of up to
        `decode_quantum` ticks that stops early once finished lanes free
        the pages the head of the queue needs (1 << 30 when nothing
        waits). Unfused: `decode_step` of exactly `decode_quantum` ticks."""
        self._refresh_bt()
        t0 = time.perf_counter()
        if self.serve.fused_decode:
            ph = np.zeros((self.serve.slots,), np.int32)
            for s, lane in self._lanes.items():
                if lane.phase == "decode":
                    ph[s] = len(lane.pages)
            if self._pending:
                head = self._pending[0]
                need = -(-min(len(head.ids) + head.max_new_tokens, self.serve.width)
                         // self.serve.page_size)
            else:
                need = 1 << 30
            (self.buf, self.cache, self.cursors, self.active, ticks,
             _) = serve_decode.decode_loop_window(
                self.params, self.cfg, self.buf, self.cache, self.cursors,
                self.active, self.limits, self._tensor(ph),
                self.serve.decode_quantum, need, self.eos_id,
            )
        else:
            self.buf, self.cache, self.cursors, self.active = serve_decode.decode_step(
                self.params, self.cfg, self.buf, self.cache, self.cursors,
                self.active, self.limits, self.eos_id,
                steps=self.serve.decode_quantum,
            )
            ticks = self.serve.decode_quantum
        self._walls["decode"] += time.perf_counter() - t0
        self.steps += ticks

    def _sync_evict(self, now: float) -> None:
        """Fetch cursors and flags, retire finished lanes (release their
        pages, zero their block-table row), and count generated tokens."""
        t0 = time.perf_counter()
        cur = self.cursors.cpu().numpy()
        act = self.active.cpu().numpy()
        finished = [s for s, lane in self._lanes.items()
                    if lane.phase == "decode" and not act[s]]
        gen_live = sum(int(cur[s]) - lane.prompt_len
                       for s, lane in self._lanes.items()
                       if lane.phase == "decode" and s not in finished)
        if finished:
            host_buf = self.buf.cpu().numpy()
            for s in finished:
                lane = self._lanes.pop(s)
                length = int(cur[s])
                ids = host_buf[s, :length].copy()
                # a prefix hit skipped its shared chunks, so the buffer row
                # never held those prompt tokens: take them from the request
                ids[: lane.prompt_len] = lane.req.ids
                limit = min(lane.prompt_len + lane.req.max_new_tokens, self.serve.width)
                reason = "length" if length >= limit else "eos"
                self.evicted[reason] += 1
                self.completions.append(Completion(
                    rid=lane.req.rid, ids=ids, prompt_len=lane.prompt_len,
                    generated=length - lane.prompt_len, reason=reason,
                    arrival_s=lane.req.arrival_s, admit_s=lane.admit_s,
                    done_s=now, pages=len(lane.pages), prefix_pages=lane.shared,
                    active_s=lane.active_s or lane.admit_s,
                ))
                self.allocator.release(lane.pages)
                self._bt[s] = 0
                self._bt_dirty = True
                self._free.append(s)
        self._gen_total = sum(c.generated for c in self.completions) + gen_live
        self._walls["sync"] += time.perf_counter() - t0

    def summary(self, wall_s: float) -> dict:
        comps = self.completions
        gen = sum(c.generated for c in comps)
        st = self.allocator.stats
        return dict(
            requests=len(comps), slots=self.serve.slots,
            buckets=list(self.serve.buckets), buckets_used=sorted(self.buckets_used),
            generated_tokens=gen, decode_steps=self.steps, wall_s=wall_s,
            tokens_per_sec=gen / wall_s if wall_s else None,
            mean_occupancy=gen / (self.serve.slots * self.steps) if self.steps else 0.0,
            admitted=self.admitted, evicted_eos=self.evicted["eos"],
            evicted_length=self.evicted["length"],
            p50_e2e_s=_pct([c.e2e_s for c in comps], 50),
            p99_e2e_s=_pct([c.e2e_s for c in comps], 99),
            p50_token_s=_pct([c.per_token_s for c in comps], 50),
            p99_token_s=_pct([c.per_token_s for c in comps], 99),
            prefill_s=self._walls["prefill"], decode_s=self._walls["decode"],
            sync_s=self._walls["sync"],
            max_live_slots=self.max_live, kv_bytes=self.kv_bytes,
            page_size=self.serve.page_size, num_pages=self.num_pages,
            kv_dtype=self.serve.kv_dtype, prefix_hits=st.prefix_hits,
            prefix_hit_rate=st.prefix_hits / max(self.admitted, 1),
            prefix_pages_reused=st.prefix_pages_reused,
            reclaimed_pages=st.reclaimed,
            page_occupancy=self.allocator.occupancy,
            pages_per_request=float(np.mean([c.pages for c in comps])) if comps else None,
        )

    # ---- step primitives -------------------------------------------------

    def admit(self, reqs: list[Request], now: float) -> list[Request]:
        """Admit as many of `reqs` (in order) as lanes and pages allow;
        stops at the first request the pool cannot cover (FIFO). Returns
        the un-admitted tail."""
        left = list(reqs)
        while left and self._free:
            if not self._admit_paged_one(left[0], now):
                break
            left.pop(0)
        return left

    def poll_prefill(self, now: float) -> None:
        """Advance every prefilling lane one chunk."""
        self._dispatch_prefill_chunks(now)

    def dispatch_decode(self) -> bool:
        """Run one decode quantum if any lane is decoding; returns whether
        it did."""
        if not any(l.phase == "decode" for l in self._lanes.values()):
            return False
        self._step()
        return True

    def sync(self, now: float) -> None:
        """The per-quantum host sync: retire finished lanes."""
        self._sync_evict(now)

    def finish(self, wall_s: float) -> list[Completion]:
        """Record the run's summary (`last_summary`); returns the
        completions."""
        self.last_summary = self.summary(wall_s)
        return self.completions

    def run(self, requests, max_wall_s: float | None = None) -> list[Completion]:
        """Serve `requests` (each admitted no earlier than its `arrival_s`)
        to completion; returns the completions in finish order."""
        self._pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self._walls = {k: 0.0 for k in self._walls}
        t0 = time.perf_counter()
        while self._pending or self._lanes:
            now = time.perf_counter() - t0
            if max_wall_s is not None and now > max_wall_s:
                raise TimeoutError(
                    f"serve run exceeded max_wall_s={max_wall_s} with "
                    f"{len(self._pending)} pending / {len(self._lanes)} live"
                )
            ready: list[Request] = []
            while (self._pending and len(ready) < len(self._free)
                   and self._pending[0].arrival_s <= now):
                ready.append(self._pending.popleft())
            for req in reversed(self.admit(ready, now)):
                self._pending.appendleft(req)
            self.poll_prefill(time.perf_counter() - t0)
            if not self.dispatch_decode():
                if not self._lanes and self._pending:
                    wait = self._pending[0].arrival_s - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            self.sync(time.perf_counter() - t0)
        return self.finish(time.perf_counter() - t0)


STREAM_PROFILES = ("uniform", "repetitive", "shared_prefix")


def synthetic_request_stream(tokenizer, n: int, *, seed: int = 0,
                             max_new_tokens: int = 16, buckets=(16, 32),
                             qps: float = 0.0, corpus=None, lengths=None,
                             shared_prefix: int = 0,
                             stream_profile: str = "uniform") -> list[Request]:
    """Seeded synthetic request stream (twin of tpukit's, request for
    request): prompts cut from the fixture corpus at seeded lengths
    spanning the bucket set, arrivals all at once (`qps` 0) or spaced by a
    seeded exponential process. `stream_profile` "repetitive" tiles a short
    phrase per prompt; "shared_prefix" (or `shared_prefix > 0`) prepends one
    system prompt to every request. Prompts are truncated to the largest
    bucket."""
    if stream_profile not in STREAM_PROFILES:
        raise ValueError(
            f"stream_profile={stream_profile!r} must be one of {STREAM_PROFILES}"
        )
    rng = np.random.RandomState(seed)
    corpus = corpus if corpus is not None else synthetic_stories(max(64, n))
    if stream_profile == "shared_prefix" and shared_prefix <= 0:
        shared_prefix = max(buckets) // 2
    prefix: list[int] = []
    if shared_prefix > 0:
        prefix = list(tokenizer(
            [" ".join(corpus)], truncation=True, max_length=shared_prefix
        )["input_ids"][0])
    out = []
    t = 0.0
    for i in range(n):
        text = corpus[int(rng.randint(len(corpus)))]
        if lengths is not None:
            target = int(lengths[int(rng.randint(len(lengths)))])
        else:
            target = int(rng.randint(4, max(buckets) + 1))
        ids = tokenizer([text], truncation=True, max_length=target)["input_ids"][0]
        if stream_profile == "repetitive":
            phrase = list(ids)[: int(rng.randint(2, 5))]
            reps = -(-target // max(len(phrase), 1))
            ids = (phrase * reps)[:target]
        ids = (prefix + list(ids))[: max(buckets)]
        if qps > 0:
            t += float(rng.exponential(1.0 / qps))
        out.append(Request(
            rid=i, ids=tuple(int(x) for x in ids),
            max_new_tokens=max_new_tokens, seed=seed + i, arrival_s=t,
        ))
    return out
