"""Continuous-batching serving engine (twin of `tpukit/serve/engine.py`).

The host scheduler: a free list of decode lanes (`slots`) and eviction on
EOS or length, over one of two KV caches.

  - The ring (`page_size` 0, tpukit's default): each slot owns a row of
    `gpt.init_kv_cache(cfg, slots, kv_width)`. Arrivals are admitted
    between decode quanta, grouped by bucket, each group prefilled by one
    `prefill_slots` forward padded to a power of two with repeats of its
    last entry.
  - Pages (`page_size` P > 0): page-aware admission (a request holds
    `ceil(min(prompt + budget, width) / P)` pages from admission to
    eviction), shared-prefix reuse through the page registry, chunked
    prefill between decode quanta. With `fused_decode` every decode tick
    runs the paged-attention kernel once per layer and each quantum is a
    `decode_loop_window` that can stop early; without it, a quantum is
    `decode_step` over the gathered view.

Decoding is greedy at `temperature` 0 and otherwise samples with each
request's key, `PRNGKey(req.seed)`, folded with the cursor, so a request's
tokens depend neither on its neighbours nor on the schedule: fused,
unfused and ring engines give the same tokens, and so does tpukit's.
With `draft` set, each quantum is speculative on the ring: a proposer
(`ngram` self-speculation, or a small draft `model`) guesses `spec_k`
tokens a slot and the target verifies them in one forward
(`serve/spec.py`); the output is the vanilla output, greedy or sampled.

Under a serving grid (`mesh`, a `(data, model)` `DeviceMesh` of
`mesh.create_tp_mesh`, tpukit `engine.py:498-535`) every rank of the
grid runs this same host scheduler in lockstep over its shards of the
parameters (`TensorParallel`'s, or whole ones replicated over `data`):
heads over `model` in the ring and the pools, slots over `data` on the
ring (paged serving needs a model-only grid). The allocator, the prefix
registry, the block tables and the lane state stay the same on every
rank, every rank samples the same tokens from the same gathered logits,
and the scheduler's clock is rank 0's, broadcast, so every rank takes the
same decisions and enters the same collectives in the same order.

Serving telemetry is tpukit's (`tpukit/serve/engine.py:1165-1541`): wall
clock goes into `SpanTimeline` spans named as tpukit's (`prefill`,
`decode`, `draft`, `verify`, `sync`); every `window_steps` decode steps a
`kind="serve"` record (tokens/s, occupancy, admissions, evictions, the
span split with its `other_s` residual, the dispatch/device attribution,
latency percentiles; the paged triple and the `spec` block) goes to
`logger`, and `finish` writes the `kind="serve_summary"` record. With a
`tracer` (`obs/trace.py`) the step primitives emit per-request span events
(enqueue, admit, prefill, prefill_done, quantum, finish) that `finish`
flushes with their span trees; with `metrics` (`obs/metrics.py`) each
window feeds the latency histograms, counters and gauges, `slo`'s targets
are accounted as `kind="slo"` rows, and `metrics_dir` gets the registry's
snapshot. Each of `logger`, `recorder`, `tracer` and `metrics` may be None,
and none of them changes a token or the schedule. Under a grid only the
grid's first rank is given them (the entry point's rule): the telemetry
adds no collective, and the tracer's clock is that rank's own. A fleet
replica over a grid (`serve/replica_world.py`) gives its first rank
relays that hand every call to the router's planes, on the router's
clock.

The port's fused `decode_loop_window` reads the lanes' flags on the host
after every tick, so its `decode` span (the quantum's dispatch wall, which
tpukit's records call `dispatch_overhead_s`) holds most of the device's
time, and `sync` (tpukit's `device_s`) little of it, where tpukit's
asynchronous dispatch puts the device's time in `sync` (ROADMAP.md §C).

A request with `deadline_ms` > 0 is evicted with its partial tokens once
its end-to-end wall passes the deadline (`reason="deadline"`, a
`kind="deadline_miss"` row). The fleet (`serve/fleet.py`,
`serve/ledger.py`) drives engines through the step primitives `run` is
spelled in (`admit`, `poll_prefill`, `dispatch_decode`, `sync`, `finish`)
and the hooks of tpukit's (`engine.py:1419-1627`): `replica` labels every
record, trace event and metric series; `stuck_rids` pins requests past EOS
(chaos); `requeue_live` hands back a killed replica's in-flight requests;
`release_lane` and `adopt_prefilled` are the two halves of the
disaggregated prefill's page handoff; `host_state` is what a grid
replica's first rank reports to its router. A fleet replica leaves the
shared tracer's flush and the registry's epilogue to its router.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from tpukit_torch import random as tk_random
from tpukit_torch import resolve_device
from tpukit_torch.data import synthetic_stories
from tpukit_torch.model import gpt
from tpukit_torch.obs import metrics as metrics_lib
from tpukit_torch.obs import trace as trace_lib
from tpukit_torch.obs.spans import SpanTimeline
from tpukit_torch.ops.layers import ModelGroup
from tpukit_torch.serve import decode as serve_decode
from tpukit_torch.serve import paged as paged_lib


@dataclasses.dataclass(frozen=True)
class Request:
    """One request: a tokenized prompt, its decode budget, the seed of its
    sampling key (`PRNGKey(seed)`; unused by greedy decoding), its arrival
    offset in seconds from the start of the stream and its trace id
    (`obs/trace.py`; -1 takes the rid). A request requeued after a replica
    kill is the same object, so both attempts share the trace id.
    `deadline_ms` > 0 bounds its end-to-end latency from `arrival_s`: past
    it the engine evicts the lane (reason "deadline", the partial output
    kept). `priority` orders the fleet's backpressure shedding (lower sheds
    first); it never reorders admission."""

    rid: int
    ids: tuple[int, ...]
    max_new_tokens: int = 20
    seed: int = 0
    arrival_s: float = 0.0
    trace: int = -1
    deadline_ms: float = 0.0
    priority: int = 0


def trace_id(req: Request) -> int:
    """The request's effective trace id (`trace_lib.request_trace_id`)."""
    return trace_lib.request_trace_id(req.rid, req.trace)


@dataclasses.dataclass
class Completion:
    """A finished request. `ids` holds prompt + generated tokens; times are
    run-relative seconds. `pages` is the request's page footprint,
    `prefix_pages` how many of them were shared-prefix hits (both 0 on the
    ring), `active_s` when its prefill finished and decoding began."""

    rid: int
    ids: np.ndarray
    prompt_len: int
    generated: int
    reason: str  # "eos" | "length" | "deadline"
    arrival_s: float
    admit_s: float
    done_s: float
    pages: int = 0
    prefix_pages: int = 0
    active_s: float = 0.0

    @property
    def admit_latency_s(self) -> float:
        """Slot assignment to decode-ready: the prefill a request paid,
        which shared-prefix reuse shrinks."""
        return max(self.active_s - self.admit_s, 0.0)

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
    """Engine shape (twin of tpukit's, `tpukit/serve/engine.py:158-360`).
    `buckets` is the declared prompt-length set; prompts longer than
    `max(buckets)` are rejected at admission. The slot width is
    `max(buckets) + max_new_tokens` unless `max_len` pins it.
    `decode_quantum` is the number of ticks per dispatch (the window size
    with `fused_decode`). `temperature` 0 decodes greedily; above 0 each
    request samples, `top_k` > 0 truncating to the k largest logits.
    `page_size` 0 (the default) is the ring cache; above 0 it must divide
    every bucket, `num_pages` 0 sizes the pool like a ring (slots x
    pages-per-slot + the null page) and `prefill_chunk` 0 is one page.
    `draft` "ngram" or "model" (ring only) makes each quantum speculative:
    `spec_k` proposed tokens a slot, n-grams of up to `ngram_max`
    tokens. A `kind="serve"` window closes every `window_steps` decode
    steps."""

    slots: int = 8
    buckets: tuple[int, ...] = (16, 32, 64)
    max_new_tokens: int = 20
    temperature: float = 0.0
    top_k: int = 0
    window_steps: int = 32
    max_len: int = 0
    decode_quantum: int = 4
    page_size: int = 0
    num_pages: int = 0
    kv_dtype: str = "f32"
    prefill_chunk: int = 0
    draft: str = ""  # "" | "ngram" | "model"
    spec_k: int = 4
    ngram_max: int = 3
    fused_decode: bool = False

    def __post_init__(self):
        if self.draft not in ("", "ngram", "model"):
            raise ValueError(f"draft={self.draft!r} must be '', 'ngram' or 'model'")
        if self.draft:
            if self.spec_k < 1:
                raise ValueError(
                    f"spec_k={self.spec_k} must be >= 1 with draft={self.draft!r} — a "
                    f"0-token draft is vanilla decode"
                )
            if self.ngram_max < 1:
                raise ValueError(f"ngram_max={self.ngram_max} must be >= 1")
            if self.page_size:
                raise ValueError(
                    f"draft={self.draft!r} requires the ring cache (page_size=0, got "
                    f"{self.page_size}): the k+1-token verify write-back is not "
                    f"page-aligned, and the paged write contract only covers whole pages"
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
        if self.max_len and self.max_len < max(b):
            raise ValueError(
                f"max_len={self.max_len} is smaller than the largest bucket ({max(b)}) "
                f"— a prompt admitted at that bucket could not fit the KV ring"
            )
        if self.kv_dtype not in paged_lib.KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {paged_lib.KV_DTYPES}, got {self.kv_dtype!r}"
            )
        if self.page_size < 0:
            raise ValueError(f"page_size={self.page_size} must be >= 0")
        if self.page_size == 0:
            if self.fused_decode:
                raise ValueError(
                    "fused_decode=True requires the paged cache (page_size > 0) — the "
                    "fused kernel walks block tables"
                )
            if self.kv_dtype != "f32":
                raise ValueError(
                    f"kv_dtype={self.kv_dtype!r} requires the paged cache (page_size "
                    f"> 0) — the ring stores the compute dtype"
                )
            for name in ("num_pages", "prefill_chunk"):
                if getattr(self, name):
                    raise ValueError(
                        f"{name}={getattr(self, name)} requires the paged cache "
                        f"(page_size > 0)"
                    )
            return
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
        return self.max_len or (max(self.buckets) + self.max_new_tokens)

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def pages_per_slot(self) -> int:
        """Block-table width: pages covering the worst-case sequence."""
        return -(-self.width // self.page_size)

    @property
    def padded_width(self) -> int:
        """Per-slot width of the token buffer: `width`, rounded up to whole
        pages when paged."""
        return self.pages_per_slot * self.page_size if self.paged else self.width

    @property
    def chunk(self) -> int:
        """Chunked-prefill chunk actually used (paged only)."""
        return self.prefill_chunk or self.page_size

    @property
    def kv_width(self) -> int:
        """Positions of a slot's ring row: `padded_width` plus, under
        speculation, `spec_k` scratch positions, so a verify window near
        the end still writes all its k + 1 positions without the write
        clamping down over valid history. The scratch lies above every
        limit: never appended, never attended by an accepted query."""
        return self.padded_width + (self.spec_k if self.draft else 0)


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
    phase: str = "decode"  # paged: "prefill" until the last chunk is dispatched
    active_s: float = 0.0
    # the request's key words, made once at admission
    key: np.ndarray | None = None


def _pct(vals, q) -> float | None:
    return float(np.percentile(np.asarray(vals), q)) if vals else None


class ServeEngine:
    """Host-side continuous-batching loop over the `decode` programs.
    `params` is the model tree (`gpt.init_params`, or tpukit's through
    `bridge.params_from_numpy`) on `device`; `draft_params` and
    `draft_cfg` are the draft model of `draft="model"`, whole on every
    rank. Under `mesh` (a `(data, model)` `DeviceMesh` this rank is on)
    `params` is this rank's tree on the grid: `TensorParallel`'s
    shards on its `model` ranks, whole when the grid's model degree is
    one. `logger` (`obs.StepLogger`), `recorder` (`obs.FlightRecorder`),
    `tracer` (`obs.TraceRecorder`), `metrics` (`obs.MetricRegistry`, with
    `slo`, a list of `obs.parse_slo` targets, and `metrics_dir`, where its
    snapshots go) are tpukit's telemetry planes; None turns each off.
    `replica` is a fleet replica's id (None: a standalone engine): it is
    stamped on the engine's records, trace events and metric series."""

    def __init__(self, params, cfg: gpt.GPTConfig, serve: ServeConfig,
                 eos_id: int, device=None, draft_params=None, draft_cfg=None, mesh=None,
                 logger=None, recorder=None, tracer=None, metrics=None, slo=None,
                 metrics_dir=None, replica=None):
        self.device = resolve_device(device)
        n = serve.slots
        if mesh is not None:
            d = mesh.size(0)
            if serve.paged and d > 1:
                raise ValueError(
                    f"paged serving requires a model-only grid (data axis 1, got data={d}): "
                    f"the page pool is replicated across `data` and a data-sharded slot set "
                    f"would make the pool write-back an unauditable cross-shard scatter "
                    f"(decode.decode_step_comm) — shrink the data axis or use the ring "
                    f"cache (page_size=0)")
            if n % d:
                raise ValueError(f"slots={n} must be a multiple of the mesh's data axis "
                                 f"({d}) — slots shard over it")
            cfg = cfg.replace(tp=ModelGroup.of(mesh))
        # the grid's ranks run this scheduler in lockstep on rank 0's clock
        self._clock_groups = ([] if mesh is None or mesh.size() == 1 else
                              [mesh.get_group(a) for a in ("model", "data")
                               if mesh.size(mesh.mesh_dim_names.index(a)) > 1])
        if serve.kv_width > cfg.max_position_embeddings:
            raise ValueError(
                f"slot width {serve.kv_width} (max bucket {max(serve.buckets)} + "
                f"max_new_tokens {serve.max_new_tokens}"
                + (", in whole pages" if serve.paged else "")
                + (f", + spec_k {serve.spec_k} verify scratch" if serve.draft else "")
                + f") exceeds the position table ({cfg.max_position_embeddings})"
            )
        if serve.draft == "model":
            if draft_params is None or draft_cfg is None:
                raise ValueError("draft='model' requires draft_params and draft_cfg")
            # the acceptance test compares p and q token id by token id
            if (draft_cfg.vocab_size != cfg.vocab_size
                    or draft_cfg.padded_vocab_size != cfg.padded_vocab_size):
                raise ValueError(
                    f"draft model vocab (vocab_size {draft_cfg.vocab_size}, padded "
                    f"{draft_cfg.padded_vocab_size}) does not match the target "
                    f"({cfg.vocab_size}, padded {cfg.padded_vocab_size}) — draft and "
                    f"target must share one tokenizer"
                )
            if serve.kv_width > draft_cfg.max_position_embeddings:
                raise ValueError(
                    f"draft model position table ({draft_cfg.max_position_embeddings}) "
                    f"is smaller than the KV ring width {serve.kv_width}"
                )
        elif draft_params is not None or draft_cfg is not None:
            raise ValueError(
                f"draft_params/draft_cfg passed but ServeConfig.draft={serve.draft!r} — "
                f"set draft='model' to use them"
            )
        if serve.paged:
            paged_lib.validate_kv_layout(cfg, serve.page_size, serve.kv_dtype)
        self.params = params
        self.cfg = cfg.replace(fused_decode=True) if serve.fused_decode else cfg
        self.serve = serve
        self.eos_id = int(eos_id)
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.logger = logger
        self.recorder = recorder
        # the fleet identity on every record, trace event and metric series
        # (None: a standalone engine, whose records carry no label)
        self.replica = replica
        # telemetry (tpukit engine.py:540-566): the tracer's span events,
        # the metric registry fed at window boundaries only, and the SLO
        # targets accounted there
        self.tracer = tracer
        self.metrics = metrics
        self.slo_accountant = (metrics_lib.SloAccountant(slo)
                               if (metrics is not None and slo) else None)
        self.metrics_dir = metrics_dir
        self._metrics_traces_seen: set = set()
        self._metrics_q_mark = -1.0  # the last quantum's t1 the registry has seen
        self._pending_quantum = None  # the dispatch half of a quantum event
        # top_k beyond the logits width is clamped, as tpukit clamps it
        self._top_k = min(int(serve.top_k), cfg.padded_vocab_size)
        self._temperature = float(serve.temperature)
        w = serve.padded_width
        dev = self.device
        if serve.paged:
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
        else:
            self.num_pages = 0
            self.allocator = None
            rows = serve_decode.slot_rows(cfg, n)
            self.cache = gpt.init_kv_cache(cfg, rows.stop - rows.start, serve.kv_width,
                                           device=dev)
            self.kv_bytes = sum(c.numel() * c.element_size() for c in self.cache.values())
        self.draft_cache = (gpt.init_kv_cache(draft_cfg, n, serve.kv_width, device=dev)
                            if serve.draft == "model" else None)
        self.buf = torch.zeros((n, w), dtype=torch.int32, device=dev)
        self.cursors = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.limits = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.keys = torch.zeros((n, 2), dtype=torch.int64, device=dev)
        self._free = deque(range(n))
        self._lanes: dict[int, _Lane] = {}
        self._pending: deque[Request] = deque()
        self.completions: list[Completion] = []
        self.spans = SpanTimeline()
        self.buckets_used: set[int] = set()
        self.steps = 0
        self.prefill_dispatches = 0  # batched prefill calls (one forward each)
        self.admitted = 0
        self.max_live = 0
        self.evicted = {"eos": 0, "length": 0, "deadline": 0}
        # rids pinned past their natural retirement (stuck_request chaos):
        # `_sync_evict` never retires them, so they hold their slot until
        # their deadline evicts them
        self.stuck_rids: set[int] = set()
        # speculation (tpukit engine.py:253-259): draft tokens proposed and
        # accepted, and how many verifies appended 0 .. spec_k + 1 tokens
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_hist = [0] * (serve.spec_k + 2) if serve.draft else []
        self._pending_spec = None
        self._gen_total = 0
        self.last_summary: dict | None = None
        # the open window's starting counts
        self._win = dict(steps=0, gen0=0, admit0=0, comps0=0, hits0=0, prop0=0, acc0=0,
                         hist0=list(self.spec_hist))
        self._window_idx = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _clock(self, t0: float) -> float:
        """Seconds since `t0`: under a grid of more than one rank, the
        grid's first rank's, broadcast along `model` from each replica's
        first rank, then along `data` from replica 0 (each rank's own
        clock would let the ranks admit, time out or sleep differently and
        then wait in different collectives)."""
        now = time.perf_counter() - t0
        if not self._clock_groups:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        for group in self._clock_groups:
            dist.broadcast(t, src=dist.get_process_group_ranks(group)[0], group=group)
        return float(t)

    def _decoding_traces(self) -> list[int]:
        """The trace ids of the lanes a quantum advances, in slot order."""
        return [trace_id(l.req) for s, l in sorted(self._lanes.items())
                if l.phase == "decode"]

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

    def _admit_batch(self, reqs: list[Request], now: float) -> None:
        """Ring admission (twin of `tpukit/serve/engine.py:302`): group the
        requests by bucket and prefill each group in one `prefill_slots`
        forward, padded to the next power of two by repeating its last
        entry (the same rows tpukit's forward sees). Every request is
        validated before a slot is taken."""
        validated = []
        for req in reqs:
            plen = len(req.ids)
            if plen < 1:
                raise ValueError(f"request {req.rid}: empty prompt")
            validated.append((req, plen, self.bucket_for(plen)))
        groups: dict[int, list] = {}
        for req, plen, bucket in validated:
            groups.setdefault(bucket, []).append((self._free.popleft(), req, plen))
        tr = self.tracer
        for bucket, entries in sorted(groups.items()):
            a = 1 << (len(entries) - 1).bit_length()
            rows = np.zeros((a, bucket), np.int32)
            slots = np.zeros((a,), np.int32)
            plens = np.zeros((a,), np.int32)
            lims = np.zeros((a,), np.int32)
            keys = np.zeros((a, 2), np.int64)
            for i in range(a):
                slot, req, plen = entries[min(i, len(entries) - 1)]
                rows[i, :plen] = req.ids
                slots[i], plens[i] = slot, plen
                lims[i] = min(plen + req.max_new_tokens, self.serve.width)
                keys[i] = tk_random.PRNGKey(req.seed).numpy()
            args = [self._tensor(x) for x in (slots, rows, plens, lims, keys)]
            p0 = tr.now() if tr is not None else 0.0
            with self.spans.span("prefill"):
                serve_decode.prefill_slots(self.params, self.cfg, self.buf, self.cache,
                                           self.cursors, self.active, self.limits,
                                           self.keys, *args)
                if self.serve.draft == "model":
                    # the draft's ring takes the same admit batch; the lane
                    # state it writes again is the same values
                    serve_decode.prefill_slots(self.draft_params, self.draft_cfg, self.buf,
                                               self.draft_cache, self.cursors, self.active,
                                               self.limits, self.keys, *args)
            p1 = tr.now() if tr is not None else 0.0
            self.prefill_dispatches += 1
            self.buckets_used.add(bucket)
            for slot, req, plen in entries:
                self._lanes[slot] = _Lane(req, now, plen, bucket, active_s=now)
                self.admitted += 1
                if tr is not None:
                    tid = trace_id(req)
                    tr.emit("admit", tid, rid=req.rid, t=now, slot=slot, replica=self.replica)
                    tr.emit("prefill", tid, rid=req.rid, t0=p0, t1=p1, chunk=0,
                            replica=self.replica)
                    tr.emit("prefill_done", tid, rid=req.rid, t=p1, replica=self.replica)
        self.max_live = max(self.max_live, len(self._lanes))

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
            next_chunk=s_tokens, prefill_end=-(-plen // c) * c, phase="prefill",
            key=tk_random.PRNGKey(req.seed).numpy(),
        )
        self.admitted += 1
        self.max_live = max(self.max_live, len(self._lanes))
        self.buckets_used.add(bucket)
        if self.tracer is not None:
            self.tracer.emit("admit", trace_id(req), rid=req.rid, t=now, slot=slot,
                             replica=self.replica)
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
        keys = np.zeros((a, 2), np.int64)
        for i in range(a):
            slot, lane, start, row, is_last = entries[min(i, len(entries) - 1)]
            rows[i], slots[i], starts[i], last[i] = row, slot, start, is_last
            plens[i] = lane.prompt_len
            lims[i] = min(lane.prompt_len + lane.req.max_new_tokens, self.serve.width)
            keys[i] = lane.key
        self._refresh_bt()
        tr = self.tracer
        p0 = tr.now() if tr is not None else 0.0
        with self.spans.span("prefill"):
            serve_decode.prefill_chunk_paged(
                self.params, self.cfg, self.buf, self.cache, self.cursors,
                self.active, self.limits, self.keys, self._tensor(slots),
                self._tensor(rows), self._tensor(starts), self._tensor(last),
                self._tensor(plens), self._tensor(lims), self._tensor(keys),
            )
        p1 = tr.now() if tr is not None else 0.0
        self.prefill_dispatches += 1
        for slot, lane, start, row, is_last in entries:
            lane.next_chunk = start + c
            if tr is not None:
                tid = trace_id(lane.req)
                tr.emit("prefill", tid, rid=lane.req.rid, t0=p0, t1=p1, chunk=start // c,
                        replica=self.replica)
                if is_last:
                    tr.emit("prefill_done", tid, rid=lane.req.rid, t=p1,
                            replica=self.replica)
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
        waits). Otherwise (unfused, or the ring): `decode_step` of exactly
        `decode_quantum` ticks."""
        tr = self.tracer
        sample = (self._temperature, self._top_k)
        if self.serve.paged:
            self._refresh_bt()
        t0 = tr.now() if tr is not None else 0.0
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
            with self.spans.span("decode"):
                (self.buf, self.cache, self.cursors, self.active, ticks,
                 _) = serve_decode.decode_loop_window(
                    self.params, self.cfg, self.buf, self.cache, self.cursors,
                    self.active, self.limits, self.keys, self._tensor(ph),
                    self.serve.decode_quantum, need, self.eos_id, *sample,
                )
        else:
            with self.spans.span("decode"):
                self.buf, self.cache, self.cursors, self.active = serve_decode.decode_step(
                    self.params, self.cfg, self.buf, self.cache, self.cursors,
                    self.active, self.limits, self.keys, self.eos_id, *sample,
                    steps=self.serve.decode_quantum,
                )
            ticks = self.serve.decode_quantum
        if tr is not None:
            # the dispatch half of the quantum event; the sync adds its half.
            # The fused window's tick count is already on the host here
            # (tpukit fetches its device count at the sync)
            self._pending_quantum = dict(t0=t0, t1=tr.now(), steps=ticks,
                                         lanes=self._decoding_traces())
        self.steps += ticks
        self._win["steps"] += ticks

    # ---- speculative decoding (serve/spec.py) ----------------------------

    def _spec_step(self) -> None:
        """One draft-and-verify quantum (twin of `tpukit/serve/engine.py:584`):
        propose up to `spec_k` tokens a slot (the draft model's ticks, the
        `draft` span; or the n-gram match fused into the verify), then
        score all spec_k + 1 positions in one batched target forward and
        accept a per-slot prefix (the `verify` span). Counts as one step; a
        verify appends up to spec_k + 1 tokens a slot."""
        from tpukit_torch.serve import spec as spec_lib

        k, n = self.serve.spec_k, self.serve.slots
        live = np.zeros((n,), bool)
        for s, lane in self._lanes.items():
            if lane.phase == "decode":
                live[s] = True
        sample = dict(temperature=self._temperature, top_k=self._top_k)
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        if self.serve.draft == "model":
            with self.spans.span("draft"):
                draft_toks, draft_q, _ = spec_lib.draft_propose(
                    self.draft_params, self.draft_cfg, self.buf, self.draft_cache,
                    self.cursors, self.keys, k=k, **sample)
                dlen = np.where(live, k, 0).astype(np.int32)
                draft_len = torch.full((n,), k, dtype=torch.int32, device=self.device)
            with self.spans.span("verify"):
                (self.buf, self.cache, self.cursors, self.active, acc,
                 napp) = spec_lib.verify_step(
                    self.params, self.cfg, self.buf, self.cache, self.cursors, self.active,
                    self.limits, self.keys, draft_toks, draft_q, draft_len, self.eos_id,
                    k=k, **sample)
        else:
            with self.spans.span("verify"):
                (self.buf, self.cache, self.cursors, self.active, acc, napp,
                 dlen) = spec_lib.spec_ngram_step(
                    self.params, self.cfg, self.buf, self.cache, self.cursors, self.active,
                    self.limits, self.keys, self.eos_id, k=k,
                    max_ngram=self.serve.ngram_max, **sample)
        self._pending_spec = (live, dlen, acc, napp)
        if tr is not None:
            self._pending_quantum = dict(t0=t0, t1=tr.now(), steps=1,
                                         lanes=self._decoding_traces())
        self.steps += 1
        self._win["steps"] += 1

    def _drain_spec(self, dlen, acc, napp) -> None:
        """Fold the last verify's counters into the spec telemetry (twin of
        `tpukit/serve/engine.py:648`)."""
        live = self._pending_spec[0]
        self._pending_spec = None
        for s in np.flatnonzero(live):
            self.spec_proposed += int(dlen[s])
            self.spec_accepted += int(min(acc[s], dlen[s]))
            self.spec_hist[int(napp[s])] += 1

    def _sync_evict(self, now: float) -> None:
        """Fetch cursors and flags (and a verify's counters, in the same
        copy), retire finished lanes (paged: release their pages, zero
        their block-table row), and count generated tokens."""
        tr = self.tracer
        s0 = tr.now() if tr is not None else 0.0
        with self.spans.span("sync"):
            if self._pending_spec is not None:
                _, dlen, acc, napp = self._pending_spec
                if isinstance(dlen, np.ndarray):
                    dlen = torch.from_numpy(dlen).to(self.device)
                host = torch.stack([self.cursors.long(), self.active.long(), dlen.long(),
                                    acc.long(), napp.long()]).cpu().numpy()
                cur, act = host[0], host[1].astype(bool)
                self._drain_spec(host[2], host[3], host[4])
            else:
                host = torch.stack([self.cursors.long(), self.active.long()]).cpu().numpy()
                cur, act = host[0], host[1].astype(bool)
        if tr is not None and self._pending_quantum is not None:
            # [t0, t1] the dispatch wall, [s0, s1] the wall to the sync
            q, self._pending_quantum = self._pending_quantum, None
            tr.emit("quantum", -1, t0=q["t0"], t1=q["t1"], s0=s0, s1=tr.now(),
                    steps=q["steps"], lanes=q["lanes"], replica=self.replica)
        # prefilling lanes are inactive by design, not finished
        finished = [s for s, lane in self._lanes.items()
                    if lane.phase == "decode" and not act[s]
                    and lane.req.rid not in self.stuck_rids]
        gen_live = sum(int(cur[s]) - lane.prompt_len
                       for s, lane in self._lanes.items()
                       if lane.phase == "decode" and s not in finished)
        if finished:
            host_buf = self.buf.cpu().numpy()
            # stamped after the copy, so the last quantum's sync lies inside
            # the request's tree
            fin_t = tr.now() if tr is not None else 0.0
            for s in finished:
                lane = self._lanes.pop(s)
                length = int(cur[s])
                generated = length - lane.prompt_len
                ids = host_buf[s, :length].copy()
                if self.serve.paged:
                    # a prefix hit skipped its shared chunks, so the buffer
                    # row never held those prompt tokens: take them from the
                    # request
                    ids[: lane.prompt_len] = lane.req.ids
                limit = min(lane.prompt_len + lane.req.max_new_tokens, self.serve.width)
                reason = "length" if length >= limit else "eos"
                self.evicted[reason] += 1
                self.completions.append(Completion(
                    rid=lane.req.rid, ids=ids, prompt_len=lane.prompt_len,
                    generated=generated, reason=reason,
                    arrival_s=lane.req.arrival_s, admit_s=lane.admit_s,
                    done_s=now, pages=len(lane.pages), prefix_pages=lane.shared,
                    active_s=lane.active_s or lane.admit_s,
                ))
                if tr is not None:
                    tr.emit("finish", trace_id(lane.req), rid=lane.req.rid, t=fin_t,
                            reason=reason, generated=generated, replica=self.replica)
                if self.serve.paged:
                    self.allocator.release(lane.pages)
                    self._bt[s] = 0
                    self._bt_dirty = True
                self._free.append(s)
        self._gen_total = sum(c.generated for c in self.completions) + gen_live

    def _evict_deadlines(self, now: float) -> None:
        """Retire the decoding lanes past their `deadline_ms` (twin of
        `tpukit/serve/engine.py:1098`): each becomes a Completion with
        reason "deadline" and its partial output, a `kind="deadline_miss"`
        row and a `serve_deadline_miss` count; its pages are released and
        its block-table row zeroed as at a natural retirement. Runs after
        `_sync_evict`, so the quantum is synced; prefilling lanes wait for
        their decode phase, so no chunk in flight targets released pages."""
        over = [(s, lane) for s, lane in self._lanes.items()
                if lane.phase == "decode" and lane.req.deadline_ms > 0
                and (now - lane.req.arrival_s) * 1e3 > lane.req.deadline_ms]
        if not over:
            return
        cur = self.cursors.cpu().numpy()
        host_buf = self.buf.cpu().numpy()
        tr = self.tracer
        fin_t = tr.now() if tr is not None else 0.0
        for s, lane in over:
            self._lanes.pop(s)
            length = int(cur[s])
            generated = max(length - lane.prompt_len, 0)
            ids = host_buf[s, :length].copy()
            if self.serve.paged:
                ids[: lane.prompt_len] = lane.req.ids
            self.evicted["deadline"] += 1
            over_ms = (now - lane.req.arrival_s) * 1e3 - lane.req.deadline_ms
            self.completions.append(Completion(
                rid=lane.req.rid, ids=ids, prompt_len=lane.prompt_len,
                generated=generated, reason="deadline", arrival_s=lane.req.arrival_s,
                admit_s=lane.admit_s, done_s=now, pages=len(lane.pages),
                prefix_pages=lane.shared, active_s=lane.active_s or lane.admit_s,
            ))
            if self.logger is not None:
                rec = dict(kind="deadline_miss", rid=lane.req.rid,
                           deadline_ms=lane.req.deadline_ms, over_ms=round(over_ms, 3),
                           generated=generated)
                if self.replica is not None:
                    rec["replica"] = self.replica
                self.logger.log(**rec)
            if self.metrics is not None:
                self.metrics.inc("serve_deadline_miss")
            if tr is not None:
                tr.emit("finish", trace_id(lane.req), rid=lane.req.rid, t=fin_t,
                        reason="deadline", generated=generated, replica=self.replica)
            if self.serve.paged:
                self.allocator.release(lane.pages)
                self._bt[s] = 0
                self._bt_dirty = True
            self._free.append(s)
        # _gen_total stays: the last sync counted these tokens among the
        # live lanes, and the next one recounts from the completions

    # ---- telemetry (tpukit engine.py:1165-1419) --------------------------

    def _emit_window(self) -> None:
        """Close the window: the `kind="serve"` record, its flight-recorder
        entry and the metrics window."""
        b = self.spans.window()
        comps = self.completions[self._win["comps0"]:]
        new_tokens = self._gen_total - self._win["gen0"]
        steps = self._win["steps"]
        # slot-step utilization; under speculation a step is one verify of
        # spec_k + 1 tokens a slot
        cap = (self.serve.spec_k + 1) if self.serve.draft else 1
        sec = b["seconds"]
        rec = dict(
            kind="serve", window=self._window_idx, steps=steps, new_tokens=new_tokens,
            tokens_per_sec=(new_tokens / b["total_s"]) if b["total_s"] else None,
            occupancy=(new_tokens / (self.serve.slots * steps * cap)) if steps else 0.0,
            admitted=self.admitted - self._win["admit0"],
            completed=len(comps), queue_depth=len(self._pending),
            slots=self.serve.slots, window_s=b["total_s"],
            seconds=sec, fractions=b["fractions"],
            p50_e2e_s=_pct([c.e2e_s for c in comps], 50),
            p99_e2e_s=_pct([c.e2e_s for c in comps], 99),
            p50_token_s=_pct([c.per_token_s for c in comps], 50),
            p99_token_s=_pct([c.per_token_s for c in comps], 99),
            # the named spans and other_s sum to window_s
            other_s=sec.get("other", 0.0),
            dispatch_overhead_s=(sec.get("decode", 0.0) + sec.get("draft", 0.0)
                                 + sec.get("verify", 0.0)),
            device_s=sec.get("sync", 0.0),
        )
        if self.serve.paged:
            hits = self.allocator.stats.prefix_hits - self._win["hits0"]
            rec["page_occupancy"] = self.allocator.occupancy
            rec["prefix_hit_rate"] = hits / rec["admitted"] if rec["admitted"] else None
            rec["pages_per_request"] = (float(np.mean([c.pages for c in comps]))
                                        if comps else None)
        if self.serve.draft:
            prop = self.spec_proposed - self._win["prop0"]
            acc = self.spec_accepted - self._win["acc0"]
            rec["spec"] = dict(
                draft=self.serve.draft, k=self.serve.spec_k, proposed=prop, accepted=acc,
                accept_rate=(acc / prop) if prop else None,
                accepted_hist=[h - h0 for h, h0 in zip(self.spec_hist, self._win["hist0"])],
            )
        if self.replica is not None:
            rec["replica"] = self.replica
        if self.logger is not None:
            self.logger.log(**rec)
        if self.recorder is not None:
            self.recorder.record("serve", window=self._window_idx, steps=steps,
                                 new_tokens=new_tokens, occupancy=rec["occupancy"],
                                 completed=len(comps))
        if self.metrics is not None:
            self._metrics_window(comps, rec)
        self._window_idx += 1
        self._win = dict(
            steps=0, gen0=self._gen_total, admit0=self.admitted,
            comps0=len(self.completions),
            hits0=self.allocator.stats.prefix_hits if self.serve.paged else 0,
            prop0=self.spec_proposed, acc0=self.spec_accepted, hist0=list(self.spec_hist),
        )

    def _metrics_window(self, comps, rec: dict) -> None:
        """Fold one window into the registry and account the SLOs, derived
        from the completions, the closed span trees and the quantum events
        alone (tpukit engine.py:1249-1327). Every series carries the
        engine's `replica` label (none on a standalone engine), so a fleet's
        replicas share one registry."""
        m = self.metrics
        rep = self.replica
        for c in comps:
            m.observe("serve_e2e_s", c.e2e_s, replica=rep)
            m.observe("serve_ttft_s", max(c.active_s - c.arrival_s, 0.0), replica=rep)
            m.observe("serve_queue_wait_s", max(c.admit_s - c.arrival_s, 0.0), replica=rep)
            m.observe("serve_tpot_s", c.per_token_s, replica=rep)
            m.observe("serve_tokens_per_request", c.generated, replica=rep)
            m.inc("serve_requests", 1, replica=rep, reason=c.reason)
            m.inc("serve_tokens", c.generated, replica=rep)
        if rec.get("tokens_per_sec") is not None:
            m.gauge("serve_tokens_per_sec", rec["tokens_per_sec"], replica=rep)
        m.gauge("serve_occupancy", rec["occupancy"], replica=rep)
        m.gauge("serve_queue_depth", rec["queue_depth"], replica=rep)
        if self.serve.paged:
            m.gauge("serve_page_occupancy", rec["page_occupancy"], replica=rep)
        if self.tracer is not None:
            # phase walls of newly closed trees, each request once
            events = self.tracer.snapshot()
            rids = {c.rid for c in self.completions}
            for t in trace_lib.build_trees(events):
                if (t["trace"] in self._metrics_traces_seen
                        or not t["closed"] or t["rid"] not in rids):
                    continue
                self._metrics_traces_seen.add(t["trace"])
                for ph, wall in t["phases"].items():
                    m.observe("serve_phase_s", wall, replica=rep, phase=ph)
            # this engine's quanta's dispatch and sync walls, once each
            # (watermarked on t1)
            mark = self._metrics_q_mark
            for ev in events:
                if (ev.get("ev") != "quantum" or ev.get("replica") != rep
                        or ev.get("t1", 0.0) <= mark):
                    continue
                self._metrics_q_mark = max(self._metrics_q_mark, ev["t1"])
                m.observe("serve_dispatch_s", ev["t1"] - ev["t0"], replica=rep,
                          phase="dispatch")
                if "s1" in ev:
                    m.observe("serve_sync_s", ev["s1"] - ev["s0"], replica=rep, phase="sync")
        if self.slo_accountant is not None:
            samples = {
                "e2e": [c.e2e_s for c in comps],
                "ttft": [max(c.active_s - c.arrival_s, 0.0) for c in comps],
                "queue_wait": [max(c.admit_s - c.arrival_s, 0.0) for c in comps],
                "tpot": [c.per_token_s for c in comps],
            }
            slo_rec = dict(kind="slo", window=self._window_idx,
                           **self.slo_accountant.evaluate(samples))
            if self.replica is not None:
                slo_rec["replica"] = self.replica
            if self.logger is not None:
                self.logger.log(**slo_rec)
            if self.recorder is not None:
                self.recorder.record("slo", window=self._window_idx,
                                     overall_compliance=slo_rec["overall_compliance"])
        if self.metrics_dir:
            metrics_lib.publish_snapshot(self.metrics_dir, self.replica or 0, m,
                                         time_s=time.time())

    def summary(self, wall_s: float) -> dict:
        """The `kind="serve_summary"` record (tpukit engine.py:1329-1419),
        with the port's `prefill_dispatches` beside tpukit's keys."""
        comps = self.completions
        gen = sum(c.generated for c in comps)
        # under speculation a step is one verify, spec_k + 1 tokens a slot
        cap = (self.serve.spec_k + 1) if self.serve.draft else 1
        rec = dict(
            kind="serve_summary", requests=len(comps), slots=self.serve.slots,
            buckets=list(self.serve.buckets), buckets_used=sorted(self.buckets_used),
            generated_tokens=gen, decode_steps=self.steps,
            prefill_dispatches=self.prefill_dispatches, wall_s=wall_s,
            tokens_per_sec=gen / wall_s if wall_s else None,
            mean_occupancy=(gen / (self.serve.slots * self.steps * cap)
                            if self.steps else 0.0),
            admitted=self.admitted, evicted_eos=self.evicted["eos"],
            evicted_length=self.evicted["length"],
            evicted_deadline=self.evicted["deadline"],
            p50_e2e_s=_pct([c.e2e_s for c in comps], 50),
            p99_e2e_s=_pct([c.e2e_s for c in comps], 99),
            p50_token_s=_pct([c.per_token_s for c in comps], 50),
            p99_token_s=_pct([c.per_token_s for c in comps], 99),
        )
        if self.replica is not None:
            rec["replica"] = self.replica
        sec = self.spans.epoch()["seconds"]
        spec_s = sec.get("draft", 0.0) + sec.get("verify", 0.0)
        rec["prefill_s"] = sec.get("prefill", 0.0)
        rec["decode_s"] = sec.get("decode", 0.0)
        rec["sync_s"] = sec.get("sync", 0.0)
        # the wall outside every span (run resets the epoch at its start)
        rec["other_s"] = max(wall_s - rec["prefill_s"] - rec["decode_s"] - rec["sync_s"]
                             - spec_s, 0.0)
        rec["dispatch_overhead_s"] = rec["decode_s"] + spec_s
        rec["device_s"] = rec["sync_s"]
        rec["max_live_slots"] = self.max_live
        rec["kv_bytes"] = self.kv_bytes
        if self.serve.draft:
            rec["draft_s"] = sec.get("draft", 0.0)
            rec["verify_s"] = sec.get("verify", 0.0)
            rec["spec"] = dict(
                draft=self.serve.draft, k=self.serve.spec_k,
                proposed=self.spec_proposed, accepted=self.spec_accepted,
                accept_rate=(self.spec_accepted / self.spec_proposed
                             if self.spec_proposed else None),
                accepted_hist=list(self.spec_hist),
            )
        if self.serve.paged:
            st = self.allocator.stats
            hit = [c.admit_latency_s for c in comps if c.prefix_pages > 0]
            cold = [c.admit_latency_s for c in comps if c.prefix_pages == 0]
            rec.update(
                page_size=self.serve.page_size, num_pages=self.num_pages,
                kv_dtype=self.serve.kv_dtype, prefix_hits=st.prefix_hits,
                prefix_hit_rate=st.prefix_hits / max(self.admitted, 1),
                prefix_pages_reused=st.prefix_pages_reused,
                reclaimed_pages=st.reclaimed,
                page_occupancy=self.allocator.occupancy,
                pages_per_request=(float(np.mean([c.pages for c in comps]))
                                   if comps else None),
                admit_latency_hit_s=float(np.mean(hit)) if hit else None,
                admit_latency_cold_s=float(np.mean(cold)) if cold else None,
            )
        if self.tracer is not None:
            # phase percentiles of this engine's own requests' trees
            rids = {c.rid for c in comps}
            trees = [t for t in trace_lib.build_trees(self.tracer.snapshot())
                     if t["rid"] in rids]
            rec["phase_p50"], rec["phase_p99"] = trace_lib.phase_stats(trees)
            rec["trace_complete"] = trace_lib.completeness(trees)
            # ring evictions make every aggregate above partial: say so
            # (the tracer may be a fleet's, so this engine's ring alone)
            rec["trace_dropped"] = self.tracer.dropped_by_replica.get(self.replica, 0)
        if self.slo_accountant is not None:
            rec["slo_overall_compliance"] = self.slo_accountant.overall_compliance()
        return rec

    # ---- step primitives (the fleet drives engines through these) ----------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_lanes(self) -> int:
        return len(self._lanes)

    @property
    def decoding_lanes(self) -> int:
        return sum(1 for l in self._lanes.values() if l.phase == "decode")

    @property
    def generated_tokens(self) -> int:
        """Tokens generated so far (completed and live lanes, as of the last
        sync): the fleet router's aggregation counter."""
        return self._gen_total

    @property
    def free_pages(self) -> int:
        """Pages an admission could obtain (free and reclaimable); the ring
        has no page budget and reports 1 << 30."""
        return self.allocator.available_pages if self.serve.paged else (1 << 30)

    def host_state(self, completions_from: int = 0) -> dict:
        """The host state a grid replica's first rank sends its router with
        every reply (`serve/replica_world.py`): the counters the router
        reads, each lane as `(slot, rid, phase, pages, prefill_end,
        prompt_len, admit_s, key)`, the allocator's stats, the summary of
        the last `finish`, and the completions from `completions_from` on."""
        return dict(
            free_slots=self.free_slots, free_pages=self.free_pages,
            live_lanes=self.live_lanes, decoding_lanes=self.decoding_lanes,
            generated_tokens=self.generated_tokens, admitted=self.admitted,
            steps=self.steps, prefill_dispatches=self.prefill_dispatches,
            lanes=[(s, l.req.rid, l.phase, list(l.pages), l.prefill_end, l.prompt_len,
                    l.admit_s, l.key) for s, l in sorted(self._lanes.items())],
            stats=(dataclasses.replace(self.allocator.stats) if self.serve.paged else None),
            last_summary=self.last_summary,
            completions=self.completions[completions_from:],
        )

    def admit(self, reqs: list[Request], now: float) -> list[Request]:
        """Admit as many of `reqs` (in order) as capacity allows; returns the
        un-admitted tail. Ring: up to the free-slot count, in one batched
        bucket-grouped prefill. Paged: stops at the first request the pool
        cannot cover (FIFO)."""
        if not self.serve.paged:
            take = reqs[: len(self._free)]
            if take:
                self._admit_batch(take, now)
            return list(reqs[len(take):])
        left = list(reqs)
        while left and self._free:
            if not self._admit_paged_one(left[0], now):
                break
            left.pop(0)
        return left

    def poll_prefill(self, now: float) -> None:
        """Advance every prefilling paged lane one chunk (the ring prefills
        at admission)."""
        if self.serve.paged:
            self._dispatch_prefill_chunks(now)

    def dispatch_decode(self) -> bool:
        """Run one decode quantum (or speculative quantum) if any lane is
        decoding; returns whether it did."""
        if not any(l.phase == "decode" for l in self._lanes.values()):
            return False
        if self.serve.draft:
            self._spec_step()
        else:
            self._step()
        return True

    def sync(self, now: float) -> None:
        """The per-quantum host sync: retire finished lanes, evict those
        past their deadline, and close a `kind="serve"` window when one is
        due."""
        self._sync_evict(now)
        self._evict_deadlines(now)
        if self._win["steps"] >= self.serve.window_steps:
            self._emit_window()

    def finish(self, wall_s: float) -> list[Completion]:
        """Close the partial window and record the run's summary
        (`last_summary`, and the logger's `kind="serve_summary"` row); a
        standalone engine also flushes its traces and span trees, the
        `kind="metrics"` row and the merged snapshot (a fleet replica leaves
        them to its router, which shares the tracer and the registry and
        flushes once, killed replicas included). Returns the completions."""
        if self._win["steps"]:
            self._emit_window()
        rec = self.last_summary = self.summary(wall_s)
        if self.logger is not None:
            self.logger.log(**rec)
        if self.recorder is not None:
            self.recorder.record("serve_summary", requests=rec["requests"],
                                 tokens_per_sec=rec["tokens_per_sec"],
                                 mean_occupancy=rec["mean_occupancy"])
        if self.tracer is not None and self.replica is None:
            trace_lib.flush_to_logger(self.tracer, self.logger,
                                      trace_lib.build_trees(self.tracer.snapshot()))
        if self.metrics is not None and self.replica is None:
            rec_m = dict(kind="metrics", source="serve", **self.metrics.summary())
            if self.logger is not None:
                self.logger.log(**rec_m)
            if self.recorder is not None:
                self.recorder.record("metrics", source="serve", hists=len(rec_m["hists"]),
                                     tokens=self.metrics.sum_counter("serve_tokens"))
            if self.metrics_dir:
                metrics_lib.publish_snapshot(self.metrics_dir, 0, self.metrics,
                                             time_s=time.time())
                merged, meta = metrics_lib.merge_snapshot_dir(self.metrics_dir)
                metrics_lib.write_merged(self.metrics_dir, merged, meta=meta)
        return self.completions

    def requeue_live(self) -> list[Request]:
        """This replica's in-flight requests, rebuilt from the Request objects
        (twin of `tpukit/serve/engine.py:1543`): a lane's prompt and seed
        never depend on device state, so a killed replica's work requeues
        onto survivors and gives the same tokens there. The partial output
        is dropped, so each request completes once. The engine is not
        changed: a killed replica is simply dropped."""
        return sorted((l.req for l in self._lanes.values()), key=lambda r: r.rid)

    def release_lane(self, slot: int) -> None:
        """Retire lane `slot` without a completion: the prefill worker's half
        of the page handoff. Its pages are released (registered lead pages
        stay in the prefix registry for later hits) and its block-table row
        zeroed, so a stale write lands in the null page."""
        lane = self._lanes.pop(slot)
        if self.serve.paged:
            self.allocator.release(lane.pages)
            self._bt[slot] = 0
            self._bt_dirty = True
        self._free.append(slot)

    @torch.no_grad()
    def adopt_prefilled(self, req: Request, pages: list[int], shared: int,
                        admit_s: float, now: float, key) -> int:
        """The decode replica's half of the handoff (twin of
        `tpukit/serve/engine.py:1572`): arm a lane whose K/V another engine
        prefilled and the fleet's handoff copied into this engine's pool at
        `pages` (allocated or claimed on this allocator; the first `shared`
        are registry claims). Writes the block-table row, the prompt into
        the buffer and the lane's decode state (`decode.adopt_slot`, no
        forward), and registers the lead `(prompt_len - 1) // P` pages so a
        later handoff of the same prefix claims them. Returns the slot."""
        if not self.serve.paged:
            raise ValueError(
                "adopt_prefilled requires the paged cache (page_size > 0) "
                "— the disaggregated handoff rides page granularity")
        plen = len(req.ids)
        slot = self._free.popleft()
        self._bt[slot] = 0
        self._bt[slot, : len(pages)] = pages
        self._bt_dirty = True
        self._refresh_bt()
        row = np.zeros((self.serve.padded_width,), np.int32)
        row[:plen] = req.ids
        limit = min(plen + req.max_new_tokens, self.serve.width)
        key = np.asarray(key, np.int64)
        (self.buf, self.cursors, self.active, self.limits,
         self.keys) = serve_decode.adopt_slot(
            self.buf, self.cursors, self.active, self.limits, self.keys, slot,
            self._tensor(row), plen, limit, self._tensor(key))
        reg = (plen - 1) // self.serve.page_size
        self.allocator.register(req.ids, pages[:reg])
        self._lanes[slot] = _Lane(
            req, admit_s, plen, self.bucket_for(plen), pages=list(pages), shared=shared,
            next_chunk=0, prefill_end=0, phase="decode", active_s=now, key=key,
        )
        self.admitted += 1
        self.max_live = max(self.max_live, len(self._lanes))
        if self.tracer is not None:
            self.tracer.emit("adopt", trace_id(req), rid=req.rid, t=now, slot=slot,
                             replica=self.replica)
        if shared:
            self.allocator.stats.prefix_hits += 1
            self.allocator.stats.prefix_pages_reused += shared
        return slot

    @torch.no_grad()
    def run(self, requests, max_wall_s: float | None = None) -> list[Completion]:
        """Serve `requests` (each admitted no earlier than its `arrival_s`)
        to completion; returns the completions in finish order."""
        self._pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self.spans.epoch()  # the summary's walls start with the run
        t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.set_epoch(t0)
            for r in self._pending:
                self.tracer.emit("enqueue", trace_id(r), rid=r.rid, t=r.arrival_s,
                                 replica=self.replica)
        while self._pending or self._lanes:
            now = self._clock(t0)
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
            self.poll_prefill(self._clock(t0))
            if not self.dispatch_decode():
                if not self._lanes and self._pending:
                    wait = self._pending[0].arrival_s - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            self.sync(self._clock(t0))
        return self.finish(self._clock(t0))


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
