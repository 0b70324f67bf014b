"""Mergeable metrics for the fleet: counters, gauges, log-bucket
histograms, SLO accounting (a copy of `tpukit/obs/metrics.py`; the
serving half of the port will use `SloAccountant` and `parse_slo`).

The serving JSONL already answers "how did THIS run go" (window
aggregates and span trees). What it cannot answer is anything that
requires *combining* distributions — p99 across a fleet's replicas,
across a multi-host world's processes, or across two runs a week apart.
Sampled percentiles don't merge (the p99 of two p99s is not the fleet
p99); raw sample lists don't bound memory. This module takes the
classic fixed-bucket route instead:

**Histograms are log-spaced fixed-bucket counters.** Every histogram in
every process shares ONE edge table: ``EDGES[k] = LO * GROWTH**k`` with
``GROWTH = 2**(1/8)`` (8 buckets per octave), ``LO = 1e-6`` s and
``N_BUCKETS`` finite buckets spanning 1 µs .. ~4.8 h, plus an underflow
and an overflow bucket. Identical edges everywhere means

    merge(A, B) = bucket-wise sum          (exact, associative,
                                            commutative — no sketch
                                            error, no sample loss)

so replica/process/run aggregation is closed-form and auditable (*The
Big Send-off* discipline applied to telemetry). Quantiles are derived
from the buckets: nearest-rank over the cumulative counts, estimated at
the straddling bucket's geometric midpoint ``sqrt(lo*hi)`` and clamped
to the tracked exact [min, max]. Since every sample in bucket
[e, e*GROWTH) is within a factor ``sqrt(GROWTH)`` of the midpoint, the
estimate's RELATIVE ERROR is bounded by

    sqrt(GROWTH) - 1 = 2**(1/16) - 1 ≈ 4.4%

for any sample in [LO, HI); underflow/overflow samples clamp to the
exact min/max instead (tests/test_metrics.py proves the bound against
exact sorted data on adversarial distributions). Counters merge by sum,
gauges are point-in-time (label them per replica/process; on a merge
collision the later snapshot wins — only histograms and counters claim
exact associative merge).

Metrics are labeled (``{replica, phase, class}`` is the vocabulary the
serving stack uses); a (name, sorted-labels) pair is one time series.

**Snapshot files** follow the heartbeat-file discipline
(`tpukit/obs/heartbeat.py`): each process atomically publishes
``metrics-p{index:05d}.json`` into a shared ``--metrics_dir``
(tmp-sibling + rename, so a reader never sees a torn file), readers
skip-and-count torn/foreign files rather than raising, and records from
a stale incarnation (``process >= process_count`` after an elastic
reshard shrank the world) are excluded the same way heartbeat's
straggler check excludes them. Process 0 merges everything by bucket
sum.

**SLO accounting**: ``parse_slo("ttft<=250ms@p99;tpot<=40ms@p95")``
parses the declared objectives at startup (typos fail fast with pointed
errors — the chaos-grammar discipline), and `SloAccountant` turns each
window's samples into a compliance fraction and an error-budget burn
rate (violation fraction over the budget ``1 - q``; burn 1.0 means
exactly consuming budget, >1 means burning toward violation).

Deliberately stdlib-only (no torch, no numpy), as tpukit's copy is, so
that its snapshot files are the ones `tools/top.py` and `tools/report.py
--compare` read.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from pathlib import Path

# ---- the one bucket table ------------------------------------------------

# 8 buckets per octave: quantile relative error <= 2**(1/16)-1 ~ 4.4%.
GROWTH = 2.0 ** 0.125
# First finite edge: 1 microsecond. 272 finite buckets = 34 octaves,
# so the last edge is 1e-6 * 2**34 ~ 1.7e4 s (~4.8 h) — generous for
# both per-token walls and end-to-end request lifetimes.
LO = 1e-6
N_BUCKETS = 272
EDGES = tuple(LO * GROWTH**k for k in range(N_BUCKETS + 1))
HI = EDGES[-1]
_LOG_G = math.log(GROWTH)

# Bucket layout: index 0 is underflow (< LO), 1..N_BUCKETS hold
# [EDGES[i-1], EDGES[i]), N_BUCKETS+1 is overflow (>= HI).
UNDERFLOW = 0
OVERFLOW = N_BUCKETS + 1

# Bound proven by construction and asserted in tests: any quantile
# estimate for a sample in [LO, HI) is within this relative error.
QUANTILE_REL_ERROR = math.sqrt(GROWTH) - 1.0


def bucket_index(v: float) -> int:
    """Bucket index of a sample — THE one placement function, shared by
    every process so merged histograms are bucket-exact comparable."""
    if v < LO:
        return UNDERFLOW
    if v >= HI:
        return OVERFLOW
    i = int(math.log(v / LO) / _LOG_G) + 1
    # float log can land one off at an edge; restore the invariant
    # v in [EDGES[i-1], EDGES[i]) exactly
    while i > 1 and v < EDGES[i - 1]:
        i -= 1
    while i <= N_BUCKETS and v >= EDGES[i]:
        i += 1
    return min(max(i, UNDERFLOW), OVERFLOW)


class Histogram:
    """One log-bucket histogram: sparse bucket counts plus exact
    count/sum/min/max (all of which also merge exactly: sum, sum, min,
    max). O(1) observe, O(nonzero buckets) merge/quantile."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float, n: int = 1) -> None:
        if n <= 0:
            return
        v = float(v)
        i = bucket_index(v)
        self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        """Bucket-wise sum — exact, associative, commutative."""
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile estimate from the buckets, relative
        error <= QUANTILE_REL_ERROR for samples in [LO, HI); underflow/
        overflow ranks clamp to the exact tracked min/max."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = max(0, math.ceil(q * self.count) - 1)  # 0-based
        cum = 0
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if rank < cum:
                if i == UNDERFLOW:
                    est = self.min
                elif i == OVERFLOW:
                    est = self.max
                else:
                    est = math.sqrt(EDGES[i - 1] * EDGES[i])
                return float(min(max(est, self.min), self.max))
        return float(self.max)  # unreachable unless counts drifted

    def fraction_le(self, bound: float) -> float | None:
        """Fraction of samples <= bound, linearly interpolated inside
        the straddling bucket (bucket-resolution accuracy — exact when
        the bound lands on an edge)."""
        if self.count == 0:
            return None
        le = 0.0
        for i, n in self.buckets.items():
            if i == UNDERFLOW:
                lo, hi = 0.0, LO
            elif i == OVERFLOW:
                lo, hi = HI, max(self.max, HI)
            else:
                lo, hi = EDGES[i - 1], EDGES[i]
            if bound >= hi:
                le += n
            elif bound > lo:
                le += n * (bound - lo) / max(hi - lo, 1e-300)
        return le / self.count

    def to_dict(self) -> dict:
        """JSON-safe encoding (sparse buckets keyed by str index)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls()
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        h.buckets = {int(k): int(n) for k, n in (d.get("buckets") or {}).items()}
        return h

    def summary(self) -> dict:
        """count/sum/min/max/p50/p99 — the compact row report.py and the
        `kind="metrics"` JSONL record carry."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


# ---- the registry --------------------------------------------------------


def _label_key(labels: dict) -> tuple:
    """Canonical hashable form: sorted (k, str(v)) pairs — None values
    mean 'label absent' so a standalone engine and a replica-0 engine
    produce distinct series only when a replica label is actually set."""
    return tuple(sorted((k, str(v)) for k, v in labels.items() if v is not None))


class MetricRegistry:
    """Thread-safe home of every named series. One lock, O(1) updates —
    cheap enough to live inside window-boundary host code (the hot
    device path never touches it: metrics are DERIVED from completions,
    trace trees and span walls, never re-instrumented)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, Histogram] = {}

    # -- writers ----------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def counter_set(self, name: str, value: float, **labels) -> None:
        """Mirror an existing cumulative observer (RetryLog, rollback
        seq, preempt count) into a counter — the value is authoritative
        elsewhere; merge across processes still sums."""
        with self._lock:
            self._counters[(name, _label_key(labels))] = float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float, n: int = 1, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
        h.observe(value, n)

    # -- readers ----------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def sum_counter(self, name: str) -> float:
        """Sum of a counter over every label combination."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items() if n == name)

    def hist(self, name: str, **labels) -> Histogram | None:
        with self._lock:
            return self._hists.get((name, _label_key(labels)))

    def aggregate_hist(self, name: str) -> Histogram:
        """Merge every label variant of `name` into one histogram — the
        cross-run / fleet-vs-single comparison view (replica labels
        differ between a fleet and a standalone engine; distributions
        must not)."""
        out = Histogram()
        with self._lock:
            hists = [h for (n, _), h in self._hists.items() if n == name]
        for h in hists:
            out.merge(h)
        return out

    def hist_names(self) -> list[str]:
        with self._lock:
            return sorted({n for (n, _) in self._hists})

    def filter(self, **labels) -> "MetricRegistry":
        """Sub-registry of series matching every given label exactly —
        how a fleet splits its shared registry into per-replica
        snapshot files."""
        want = dict(_label_key(labels))
        sub = MetricRegistry()
        with self._lock:
            items = (
                list(self._counters.items()),
                list(self._gauges.items()),
                list(self._hists.items()),
            )
        for (name, lk), v in items[0]:
            if all(dict(lk).get(k) == w for k, w in want.items()):
                sub._counters[(name, lk)] = v
        for (name, lk), v in items[1]:
            if all(dict(lk).get(k) == w for k, w in want.items()):
                sub._gauges[(name, lk)] = v
        for (name, lk), h in items[2]:
            if all(dict(lk).get(k) == w for k, w in want.items()):
                c = Histogram()
                c.merge(h)
                sub._hists[(name, lk)] = c
        return sub

    # -- snapshot / merge --------------------------------------------------

    def snapshot(self) -> dict:
        """Consistent JSON-safe copy of every series."""
        with self._lock:
            return {
                "v": 1,
                "counters": [
                    {"name": n, "labels": dict(lk), "value": v}
                    for (n, lk), v in sorted(self._counters.items())
                ],
                "gauges": [
                    {"name": n, "labels": dict(lk), "value": v}
                    for (n, lk), v in sorted(self._gauges.items())
                ],
                "hists": [
                    {"name": n, "labels": dict(lk), **h.to_dict()}
                    for (n, lk), h in sorted(self._hists.items())
                ],
            }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "MetricRegistry":
        reg = cls()
        reg.merge_snapshot(snap)
        return reg

    def merge_snapshot(self, snap: dict) -> None:
        """Fold a snapshot in: counters sum, histograms bucket-sum,
        gauges last-writer-wins (see module docstring)."""
        with self._lock:
            for row in snap.get("counters", ()):
                key = (row["name"], _label_key(row.get("labels") or {}))
                self._counters[key] = self._counters.get(key, 0.0) + float(row["value"])
            for row in snap.get("gauges", ()):
                key = (row["name"], _label_key(row.get("labels") or {}))
                self._gauges[key] = float(row["value"])
            for row in snap.get("hists", ()):
                key = (row["name"], _label_key(row.get("labels") or {}))
                h = self._hists.get(key)
                if h is None:
                    h = self._hists[key] = Histogram()
                h.merge(Histogram.from_dict(row))

    def summary(self) -> dict:
        """Compact per-series summaries — the `kind="metrics"` record
        body (full bucket tables live in the snapshot files, not the
        JSONL)."""
        with self._lock:
            counters = [
                {"name": n, "labels": dict(lk), "value": v}
                for (n, lk), v in sorted(self._counters.items())
            ]
            gauges = [
                {"name": n, "labels": dict(lk), "value": v}
                for (n, lk), v in sorted(self._gauges.items())
            ]
            hists = [
                {"name": n, "labels": dict(lk), **h.summary()}
                for (n, lk), h in sorted(self._hists.items())
            ]
        return {"counters": counters, "gauges": gauges, "hists": hists}


# ---- snapshot files (heartbeat-file discipline) --------------------------

SNAPSHOT_GLOB = "metrics-p*.json"
MERGED_NAME = "metrics-merged.json"
OPENMETRICS_NAME = "metrics.prom"


def snapshot_path(directory, process_index: int) -> Path:
    return Path(directory) / f"metrics-p{process_index:05d}.json"


def _atomic_write_text(path: Path, text: str) -> None:
    """tmp-sibling + rename publish (the port's `checkpoint.atomic_write_text`,
    spelled here so that the module stays stdlib-only)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def publish_snapshot(
    directory,
    process_index: int,
    registry: MetricRegistry,
    *,
    process_count: int = 1,
    time_s: float = 0.0,
) -> Path:
    """Atomically publish one process's snapshot file. Readers never see
    a torn file (rename publish); last write wins per process."""
    path = snapshot_path(directory, process_index)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "process": int(process_index),
        "process_count": int(process_count),
        "time": float(time_s),
        "metrics": registry.snapshot(),
    }
    _atomic_write_text(path, json.dumps(payload))
    return path


def read_snapshots(directory, process_count: int | None = None) -> tuple[list[dict], dict]:
    """Every readable snapshot payload in the directory, plus a meta
    dict {"files", "skipped", "stale"}. Torn/foreign files are skipped
    and counted, never raised (heartbeat read_all discipline); payloads
    whose `process >= process_count` are a stale incarnation left over
    from a larger world and are excluded the same way heartbeat's
    straggler check excludes them."""
    out: list[dict] = []
    skipped = 0
    stale = 0
    directory = Path(directory)
    paths = sorted(directory.glob(SNAPSHOT_GLOB)) if directory.is_dir() else []
    for path in paths:
        try:
            payload = json.loads(path.read_text())
            proc = int(payload["process"])
            payload["metrics"]["counters"]  # shape check: a snapshot, not a stray json
        except (ValueError, KeyError, TypeError, OSError):
            skipped += 1  # torn/foreign file: skip, never raise
            continue
        if process_count is not None and proc >= process_count:
            stale += 1
            continue
        out.append(payload)
    return out, {"files": len(paths), "skipped": skipped, "stale": stale}


def merge_snapshot_dir(
    directory, process_count: int | None = None
) -> tuple[MetricRegistry, dict]:
    """Process 0's merge: fold every live snapshot into one registry by
    bucket-wise sum. Deterministic in file order (sorted paths), but the
    result is order-independent for counters/histograms (associative
    commutative merge — tests shuffle to prove it)."""
    payloads, meta = read_snapshots(directory, process_count)
    merged = MetricRegistry()
    for p in payloads:
        merged.merge_snapshot(p["metrics"])
    meta["merged"] = len(payloads)
    return merged, meta


def write_merged(directory, registry: MetricRegistry, *, meta: dict | None = None) -> None:
    """Publish the merged view beside the per-process files: the JSON
    merge (`metrics-merged.json`) and the OpenMetrics textfile
    (`metrics.prom`) external scrapers collect."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload = {"meta": meta or {}, "metrics": registry.snapshot()}
    _atomic_write_text(directory / MERGED_NAME, json.dumps(payload))
    _atomic_write_text(directory / OPENMETRICS_NAME, to_openmetrics(registry))


# ---- OpenMetrics textfile export -----------------------------------------


def _om_labels(labels: dict, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _om_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def to_openmetrics(registry: MetricRegistry) -> str:
    """OpenMetrics text exposition of the registry (counter/gauge/
    histogram families; histogram buckets are cumulative `le` series —
    only edges whose cumulative count changes are emitted, which is
    valid exposition and keeps 272-bucket tables compact)."""
    snap = registry.snapshot()
    lines: list[str] = []
    seen_types: set[str] = set()

    def head(name: str, kind: str):
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for row in snap["counters"]:
        name = _om_name(row["name"]) + "_total"
        head(name, "counter")
        lines.append(f"{name}{_om_labels(row['labels'])} {row['value']:g}")
    for row in snap["gauges"]:
        name = _om_name(row["name"])
        head(name, "gauge")
        lines.append(f"{name}{_om_labels(row['labels'])} {row['value']:g}")
    for row in snap["hists"]:
        name = _om_name(row["name"])
        head(name, "histogram")
        labels = row["labels"]
        cum = 0
        for i in sorted(int(k) for k in row["buckets"]):
            cum += row["buckets"][str(i)]
            le = "+Inf" if i >= OVERFLOW else f"{EDGES[i]:.9g}"
            le_attr = 'le="' + le + '"'
            lines.append(f"{name}_bucket{_om_labels(labels, le_attr)} {cum}")
        if cum < row["count"]:  # defensive: counts are authoritative
            cum = row["count"]
        inf_attr = 'le="+Inf"'
        lines.append(f"{name}_bucket{_om_labels(labels, inf_attr)} {cum}")
        lines.append(f"{name}_sum{_om_labels(labels)} {row['sum']:g}")
        lines.append(f"{name}_count{_om_labels(labels)} {row['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---- SLO grammar + accounting --------------------------------------------

# ttft<=250ms@p99 ; tpot<=40ms@p95 ; e2e<=2s@p99 ; queue_wait<=100ms@p90
_SLO_ITEM_RE = re.compile(
    r"^(?P<metric>[a-z_][a-z0-9_]*)"
    r"<=(?P<value>[0-9]+(?:\.[0-9]+)?)(?P<unit>us|ms|s)"
    r"@p(?P<q>[0-9]+(?:\.[0-9]+)?)$"
)
_UNIT_S = {"us": 1e-6, "ms": 1e-3, "s": 1.0}

# The latency series the serving stack derives (module docstring of the
# engine wiring): what an --slo clause may name.
SLO_METRICS = ("ttft", "tpot", "e2e", "queue_wait")


class SloSpecError(ValueError):
    """A malformed --slo spec — raised at startup so a typo'd objective
    fails the launch, not silently never gates (chaos-grammar
    discipline)."""


class SloTarget:
    """One parsed clause: `metric <= bound_s @ quantile q`."""

    __slots__ = ("metric", "bound_s", "q", "raw")

    def __init__(self, metric: str, bound_s: float, q: float, raw: str):
        self.metric = metric
        self.bound_s = bound_s
        self.q = q
        self.raw = raw

    @property
    def budget(self) -> float:
        """Allowed violation fraction: 1 - q."""
        return 1.0 - self.q

    def __repr__(self):
        return f"SloTarget({self.raw!r})"


def parse_slo(spec: str) -> list[SloTarget]:
    """Parse `"ttft<=250ms@p99;tpot<=40ms@p95"` into targets, failing
    fast with a pointed message on any malformed clause."""
    targets: list[SloTarget] = []
    seen: set[str] = set()
    for raw in spec.split(";"):
        item = raw.strip()
        if not item:
            continue
        m = _SLO_ITEM_RE.match(item)
        if m is None:
            raise SloSpecError(
                f"bad --slo clause {item!r}: expected "
                f"`metric<=VALUE[us|ms|s]@pQQ` like `ttft<=250ms@p99` "
                f"(metrics: {', '.join(SLO_METRICS)})"
            )
        metric = m.group("metric")
        if metric not in SLO_METRICS:
            raise SloSpecError(
                f"bad --slo clause {item!r}: unknown metric {metric!r} "
                f"(metrics: {', '.join(SLO_METRICS)})"
            )
        q = float(m.group("q")) / 100.0
        if not 0.0 < q < 1.0:
            raise SloSpecError(
                f"bad --slo clause {item!r}: quantile p{m.group('q')} "
                f"must be in (p0, p100) exclusive"
            )
        if metric in seen:
            raise SloSpecError(
                f"bad --slo spec: metric {metric!r} declared twice"
            )
        seen.add(metric)
        bound_s = float(m.group("value")) * _UNIT_S[m.group("unit")]
        if bound_s <= 0.0:
            raise SloSpecError(
                f"bad --slo clause {item!r}: bound must be > 0"
            )
        targets.append(SloTarget(metric, bound_s, q, item))
    if not targets:
        raise SloSpecError(
            "empty --slo spec: declare at least one clause like "
            "`ttft<=250ms@p99`"
        )
    return targets


class SloAccountant:
    """Window-by-window compliance + error-budget burn.

    Per window and target: `compliance` is the fraction of that
    window's samples meeting the bound, `met` is compliance >= q, and
    `burn` is the violation fraction over the budget (1-q) — burn 1.0
    consumes budget exactly as fast as allowed, >1 is on track to
    violate. Cumulative rows accumulate samples across windows so the
    run-level verdict (`overall_compliance`, what the
    --min_slo_compliance gate reads) is sample-weighted, not
    window-weighted."""

    def __init__(self, targets: list[SloTarget]):
        self.targets = list(targets)
        self._cum_n = {t.metric: 0 for t in self.targets}
        self._cum_viol = {t.metric: 0 for t in self.targets}
        self.windows = 0

    def evaluate(self, samples: dict[str, list[float]]) -> dict:
        """Account one window. `samples` maps metric name -> that
        window's raw values (seconds). Returns the `kind="slo"` record
        body (minus the kind/window tags the caller stamps)."""
        self.windows += 1
        rows = []
        for t in self.targets:
            vals = samples.get(t.metric) or []
            n = len(vals)
            viol = sum(1 for v in vals if v > t.bound_s)
            self._cum_n[t.metric] += n
            self._cum_viol[t.metric] += viol
            cn = self._cum_n[t.metric]
            cv = self._cum_viol[t.metric]
            compliance = None if n == 0 else (n - viol) / n
            cum_compliance = None if cn == 0 else (cn - cv) / cn
            rows.append({
                "slo": t.raw,
                "metric": t.metric,
                "bound_s": t.bound_s,
                "q": t.q,
                "n": n,
                "violations": viol,
                "compliance": compliance,
                "met": None if compliance is None else compliance >= t.q,
                "burn": None if n == 0 else (viol / n) / max(t.budget, 1e-9),
                "cum_n": cn,
                "cum_compliance": cum_compliance,
                "cum_burn": None if cn == 0 else (cv / cn) / max(t.budget, 1e-9),
            })
        return {"targets": rows, "overall_compliance": self.overall_compliance()}

    def overall_compliance(self) -> float | None:
        """The run verdict: the WORST cumulative compliance across
        targets that have samples (min, not mean — one violated
        objective is a violated SLO). None until any target has a
        sample (the gate treats that as failure, anti-vacuous)."""
        fracs = [
            (self._cum_n[t.metric] - self._cum_viol[t.metric]) / self._cum_n[t.metric]
            for t in self.targets
            if self._cum_n[t.metric] > 0
        ]
        return min(fracs) if fracs else None
