"""Metrics tracker: counters, gauges, streaming histograms and typed
events (port of ``repro/obs/tracker.py``).

One :class:`Tracker` is the observability hub a serving process threads
through its index surfaces (``QueryEngine(tracker=)``,
``MutableIndex(tracker=)``, ``IndexSpec(tracker=)``, or ambiently through
:func:`set_default_tracker`). Everything here is plain host Python:
metrics are recorded after the device-sync points of the spans
(:mod:`repro_torch.obs.trace`), so attaching a tracker cannot change what
a query computes or returns.

Aggregation lives in the tracker (counters sum, gauges keep the last
value, histograms bucket); every update also goes to the attached sinks
as one flat record dict (:mod:`repro_torch.obs.sinks`), so time-series
consumers see the stream while ``snapshot()`` serves the rollup.

Metric names are the reference's dotted paths under a per-layer prefix:
``repro.engine.*`` (query engines), ``repro.planner.*`` (planner),
``repro.streaming.*`` (mutable indexes, drift), ``repro.kernels.*``
(kernel dispatch), so one consumer reads either package's records.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

# histogram bucket geometry: fixed log-spaced buckets covering [LOG_LO,
# LOG_LO * GROWTH^num_buckets). GROWTH=1.07 bounds the relative quantile
# error by ~sqrt(1.07)-1 = 3.4% — tested against numpy on lognormal
# samples. LOG_LO=1e-9 keeps nanosecond-scale span durations resolvable.
HIST_GROWTH = 1.07
HIST_LO = 1e-9
HIST_HI = 1e12
DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


class LogHistogram:
    """Streaming fixed-bucket log histogram with quantile estimates.

    O(1) record, O(buckets) quantile; the bucket array is fixed at
    construction (no allocation on the hot path). Values at or below zero
    land in the underflow bucket; exact count/sum/min/max ride alongside
    so means and extremes are not bucket-quantized.
    """

    def __init__(self, *, lo: float = HIST_LO, hi: float = HIST_HI,
                 growth: float = HIST_GROWTH):
        if not (lo > 0.0 and hi > lo and growth > 1.0):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
                f"growth={growth}")
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_growth = math.log(growth)
        self.num_buckets = int(
            math.ceil(math.log(hi / lo) / self._log_growth)) + 1
        self.counts = [0] * self.num_buckets
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, value: float) -> int:
        if value <= self.lo:
            return 0
        b = int(math.log(value / self.lo) / self._log_growth) + 1
        return min(b, self.num_buckets - 1)

    def record(self, value: float) -> None:
        value = float(value)
        self.counts[self._bucket(value)] += 1
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into this histogram in place (returns self).

        Merging is exact on the bucket counts — both histograms must share
        the same bucket geometry (lo/growth/num_buckets), else ValueError —
        so quantile error after a merge is the same ~sqrt(growth)-1 bound
        as for a single histogram that saw every sample (tested). The
        per-shard -> fleet rollup path (``Tracker.merge``) and the
        distributed benchmark use this."""
        if not isinstance(other, LogHistogram):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if (self.lo != other.lo or self.growth != other.growth
                or self.num_buckets != other.num_buckets):
            raise ValueError(
                f"bucket geometry mismatch: lo={self.lo}/{other.lo} "
                f"growth={self.growth}/{other.growth} "
                f"buckets={self.num_buckets}/{other.num_buckets}")
        for b, c in enumerate(other.counts):
            self.counts[b] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def _edges(self, b: int) -> tuple:
        """(lo, hi) value edges of bucket ``b`` (bucket 0 = underflow)."""
        if b == 0:
            return (0.0, self.lo)
        return (self.lo * self.growth ** (b - 1),
                self.lo * self.growth ** b)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile: geometric midpoint of the covering
        bucket, clamped to the exact observed [min, max]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for b, c in enumerate(self.counts):
            cum += c
            if cum >= target and c > 0:
                lo, hi = self._edges(b)
                mid = math.sqrt(lo * hi) if lo > 0.0 else hi / 2.0
                return min(max(mid, self.min), self.max)
        return self.max

    def summary(self, quantiles: Sequence[float] = DEFAULT_QUANTILES
                ) -> Dict[str, float]:
        out = {"count": self.count, "mean": self.mean,
               "min": self.min if self.count else 0.0,
               "max": self.max if self.count else 0.0}
        for q in quantiles:
            out[f"p{round(q * 100):d}"] = self.quantile(q)
        return out


class Tracker:
    """Counters + gauges + histograms + typed events behind one object.

    Args:
      sinks: objects with ``emit(record: dict)``
             (:mod:`repro_torch.obs.sinks`);
             every metric update forwards one flat record. No sinks is
             fine — the in-tracker aggregates still serve ``snapshot()``.
      clock: monotonic time source (seconds); injectable for tests.
    """

    def __init__(self, sinks: Optional[List] = None, *,
                 clock: Callable[[], float] = time.perf_counter):
        self.sinks = list(sinks) if sinks else []
        self.clock = clock
        self._t0 = clock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, LogHistogram] = {}
        self.events: List[dict] = []
        # span bookkeeping lives in the tracer (one per tracker)
        from repro_torch.obs.trace import Tracer
        self.tracer = Tracer(self)

    # -- emission ------------------------------------------------------------

    def _emit(self, record: dict) -> None:
        record["t"] = self.clock() - self._t0
        for s in self.sinks:
            s.emit(record)

    # -- metric surface ------------------------------------------------------

    def count(self, name: str, n: float = 1) -> None:
        """Monotonic counter increment."""
        total = self.counters.get(name, 0) + n
        self.counters[name] = total
        self._emit({"type": "counter", "name": name, "inc": n,
                    "total": total})

    def gauge(self, name: str, value: float) -> None:
        """Point-in-time value (last write wins)."""
        value = float(value)
        self.gauges[name] = value
        self._emit({"type": "gauge", "name": name, "value": value})

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the named streaming histogram."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = LogHistogram()
        h.record(value)
        self._emit({"type": "observe", "name": name, "value": float(value)})

    def event(self, name: str, **fields: Any) -> None:
        """Typed structured event (streaming repartitions, calibration
        staleness, ...): kept in-tracker and forwarded to sinks."""
        rec = {"type": "event", "name": name, "fields": fields}
        self.events.append({"name": name, **fields})
        self._emit(rec)

    def span(self, name: str, *, sync: Any = None, attrs=None):
        """Context manager timing a stage of the query hot path; see
        :class:`repro_torch.obs.trace.Tracer`. ``sync`` (or ``sp.sync(x)`` in
        the body) marks the device-sync boundary — the span blocks on it
        before reading the clock, so timings measure finished device work,
        not dispatch. ``attrs`` (or ``sp.set_attrs(...)``) attach
        structured attributes — predicted flops/bytes — to the record."""
        return self.tracer.span(name, sync=sync, attrs=attrs)

    # -- fleet rollup: per-shard trackers -> one view ------------------------

    def merge(self, other: "Tracker") -> "Tracker":
        """Fold another tracker's aggregates into this one in place
        (returns self): counters sum, gauges last-write (``other`` wins on
        keys it carries), histograms merge bucket-exact
        (:meth:`LogHistogram.merge` — mismatched geometries raise), events
        append. Sinks and span state are NOT merged — merge is the
        fleet-view aggregation step for per-shard / per-process trackers
        (trace-level merging is :mod:`repro_torch.obs.export`'s job,
        which keeps per-shard records separate under stable pids)."""
        if not isinstance(other, Tracker):
            raise TypeError(f"cannot merge {type(other).__name__}")
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        self.gauges.update(other.gauges)
        for k, h in other.hists.items():
            mine = self.hists.get(k)
            if mine is None:
                # clone the geometry field-for-field: recomputing the
                # bucket count from hi through logs could drift one off
                mine = LogHistogram(lo=h.lo, growth=h.growth)
                mine.num_buckets = h.num_buckets
                mine.counts = [0] * h.num_buckets
                self.hists[k] = mine
            mine.merge(h)
        self.events.extend(other.events)
        return self

    # -- rollup --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Current aggregate state: counters, gauges, histogram summaries
        (count/mean/min/max/p50/p90/p99), event count, and per-sink
        record/drop totals (sinks exposing ``total``/``dropped`` — the
        silent-overflow visibility ``format_table`` renders)."""
        sinks = []
        for s in self.sinks:
            total = getattr(s, "total", None)
            if total is None:
                continue
            sinks.append({"sink": type(s).__name__, "records": int(total),
                          "dropped": int(getattr(s, "dropped", 0))})
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "hists": {k: h.summary() for k, h in self.hists.items()},
            "num_events": len(self.events),
            "sinks": sinks,
        }

    def flush(self) -> None:
        for s in self.sinks:
            if hasattr(s, "flush"):
                s.flush()

    def close(self) -> None:
        self.flush()
        for s in self.sinks:
            if hasattr(s, "close"):
                s.close()


# -- ambient default tracker --------------------------------------------------

_default_tracker: Optional[Tracker] = None


def set_default_tracker(tracker: Optional[Tracker]) -> Optional[Tracker]:
    """Install (or clear, with None) the process-wide ambient tracker;
    returns the previous one. Surfaces constructed without an explicit
    ``tracker=`` pick it up at construction time."""
    global _default_tracker
    prev = _default_tracker
    _default_tracker = tracker
    return prev


def default_tracker() -> Optional[Tracker]:
    return _default_tracker


def resolve_tracker(tracker: Optional[Tracker]) -> Optional[Tracker]:
    """Explicit tracker wins; None falls back to the ambient default."""
    return tracker if tracker is not None else _default_tracker
