"""Span-based tracing of the query hot path (port of
``repro/obs/trace.py``).

A span times one stage — ``hash_encode``, ``directory_match``,
``segmented_gather``, ``re_rank``, ``top_k`` — with an explicit
device-sync boundary: CUDA launches are asynchronous, so a host clock read
after an un-synced call measures the enqueue, not the stage. Registering
a sync value (``span(name, sync=x)`` or ``sp.sync(x)`` in the body) makes
the span wait for it before reading the clock: for every CUDA device that
holds a tensor of the value (a tensor, or a tuple, list or dict of them),
the span synchronises that device's current stream, the stream the
stage's work was enqueued on. CPU tensors need no sync. Instrumentation
never touches values, so enabling tracing cannot change query results.

Spans nest: the tracer keeps a stack and emits each span with its full
``path`` (``/``-joined ancestry), so the per-stage breakdown of a
``repro.engine.query`` parent is reconstructable from the record stream.
Durations also land in the tracker histogram named by the span (p50 /
p90 / p99 stage timings). The port adds child spans of its own
(``cost.PORT_STAGES``): ``repro.engine.directory_scan`` and
``rank_sort`` inside ``directory_match``, ``repro.engine.runs`` and
``fused_score`` inside ``fused_query``; and
``repro.planner.resolve_budgets`` inside ``repro.engine.query`` when a
call names a recall target.

Span records carry ``t0`` (start, seconds since tracker start) beside
``dur_s``, so :mod:`repro_torch.obs.export` can rebuild begin/end pairs,
and an optional ``attrs`` dict — ``sp.set_attrs(flops=...,
hbm_bytes=...)``, the analytic costs of :mod:`repro_torch.obs.cost`. A
span whose body OR sync raises emits nothing: a failed device
computation has no meaningful duration.

Profiler ranges (the port's own; the reference has none): while
``torch.profiler`` records (``torch._C._autograd._profiler_enabled()``),
every span site opens a ``record_function`` range named as the span, so
a device trace names each stage on the profiler's clock
(``repro.engine.query`` > ``repro.engine.fused_query`` >
``repro.engine.runs`` ...) and an idle gap inside a stage is labelled by
it. Tracked, the range holds the span's clock and sync; untracked,
:func:`span_or_null` and :func:`costed_span` return a range-only context
that neither synchronises nor records. With the profiler off the cost is
one flag read a site: ``record_function`` is never entered (it goes
through the dispatcher, ~11 us a call even when nothing records).

Captured code (the port's own): a CUDA graph replays its kernels with no
host code between them, so a span inside it cannot read a host clock.
:class:`DeviceSpans` stands in for the tracker while the graph is
captured: its span sites are timing events inside the graph, and its
deferred records (:func:`record_later`) read the replay's tensors; after
each replay it hands the tracker the spans, timed on the device, and the
records.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

# the autograd profiler's recording state, under which record_function
# ranges land in a trace
_profiler_enabled = torch._C._autograd._profiler_enabled


def _cuda_devices(value: Any, out: set) -> set:
    """The CUDA devices holding a tensor of ``value`` (a tensor, or a
    tuple, list or dict of them, nested)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    return out


def block_until_ready(value: Any) -> Any:
    """Wait until the device work that produces ``value`` has finished:
    synchronise the current stream of each CUDA device holding one of its
    tensors. Returns ``value``."""
    for device in _cuda_devices(value, set()):
        torch.cuda.current_stream(device).synchronize()
    return value


class Span:
    """One timed stage; use via ``with tracker.span(name) as sp:``."""

    __slots__ = ("name", "tracer", "_sync", "t_start", "duration", "path",
                 "depth", "attrs", "_range")

    def __init__(self, tracer: "Tracer", name: str, sync: Any = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.tracer = tracer
        self.name = name
        self._sync = sync
        self.t_start: Optional[float] = None
        self.duration: Optional[float] = None
        self.path: Optional[str] = None
        self.depth: Optional[int] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self._range: Optional[record_function] = None

    def sync(self, value: Any) -> Any:
        """Register the value whose device completion ends this span;
        returns it unchanged so it can wrap the producing expression."""
        self._sync = value
        return value

    def set_attrs(self, **attrs: Any) -> None:
        """Attach structured attributes (predicted flops/bytes, shapes,
        ...) to this span's record; merged over earlier values."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.tracer._push(self)
        self.t_start = self.tracer.tracker.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        failed = exc_type is not None
        try:
            if not failed and self._sync is not None:
                block_until_ready(self._sync)
        except BaseException:
            # a sync that raises is a failed span: the duration would
            # measure time-to-error, not the stage
            failed = True
            raise
        finally:
            self.duration = self.tracer.tracker.clock() - self.t_start
            try:
                self.tracer._pop(self, failed=failed)
            finally:
                if self._range is not None:
                    self._range.__exit__(None, None, None)
                    self._range = None


class Tracer:
    """Span factory + nesting stack for one tracker."""

    def __init__(self, tracker):
        self.tracker = tracker
        self._stack: List[Span] = []

    def span(self, name: str, *, sync: Any = None,
             attrs: Optional[Dict[str, Any]] = None) -> Span:
        return Span(self, name, sync=sync, attrs=attrs)

    def _push(self, span: Span) -> None:
        span.depth = len(self._stack)
        span.path = "/".join([s.name for s in self._stack] + [span.name])
        self._stack.append(span)

    def _pop(self, span: Span, *, failed: bool) -> None:
        # unwind even on exceptions; tolerate out-of-order exits from
        # misuse rather than corrupting the stack
        while self._stack and self._stack[-1] is not span:
            self._stack.pop()
        if self._stack:
            self._stack.pop()
        if failed:
            return
        self._emit_span(span.name, span.path, span.depth, span.t_start,
                        span.duration, span.attrs)

    def record(self, name: str, t_start: float, duration: float) -> None:
        """Emit a span timed elsewhere (``t_start`` on the tracker's
        clock, ``duration`` seconds), as a child of the open spans."""
        path = "/".join([s.name for s in self._stack] + [name])
        self._emit_span(name, path, len(self._stack), t_start, duration,
                        None)

    def _emit_span(self, name: str, path: str, depth: int, t_start: float,
                   duration: float, attrs: Optional[Dict[str, Any]]
                   ) -> None:
        tr = self.tracker
        h = tr.hists.get(name)
        if h is None:
            from repro_torch.obs.tracker import LogHistogram
            h = tr.hists[name] = LogHistogram()
        h.record(duration)
        rec = {"type": "span", "name": name, "path": path, "depth": depth,
               "t0": t_start - tr._t0, "dur_s": duration}
        if attrs:
            rec["attrs"] = dict(attrs)
        tr._emit(rec)


class _NullSpan:
    """No-tracker fast path: zero bookkeeping, ``sync`` is identity."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    @staticmethod
    def sync(value):
        return value

    @staticmethod
    def set_attrs(**attrs):
        return None


_NULL_SPAN = _NullSpan()


class _RangeSpan(_NullSpan):
    """No tracker while the profiler records: a ``record_function`` range
    named as the span, no sync and no record."""

    def __init__(self, name: str):
        self._range = record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return None


def span_or_null(tracker, name: str, *, sync: Any = None):
    """``tracker.span(name)`` when a tracker is attached, else a shared
    no-op context — the instrumentation idiom for hot paths where
    ``tracker`` is usually None — or, while the profiler records, a
    range-only context."""
    if tracker is None:
        return _RangeSpan(name) if _profiler_enabled() else _NULL_SPAN
    return tracker.span(name, sync=sync)


def costed_span(tracker, name: str, cost_fn, *args):
    """:func:`span_or_null` whose ``attrs`` are ``cost_fn(*args)`` (an
    analytic stage cost of :mod:`repro_torch.obs.cost`), evaluated only
    when a tracker is attached, so an untracked stage computes nothing."""
    if tracker is None:
        return _RangeSpan(name) if _profiler_enabled() else _NULL_SPAN
    return tracker.span(name, attrs=cost_fn(*args))


class DeviceSpans:
    """Span sites of code captured as a CUDA graph, timed on the device:
    no host clock sees where a stage of a replay starts or ends.

    Handed to the captured code in place of a tracker, each span site
    records a timing event into the graph at its start and at its end
    (``external`` events: nodes of the graph, recorded at every replay),
    and each :func:`record_later` site keeps its arguments, whose tensors
    the graph rewrites at every replay. Once a replay has finished,
    :meth:`emit` gives a tracker each span (its duration the events'
    elapsed device time, its start the replay's launch plus the device
    time from the graph's first event) and runs each deferred record on
    the replay's values, in the order of capture. Nothing inside the
    graph waits for the host."""

    def __init__(self):
        self._first = None
        self._sites: List[tuple] = []

    def _event(self):
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        if self._first is None:
            self._first = event
        return event

    def span(self, name: str, *, sync: Any = None, attrs=None
             ) -> "_DeviceSpan":
        return _DeviceSpan(self, name)

    def emit(self, tracker, launched: float) -> None:
        """Hand ``tracker`` the finished replay's spans and deferred
        records; ``launched``: the replay's launch on its clock."""
        for kind, name_or_fn, *rest in self._sites:
            if kind == "span":
                start, end = rest
                tracker.tracer.record(
                    name_or_fn,
                    launched + 1e-3 * self._first.elapsed_time(start),
                    1e-3 * start.elapsed_time(end))
            else:
                name_or_fn(tracker, *rest[0])


class _DeviceSpan(_NullSpan):
    """One span site of a capture: a timing event at each end."""

    def __init__(self, spans: DeviceSpans, name: str):
        self._spans, self._name = spans, name

    def __enter__(self):
        self._start = self._spans._event()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self._spans._sites.append(("span", self._name, self._start,
                                       self._spans._event()))
        return None


def record_later(tracker, fn, *args) -> None:
    """``fn(tracker, *args)`` for a tracker; in a capture (``tracker`` a
    :class:`DeviceSpans`) after each replay, on the values the replay
    leaves in ``args``' tensors. ``fn`` reads the device."""
    if isinstance(tracker, DeviceSpans):
        tracker._sites.append(("later", fn, args))
    else:
        fn(tracker, *args)
