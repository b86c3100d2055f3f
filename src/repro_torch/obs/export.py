"""Chrome ``trace_event`` export of recorded spans (port of
``repro/obs/export.py``).

Renders the span records a :class:`~repro_torch.obs.tracker.Tracker`
emitted (through a ``RingBufferSink`` or ``JsonlSink``) as Chrome
trace-event JSON — ``{"traceEvents": [...]}`` with balanced ``B``/``E``
duration pairs — loadable in Perfetto or ``chrome://tracing``. Nested
spans nest on the timeline because every span record carries its start
(``t0``) and duration off the same monotonic clock; span ``attrs`` (the
analytic flops/bytes of :mod:`repro_torch.obs.cost`) and the span
``path`` become trace-event ``args``.

:func:`export_chrome_trace` takes one source or a ``{label: source}``
dict of per-process sources; every label gets a stable ``pid`` (sorted
order) and a ``process_name`` metadata event, so timelines sit side by
side in one trace — the trace-level complement of ``Tracker.merge``.

:func:`validate_chrome_trace` is the schema gate: phase pairs balanced
per ``(pid, tid)``, monotonic timestamps, names matching across each
B/E pair.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Union

_US = 1e6   # trace-event timestamps are microseconds


def _span_records(source) -> List[dict]:
    """Span records from a records list, RingBufferSink, or Tracker."""
    if hasattr(source, "sinks"):                       # Tracker
        for s in source.sinks:
            if hasattr(s, "records"):
                source = s
                break
        else:
            raise ValueError(
                "tracker has no RingBufferSink — attach one (span records "
                "live in sinks, not in the tracker aggregates)")
    if hasattr(source, "records"):                     # RingBufferSink
        source = source.records
    return [r for r in source if r.get("type") == "span"]


def chrome_trace_events(records: Iterable[dict], *, pid: int = 0,
                        tid: int = 0) -> List[dict]:
    """Balanced ``B``/``E`` event pairs for one source's span records.

    Spans missing ``t0`` (pre-PR7 recordings) fall back to ``t - dur_s``
    (emit-time minus duration — close, but only ``t0`` guarantees exact
    nesting). Rather than sorting B/E events blind — timestamp ties
    between a parent and a zero-duration child, or a sibling's end and
    the next sibling's begin, cannot be ordered correctly from
    timestamps alone — the exporter replays the recorded intervals
    through an explicit span stack: begins open in start order, every
    end closes the innermost open span, and a child whose clamped end
    would outlive its parent is trimmed to the parent's end. The output
    is balanced and timestamp-monotonic by construction
    (:func:`validate_chrome_trace` asserts it anyway)."""
    spans = []
    for r in records:
        t0 = r.get("t0")
        if t0 is None:
            t0 = r.get("t", 0.0) - r["dur_s"]
        args: Dict[str, Any] = {"path": r.get("path", r["name"])}
        args.update(r.get("attrs") or {})
        spans.append({"name": r["name"], "t0": float(t0),
                      "t1": float(t0) + float(r["dur_s"]),
                      "depth": int(r.get("depth", 0)), "args": args})
    spans.sort(key=lambda s: (s["t0"], s["depth"]))

    events: List[dict] = []
    stack: List[dict] = []
    common = {"cat": "repro", "pid": int(pid), "tid": int(tid)}

    def close_through(t: float) -> None:
        while stack and stack[-1]["t1"] <= t:
            s = stack.pop()
            events.append({**common, "name": s["name"], "ph": "E",
                           "ts": s["t1"] * _US})

    for s in spans:
        close_through(s["t0"])
        if stack:   # float-safety: a child never outlives its parent
            s["t1"] = min(s["t1"], stack[-1]["t1"])
        s["t1"] = max(s["t1"], s["t0"])
        events.append({**common, "name": s["name"], "ph": "B",
                       "ts": s["t0"] * _US, "args": s["args"]})
        stack.append(s)
    close_through(float("inf"))
    return events


def export_chrome_trace(sources: Union[Any, Dict[str, Any]],
                        path: Optional[str] = None) -> dict:
    """Full Chrome trace JSON from one source or ``{label: source}``.

    Each source is a Tracker (with a RingBufferSink), a RingBufferSink,
    or a plain record list. Labels map to stable pids in sorted order
    with ``process_name`` metadata. Writes JSON to ``path`` when given;
    returns the trace dict either way."""
    if not isinstance(sources, dict):
        sources = {"main": sources}
    events: List[dict] = []
    for pid, label in enumerate(sorted(sources)):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        events.extend(chrome_trace_events(_span_records(sources[label]),
                                          pid=pid, tid=0))
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def validate_chrome_trace(trace: dict) -> Dict[str, Any]:
    """Schema gate for an exported trace; raises ValueError on the first
    violation, returns summary stats otherwise.

    Checks: every event carries integer pid/tid and (for B/E) numeric
    ``ts``; timestamps are monotonically non-decreasing per (pid, tid)
    stream; B/E pairs are balanced per stream with matching names (no
    dangling begin, no stray end); every B carries ``args`` with the span
    path."""
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no traceEvents list")
    stacks: Dict[tuple, List[str]] = {}
    last_ts: Dict[tuple, float] = {}
    n_pairs = 0
    pids = set()
    for i, e in enumerate(events):
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            raise ValueError(f"event {i}: non-integer pid/tid: {e}")
        ph = e.get("ph")
        if ph == "M":
            continue
        if ph not in ("B", "E"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        key = (e["pid"], e["tid"])
        pids.add(e["pid"])
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            raise ValueError(f"event {i}: missing/non-numeric ts")
        if ts < last_ts.get(key, float("-inf")):
            raise ValueError(
                f"event {i}: ts {ts} < previous {last_ts[key]} on "
                f"pid/tid {key} — timestamps must be monotonic per "
                "stream")
        last_ts[key] = ts
        stack = stacks.setdefault(key, [])
        if ph == "B":
            if "path" not in (e.get("args") or {}):
                raise ValueError(f"event {i}: B event missing args.path")
            stack.append(e["name"])
        else:
            if not stack:
                raise ValueError(f"event {i}: E without matching B on "
                                 f"pid/tid {key}")
            opened = stack.pop()
            if opened != e["name"]:
                raise ValueError(
                    f"event {i}: E {e['name']!r} closes B {opened!r} on "
                    f"pid/tid {key} — unbalanced phase pairs")
            n_pairs += 1
    dangling = {k: v for k, v in stacks.items() if v}
    if dangling:
        raise ValueError(f"dangling B events at end of trace: {dangling}")
    return {"span_pairs": n_pairs, "num_pids": len(pids),
            "num_events": len(events)}
