"""Observability for the port (port of ``repro/obs``).

The tracker/span/sink subsystem plus the layer on top of it: SLO
monitoring over request classes, recall audits, Chrome trace export with
per-source pids, analytic device-cost attribution, and tracker/histogram
merge for per-process -> fleet rollups. Everything is host-side Python
recorded after explicit device-sync boundaries, so attaching a tracker
never changes query results. It imports neither JAX nor ``repro``; the
metric names are the reference's, beside the port's own child spans
(``cost.PORT_STAGES``). While ``torch.profiler`` records, every span
site is also a ``record_function`` range of its name, tracked or not.
One name differs in meaning: for a call that names a recall target the
port plans inside ``repro.engine.query`` (child span
``repro.planner.resolve_budgets``), so that span's duration covers the
host's planning, which the reference's ``repro.engine.query`` does not.

Typical wiring::

    from repro_torch import obs
    tracker = obs.Tracker(sinks=[obs.RingBufferSink(),
                                 obs.JsonlSink("metrics.jsonl",
                                               max_bytes=1 << 24)])
    eng = QueryEngine(index, tracker=tracker)      # explicit
    obs.set_default_tracker(tracker)               # or ambient
    ...
    obs.export_chrome_trace(tracker, "trace.json")  # load in Perfetto

The reference's ``xla_cost`` has no counterpart here; its cross-check is
:func:`flop_counter_cost`.
"""

from repro_torch.obs.audit import RecallAuditor
from repro_torch.obs.cost import flop_counter_cost, query_stage_costs
from repro_torch.obs.export import (chrome_trace_events,
                                    export_chrome_trace,
                                    validate_chrome_trace)
from repro_torch.obs.sinks import (JsonlSink, RingBufferSink,
                                   StdoutTableSink, format_table, read_jsonl)
from repro_torch.obs.slo import RequestClass, SloMonitor
from repro_torch.obs.trace import Span, Tracer, span_or_null
from repro_torch.obs.tracker import (DEFAULT_QUANTILES, HIST_GROWTH, HIST_HI,
                                     HIST_LO, LogHistogram, Tracker,
                                     default_tracker, resolve_tracker,
                                     set_default_tracker)

__all__ = [
    "Tracker", "LogHistogram", "HIST_GROWTH", "HIST_LO", "HIST_HI",
    "DEFAULT_QUANTILES",
    "Span", "Tracer", "span_or_null",
    "RingBufferSink", "JsonlSink", "StdoutTableSink", "read_jsonl",
    "format_table",
    "RecallAuditor",
    "RequestClass", "SloMonitor",
    "chrome_trace_events", "export_chrome_trace", "validate_chrome_trace",
    "query_stage_costs", "flop_counter_cost",
    "set_default_tracker", "default_tracker", "resolve_tracker",
]
