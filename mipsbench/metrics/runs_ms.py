"""runs_ms: milliseconds a served batch spends turning the probe order
into runs (``_planned_runs``: ``range_cum_before``'s per-range take, the
take and the exclusive cumsum; ``_probe_runs`` under a global budget),
the ``repro.engine.runs`` span inside ``repro.engine.fused_query``,
summed over the span phase and divided by its batches. A program without
the span reads None."""

SPAN = "repro.engine.runs"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
