"""probe_score_ms: milliseconds a served batch spends turning the probe
order into planned runs (``range_cum_before``) and scoring them in the
fused kernel, the ``repro.engine.fused_query`` span, summed over the span
phase and divided by its batches."""

SPAN = "repro.engine.fused_query"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
