"""fused_score_ms: milliseconds a served batch spends in the
``fused_query`` launch (run expansion, scoring, top k', rescore) and the
gather of its item ids, the ``repro.engine.fused_score`` span inside
``repro.engine.fused_query``, summed over the span phase and divided by
its batches. A program without the span reads None."""

SPAN = "repro.engine.fused_score"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
