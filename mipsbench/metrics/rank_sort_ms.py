"""rank_sort_ms: milliseconds a served batch spends gathering each
bucket's probe rank and stably sorting the ranks into the probe order,
the ``repro.engine.rank_sort`` span inside
``repro.engine.directory_match``, summed over the span phase and divided
by its batches. A program without the span reads None."""

SPAN = "repro.engine.rank_sort"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
