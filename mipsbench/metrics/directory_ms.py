"""directory_ms: milliseconds a served batch spends on the bucket
directory walk (match counts, rank gather, stable argsort), the
``repro.engine.directory_match`` span, summed over the span phase and
divided by its batches."""

SPAN = "repro.engine.directory_match"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
