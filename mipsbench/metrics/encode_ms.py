"""encode_ms: milliseconds a served batch spends hashing its queries, the
``repro.engine.hash_encode`` span (which synchronises before it reads the
clock), summed over the span phase and divided by its batches."""

SPAN = "repro.engine.hash_encode"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
