"""directory_scan_ms: milliseconds a served batch spends counting each
query's matches against the bucket directory (the family's match
counter), the ``repro.engine.directory_scan`` span inside
``repro.engine.directory_match``, summed over the span phase and divided
by its batches. A program without the span reads None."""

SPAN = "repro.engine.directory_scan"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
