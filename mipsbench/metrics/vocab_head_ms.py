"""vocab_head_ms: milliseconds a decode step spends in its vocabulary
head, the fused RANGE-LSH top-k over the unembedding (the
``repro.serve.topk_head`` span inside ``BatchedServer.step``), summed over
the span phase and divided by its steps."""

SPAN = "repro.serve.topk_head"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
