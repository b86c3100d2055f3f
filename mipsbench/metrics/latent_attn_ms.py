"""latent_attn_ms: milliseconds a decode step spends in its layers'
latent attention, projections included (the ``repro.model.attn`` spans of
``models/lm.py``, every layer's), summed over the span phase and divided
by its steps. On the card the step is a replayed CUDA graph and each span
is the device time between two events inside it; elsewhere each span
synchronises at its end."""

SPAN = "repro.model.attn"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    return 1e3 * total / r.batches if count and r.batches else None
