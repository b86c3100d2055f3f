"""latent_attn_hbm_share: the decode step's latent attention against its
memory bound, in percent: the least time to read every layer's attention
weights and the live latent and rope-key cache once at the card's memory
bandwidth (the bytes the decode kind computes from the traced steps'
positions, ``attn_bytes``), over the ``repro.model.attn`` spans' time a
step (``latent_attn_ms``: on the card the device time of the
projections, the latent scores, softmax and weighted sum inside the
replayed graph)."""

SPAN = "repro.model.attn"


def read(r):
    total, count = r.spans.get(SPAN, (0.0, 0))
    work = r.setup.get("attn_bytes")
    if not (count and r.batches and work and r.peaks):
        return None
    return 100.0 * (work / r.peaks["hbm_byte_per_s"]) / (total / r.batches)
