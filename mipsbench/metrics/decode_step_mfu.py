"""decode_step_mfu: the whole decode step against the card's peaks, in
percent: the larger of two least times, over the time a step takes in
the profiled phase (untracked, as in the measured window: the traced
window's length over the steps in it, ``profiled_steps``).

- operations: the step's model FLOPs (``step_flops``: every product of
  the layers, latent scores over the live cache included) at the dense
  bf16 tensor-core peak, 989 TFLOP/s (NVIDIA H100 SXM data sheet, at the
  700 W limit; ``peaks.json`` has no bf16 entry);
- bytes: ``step_bytes`` at the card's memory bandwidth: the weights of
  every expert the routing counter says a layer touched, the dense,
  shared, router and attention weights, the live cache and the head's
  payload, each once.

The decode kind computes both from the span phase's steps."""

BF16_FLOP_PER_S = 989e12


def read(r):
    steps = r.setup.get("profiled_steps")
    flops, nbytes = r.setup.get("step_flops"), r.setup.get("step_bytes")
    if r.trace is None or not (steps and steps > 0 and flops and nbytes
                               and r.peaks):
        return None
    least = max(flops / BF16_FLOP_PER_S, nbytes / r.peaks["hbm_byte_per_s"])
    return 100.0 * least / (r.trace.window_s / steps)
