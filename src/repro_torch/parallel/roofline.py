"""The roofline of a step against the peaks of the card that ran it
(the counterpart of ``repro/parallel/hlo_analysis.py``'s ``roofline``).

Three terms, in seconds a step: the whole-program FLOPs over the chips'
dense bf16 tensor-core rate, the HBM bytes over their memory rate, and
the per-device collective wire bytes over one link's rate. The card's
peaks come from :data:`PEAKS`, keyed by the name
``torch.cuda.get_device_name`` reports; an unknown card raises rather
than be given a guess. In place of the reference's HLO collective
parser, the wire bytes come from ``parallel/collectives.py``: the
collectives DTensor and the shard groups issue under a dispatch
recorder, or ``torch.profiler``'s NCCL events of a run on the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class Peaks(NamedTuple):
    """A card's data-sheet peaks: dense bf16 and f32 (outside the tensor
    cores, a fused multiply-add counted as 2) FLOP/s, HBM bytes/s, NVLink
    bytes/s, its L2 size in bytes, the power limit (W) they are quoted
    at, and its memory in bytes."""
    bf16_flops: float
    f32_flops: float
    hbm_bytes: float
    link_bytes: float
    l2_bytes: int
    power_w: float
    memory_bytes: int


# the card the port targets, whose peaks a run off the card reads
TARGET_CARD = "NVIDIA H100 80GB HBM3"

# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 67 TFLOP/s f32,
# 3.35 TB/s HBM3, 900 GB/s NVLink, 50 MB L2, at the 700 W limit, 80 GB
PEAKS: Dict[str, Peaks] = {
    TARGET_CARD: Peaks(989e12, 67e12, 3.35e12, 900e9, 50 * 2 ** 20, 700.0,
                       80 * 10 ** 9),
}


def card_peaks(card: Optional[str] = None) -> Peaks:
    """The peaks of ``card`` (default: CUDA device 0's name);
    ``ValueError`` for a card the table does not hold."""
    if card is None:
        import torch
        card = torch.cuda.get_device_name(0)
    if card not in PEAKS:
        raise ValueError(f"no peaks for card {card!r}; known: "
                         f"{sorted(PEAKS)}")
    return PEAKS[card]


def roofline(flops: float, bytes_accessed: float, wire_bytes: float,
             chips: int, model_flops: Optional[float] = None, *,
             card: Optional[str] = None) -> Dict[str, float]:
    """The three roofline terms, in seconds a step.

    ``flops``/``bytes_accessed`` are whole-program (analytic estimates),
    ``wire_bytes`` per device. ``roofline_fraction`` is MFU-like: the
    time the *useful* ``model_flops`` would take at peak over the
    dominant term; 1.0 is a step of pure useful compute."""
    pk = card_peaks(card)
    compute = flops / (chips * pk.bf16_flops)
    memory = bytes_accessed / (chips * pk.hbm_bytes)
    collective = wire_bytes / pk.link_bytes
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    total = max(compute, memory, collective)
    useful = model_flops if model_flops is not None else flops
    useful_t = useful / (chips * pk.bf16_flops)
    return {**terms, "bottleneck": dom,
            "roofline_fraction": useful_t / total if total > 0 else 0.0}


def measured_fraction(model_flops: float, seconds: float, chips: int = 1,
                      *, card: Optional[str] = None) -> float:
    """The share of the chips' bf16 peak that ``model_flops`` done in a
    measured ``seconds`` a step attains (MFU)."""
    return model_flops / (chips * card_peaks(card).bf16_flops * seconds)
