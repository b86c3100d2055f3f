"""Analytic device-cost attribution for the query hot path (port of
``repro/obs/cost.py``).

Closed-form FLOP / HBM-byte estimates for every stage of Algorithm 2
(``hash_encode -> directory_match -> segmented_gather -> re_rank ->
top_k``, plus the dense arm and the fused query): the reference's
formulas, verbatim, modelling what its kernels compute — every popcount
word, every gathered row — not an idealized lower bound. The estimates
attach to the hot-path spans as ``attrs`` (``flops``/``hbm_bytes``,
``core/engine.py`` and ``core/topk.py``), ride the span records into the
Chrome trace export (:mod:`repro_torch.obs.export`), and the kernel
wrappers accumulate them per op (``repro.kernels.cost.<op>.*``).

The reference cross-checks a single jitted stage against XLA's compiled
cost estimate. The port has no compiler to ask; its cross-check,
:func:`flop_counter_cost`, counts the FLOPs of one eager call of a
callable with ``torch.utils.flop_counter.FlopCounterMode``. Like the
reference's, it is not used on the hot path.

Units: flops are multiply-add = 2 flops; word-ops (popcounts,
compare-exchanges) count as 1 flop each. Bytes count one HBM round-trip
of every operand/result tile touched.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

F32 = 4          # bytes per float32 element
WORD = 4         # bytes per packed uint32 code word / int32 index

# ordered hot-path stage names (the reference's metric names); the
# dense arm substitutes dense_match/dense_select for the middle stages
BUCKET_STAGES = ("repro.engine.hash_encode", "repro.engine.directory_match",
                 "repro.engine.segmented_gather", "repro.engine.re_rank",
                 "repro.engine.top_k")

# the port's own child spans, which the reference does not emit: the
# directory walk's match and its rank gather + stable sort (inside
# directory_match), and the fused arm's planned or global runs and its
# launch + id gather (inside fused_query)
PORT_STAGES = ("repro.engine.directory_scan", "repro.engine.rank_sort",
               "repro.engine.runs", "repro.engine.fused_score")


def hash_encode_cost(q: int, d: int, code_len: int) -> Dict[str, float]:
    """Sign-projection encode: (q, d) x (d, L) -> packed (q, W)."""
    W = (code_len + 31) // 32
    return {"flops": 2.0 * q * d * code_len,
            "hbm_bytes": float(F32 * (q * d + d * code_len) + WORD * q * W)}


def directory_match_cost(q: int, num_buckets: int,
                         code_len: int) -> Dict[str, float]:
    """Directory popcount scan + per-query stable sort of B bucket ranks."""
    B = max(2, int(num_buckets))
    W = (code_len + 31) // 32
    return {"flops": q * B * (W + math.log2(B)),
            "hbm_bytes": float(WORD * (q * W + B * W + 3 * q * B))}


def dense_match_cost(q: int, n: int, code_len: int) -> Dict[str, float]:
    """Dense packed-Hamming scan over all N items + O(N log N) sort."""
    n = max(2, int(n))
    W = (code_len + 31) // 32
    return {"flops": q * n * (W + math.log2(n)),
            "hbm_bytes": float(WORD * (q * W + n * W + 3 * q * n))}


def packed_scan_cost(q: int, n: int, code_len: int) -> Dict[str, float]:
    """One packed-popcount scan with no sort (the kernel-level unit under
    hamming_scan / bucket_match / delta_scan dispatches)."""
    W = (code_len + 31) // 32
    return {"flops": float(q * n * W),
            "hbm_bytes": float(WORD * (q * W + n * W + q * n))}


def segmented_gather_cost(q: int, probe: float) -> Dict[str, float]:
    """CSR position walk + id gather of the probed prefix."""
    return {"flops": float(q * probe),
            "hbm_bytes": float(WORD * 2 * q * probe)}


def dense_select_cost(q: int, n: int) -> Dict[str, float]:
    """Dense-arm budget mask + stable front-pull over the sorted scan."""
    n = max(2, int(n))
    return {"flops": q * n * math.log2(n),
            "hbm_bytes": float(WORD * 3 * q * n)}


def re_rank_cost(q: int, probe: float, d: int) -> Dict[str, float]:
    """Exact inner products over the gathered candidate rows."""
    return {"flops": 2.0 * q * probe * d,
            "hbm_bytes": float(F32 * (q * probe * d + q * d + q * probe))}


def top_k_cost(q: int, probe: float, k: int) -> Dict[str, float]:
    """top_k compare/exchange network over the candidate scores."""
    k = max(2, int(k))
    return {"flops": q * probe * math.log2(k),
            "hbm_bytes": float((F32 + WORD) * (q * probe + q * k))}


def mips_topk_cost(q: int, n: int, d: int, k: int) -> Dict[str, float]:
    """Composite exact-MIPS op (kernels/ops.py mips_topk): re-rank matmul
    over all n items + streaming top-k — the model the op's ``_charge``
    call evaluates."""
    rr, tk = re_rank_cost(q, n, d), top_k_cost(q, n, k)
    return {m: rr[m] + tk[m] for m in ("flops", "hbm_bytes")}


def fused_query_cost(q: int, total: int, d: int, k: int,
                     kprime: int) -> Dict[str, float]:
    """Fused single-pass query op (kernels/ops.py fused_query): CSR position
    walk + phase-1 scoring of the planned candidate width against the
    (possibly int8) payload + streaming top-k' merge + f32 rescore of the
    k' survivors. The byte model charges the int8 candidate-row traffic
    (one byte per element) plus the per-item f32 scale — the 4x phase-1
    read reduction vs the staged f32 re-rank is exactly what the fusion
    buys on the gather side."""
    kp, kk = max(2, int(kprime)), max(2, int(k))
    flops = (q * total                       # CSR position walk
             + 2.0 * q * total * d           # phase-1 dot per candidate
             + q * total * math.log2(kp)     # streaming top-k' merge
             + 2.0 * q * kp * d              # f32 rescore of survivors
             + q * kp * math.log2(kk))       # final top-k
    bytes_ = (q * total * (d + F32)          # int8 rows + per-item scale
              + F32 * q * d                  # query block
              + F32 * q * kp * d             # f32 survivor rows
              + (F32 + WORD) * q * kk        # (vals, pos) result
              + WORD * 2 * q * total)        # cum/starts walk + positions
    return {"flops": float(flops), "hbm_bytes": float(bytes_)}


def planned_runs_cost(q: int, b: int, r: int) -> Dict[str, float]:
    """The port's own per-range take (kernels/ops.py planned_runs; the
    reference runs it as plain jnp, with no op of its own): the (q, b)
    int64 probe order read once, the bucket offsets, ranges and caps read
    once, ``starts`` (q, b) and ``cum`` (q, b+1) int32 written once. No
    FLOPs are counted: its work is integer adds and compares."""
    bytes_ = (8 * q * b                      # probe order
              + WORD * (2 * b + 1 + r)       # bucket_start, bucket_rid, caps
              + WORD * (2 * q * b + q))      # starts, cum
    return {"flops": 0.0, "hbm_bytes": float(bytes_)}


def query_stage_costs(shape: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Per-stage predicted {flops, hbm_bytes} for one served batch.

    ``shape`` describes the batch: q, n, d, code_len,
    num_buckets, probe_width, k. Keys are the span metric names, so the
    result zips directly against measured span summaries
    (the reference's roofline report)."""
    q, d = int(shape["q"]), int(shape["d"])
    L = int(shape["code_len"])
    B = int(shape["num_buckets"])
    P = max(1.0, float(shape["probe_width"]))
    k = int(shape.get("k", 10))
    return {
        "repro.engine.hash_encode": hash_encode_cost(q, d, L),
        "repro.engine.directory_match": directory_match_cost(q, B, L),
        "repro.engine.segmented_gather": segmented_gather_cost(q, P),
        "repro.engine.re_rank": re_rank_cost(q, P, d),
        "repro.engine.top_k": top_k_cost(q, P, k),
    }


def flop_counter_cost(fn: Callable, *args, **kwargs
                      ) -> Optional[Dict[str, float]]:
    """The FLOPs torch counts for one call ``fn(*args, **kwargs)`` under
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
    convolutions, 2 flops a multiply-add): ``{"flops"}``, or None when it
    counts none. The cross-check arm for the analytic model (unit-tested
    on hash_encode's projection); it runs ``fn`` once, so it is not for
    the hot path. Takes the place of the reference's ``xla_cost``; torch
    gives no byte estimate, so there is no ``hbm_bytes``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return {"flops": flops} if flops > 0 else None
