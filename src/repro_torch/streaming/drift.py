"""Norm-drift monitoring for streaming indexes (port of
``repro/streaming/drift.py``; numpy only).

The paper's complexity argument rests on two structural facts that inserts
erode: every item's norm lies within its range's bound ``U_j`` (otherwise
eq. 12 mis-ranks its buckets), and ranges hold comparable item counts
(otherwise one sub-index degenerates toward SIMPLE-LSH). The monitor tracks
both per range and turns violations into repartition triggers:

  * **overflow** — an insert's norm exceeds ``U_j`` (including ``U_j = 0``:
    an empty uniform-partition bin taking its first item). Handled per
    insert batch, before encoding, so codes are always computed under the
    final bound.
  * **skew** — a range's live count exceeds ``skew_ratio`` times the mean;
    the index rebalances the boundary with the lighter adjacent neighbor.

It also keeps a bounded window of recent insert norms per range so
``quantiles()`` can report where the tail is moving relative to the build
baseline — observability, not a trigger.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np

DEFAULT_SKEW_RATIO = 4.0
DEFAULT_MIN_SKEW_COUNT = 64


class DriftMonitor:
    """Per-range occupancy and norm-tail tracking (host-side)."""

    def __init__(self, counts: np.ndarray, baseline_norms: np.ndarray,
                 range_id: np.ndarray, *,
                 skew_ratio: float = DEFAULT_SKEW_RATIO,
                 min_skew_count: int = DEFAULT_MIN_SKEW_COUNT,
                 window: int = 256):
        self.m = int(counts.shape[0])
        self.counts = counts.astype(np.int64).copy()
        self.skew_ratio = float(skew_ratio)
        self.min_skew_count = int(min_skew_count)
        self.window = int(window)
        self._recent = [deque(maxlen=window) for _ in range(self.m)]
        self.baseline_q95 = np.zeros((self.m,), np.float32)
        for j in range(self.m):
            nj = baseline_norms[range_id == j]
            if nj.size:
                self.baseline_q95[j] = np.quantile(nj, 0.95)

    # -- observations --------------------------------------------------------

    def observe_insert(self, rid: int, norm: float) -> None:
        self.counts[rid] += 1
        self._recent[rid].append(float(norm))

    def observe_delete(self, rid: int) -> None:
        self.counts[rid] -= 1

    def set_counts(self, counts: np.ndarray) -> None:
        """Structural events (compaction, rebalance) recount from arrays."""
        self.counts = counts.astype(np.int64).copy()

    # -- triggers ------------------------------------------------------------

    @staticmethod
    def overflow(norm: float, upper_j: float) -> bool:
        """True when ``norm`` invalidates the range bound (or the range has
        never held an item — uniform partitioning leaves empty bins)."""
        return norm > upper_j or upper_j <= 0.0

    def skew_range(self) -> Optional[int]:
        """Range whose occupancy breaches the skew threshold, or None."""
        total = int(self.counts.sum())
        if self.m <= 1 or total == 0:
            return None
        j = int(np.argmax(self.counts))
        top = int(self.counts[j])
        if top >= self.min_skew_count and \
                top > self.skew_ratio * total / self.m:
            return j
        return None

    # -- reporting -----------------------------------------------------------

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95)
                  ) -> Dict[int, Dict[float, float]]:
        """Recent-insert norm quantiles per range (windowed)."""
        out: Dict[int, Dict[float, float]] = {}
        for j in range(self.m):
            if self._recent[j]:
                arr = np.asarray(self._recent[j], np.float32)
                out[j] = {q: float(np.quantile(arr, q)) for q in qs}
        return out

    def snapshot(self) -> Dict[str, object]:
        recent = self.quantiles()
        drift = {j: round(v[0.95] / b, 3)
                 for j, v in recent.items()
                 if (b := float(self.baseline_q95[j])) > 0 and 0.95 in v}
        return {"counts": self.counts.tolist(),
                "recent_q95_over_baseline": drift}

    def report(self, tracker, *, prefix: str = "repro.streaming.drift"
               ) -> None:
        """Route the snapshot through a tracker (an object with ``gauge``
        and ``event``) as per-range occupancy and windowed norm-quantile
        gauges plus one ``<prefix>.snapshot`` event; a no-op without one."""
        if tracker is None:
            return
        recent = self.quantiles()
        for j in range(self.m):
            tracker.gauge(f"{prefix}.count.range{j}",
                          float(self.counts[j]))
            for q, v in recent.get(j, {}).items():
                tracker.gauge(f"{prefix}.q{round(q * 100):d}.range{j}", v)
        snap = self.snapshot()
        tracker.event(f"{prefix}.snapshot", counts=snap["counts"],
                      recent_q95_over_baseline={
                          str(j): v for j, v in
                          snap["recent_q95_over_baseline"].items()})
