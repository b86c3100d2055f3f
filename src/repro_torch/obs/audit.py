"""Sampled online recall-contract audits (port of
``repro/obs/audit.py``).

The planner enforces ``recall_target`` from curves measured offline at
calibration time; the auditor checks that the served ids still meet it.
For a deterministic sample of query batches it brute-forces the exact
top-k over the live item set and measures the recall the served ids
achieved, emitting

  * ``repro.planner.audit.achieved_recall`` — histogram + gauge (latest),
  * ``repro.planner.audit.shortfall``       — counter of audits that fell
    more than ``tolerance`` below the target,
  * a ``repro.planner.audit`` typed event per audited batch.

Sampling is counter-based (every ``1/sample_fraction``-th batch, the
first batch always), so audit cost is a fixed, predictable fraction of
traffic and replays are deterministic. The brute force runs in numpy on
the host, on the audited sample only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class RecallAuditor:
    """Online ground-truth recall audits against a recall contract.

    Args:
      tracker:         the :class:`~repro_torch.obs.tracker.Tracker` the
                       metrics land in.
      recall_target:   the contract being audited (None = observe-only:
                       recall is recorded but no shortfall accounting).
      sample_fraction: fraction of offered batches to audit (counter
                       -based: batch i is audited iff
                       ``floor(i * f) > floor((i-1) * f)``; f=1 audits
                       everything, f=0 disables).
      tolerance:       slack under the target before an audit counts as a
                       shortfall (sampling noise allowance).
      prefix:          metric-name prefix.
    """

    def __init__(self, tracker, *, recall_target: Optional[float] = None,
                 sample_fraction: float = 0.1, tolerance: float = 0.05,
                 prefix: str = "repro.planner.audit"):
        if not 0.0 <= sample_fraction <= 1.0:
            raise ValueError(f"sample_fraction must be in [0, 1], got "
                             f"{sample_fraction}")
        self.tracker = tracker
        self.recall_target = recall_target
        self.sample_fraction = float(sample_fraction)
        self.tolerance = float(tolerance)
        self.prefix = prefix
        self.batches_seen = 0
        self.batches_audited = 0

    def should_audit(self) -> bool:
        """Deterministic sampling decision for the *next* batch."""
        f = self.sample_fraction
        if f <= 0.0:
            return False
        i = self.batches_seen
        return int((i + 1) * f) > int(i * f) or i == 0

    def audit(self, queries, served_ids, items, *,
              item_ids: Optional[np.ndarray] = None,
              k: Optional[int] = None) -> Optional[float]:
        """Offer one served batch; returns achieved recall when this
        batch was sampled, else None.

        Arrays may be numpy arrays or tensors on any device (the audit
        runs on the host).

        queries:    (Q, d) the served queries.
        served_ids: (Q, k) ids the surface returned.
        items:      (N, d) the *live* item matrix ground truth is
                    brute-forced over.
        item_ids:   (N,) global id of each items row (streaming surfaces,
                    where served ids are storage rows); None = row == id.
        k:          audit depth (default: served_ids.shape[1]).
        """
        take = self.should_audit()
        self.batches_seen += 1
        if not take:
            return None
        self.batches_audited += 1
        served = _host(served_ids)
        q = _host(queries).astype(np.float32)
        mat = _host(items).astype(np.float32)
        k = int(k) if k is not None else served.shape[1]
        k = min(k, served.shape[1], mat.shape[0])
        scores = q @ mat.T                                   # (Q, N)
        truth_rows = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        if item_ids is not None:
            truth = _host(item_ids)[truth_rows]
        else:
            truth = truth_rows
        hit = (served[:, :, None] == truth[:, None, :]).any(axis=1)
        achieved = float(hit.mean())

        tr = self.tracker
        if tr is not None:
            tr.observe(f"{self.prefix}.achieved_recall", achieved)
            tr.gauge(f"{self.prefix}.achieved_recall.last", achieved)
            short = (self.recall_target is not None
                     and achieved < self.recall_target - self.tolerance)
            if short:
                tr.count(f"{self.prefix}.shortfall")
            tr.event(self.prefix, batch=self.batches_seen - 1,
                     achieved_recall=achieved,
                     recall_target=self.recall_target, k=k,
                     num_queries=int(served.shape[0]),
                     shortfall=bool(short))
        return achieved


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
