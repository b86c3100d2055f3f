"""SLO monitoring for load-shaped serving traffic (port of
``repro/obs/slo.py``).

Traffic is a mix of *request classes* — ``(recall_target, k)`` pairs
with their own latency objectives. Per class the monitor keeps a latency
histogram (the tracker's :class:`~repro_torch.obs.tracker.LogHistogram`,
so per-class latency series merge across trackers like every other
metric), an **error-budget** account — the SLO allows
``1 - budget_quantile`` of requests over the p99 bound, and the **burn
rate** is the observed violating fraction over that allowance (burn > 1
spends the budget faster than the SLO permits) — and a tolerance-gated
breach counter: ``evaluate()`` flags a class whose measured p50/p99
exceeds its target by more than ``tolerance`` (relative), counts
``repro.slo.breach`` and emits one typed ``repro.slo.breach`` event per
breached class, in the same event stream as
:class:`~repro_torch.obs.audit.RecallAuditor`'s recall shortfalls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence


@dataclass(frozen=True)
class RequestClass:
    """One traffic class of the serving mix.

    name:          metric label (``repro.slo.latency.<name>``).
    recall_target: the recall contract this class is served under.
    k:             results per query.
    slo_p50_s / slo_p99_s: latency objectives (seconds, arrival-to-
                   completion — queueing included under open-loop load).
    weight:        relative traffic share (the load generator samples
                   classes proportionally; weights need not sum to 1).
    """
    name: str
    recall_target: float
    k: int
    slo_p50_s: float
    slo_p99_s: float
    weight: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.slo_p50_s <= self.slo_p99_s:
            raise ValueError(
                f"need 0 < slo_p50_s <= slo_p99_s, got "
                f"{self.slo_p50_s}/{self.slo_p99_s}")
        if self.weight <= 0.0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


class SloMonitor:
    """Latency-SLO accounting over a set of request classes.

    Args:
      tracker:         the :class:`~repro_torch.obs.tracker.Tracker` the
                       metrics land in.
      classes:         the :class:`RequestClass` mix (names must be
                       unique).
      tolerance:       relative slack on the p50/p99 targets before
                       ``evaluate()`` counts a breach (CI-noise
                       allowance, same role as the auditor's tolerance).
      budget_quantile: the quantile the error budget is written against —
                       the SLO permits ``1 - budget_quantile`` of
                       requests over ``slo_p99_s``.
      min_samples:     evaluation gate: classes with fewer recorded
                       requests are reported but never breach-counted
                       (quantiles of a handful of samples are noise).
      prefix:          metric-name prefix.
    """

    def __init__(self, tracker, classes: Sequence[RequestClass], *,
                 tolerance: float = 0.25, budget_quantile: float = 0.99,
                 min_samples: int = 20, prefix: str = "repro.slo"):
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names: {names}")
        if not 0.0 < budget_quantile < 1.0:
            raise ValueError(
                f"budget_quantile must be in (0, 1), got {budget_quantile}")
        self.tracker = tracker
        self.classes: Dict[str, RequestClass] = {c.name: c for c in classes}
        self.tolerance = float(tolerance)
        self.budget_quantile = float(budget_quantile)
        self.min_samples = int(min_samples)
        self.prefix = prefix
        self._over_budget: Dict[str, int] = {n: 0 for n in names}
        self._n: Dict[str, int] = {n: 0 for n in names}

    def record(self, class_name: str, latency_s: float) -> None:
        """One completed request of ``class_name`` with arrival-to-
        completion latency ``latency_s``."""
        cls = self.classes.get(class_name)
        if cls is None:
            raise KeyError(f"unknown request class {class_name!r} "
                           f"(have {sorted(self.classes)})")
        latency_s = float(latency_s)
        self._n[class_name] += 1
        if latency_s > cls.slo_p99_s:
            self._over_budget[class_name] += 1
        tr = self.tracker
        if tr is not None:
            tr.observe(f"{self.prefix}.latency.{class_name}", latency_s)

    def burn_rate(self, class_name: str) -> float:
        """Error-budget burn rate: observed fraction of requests over the
        p99 bound, divided by the allowed fraction
        (``1 - budget_quantile``). 1.0 = spending exactly the budget."""
        n = self._n[class_name]
        if n == 0:
            return 0.0
        allowed = 1.0 - self.budget_quantile
        return (self._over_budget[class_name] / n) / allowed

    def evaluate(self) -> Dict[str, dict]:
        """Per-class verdicts; emits breach counters/events + gauges.

        Returns ``{class: {n, p50_s, p99_s, slo_p50_s, slo_p99_s,
        burn_rate, over_budget, breached, evaluated}}``. A class breaches
        when measured p50 or p99 exceeds its target by more than
        ``tolerance`` (relative) with at least ``min_samples`` requests;
        each breach increments ``<prefix>.breach`` and emits one typed
        ``<prefix>.breach`` event carrying the measured-vs-target pair.
        """
        tr = self.tracker
        out: Dict[str, dict] = {}
        for name, cls in self.classes.items():
            n = self._n[name]
            hist = tr.hists.get(f"{self.prefix}.latency.{name}") \
                if tr is not None else None
            p50 = hist.quantile(0.5) if hist is not None else 0.0
            p99 = hist.quantile(0.99) if hist is not None else 0.0
            burn = self.burn_rate(name)
            evaluated = n >= self.min_samples
            gate = 1.0 + self.tolerance
            breached = evaluated and (p50 > cls.slo_p50_s * gate
                                      or p99 > cls.slo_p99_s * gate)
            out[name] = {
                "n": n, "p50_s": p50, "p99_s": p99,
                "slo_p50_s": cls.slo_p50_s, "slo_p99_s": cls.slo_p99_s,
                "burn_rate": burn, "over_budget": self._over_budget[name],
                "breached": breached, "evaluated": evaluated,
            }
            if tr is not None:
                tr.gauge(f"{self.prefix}.burn_rate.{name}", burn)
                if breached:
                    tr.count(f"{self.prefix}.breach")
                    tr.event(f"{self.prefix}.breach", request_class=name,
                             n=n, p50_s=p50, slo_p50_s=cls.slo_p50_s,
                             p99_s=p99, slo_p99_s=cls.slo_p99_s,
                             burn_rate=burn)
        return out
