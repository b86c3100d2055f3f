"""Norm-range partitioning, Algorithm 1 lines 3-4 and the §4 uniform
variant (port of ``repro/core/partition.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Partition(NamedTuple):
    """Partition of ``n`` items into ``m`` norm ranges.

    Attributes:
      range_id: (n,) int32 — sub-dataset index of each item, in [0, m).
      upper:    (m,) f32   — ``U_j = max_{x in S_j} ||x||`` (0 if empty).
      lower:    (m,) f32   — min 2-norm in S_j (0 if empty).
      counts:   (m,) int32 — items per range.
    """

    range_id: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor
    counts: torch.Tensor

    @property
    def num_ranges(self) -> int:
        return self.upper.shape[0]


def _range_stats(norms: torch.Tensor, range_id: torch.Tensor,
                 m: int) -> Partition:
    rid = range_id.long()
    counts = torch.bincount(rid, minlength=m).to(torch.int32)
    upper = torch.zeros((m,), dtype=norms.dtype, device=norms.device
                        ).scatter_reduce(0, rid, norms, "amax")
    big = torch.full((m,), float("inf"), dtype=norms.dtype,
                     device=norms.device).scatter_reduce(0, rid, norms,
                                                         "amin")
    lower = torch.where(torch.isfinite(big), big, 0.0)
    return Partition(range_id.to(torch.int32), upper, lower, counts)


def percentile_partition(norms: torch.Tensor, m: int) -> Partition:
    """Algorithm 1: rank by 2-norm (ties by item index), range j gets the
    ranks in ``[j n/m, (j+1) n/m)``."""
    n = norms.shape[0]
    # the reference computes ranks * m in int32; keep its guard
    if n * m >= 2 ** 31:
        raise ValueError(f"partition arithmetic would overflow int32: "
                         f"n={n} items x m={m} ranges >= 2^31")
    order = torch.argsort(norms, stable=True)
    ranks = torch.empty((n,), dtype=torch.int64, device=norms.device)
    ranks[order] = torch.arange(n, device=norms.device)
    range_id = torch.clamp_max((ranks * m) // n, m - 1)
    return _range_stats(norms, range_id, m)


def uniform_partition(norms: torch.Tensor, m: int) -> Partition:
    """Fig 3a variant: m equal-width bins over [min norm, max norm]."""
    lo = torch.min(norms)
    width = torch.clamp_min(torch.max(norms) - lo, 1e-12)
    range_id = torch.clamp(((norms - lo) / width * m).to(torch.int32),
                           0, m - 1)
    return _range_stats(norms, range_id, m)


def single_partition(norms: torch.Tensor) -> Partition:
    """Degenerate m = 1 partition: SIMPLE-LSH as a special case of
    RANGE-LSH."""
    return percentile_partition(norms, 1)


def effective_upper(part: Partition) -> torch.Tensor:
    """``U_j`` with empty ranges mapped to the global max (no item uses
    them), so downstream math never divides by zero."""
    return torch.where(part.counts > 0, part.upper, torch.max(part.upper))


def partition_by_scheme(norms: torch.Tensor, m: int,
                        scheme: str) -> Partition:
    if scheme == "percentile":
        return percentile_partition(norms, m)
    if scheme == "uniform":
        return uniform_partition(norms, m)
    raise ValueError(f"unknown partition scheme: {scheme!r}")
