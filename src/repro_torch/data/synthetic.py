"""Synthetic MIPS datasets with the norm profiles of the paper's three
(port of ``repro/data/synthetic.py``), drawn on the device from a seeded
``torch.Generator``. The numbers differ from the JAX package's draws for
the same seed; the distributions are the same.

  * ``imagenet``   — lognormal norms (sigma 0.8): a long tail.
  * ``netflix``    — norms near 1 (truncated normal, spread 0.15).
  * ``yahoomusic`` — two clusters of norms.

Directions are uniform on the sphere; queries are standard normal.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device


class MIPSDataset(NamedTuple):
    items: torch.Tensor    # (n, d)
    queries: torch.Tensor  # (q, d)
    name: str


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def longtail_norms(gen: torch.Generator, n: int,
                   sigma: float = 0.8) -> torch.Tensor:
    """Lognormal norms — long tail, max >> median (ImageNet-like)."""
    return torch.exp(sigma * _normal(gen, (n,)))


def flat_norms(gen: torch.Generator, n: int,
               spread: float = 0.15) -> torch.Tensor:
    """Norms concentrated near 1 (Netflix-like)."""
    return torch.clamp_min(1.0 + spread * _normal(gen, (n,)), 0.3)


def bimodal_norms(gen: torch.Generator, n: int) -> torch.Tensor:
    """Two-cluster norms (Yahoo!Music-like)."""
    lo = 0.6 + 0.08 * _normal(gen, (n,))
    hi = 1.1 + 0.08 * _normal(gen, (n,))
    pick = torch.rand((n,), generator=gen, device=gen.device) < 0.35
    return torch.clamp_min(torch.where(pick, hi, lo), 0.1)


_PROFILES: Dict[str, Tuple[int, int, Callable]] = {
    #  name        (n,      d,   norm sampler)
    "netflix":     (17770, 300, flat_norms),
    "yahoomusic":  (30000, 300, bimodal_norms),
    "imagenet":    (100000, 128, longtail_norms),
}


def profile_names():
    return sorted(_PROFILES)


def make_dataset(name: str, seed: int = 0, *, n: Optional[int] = None,
                 d: Optional[int] = None, num_queries: int = 1000,
                 device=None) -> MIPSDataset:
    """One of the paper-profile datasets (sizes overridable), drawn on
    ``device`` (the card unless ``device="cpu"``) from ``seed``."""
    if name not in _PROFILES:
        raise ValueError(f"unknown dataset profile {name!r}; "
                         f"choose from {sorted(_PROFILES)}")
    n0, d0, sampler = _PROFILES[name]
    n = n0 if n is None else n
    d = d0 if d is None else d
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dirs = _normal(gen, (n, d))
    dirs /= torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    items = dirs * sampler(gen, n)[:, None]
    queries = _normal(gen, (num_queries, d))
    return MIPSDataset(items, queries, name)

