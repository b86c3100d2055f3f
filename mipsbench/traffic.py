"""The seeded inputs of one run: the catalogue, the hash projections, the
calibration queries and the pool of served queries.

Everything is drawn on the run's device by ``torch.Generator``s in a
fixed order. The deployment (catalogue, projections, calibration
queries) comes from the configuration's ``data_seed``, so every run of a
configuration serves the same catalogue with the same plan; the pool of
served queries comes from ``--seed``. One seed gives the same inputs on
every run, and every seed the same work. The benchmark hands the same
tensors to the program and to the plain reference.

The norm profiles are a frozen copy of the port's synthetic generator
(``src/repro_torch/data/synthetic.py``): directions uniform on the
sphere, norms from a named profile, queries standard normal. What a
configuration or a mix may ask for is the data below; a new profile is
a new entry of ``NORM_PROFILES``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def longtail_norms(gen: torch.Generator, n: int, sigma: float) -> torch.Tensor:
    """Lognormal norms: a long tail, the largest far above the median."""
    return torch.exp(sigma * _normal(gen, (n,)))


def bimodal_norms(gen: torch.Generator, n: int, low: float, high: float,
                  spread: float, high_share: float) -> torch.Tensor:
    """Two clusters of norms, ``high_share`` of the items in the upper."""
    lo = low + spread * _normal(gen, (n,))
    hi = high + spread * _normal(gen, (n,))
    pick = torch.rand((n,), generator=gen, device=gen.device) < high_share
    return torch.clamp_min(torch.where(pick, hi, lo), 0.1)


NORM_PROFILES: Dict[str, Callable] = {
    "longtail": longtail_norms,
    "bimodal": bimodal_norms,
}


class Inputs(NamedTuple):
    items: torch.Tensor         # (n, d) f32 catalogue
    projections: torch.Tensor   # (d + 1, hash_bits) f32, augmentation row last
    calibration: torch.Tensor   # (calibration_queries, d) f32 held-out queries
    pool: torch.Tensor          # (pool_batches * batch, d) f32 served queries


def hash_bits(spec: dict) -> int:
    """Hash functions left of the code budget after ceil(log2 m) bits pay
    for the range id (the paper's Sec. 4 protocol)."""
    m = int(spec["m"])
    return int(spec["code_len"]) - (math.ceil(math.log2(m)) if m > 1 else 0)


def make_inputs(config: dict, mix: dict, seed: int,
                device: torch.device) -> Inputs:
    """The run's inputs: items, projections and calibration queries from
    the configuration's ``data_seed``, then the query pool from ``seed``,
    in a few large calls."""
    gen = torch.Generator(device=device).manual_seed(int(config["data_seed"]))
    n, d = int(config["n"]), int(config["d"])
    norms = dict(config["norms"])
    sampler = NORM_PROFILES[norms.pop("profile")]
    items = _normal(gen, (n, d))
    items /= torch.linalg.vector_norm(items, dim=1, keepdim=True)
    items *= sampler(gen, n, **norms)[:, None]
    proj = _normal(gen, (d + 1, hash_bits(config["spec"])))
    cal = _normal(gen, (int(config["calibration_queries"]), d))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pool = _normal(gen, (int(mix["pool_batches"]) * int(mix["batch"]), d))
    return Inputs(items, proj, cal, pool)
