"""Gradient compression with error feedback (port of
``repro/optim/compression.py``).

The reference compresses gradients for its cross-pod all-reduce; the
port's trainer runs on one device and applies the same compression in
the step, so its updates and state equal the reference's:

  * :func:`bf16_compress` — the f32 sum of gradient and residual rounded
    to bf16 (round to nearest even); the residual carries the rounding
    error to the next step.
  * :func:`topk_sparsify` — keep the values at or above the k-th largest
    magnitude, the rest carried in the residual.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map

PyTree = Any
f32 = torch.float32


class ErrorFeedback(NamedTuple):
    residual: PyTree


def ef_init(params: PyTree) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda p: torch.zeros(p.shape, dtype=f32, device=p.device), params))


def _map_pairs(fn, grads: PyTree, residual: PyTree
               ) -> Tuple[PyTree, ErrorFeedback]:
    """``fn(g, r) -> (comp, new residual)`` over the leaves, as the
    compressed tree and the new :class:`ErrorFeedback`."""
    res = []

    def one(g, r):
        comp, new = fn(g, r)
        res.append(new)
        return comp

    comp = tree_map(one, grads, residual)
    it = iter(res)
    return comp, ErrorFeedback(tree_map(lambda _: next(it), grads))


def bf16_compress(grads: PyTree, ef: ErrorFeedback
                  ) -> Tuple[PyTree, ErrorFeedback]:
    """(bf16 grads, new residual): ``full = g + r`` in f32, ``comp =
    bf16(full)``, ``r' = full - comp``."""
    def one(g, r):
        full = g.to(f32) + r
        comp = full.to(torch.bfloat16)
        return comp, full - comp.to(f32)

    return _map_pairs(one, grads, ef.residual)


def topk_sparsify(grads: PyTree, ef: ErrorFeedback, keep_frac: float = 0.1
                  ) -> Tuple[PyTree, ErrorFeedback]:
    """Magnitude top-k with error feedback: a leaf keeps the values whose
    magnitude reaches its k-th largest (k = max(1, int(n * keep_frac))),
    zeros the rest, and the residual takes what was dropped."""
    def one(g, r):
        full = g.to(f32) + r
        flat = torch.abs(full).reshape(-1)
        k = max(1, int(flat.shape[0] * keep_frac))
        thresh = torch.topk(flat, k).values[-1]
        comp = full * (torch.abs(full) >= thresh).to(f32)
        return comp, full - comp

    return _map_pairs(one, grads, ef.residual)


def decompress(grads: PyTree) -> PyTree:
    return tree_map(lambda g: g.to(f32), grads)
