"""Optimizers, schedules and gradient utilities (port of
``repro/optim/optimizers.py``).

AdamW with f32 moments over bf16 params is the trainer's default; its
state is a tree mirroring the params (the reference's tree paths, so a
checkpoint of either package restores into the other). Trees are walked
by :mod:`repro_torch.tree`; sums over leaves run in the reference's leaf
order (dict keys sorted).

``adamw_update`` writes the params and the moments in place (the
reference returns new arrays); every other function returns new
tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map

PyTree = Any
f32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: PyTree           # first moment, f32
    nu: PyTree           # second moment, f32


def adamw_init(params: PyTree) -> AdamWState:
    """Zero moments (f32, on each param's device) and step 0."""
    first = leaves(params)[0]
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=first.device),
        tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device),
                 params),
        tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device),
                 params))


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[PyTree, AdamWState]:
    """One AdamW step: returns (params, state), the params and moments
    updated in place; params keep their dtype. ``lr`` is a float or a 0-d
    f32 tensor; the bias corrections ``1 - b ** t`` are f32."""
    step = state.step + 1
    t = step.to(f32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=t.device), t)
    for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                          leaves(state.nu), leaves(params)):
        g32 = g.to(f32)
        m.mul_(b1).add_((1.0 - b1) * g32)
        v.mul_(b2).add_((1.0 - b2) * torch.square(g32))
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        upd = upd + weight_decay * p.to(f32)
        p.copy_((p.to(f32) - lr * upd).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    dtype; the global norm before scaling: f32, its squares summed over
    the leaves in the reference's order)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                           for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-6), max=1.0)
    return tree_map(lambda g: (g.to(f32) * scale).to(g.dtype), grads), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``: ``lr(step)`` is a 0-d f32 tensor (on the
    step's device, the CPU for an int)."""
    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(f32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr


def sgd_update(grads: PyTree, params: PyTree, lr: float) -> PyTree:
    """New params ``p - lr * g`` (f32 arithmetic, params' dtype)."""
    return tree_map(lambda p, g: (p.to(f32) - lr * g.to(f32)).to(p.dtype),
                    params, grads)
