"""Mixture-of-Experts layer: GShard-style one-hot dispatch (port of
``repro/models/moe.py``).

Routing (top-k, normalized gates) feeds capacity-bounded dispatch and
combine products. Tokens are grouped by batch row, so the dispatch tensor
is (B, S, E, C_g) with per-group capacity ``C_g = ceil(S / E * cf *
top_k)`` (at least 4, at most S) rather than a global (T, E, C). The
router runs in f32 and picks experts with ``lax.top_k``'s tie rule (equal
probabilities go to the lower expert id); a token's (token, k) slots rank
within their expert in token order, and those ranked at or past ``C_g``
are dropped. The products are plain ``torch.einsum`` (the reference
computes them outside any Pallas kernel), the dispatch and combine
tensors cast to the activations' dtype where the reference casts them.

The layer also returns the Switch/GShard load-balancing loss
``E * sum_e f_e * p_e``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk import stable_topk
from repro_torch.models.common import dense_init


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """One MoE FFN's params: an f32 router, the experts' stacked SwiGLU
    weights, and the shared expert's where the config has one."""
    m = cfg.moe
    d, E = cfg.d_model, m.num_experts
    d_ff = m.d_ff or cfg.d_ff
    p = {
        "router": dense_init(generator, stack + (d, E), dtype=torch.float32),
        "w_gate": dense_init(generator, stack + (E, d, d_ff)),
        "w_up": dense_init(generator, stack + (E, d, d_ff)),
        "w_down": dense_init(generator, stack + (E, d_ff, d)),
    }
    if m.shared_expert:
        p["s_gate"] = dense_init(generator, stack + (d, d_ff))
        p["s_up"] = dense_init(generator, stack + (d, d_ff))
        p["s_down"] = dense_init(generator, stack + (d_ff, d))
    return p


def group_capacity(group_size: int, num_experts: int, top_k: int,
                   capacity_factor: float) -> int:
    c = math.ceil(group_size * top_k * capacity_factor / num_experts)
    return max(4, min(c, group_size))


def route(p, x: torch.Tensor, cfg: ModelConfig):
    """The router's decisions for x (B, S, d): (probs (B, S, E) f32,
    normalized gates (B, S, K) f32 with dropped slots zeroed, gate_idx
    (B, S, K) int64, its one-hot (B, S, K, E) f32, capacity ranks
    (B, S, K) int64, C)."""
    m = cfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    C = group_capacity(S, E, K, m.capacity_factor)
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)                  # (B, S, E)
    gate_vals, gate_idx = stable_topk(probs.reshape(B * S, E), K)
    gate_vals = gate_vals.reshape(B, S, K)
    gate_idx = gate_idx.reshape(B, S, K)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    # position of each (token, k) within its expert's capacity buffer:
    # the k slots flattened in token order, so cumsum ranks earlier
    # tokens first
    onehot = torch.nn.functional.one_hot(gate_idx, E).to(torch.float32)
    flat = onehot.reshape(B, S * K, E)
    rank = torch.cumsum(flat, dim=1) - flat
    rank = torch.sum(rank * flat, dim=-1).reshape(B, S, K).long()
    keep = rank < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return probs, gate_vals, gate_idx, onehot, rank, C


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()).

    Decode calls reshape their (B, d) batch to (G, B / G, d) groups."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    f32 = torch.float32
    probs, gate_vals, _, onehot, rank, C = route(p, x, cfg)
    keep = (rank < C).to(f32)
    # a rank at or past C has an all-zero one-hot row, as jax.nn.one_hot
    rank_oh = (rank[..., None] == torch.arange(
        C, device=x.device)).to(f32)                           # (B,S,K,C)
    dispatch = torch.einsum("bske,bskc->bsec", onehot,
                            rank_oh * keep[..., None])
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, onehot,
                           rank_oh)

    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
    g = torch.nn.functional.silu(torch.einsum("ebcd,edf->ebcf", xe,
                                              p["w_gate"]))
    u = torch.einsum("ebcd,edf->ebcf", xe, p["w_up"])
    ye = torch.einsum("ebcf,efd->ebcd", g * u, p["w_down"])
    out = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), ye)

    if m.shared_expert:
        sg = torch.nn.functional.silu(x @ p["s_gate"])
        out = out + (sg * (x @ p["s_up"])) @ p["s_down"]

    # Switch-style load-balance loss: E * sum_e (frac tokens) * (mean prob)
    frac = torch.mean(onehot[..., 0, :] if K == 1 else onehot.sum(2),
                      dim=(0, 1)) / K
    mean_p = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac * mean_p)
    return out, aux
