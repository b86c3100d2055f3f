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
    # a stable descending sort: ties go to the lower expert id, as
    # lax.top_k's do (no data-dependent shapes, so it also runs on meta)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]
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


def _routed(p, x: torch.Tensor, gate_vals, onehot, rank, C: int
            ) -> torch.Tensor:
    """The routed experts' output (B, S, d) for the experts of ``p``'s
    stacks, ``onehot`` (B, S, K, E) holding those experts' columns."""
    f32 = torch.float32
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
    return torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), ye)


def _balance(probs, onehot, E: int, K: int):
    """(frac of tokens, mean prob) per expert over the (B, S) tokens."""
    frac = torch.mean(onehot[..., 0, :] if K == 1 else onehot.sum(2),
                      dim=(0, 1)) / K
    return frac, torch.mean(probs, dim=(0, 1))


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()).

    Decode calls reshape their (B, d) batch to (G, B / G, d) groups. On a
    mesh (x a DTensor) the routed experts run on local shards
    (:func:`_moe_on_mesh`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_on_mesh(p, x, cfg)
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    probs, gate_vals, _, onehot, rank, C = route(p, x, cfg)
    out = _routed(p, x, gate_vals, onehot, rank, C)
    if m.shared_expert:
        sg = torch.nn.functional.silu(x @ p["s_gate"])
        out = out + (sg * (x @ p["s_up"])) @ p["s_down"]
    # Switch-style load-balance loss: E * sum_e (frac tokens) * (mean prob)
    frac, mean_p = _balance(probs, onehot, E, K)
    aux = E * torch.sum(frac * mean_p)
    return out, aux


def _moe_on_mesh(p, x, cfg: ModelConfig):
    """:func:`moe_forward` on a DTensor x: expert parallelism on local
    shards. The groups (x's dim 0) keep their sharding, every other
    dimension is replicated. Where the tokens are replicated along
    ``model``, each rank routes its tokens and runs only its own experts
    (the stacks' ``model`` shards) and the outputs sum over ``model``;
    where they are also replicated along a dimension that splits the
    experts' d_ff (the stationary serve layout), each rank runs its d_ff
    slice and the outputs sum there too. Every other shard of the stacks
    is gathered (FSDP). Routing, capacity ranks and the dispatch run on
    the local tokens; the balance loss averages over the group shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    keep = tuple(pl if pl == Shard(0) else Replicate()
                 for pl in x.placements)
    x = x.redistribute(mesh, keep)
    rep = (Replicate(),) * mesh.ndim
    stacks = ("w_gate", "w_up", "w_down")
    f_dim = {"w_gate": 2, "w_up": 2, "w_down": 1}

    def on(name, d):
        w = p[name]
        return w.placements[d] if isinstance(w, DTensor) else Replicate()

    place = {n: [Replicate()] * mesh.ndim for n in stacks}
    summed = []
    for d, axis in enumerate(names):
        if keep[d] != Replicate():
            continue
        if axis == "model":
            split = {n: Shard(0) for n in stacks}
        elif all(on(n, d) == Shard(f_dim[n]) for n in stacks):
            split = {n: Shard(f_dim[n]) for n in stacks}
        else:
            continue
        for n in stacks:
            place[n][d] = split[n]
        summed.append(d)

    def local(w, placements):
        if isinstance(w, DTensor):
            return w.redistribute(mesh, tuple(placements)).to_local()
        return w

    xl = x.to_local()
    probs, gate_vals, _, onehot, rank, C = route(
        {"router": local(p["router"], rep)}, xl, cfg)
    w = {n: local(p[n], place[n]) for n in stacks}
    lo = 0
    if "model" in names and names.index("model") in summed:
        n_model = mesh.size(names.index("model"))
        lo = mesh.get_local_rank("model") * (-(-E // n_model))
    out = _routed(w, xl, gate_vals, onehot[..., lo:lo + w["w_gate"].shape[0]],
                  rank, C)
    out = DTensor.from_local(
        out, mesh, tuple(Partial() if d in summed else keep[d]
                         for d in range(mesh.ndim)),
        run_check=False, shape=x.shape, stride=x.stride()
    ).redistribute(mesh, keep)
    if m.shared_expert:
        sg = torch.nn.functional.silu(x @ p["s_gate"])
        out = out + (sg * (x @ p["s_up"])) @ p["s_down"]
    avg = tuple(Partial("avg") if pl == Shard(0) else Replicate()
                for pl in keep)
    frac, mean_p = (DTensor.from_local(t, mesh, avg, run_check=False)
                    .redistribute(mesh, rep)
                    for t in _balance(probs, onehot, E, K))
    return out, E * torch.sum(frac * mean_p)
