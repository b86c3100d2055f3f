"""DeepSeek-V2-Lite's forward pass, written from its published description
(the model card's config.json and the DeepSeek-V2 paper, arXiv 2405.04434)
in plain PyTorch and float32, with no kernel, cache or batching: one
sequence of token ids to every position's final hidden state and logits.

It reads the configuration as the source gives it (``hidden_size``,
``kv_lora_rank``, ``rope_scaling``, ``first_k_dense_replace``, ...) and
the weights as the program holds them: the bf16 tree of the port's
``models/lm.py`` (``embed``, ``unembed``, ``final_norm``, the leading dense
layers under ``lead`` and the MoE layers under ``pos0``, each stacked over
its layers). Each layer's weights are upcast to float32 when the layer
runs, so the whole model never exists in float32 beside the bf16 one.
TF32 is off for the whole pass.

The equations, per layer l (x the residual stream, one row a position):

- h = RMSNorm(x); q = h W_q split into 16 heads of nope 128 + rope 64 (no
  query compression); c = RMSNorm(h W_dkv) (the 512-wide latent);
  k_rope = h W_kr (64, shared by the heads); k_nope = c W_uk and
  v = c W_uv (16 heads of 128).
- YaRN rotary embedding on q_rope and k_rope: inverse frequencies
  theta^(-2i/64) blended with the same over ``factor`` by a linear ramp
  between the correction dimensions of ``beta_fast`` and ``beta_slow``
  rotations over ``original_max_position_embeddings`` positions; cos and
  sin times mscale(factor, mscale) / mscale(factor, mscale_all_dim),
  mscale(s, m) = 0.1 m ln s + 1.
- causal softmax attention at scale (nope + rope)^-1/2 times
  mscale(factor, mscale_all_dim)^2; out = o W_o; x += out.
- h = RMSNorm(x). Layers below ``first_k_dense_replace``: the SwiGLU
  silu(h W_gate) * (h W_up) W_down of ``intermediate_size``. The others:
  probabilities softmax(h W_router) in float32, the greedy top
  ``num_experts_per_tok`` (equal probabilities to the lower expert id),
  gates the probabilities as they are (``norm_topk_prob`` false) times
  ``routed_scaling_factor``, every chosen expert's SwiGLU of
  ``moe_intermediate_size`` weighted by its gate (no capacity: no token is
  dropped), plus the shared experts, one SwiGLU of ``n_shared_experts``
  times that width; x += that.
- the final RMSNorm, then logits = x W_unembed.

Departures from the published model, each a fixed relabelling that gives
the same model under random weights:

- rope layout: the port rotates the half-split pairs (column i with
  column 32 + i) where DeepSeek's checkpoints interleave them (2i with
  2i + 1) and permute before rotating; this is a fixed permutation of
  the rope columns of W_q and W_kr.
- RMSNorm parametrisation: the scale is (1 + w), the port's, where
  DeepSeek stores the scale itself.
- the latent projection W_dkv and the rope key W_kr are two matrices
  where DeepSeek's ``kv_a_proj_with_mqa`` is one (its columns split), and
  W_uk and W_uv two where ``kv_b_proj`` is one (its columns split by
  head).
- no auxiliary loss: serving only.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch

F32 = torch.float32
Q_CHUNK = 2048          # query rows of one attention block (memory only)


@contextmanager
def no_tf32():
    """float32 products in float32: TF32 off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(h @ w_gate) * (h @ w_up)) @ w_down


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def rope_tables(config: dict, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (S, rope/2) of the YaRN rotary embedding at
    ``positions``."""
    dim = int(config["qk_rope_head_dim"])
    base = float(config["rope_theta"])
    ys = config.get("rope_scaling")
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=F32,
                                        device=positions.device) / dim)
    factor = 1.0
    if ys is not None:
        factor = float(ys["factor"])
        orig = float(ys["original_max_position_embeddings"])

        def correction(rotations):
            return (dim * math.log(orig / (rotations * 2 * math.pi))
                    / (2 * math.log(base)))

        lo = max(math.floor(correction(float(ys["beta_fast"]))), 0)
        hi = min(math.ceil(correction(float(ys["beta_slow"]))), dim - 1)
        if lo == hi:
            hi += 0.001
        ramp = torch.clamp((torch.arange(dim // 2, dtype=F32,
                                         device=positions.device) - lo)
                           / (hi - lo), 0, 1)
        inv_freq = extra / factor * ramp + extra * (1 - ramp)
        mult = (yarn_mscale(factor, float(ys["mscale"]))
                / yarn_mscale(factor, float(ys["mscale_all_dim"])))
    else:
        inv_freq, mult = extra, 1.0
    ang = positions.to(F32)[:, None] * inv_freq[None, :]
    return torch.cos(ang) * mult, torch.sin(ang) * mult


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """The rotary embedding of x (S, ..., rope): half-split pairs."""
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[1],)
    c, s = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def softmax_scale(config: dict) -> float:
    scale = (int(config["qk_nope_head_dim"])
             + int(config["qk_rope_head_dim"])) ** -0.5
    ys = config.get("rope_scaling")
    if ys is not None and float(ys.get("mscale_all_dim", 0)):
        scale *= yarn_mscale(float(ys["factor"]),
                             float(ys["mscale_all_dim"])) ** 2
    return scale


def attention(p: Dict[str, torch.Tensor], h: torch.Tensor, config: dict,
              cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Causal multi-head latent attention over the whole sequence (S, d)."""
    S = h.shape[0]
    H = int(config["num_attention_heads"])
    nope = int(config["qk_nope_head_dim"])
    eps = float(config["rms_norm_eps"])
    q = (h @ p["w_q"]).view(S, H, -1)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], dim=-1)
    c = rms_norm(h @ p["w_dkv"], p["kv_norm"], eps)
    k_rope = rotate(h @ p["w_kr"], cos, sin)                   # (S, rope)
    k_nope = (c @ p["w_uk"]).view(S, H, nope)
    v = (c @ p["w_uv"]).view(S, H, -1)
    k = torch.cat([k_nope, k_rope[:, None, :].expand(S, H, -1)], dim=-1)
    scale = softmax_scale(config)
    out = torch.empty((S, H, v.shape[-1]), dtype=F32, device=h.device)
    keys = torch.arange(S, device=h.device)
    for q0 in range(0, S, Q_CHUNK):
        rows = torch.arange(q0, min(q0 + Q_CHUNK, S), device=h.device)
        s = torch.einsum("qhd,khd->hqk", q[rows], k) * scale
        s = s.masked_fill(keys[None, None, :] > rows[None, :, None],
                          -math.inf)
        out[rows] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                 v)
    return out.reshape(S, -1) @ p["w_o"]


def experts(p: Dict[str, torch.Tensor], h: torch.Tensor, config: dict
            ) -> torch.Tensor:
    """The MoE FFN: routed experts by their unrenormalised gates, every
    chosen (token, expert) computed, plus the shared experts."""
    E = int(config["n_routed_experts"])
    K = int(config["num_experts_per_tok"])
    probs = torch.softmax(h @ p["router"], dim=-1)               # (S, E)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :K], idx[:, :K]
    if config["norm_topk_prob"]:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    gates = gates * float(config["routed_scaling_factor"])
    out = swiglu(h, p["s_gate"], p["s_up"], p["s_down"])
    for e in range(E):
        chosen = idx == e                                          # (S, K)
        rows = torch.nonzero(chosen.any(dim=-1)).flatten()
        if rows.numel() == 0:
            continue
        g = (gates * chosen)[rows].sum(dim=-1, keepdim=True)
        out[rows] += g * swiglu(h[rows], p["w_gate"][e], p["w_up"][e],
                                p["w_down"][e])
    return out


def expected_shapes(config: dict) -> Dict[str, tuple]:
    """Each weight's shape, by its path in the tree, as the configuration
    gives it (leading dense layers under ``lead``, the MoE layers under
    ``pos0``, each stacked over its layers; vocabulary rows at least
    ``vocab_size``)."""
    d = int(config["hidden_size"])
    H = int(config["num_attention_heads"])
    nope, rope = int(config["qk_nope_head_dim"]), int(config["qk_rope_head_dim"])
    v, kv = int(config["v_head_dim"]), int(config["kv_lora_rank"])
    E, f = int(config["n_routed_experts"]), int(config["moe_intermediate_size"])
    shared = int(config["n_shared_experts"]) * f
    dense = int(config["first_k_dense_replace"])
    moe = int(config["num_hidden_layers"]) - dense
    if config["q_lora_rank"] is not None:
        raise ValueError("this reference is written for q_lora_rank null "
                         "(no query compression)")
    mixer = {"w_q": (d, H * (nope + rope)), "w_dkv": (d, kv),
             "kv_norm": (kv,), "w_kr": (d, rope), "w_uk": (kv, H * nope),
             "w_uv": (kv, H * v), "w_o": (H * v, d)}
    shapes = {"final_norm": (d,)}
    for stack, n in (("lead", dense), ("pos0", moe)):
        for name, shape in mixer.items():
            shapes[f"{stack}/mixer/{name}"] = (n,) + shape
        shapes[f"{stack}/norm1"] = shapes[f"{stack}/norm2"] = (n, d)
    dff = int(config["intermediate_size"])
    for name, shape in (("w_gate", (d, dff)), ("w_up", (d, dff)),
                        ("w_down", (dff, d))):
        shapes[f"lead/ffn/{name}"] = (dense,) + shape
    for name, shape in (("router", (d, E)), ("w_gate", (E, d, f)),
                        ("w_up", (E, d, f)), ("w_down", (E, f, d)),
                        ("s_gate", (d, shared)), ("s_up", (d, shared)),
                        ("s_down", (shared, d))):
        shapes[f"pos0/ffn/{name}"] = (moe,) + shape
    return shapes


def check_tree(params: Dict, config: dict) -> None:
    """Raise ValueError where the tree lacks a weight the configuration
    gives, holds one it does not, or holds one of another shape."""
    want = expected_shapes(config)
    got = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + key + "/")
            else:
                got[path + key] = tuple(value.shape)

    walk({k: params[k] for k in ("lead", "pos0", "final_norm")}, "")
    for path in sorted(set(want) | set(got)):
        if want.get(path) != got.get(path):
            raise ValueError(f"{path}: the tree holds {got.get(path)}, the "
                             f"configuration gives {want.get(path)}")
    V, d = int(config["vocab_size"]), int(config["hidden_size"])
    for name, (rows, cols) in (("embed", params["embed"].shape),
                               ("unembed", params["unembed"].T.shape)):
        if rows < V or cols != d:
            raise ValueError(f"{name}: {rows} x {cols} rows of the "
                             f"vocabulary, the configuration gives {V} x {d}")


def _layer(stack: Dict, l: int) -> Dict:
    """Layer ``l`` of a stacked subtree, upcast to float32."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l].to(F32)
            for k, v in stack.items()}


def forward(params: Dict, tokens: torch.Tensor, config: dict,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (S,) ids -> (final hidden states (n, d), logits (n, V)),
    float32, at ``positions`` (indices into the sequence; default every
    one)."""
    eps = float(config["rms_norm_eps"])
    dense = int(config["first_k_dense_replace"])
    layers = int(config["num_hidden_layers"])
    V = int(config["vocab_size"])
    check_tree(params, config)
    with no_tf32(), torch.no_grad():
        S = tokens.shape[0]
        x = params["embed"][tokens.long()].to(F32)
        cos, sin = rope_tables(config, torch.arange(S, device=x.device))
        for l in range(layers):
            p = (_layer(params["lead"], l) if l < dense
                 else _layer(params["pos0"], l - dense))
            x = x + attention(p["mixer"], rms_norm(x, p["norm1"], eps),
                              config, cos, sin)
            h = rms_norm(x, p["norm2"], eps)
            f = p["ffn"]
            x = x + (swiglu(h, f["w_gate"], f["w_up"], f["w_down"])
                     if l < dense else experts(f, h, config))
            del p, f, h
        if positions is not None:
            x = x[positions]
        hidden = rms_norm(x, params["final_norm"].to(F32), eps)
        logits = hidden @ params["unembed"][:, :V].to(F32)
    return hidden, logits
