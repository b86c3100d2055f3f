"""xLSTM blocks (Beck et al., 2024): mLSTM (matrix memory) and sLSTM
(port of ``repro/models/xlstm.py``).

mLSTM cell (per head, stabilized exponential gating):

    m_t = max(f~_t + m_{t-1}, i~_t)
    f'  = exp(f~_t + m_{t-1} - m_t),  i' = exp(i~_t - m_t)
    C_t = f' C_{t-1} + i' k_t v_t^T          (matrix memory, d_qk x d_v)
    n_t = f' n_{t-1} + i' k_t
    h_t = (C_t^T q_t) / max(|n_t^T q_t|, 1)

sLSTM keeps scalar memories with a block-diagonal (per-head)
hidden-to-hidden recurrence. Both run step by step over time through
``models/common.scan`` (the reference's ``lax.scan``; traced by trip on
``meta`` tensors), the stabiliser ``m`` starting at -1e30; recurrent
decode is O(1) per token. The reference's simplifications are
kept: dense per-head q/k/v projections, and the post-sLSTM MLP folded
into the block's gated output path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (PARAM_DTYPE, dense_init,
                                       log_sigmoid, merge_heads, pad,
                                       rms_norm, scan, split_heads)


class MLSTMCache(NamedTuple):
    C: torch.Tensor      # (B, H, d_qk, d_v) f32
    n: torch.Tensor      # (B, H, d_qk) f32
    m: torch.Tensor      # (B, H) f32
    conv: torch.Tensor   # (B, D_CONV-1, d_inner)


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # (B, d_model) f32
    n: torch.Tensor   # (B, d_model) f32
    m: torch.Tensor   # (B, d_model) f32
    h: torch.Tensor   # (B, d_model) f32 (recurrent input)


D_CONV = 4
M_INIT = -1e30        # the stabiliser's start


def _mlstm_dims(cfg: ModelConfig):
    x = cfg.xlstm
    d_inner = int(x.proj_factor * cfg.d_model)
    H = cfg.n_heads
    d_v = d_inner // H
    d_qk = int(d_v * x.qk_dim_factor)
    return d_inner, H, d_qk, d_v


def mlstm_init(generator: torch.Generator, cfg: ModelConfig,
               stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d_inner, H, d_qk, d_v = _mlstm_dims(cfg)
    dev = generator.device
    return {
        "w_in": dense_init(generator, stack + (cfg.d_model, 2 * d_inner)),
        "conv_w": dense_init(generator, stack + (D_CONV, d_inner),
                             scale=0.2),
        "conv_b": torch.zeros(stack + (d_inner,), dtype=PARAM_DTYPE,
                              device=dev),
        "w_q": dense_init(generator, stack + (d_inner, H * d_qk)),
        "w_k": dense_init(generator, stack + (d_inner, H * d_qk)),
        "w_v": dense_init(generator, stack + (d_inner, H * d_v)),
        "w_if": dense_init(generator, stack + (d_inner, 2 * H),
                           dtype=torch.float32),
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           3.0 * torch.ones(H, device=dev)]).expand(
                               stack + (2 * H,)).contiguous(),
        "gn": torch.zeros(stack + (d_inner,), dtype=torch.float32,
                          device=dev),
        "w_out": dense_init(generator, stack + (d_inner, cfg.d_model)),
    }


def _mlstm_cell(q, k, v, ig, fg, state):
    """One time step. q,k: (B,H,dk); v: (B,H,dv); ig,fg: (B,H)."""
    C, n, m = state
    m_new = torch.maximum(fg + m, ig)
    fp = torch.exp(fg + m - m_new)
    ip = torch.exp(ig - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), 1.0)
    h = num / den[..., None]
    return (C, n, m_new), h


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[MLSTMCache] = None
                  ) -> Tuple[torch.Tensor, MLSTMCache]:
    """Full-sequence mLSTM block. x: (B, S, d_model). Returns new state
    tensors."""
    d_inner, H, d_qk, d_v = _mlstm_dims(cfg)
    B, S, _ = x.shape
    f32 = torch.float32
    xm_raw, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    padded = (torch.cat([cache.conv, xm_raw], dim=1) if cache is not None
              else pad(xm_raw, (0, 0, D_CONV - 1, 0)))
    conv = padded[:, 0:S] * p["conv_w"][0]
    for i in range(1, D_CONV):
        conv = conv + padded[:, i:i + S] * p["conv_w"][i]
    xc = torch.nn.functional.silu(conv + p["conv_b"])

    q = split_heads(xc @ p["w_q"], H)
    k = split_heads(xc @ p["w_k"], H) * d_qk ** -0.5
    v = split_heads(xm_raw @ p["w_v"], H)
    gates = xc.to(f32) @ p["w_if"] + p["b_if"]
    ig, fg_raw = gates[..., :H], gates[..., H:]
    fg = log_sigmoid(fg_raw)                      # forget gate in (0, 1)

    if cache is None:
        state = (torch.zeros((B, H, d_qk, d_v), dtype=f32, device=x.device),
                 torch.zeros((B, H, d_qk), dtype=f32, device=x.device),
                 torch.full((B, H), M_INIT, dtype=f32, device=x.device))
    else:
        state = (cache.C, cache.n, cache.m)

    def step(s, inp):
        qt, kt, vt, it, ft = inp
        return _mlstm_cell(qt.to(f32), kt.to(f32), vt.to(f32), it, ft, s)

    state, hs = scan(step, state, (q, k, v, ig, fg))
    h = merge_heads(hs)                                     # (B,S,H*dv)
    h = rms_norm(h.to(x.dtype), p["gn"], cfg.norm_eps)
    out = (h * torch.nn.functional.silu(z)) @ p["w_out"]
    conv_tail = padded[:, S:S + D_CONV - 1]   # last D_CONV-1 raw conv inputs
    return out, MLSTMCache(state[0], state[1], state[2],
                           conv_tail.to(x.dtype))


def mlstm_decode(p, x: torch.Tensor, cache: MLSTMCache, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, MLSTMCache]:
    out, new = mlstm_forward(p, x[:, None, :], cfg, cache=cache)
    return out[:, 0], new


def slstm_init(generator: torch.Generator, cfg: ModelConfig,
               stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dev = generator.device
    zeros = torch.zeros(d, device=dev)
    return {
        # input weights for (z, i, f, o)
        "w_x": dense_init(generator, stack + (d, 4 * d),
                          dtype=torch.float32),
        # block-diagonal recurrent weights per head: (4 gates, H, dh, dh)
        "r_h": dense_init(generator, stack + (4, H, dh, dh),
                          dtype=torch.float32, scale=dh ** -0.5),
        "b": torch.cat([zeros, zeros, 3.0 * torch.ones(d, device=dev),
                        zeros]).expand(stack + (4 * d,)).contiguous(),
        "gn": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "w_z": dense_init(generator, stack + (d, d)),
        "w_out": dense_init(generator, stack + (d, d)),
    }


def _slstm_cell(p, xt, state, H):
    """xt: (B, d) f32. state: (c, n, m, h_prev)."""
    c, n, m, h_prev = state
    B, d = xt.shape
    dh = d // H
    gx = xt @ p["w_x"] + p["b"]                              # (B, 4d)
    hb = split_heads(h_prev, H)
    # recurrent term in the (B, 4 gates, H, dh) order, flattened to 4d
    rec = torch.einsum("bhj,ghjk->bghk", hb, p["r_h"]).reshape(B, 4 * d)
    g = gx + rec
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    fg = log_sigmoid(ft)
    m_new = torch.maximum(fg + m, it)
    fp = torch.exp(fg + m - m_new)
    ip = torch.exp(it - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    h = ot * c / torch.clamp_min(n, 1.0)
    return (c, n, m_new, h), h


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[SLSTMCache] = None
                  ) -> Tuple[torch.Tensor, SLSTMCache]:
    """Full-sequence sLSTM block. x: (B, S, d). Returns new state
    tensors."""
    B, _, d = x.shape
    f32 = torch.float32
    if cache is None:
        state = (torch.zeros((B, d), dtype=f32, device=x.device),
                 torch.zeros((B, d), dtype=f32, device=x.device),
                 torch.full((B, d), M_INIT, dtype=f32, device=x.device),
                 torch.zeros((B, d), dtype=f32, device=x.device))
    else:
        state = (cache.c, cache.n, cache.m, cache.h)
    state, hs = scan(lambda s, xt: _slstm_cell(p, xt, s, cfg.n_heads),
                     state, x.to(f32))
    h = hs.to(x.dtype)                                      # (B, S, d)
    h = rms_norm(h, p["gn"], cfg.norm_eps)
    z = torch.nn.functional.silu(x @ p["w_z"])
    out = (h * z) @ p["w_out"]
    return out, SLSTMCache(*state)


def slstm_decode(p, x: torch.Tensor, cache: SLSTMCache, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, SLSTMCache]:
    out, new = slstm_forward(p, x[:, None, :], cfg, cache=cache)
    return out[:, 0], new
