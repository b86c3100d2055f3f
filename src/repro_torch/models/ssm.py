"""Mamba (selective SSM) block for the Jamba hybrid (port of
``repro/models/ssm.py``).

The diagonal selective recurrence

    h_t = exp(dt_t * A) ⊙ h_{t-1} + dt_t * B_t * x_t,   y_t = C_t · h_t

is a first-order linear recurrence. It runs chunked, as the reference
runs it: an associative scan (log-depth) inside each chunk of length
``Lc`` and a scan (``models/common.scan``, the reference's ``lax.scan``)
carrying the (B, d_inner, N) boundary state between chunks. The port
scans all S / Lc chunks at once from a zero state, then carries the
boundary state across them, ``h = A_t * h + H_t``, in S / Lc steps; the
reference folds the carry into each chunk's first step before its scan.
The two differ in where the carry enters, and so in f32 rounding only.

Decode keeps (conv window, h state) per layer: O(1) per token.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (PARAM_DTYPE, dense_init, pad, scan,
                                       softplus)
from repro_torch.parallel.sharding import settled


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_inner) last pre-activation inputs
    h: torch.Tensor       # (B, d_inner, d_state) recurrent state (f32)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, s.d_state, s.d_conv, dt_rank


def ssm_init(generator: torch.Generator, cfg: ModelConfig,
             stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d_inner, N, d_conv, dt_rank = _dims(cfg)
    dev = generator.device
    u = torch.rand(stack + (d_inner,), generator=generator,
                   dtype=torch.float32, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    return {
        "in_proj": dense_init(generator, stack + (cfg.d_model, 2 * d_inner)),
        "conv_w": dense_init(generator, stack + (d_conv, d_inner),
                             scale=0.2),
        "conv_b": torch.zeros(stack + (d_inner,), dtype=PARAM_DTYPE,
                              device=dev),
        "x_proj": dense_init(generator, stack + (d_inner, dt_rank + 2 * N)),
        "dt_proj": dense_init(generator, stack + (dt_rank, d_inner)),
        "dt_bias": torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))),
        # A stored as log so A = -exp(A_log) stays negative (stable)
        "A_log": torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=dev).expand(
                stack + (d_inner, N))).contiguous(),
        "D": torch.ones(stack + (d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, stack + (d_inner, cfg.d_model)),
    }


def _assoc_scan(a: torch.Tensor, b: torch.Tensor, dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs (a_t, b_t) along ``dim`` under the
    reference's combine ``(a1, b1), (a2, b2) -> (a1 * a2, a2 * b1 + b2)``
    (Hillis-Steele: log2 of the length steps, each combining every element
    with the one ``k`` before it). Returns (the products A_t of a up to t,
    the states H_t from a zero state)."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_hi, a_lo = a.narrow(dim, k, n - k), a.narrow(dim, 0, n - k)
        b_hi, b_lo = b.narrow(dim, k, n - k), b.narrow(dim, 0, n - k)
        b = torch.cat([b.narrow(dim, 0, k), a_hi * b_lo + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, k), a_lo * a_hi], dim)
        k *= 2
    return a, b


def _ssm_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order recurrence h_t = a_t * h_{t-1} + b_t, chunked.

    a, b: (B, S, d_inner, N) f32; h0: (B, d_inner, N). Every chunk's
    associative scan runs at once; the boundary state then crosses the
    S / chunk chunks through ``scan``, and each chunk's states are
    ``A_t * h_in + H_t``. Returns (all h states (B, S, d_inner, N),
    final h)."""
    B, S, D, N = a.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length S={S} must be a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    A, H = _assoc_scan(a.reshape(B, nc, chunk, D, N),
                       b.reshape(B, nc, chunk, D, N), 2)

    def carry(h, ends):
        a_end, h_end = ends
        return a_end * h + h_end, h

    h_last, h_in = scan(carry, h0, (A[:, :, -1], H[:, :, -1]))
    hs = A * h_in[:, :, None] + H
    return hs.reshape(B, S, D, N), h_last


def _causal_conv(xp: torch.Tensor, w: torch.Tensor, S: int
                 ) -> torch.Tensor:
    """Depthwise causal conv along seq: sum_i xp[:, i:i+S] * w[i]."""
    conv = xp[:, 0:S] * w[0]
    for i in range(1, w.shape[0]):
        conv = conv + xp[:, i:i + S] * w[i]
    return conv


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                h0: Optional[torch.Tensor] = None, chunk: int = 16
                ) -> Tuple[torch.Tensor, SSMCache]:
    """Full-sequence Mamba block. x: (B, S, d_model) -> (B, S, d_model)."""
    d_inner, N, d_conv, dt_rank = _dims(cfg)
    B, S, _ = x.shape
    f32 = torch.float32
    xi_raw, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)   # (B, S, d_inner)

    padded = pad(xi_raw, (0, 0, d_conv - 1, 0))
    xi = torch.nn.functional.silu(_causal_conv(padded, p["conv_w"], S)
                                  + p["conv_b"])

    # on a mesh the projection sums d_inner's shards here (it is small)
    proj = settled((xi @ p["x_proj"]).to(f32))
    dt, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = softplus(dt @ p["dt_proj"].to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                              # (d_inner, N)
    xf = xi.to(f32)
    a = torch.exp(dt[..., None] * A)                        # (B,S,D,N)
    b = (dt * xf)[..., None] * Bm[:, :, None, :]            # (B,S,D,N)
    if h0 is None:
        h0 = torch.zeros((B, d_inner, N), dtype=f32, device=x.device)
    hs, h_last = _ssm_scan_chunked(a, b, h0, chunk)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm) + p["D"] * xf
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    out = y @ p["out_proj"]
    # the conv cache holds the last d_conv-1 PRE-activation conv inputs
    raw_tail = padded[:, S:S + d_conv - 1]
    return out, SSMCache(raw_tail.to(x.dtype), h_last)


def ssm_decode(p, x: torch.Tensor, cache: SSMCache, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, SSMCache]:
    """One-token Mamba step. x: (B, d_model). Returns new state tensors."""
    d_inner, N, d_conv, dt_rank = _dims(cfg)
    f32 = torch.float32
    xi_raw, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)   # (B, d_inner)

    window = torch.cat([cache.conv, xi_raw[:, None]], dim=1)
    conv = torch.einsum("bce,ce->be", window, p["conv_w"]) + p["conv_b"]
    xi = torch.nn.functional.silu(conv)

    # on a mesh the projection sums d_inner's shards here (it is small)
    proj = settled((xi @ p["x_proj"]).to(f32))
    dt, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = softplus(dt @ p["dt_proj"].to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xf = xi.to(f32)
    a = torch.exp(dt[..., None] * A)                        # (B, D, N)
    b = (dt * xf)[..., None] * Bm[:, None, :]
    h = a * cache.h + b
    y = torch.einsum("bdn,bn->bd", h, Cm) + p["D"] * xf
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    out = y @ p["out_proj"]
    return out, SSMCache(window[:, 1:], h)
