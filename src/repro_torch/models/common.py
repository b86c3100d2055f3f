"""Shared model building blocks: norms, RoPE, init, dtype policy (port of
``repro/models/common.py``).

Parameters are plain nested dicts of tensors (bf16 by default, f32 norm
scales). Initializers draw from an explicit ``torch.Generator`` and create
their tensors on the generator's device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


# f32 elements drawn at once: a larger parameter is filled in slices, so
# that its f32 draw never holds more than 1 GiB beside the bf16 result (an
# expert stack of llama4 or jamba is 2.7-13 GB in f32)
INIT_CHUNK = 1 << 28


class MetaGenerator(torch.Generator):
    """A generator that reports the ``meta`` device, so that the
    initializers, which create their tensors on their generator's device,
    build shapes and dtypes and allocate nothing (torch has no meta
    generator of its own; a meta tensor's draw reads no random state)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _draw(shape: Tuple[int, ...], dtype, generator: torch.Generator,
          fill) -> torch.Tensor:
    """A ``dtype`` tensor of ``shape`` whose values ``fill`` draws in f32
    (``fill(x)`` returns the values for the f32 tensor ``x``), in slices
    of at most ``INIT_CHUNK`` elements; on ``meta``, the empty tensor."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if out.is_meta:
        return out
    flat = out.view(-1)
    for s in range(0, flat.numel(), INIT_CHUNK):
        x = torch.empty(min(INIT_CHUNK, flat.numel() - s),
                        dtype=torch.float32, device=generator.device)
        flat[s:s + x.numel()] = fill(x)
    return out


def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype=PARAM_DTYPE, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal (to ±2σ) fan-in init; ``shape`` may carry leading
    stack axes (the fan-in is ``shape[-2]``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return _draw(shape, dtype, generator, lambda x: std * torch.nn.init.
                 trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator))


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    # std d^-0.5 keeps tied unembedding logits O(1) (gemma-style input
    # scaling by sqrt(d) restores residual-stream magnitude where used).
    return _draw((vocab, d), dtype, generator,
                 lambda x: d ** -0.5 * x.normal_(generator=generator))


def unstack(tree, n: int) -> List:
    """The ``n`` per-layer views of a tree (nested dicts of tensors)
    stacked on its leading axis."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return list(torch.unbind(tree, 0))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm in f32, output back in the input dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)``."""
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotary position embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``(silu(x W_g) * (x W_u)) W_d``."""
    g = torch.nn.functional.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over masked positions; logits f32-softmaxed."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
