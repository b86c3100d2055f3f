"""Shared model building blocks: norms, RoPE, init, dtype policy (port of
``repro/models/common.py``).

Parameters are plain nested dicts of tensors (bf16 by default, f32 norm
scales). Initializers draw from an explicit ``torch.Generator`` and create
their tensors on the generator's device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

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


def scan(step: Callable, carry, xs, *, dim: int = 1):
    """The port's ``jax.lax.scan`` over dimension ``dim`` of ``xs`` (a
    tensor, or a tuple of tensors of one length there): ``step(carry,
    x_t) -> (carry, y_t)`` for each slice ``x_t`` in order; returns the
    last carry and the ``y_t`` stacked along ``dim``.

    On real tensors it is that loop. On ``meta`` tensors (the dry run)
    it does not run every trip: as the reference lowers one while body
    and counts it once a trip, the body is traced for the first trip, one
    middle trip standing for the ``length - 2`` middle ones, and the last.
    The middle trip runs inside ``parallel.collectives.repeat(length -
    2)`` and its autograd nodes are marked the same
    (``repeat_backward``), so the collective recorder notes what the loop
    and its backward issue as often as the eager loop issues it: the
    first trip is the only one whose carry is the initial state, the last
    the only one whose carry gets no gradient from a next trip. The
    middle trip's ``y`` is expanded to its trips along ``dim``."""
    many = isinstance(xs, (tuple, list))
    seq = tuple(xs) if many else (xs,)
    length = seq[0].shape[dim]

    if not seq[0].is_meta or length < 3:
        # one unbind a tensor: its backward stacks the slices' gradients
        # once, where a select a step would fill a whole zero gradient
        # each (O(length^2) bytes)
        ys = []
        for x_t in zip(*(x.unbind(dim) for x in seq)):
            carry, y = step(carry, x_t if many else x_t[0])
            ys.append(y)
        return carry, torch.stack(ys, dim)
    from repro_torch.parallel import collectives

    def at(t):
        sl = tuple(x.select(dim, t) for x in seq)
        return sl if many else sl[0]

    carry, first = step(carry, at(0))
    since = collectives.autograd_mark()
    with collectives.repeat(length - 2):
        carry, mid = step(carry, at(1))
    if torch.is_grad_enabled():
        collectives.repeat_backward(length - 2, _tensors(carry) + [mid],
                                    since, collectives.autograd_mark())
    carry, last = step(carry, at(length - 1))
    shape = list(mid.unsqueeze(dim).shape)
    shape[dim] = length - 2
    return carry, torch.cat([first.unsqueeze(dim),
                             mid.unsqueeze(dim).expand(shape),
                             last.unsqueeze(dim)], dim)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm in f32, output back in the input dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def _settled_dtensor(x):
    """``x`` with its partial sums reduced if it is a DTensor (the one
    reduction the fused op would do), else None."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return None
    from repro_torch.parallel.sharding import settled
    return settled(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x)``. On a DTensor in the reference's elementary form,
    ``max(x, 0) + log1p(exp(-|x|))`` (jax's ``logaddexp(x, 0)``), its
    partial sums reduced once first: DTensor has no sharding rule for
    ``softplus_backward`` in every torch."""
    d = _settled_dtensor(x)
    if d is None:
        return torch.nn.functional.softplus(x)
    return torch.clamp_min(d, 0.0) + torch.log1p(torch.exp(-torch.abs(d)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``logsigmoid(x)``. On a DTensor in the reference's form,
    ``-softplus(-x) = min(x, 0) - log1p(exp(-|x|))``, its partial sums
    reduced once first: DTensor has no sharding rule for
    ``log_sigmoid_backward``."""
    d = _settled_dtensor(x)
    if d is None:
        return torch.nn.functional.logsigmoid(x)
    return torch.clamp_max(d, 0.0) - torch.log1p(torch.exp(-torch.abs(d)))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)``."""
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature term ``0.1 mscale ln(factor) + 1``
    (1 for a factor of at most 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def _yarn_correction_dim(rotations: float, dim: int, theta: float,
                         positions: int) -> float:
    """The rotary dimension whose wavelength fits ``rotations`` turns into
    ``positions`` positions."""
    return (dim * math.log(positions / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def yarn_freqs(head_dim: int, theta: float, yarn, device=None
               ) -> torch.Tensor:
    """YaRN's inverse frequencies (``configs.base.YarnConfig``): pair i
    keeps its original frequency below the correction dimension of
    ``beta_fast`` rotations, takes the ``factor``-times slower one above
    that of ``beta_slow``, and the linear ramp between blends the two."""
    base = rope_freqs(head_dim, theta, device)
    half = head_dim // 2
    lo = max(math.floor(_yarn_correction_dim(
        yarn.beta_fast, head_dim, theta, yarn.original_max_position)), 0)
    hi = min(math.ceil(_yarn_correction_dim(
        yarn.beta_slow, head_dim, theta, yarn.original_max_position)),
        head_dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                     device=device) - lo) / (hi - lo), 0, 1)
    return base / yarn.factor * ramp + base * (1 - ramp)


def yarn_cos_sin_factor(yarn) -> float:
    """The factor on YaRN's cos and sin (1 where ``mscale`` equals
    ``mscale_all_dim``, as in DeepSeek-V2)."""
    return (yarn_mscale(yarn.factor, yarn.mscale)
            / yarn_mscale(yarn.factor, yarn.mscale_all_dim))


def yarn_softmax_factor(yarn) -> float:
    """The factor on the attention's softmax scale under YaRN:
    ``yarn_mscale(factor, mscale_all_dim)`` squared (1 without YaRN or
    with ``mscale_all_dim`` 0)."""
    if yarn is None or not yarn.mscale_all_dim:
        return 1.0
    return yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None) -> torch.Tensor:
    """Rotary position embedding, the half-split layout (pair i rotates
    columns i and hd/2 + i). x: (..., S, H, hd); positions: (..., S).
    ``scaling``: a ``configs.base.YarnConfig`` (YaRN frequencies and
    cos/sin factor) or None."""
    hd = x.shape[-1]
    if scaling is None:
        freqs = rope_freqs(hd, theta, x.device)            # (hd/2,)
    else:
        freqs = yarn_freqs(hd, theta, scaling, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    if scaling is not None:
        f = yarn_cos_sin_factor(scaling)
        if f != 1.0:
            cos, sin = cos * f, sin * f
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


def split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., n_heads * hd) -> (..., n_heads, hd). A DTensor sharded along
    its last dimension over a number of ranks that does not divide
    ``n_heads`` (12 heads on a 16-wide ``model`` axis) is replicated on
    those mesh dimensions first: a head is never split across ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(t, DTensor):
        last = Shard(t.dim() - 1)
        n = 1
        for dim, pl in enumerate(t.placements):
            if pl == last:
                n *= t.device_mesh.size(dim)
        if n > 1 and n_heads % n:
            t = t.redistribute(t.device_mesh, [
                Replicate() if pl == last else pl for pl in t.placements])
    return t.reshape(t.shape[:-1] + (n_heads, t.shape[-1] // n_heads))


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n_heads, hd) -> (..., n_heads * hd). On a DTensor the result
    passes through a ``redistribute`` to its own placements: a no-op
    forward, whose backward brings the gradient back to those placements
    before the reshape's, so a gradient sharded along the merged
    dimension is never split into heads unevenly; heads sharded over more
    ranks than divide them, a sharded head width and partial sums are
    replicated first (the inverse of :func:`split_heads`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(t, DTensor):
        heads, width = Shard(t.dim() - 2), Shard(t.dim() - 1)
        n = 1
        for dim, pl in enumerate(t.placements):
            if pl == heads:
                n *= t.device_mesh.size(dim)
        uneven = n > 1 and t.shape[-2] % n

        def whole(pl):
            return (pl.is_partial() or pl == width
                    or (uneven and pl == heads))
        if any(whole(pl) for pl in t.placements):
            t = t.redistribute(t.device_mesh, [
                Replicate() if whole(pl) else pl for pl in t.placements])
    out = t.reshape(t.shape[:-2] + (-1,))
    if isinstance(out, DTensor):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``, an embedding lookup. On a mesh (``table`` a
    DTensor) the table keeps its vocabulary shards and gathers any other
    split; each rank looks up the tokens that fall in its vocabulary slice
    (zero rows elsewhere), and the result is a partial sum over the
    vocabulary's mesh dimensions that the next op reduces."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return torch.nn.functional.embedding(tokens, table)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, vocab = table.device_mesh, Shard(0)
    tpl = tuple(vocab if pl == vocab else Replicate()
                for pl in table.placements)
    table = table.redistribute(mesh, tpl)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    kpl = tuple(pl if pl == Shard(0) and tpl[d] != vocab else Replicate()
                for d, pl in enumerate(tokens.placements))
    tok = tokens.redistribute(mesh, kpl).to_local()
    local = table.to_local()
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, tpl)
    at = tok - offset[0]
    inside = (at >= 0) & (at < local.shape[0])
    rows = torch.nn.functional.embedding(
        at.clamp(0, max(local.shape[0] - 1, 0)), local)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(
        rows, mesh, tuple(Partial() if tpl[d] == vocab else kpl[d]
                          for d in range(mesh.ndim)),
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= int(d)
    return tuple(stride)


def pad(t: torch.Tensor, widths) -> torch.Tensor:
    """``torch.nn.functional.pad(t, widths)`` with zeros. On a DTensor the
    padded dimensions are gathered whole first and each rank pads its
    local tensor (partial sums stay partial: zeros add nothing)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return torch.nn.functional.pad(t, widths)
    grown = {t.dim() - 1 - i // 2: 0 for i in range(len(widths))}
    for i, w in enumerate(widths):
        grown[t.dim() - 1 - i // 2] += w
    pl = tuple(Replicate() if isinstance(p_, Shard) and grown.get(p_.dim)
               else p_ for p_ in t.placements)
    t = t.redistribute(t.device_mesh, pl)
    shape = tuple(n + grown.get(d, 0) for d, n in enumerate(t.shape))
    return DTensor.from_local(
        torch.nn.functional.pad(t.to_local(), widths), t.device_mesh, pl,
        run_check=False, shape=shape, stride=_contiguous_stride(shape))
