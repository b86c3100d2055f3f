"""LSH primitives for MIPS (port of ``repro/core/hashing.py``): norms,
the SIMPLE-LSH, L2-ALSH and SIGN-ALSH transforms, sign random projection
and the L2 LSH family, their collision probabilities, bit packing and
packed Hamming distance.

Packed codes are int32 tensors that hold the bits of the reference's
uint32 words: bit ``i`` of word ``w`` is code bit ``32 w + i``
(LSB-first), and the pad bits of the last word are zero. Every product
runs in full f32 (:func:`~repro_torch.kernels.ref.full_f32`), and the
collision probabilities in f32, as the reference computes them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

WORD_BITS = 32


def scalar_over(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` as one rounded division in ``t``'s dtype (a Python
    number over a tensor, ``c / t``, multiplies by ``1 / t`` instead)."""
    return torch.full_like(t, c) / t


def l2_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Euclidean norm ``sqrt(sum(x * x))`` in the input's precision (not
    ``torch.linalg.norm``, whose scaled algorithm rounds differently)."""
    return torch.sqrt(torch.sum(x * x, dim=dim))


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """Scale rows of ``x`` to unit 2-norm."""
    return x / torch.clamp_min(l2_norm(x, dim=dim)[..., None], eps)


def simple_lsh_transform(x: torch.Tensor) -> torch.Tensor:
    """SIMPLE-LSH item transform, eq. (8): ``P(x) = [x; sqrt(1-||x||^2)]``
    (``||x|| <= 1``)."""
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(x * x, dim=-1), 0.0))
    return torch.cat([x, tail[..., None]], dim=-1)


def simple_lsh_query_transform(q: torch.Tensor) -> torch.Tensor:
    """SIMPLE-LSH query transform, eq. (8): ``P(q) = [q / ||q||; 0]``."""
    q = normalize(q)
    return torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)


def _norm_powers(n2: torch.Tensor, m: int):
    """``||Ux||^2, ||Ux||^4, ..., ||Ux||^(2^m)`` by repeated squaring."""
    out, acc = [], n2
    for _ in range(m):
        out.append(acc)
        acc = acc * acc
    return out


def l2_alsh_item_transform(x: torch.Tensor, m: int, U: float
                           ) -> torch.Tensor:
    """L2-ALSH item transform, eq. (5):
    ``P(x) = [Ux; ||Ux||^2; ...; ||Ux||^(2^m)]`` (in f32, as the
    reference keeps it)."""
    ux = U * x
    tails = _norm_powers(torch.sum(ux * ux, dim=-1), m)
    return torch.cat([ux] + [t[..., None] for t in tails], dim=-1)


def l2_alsh_query_transform(q: torch.Tensor, m: int) -> torch.Tensor:
    """L2-ALSH query transform, eq. (5): ``Q(q) = [q/||q||; 1/2; ...]``."""
    q = normalize(q)
    return torch.cat([q, torch.full(q.shape[:-1] + (m,), 0.5,
                                    dtype=q.dtype, device=q.device)], dim=-1)


def sign_alsh_item_transform(x: torch.Tensor, m: int, U: float
                             ) -> torch.Tensor:
    """SIGN-ALSH item transform (Shrivastava & Li, UAI 2015):
    ``P(x) = [Ux; 1/2-||Ux||^2; ...; 1/2-||Ux||^(2^m)]``."""
    ux = U * x
    tails = _norm_powers(torch.sum(ux * ux, dim=-1), m)
    return torch.cat([ux] + [(0.5 - t)[..., None] for t in tails], dim=-1)


def sign_alsh_query_transform(q: torch.Tensor, m: int) -> torch.Tensor:
    """SIGN-ALSH query transform: ``Q(q) = [q/||q||; 0; ...; 0]``."""
    q = normalize(q)
    return torch.cat([q, q.new_zeros(q.shape[:-1] + (m,))], dim=-1)


def srp_projections(generator: torch.Generator, dim: int, n_bits: int, *,
                    device=None) -> torch.Tensor:
    """Random projection matrix (dim, n_bits), entries ~ N(0, 1), drawn
    from ``generator`` (which must live on ``device``)."""
    return torch.randn((dim, n_bits), generator=generator,
                       dtype=torch.float32, device=device)


def srp_hash(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Sign random projection, eq. (4): bits ``(x @ A >= 0)`` as uint8,
    (..., L), the product in full f32."""
    from repro_torch.kernels.ref import full_f32
    with full_f32():
        return (x @ A >= 0.0).to(torch.uint8)


def srp_hash_fused_simple(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``sign([x; sqrt(1-||x||^2)] @ A)`` with the augmentation folded
    into the projection: ``A`` is (d+1, L), ``x`` already normalized."""
    from repro_torch.kernels.ref import full_f32
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(x * x, dim=-1), 0.0))
    with full_f32():
        proj = x @ A[:-1] + tail[..., None] * A[-1]
    return (proj >= 0.0).to(torch.uint8)


def encode_packed(x: torch.Tensor, A: torch.Tensor, *,
                  fused_simple: bool = False) -> torch.Tensor:
    """Hash ``x`` with projections ``A`` and pack to int32 code words
    (``fused_simple``: ``A`` is (d+1, L) with the SIMPLE-LSH row last)."""
    bits = srp_hash_fused_simple(x, A) if fused_simple else srp_hash(x, A)
    return pack_bits(bits)


def l2_hash_params(generator: torch.Generator, dim: int, n_hashes: int,
                   r: float, *, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parameters of the L2 LSH family, eq. (2): ``a`` (dim, n_hashes)
    ~ N(0, I) and ``b`` (n_hashes,) ~ U[0, r), drawn from ``generator``."""
    a = torch.randn((dim, n_hashes), generator=generator,
                    dtype=torch.float32, device=device)
    b = torch.rand((n_hashes,), generator=generator, dtype=torch.float32,
                   device=device) * r
    return a, b


def l2_hash(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            r: float) -> torch.Tensor:
    """L2 LSH, eq. (2): ``h(x) = floor((x @ a + b) / r)`` as int32, the
    product in full f32."""
    from repro_torch.kernels.ref import full_f32
    with full_f32():
        proj = x @ a
    return torch.floor((proj + b) / r).to(torch.int32)


def srp_collision_prob(cos_sim: torch.Tensor) -> torch.Tensor:
    """Collision probability of sign random projection, eq. (4):
    ``p = 1 - acos(s)/pi``."""
    s = torch.clamp(torch.as_tensor(cos_sim, dtype=torch.float32), -1.0,
                    1.0)
    return 1.0 - torch.arccos(s) / math.pi


_SQRT2 = float(np.sqrt(np.float32(2.0)))
_SQRT_2PI = np.sqrt(np.float32(2.0 * math.pi))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two f32 values is exact in f64, so only the sum rounds
    (twice, f64 then f32, which differs from one rounding only on a
    2^-29-wide sliver of inputs)."""
    # repro-lint: allow[R5] an f32 product is exact in f64: one FMA rounding
    return (a.double() * b + c).float()


# The L2 collision probability (below) evaluates erf and exp as XLA's CPU
# code does, constant for constant, so that L2-ALSH's score table and
# probe ranks equal the reference's bit for bit. They were matched against
# the XLA of jax/jaxlib 0.9.0: should a later jaxlib change these
# approximations, a mismatch in that table is drift in the reference's
# toolchain, not a fault of the port. Nothing else uses them.
#
# the rational f32 erf that XLA emits (odd numerator, even denominator,
# Horner steps fused, the argument clamped where erf rounds to +-1)
_ERF_CLAMP = _f32(3.7439211627767994)
_ERF_ALPHA = tuple(_f32(v) for v in (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084))
_ERF_BETA = tuple(_f32(v) for v in (
    -1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
    0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0))
# the Cephes f32 exp that XLA emits: 2^m e^r with r = x - m ln 2 taken
# off in two fused steps, a degree-5 fused Horner polynomial, inputs
# below -104 clamped and results below the f32 normal range flushed to 0
_EXP_LOG2E = _f32(1.44269504088896341)
_EXP_C1, _EXP_C2 = _f32(-0.693359375), _f32(2.12194440e-4)
_EXP_P = tuple(_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_TINY = float(np.finfo(np.float32).tiny)


def _xla_erf_f32(x: torch.Tensor) -> torch.Tensor:
    """erf in f32, bit for bit the approximation XLA (jaxlib 0.9.0)
    evaluates; within a few ulps of ``torch.special.erf``."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = torch.full_like(x, _ERF_ALPHA[0])
    for c in _ERF_ALPHA[1:]:
        p = _fma(p, x2, c)
    q = torch.full_like(x, _ERF_BETA[0])
    for c in _ERF_BETA[1:]:
        q = _fma(q, x2, c)
    return (p * x) / q


def _xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp in f32, bit for bit XLA's (jaxlib 0.9.0) for arguments up to
    88 (the L2
    collision probability passes only arguments <= 0); within an ulp of
    ``torch.exp``."""
    x = torch.clamp_min(x, -104.0)
    m = torch.floor(_fma(x, _EXP_LOG2E, 0.5))
    r = _fma(m, _EXP_C2, _fma(m, _EXP_C1, x))
    y = torch.full_like(x, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    # repro-lint: allow[R5] 2^m of an integer m, exact in f64 before the cast
    out = y * torch.exp2(m.double()).float()
    return torch.where(out < _TINY, 0.0, out)


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + _xla_erf_f32(x / _SQRT2))


def l2_collision_prob(d, r: float) -> torch.Tensor:
    """Collision probability of the L2 LSH family, eq. (3), in f32:

    ``F_r(d) = 1 - 2 Phi(-r/d) - (2d / (sqrt(2 pi) r)) (1 - exp(-(r/d)^2/2))``.
    """
    d = torch.clamp_min(torch.as_tensor(d, dtype=torch.float32), 1e-12)
    rd = scalar_over(r, d)
    scale = float(_SQRT_2PI * np.float32(r))      # f32 sqrt(2 pi) * r
    return (1.0 - 2.0 * _std_normal_cdf(-rd)
            - (2.0 * d) / scale * (1.0 - _xla_exp_f32(-0.5 * rd * rd)))


def packed_words(n_bits: int) -> int:
    """Number of 32-bit words needed to hold ``n_bits``."""
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., L) array of {0, 1} into (..., ceil(L/32)) int32
    words, LSB-first, pad bits zero."""
    n = bits.shape[-1]
    w = packed_words(n)
    pad = w * WORD_BITS - n
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(bits.shape[:-1] + (w, WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    # reinterpret the unsigned word as the int32 with the same bits
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) int32 -> (..., n_bits)
    uint8."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    v = words.to(torch.int64)[..., None] & 0xFFFFFFFF
    bits = ((v >> shifts) & 1).reshape(words.shape[:-1] + (-1,))
    return bits[..., :n_bits].to(torch.uint8)


def hamming_distance_packed(a: torch.Tensor, b: torch.Tensor
                            ) -> torch.Tensor:
    """Hamming distance between broadcastable packed codes (..., W)."""
    from repro_torch.kernels.ref import popcount32
    return popcount32(torch.bitwise_xor(a, b)).sum(dim=-1,
                                                   dtype=torch.int32)


def hamming_matrix(q_codes: torch.Tensor, db_codes: torch.Tensor
                   ) -> torch.Tensor:
    """All-pairs Hamming distances: (Q, W) x (N, W) -> (Q, N) int32."""
    return hamming_distance_packed(q_codes[:, None, :], db_codes[None, :, :])
