"""LSH primitives of the main path: norms, SIMPLE-LSH projections, bit
packing and packed Hamming distance (port of ``repro/core/hashing.py``).

Packed codes are int32 tensors that hold the bits of the reference's
uint32 words: bit ``i`` of word ``w`` is code bit ``32 w + i``
(LSB-first), and the pad bits of the last word are zero.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def l2_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Euclidean norm ``sqrt(sum(x * x))`` in the input's precision (not
    ``torch.linalg.norm``, whose scaled algorithm rounds differently)."""
    return torch.sqrt(torch.sum(x * x, dim=dim))


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """Scale rows of ``x`` to unit 2-norm."""
    return x / torch.clamp_min(l2_norm(x, dim=dim)[..., None], eps)


def srp_projections(generator: torch.Generator, dim: int, n_bits: int, *,
                    device=None) -> torch.Tensor:
    """Random projection matrix (dim, n_bits), entries ~ N(0, 1), drawn
    from ``generator`` (which must live on ``device``)."""
    return torch.randn((dim, n_bits), generator=generator,
                       dtype=torch.float32, device=device)


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
