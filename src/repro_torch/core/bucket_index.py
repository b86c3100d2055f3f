"""Bucket store: the paper's hash table in CSR form (port of
``repro/core/bucket_index.py``).

Items are sorted by ``(range_id, code words, item id)``; ``item_ids``
maps a CSR position back to an item, ``bucket_start`` (B+1,) gives each
occupied ``(range, code)`` bucket its CSR run, and the directory
``(bucket_rid, bucket_code)`` is what queries scan. ``rank[j, l]`` is the
eq.-12 probe rank of a bucket of range ``j`` with ``l`` matching bits.

The build runs on the host in numpy, once per index, and the result is
moved to the index's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.probe import DEFAULT_EPS, probe_table


class BucketIndex(NamedTuple):
    """CSR bucket store over a packed-code index.

    Attributes:
      item_ids:     (N,)   int32 — item id at each CSR position.
      bucket_start: (B+1,) int32 — CSR offsets per bucket.
      bucket_rid:   (B,)   int32 — range id of each bucket.
      bucket_code:  (B, W) int32 — packed code of each bucket.
      rank:         (m, L+1) int32 — probe rank of each (j, l) pair.
      hash_bits:    int   — L.
      eps:          float — eq.-12 slack.
    """

    item_ids: torch.Tensor
    bucket_start: torch.Tensor
    bucket_rid: torch.Tensor
    bucket_code: torch.Tensor
    rank: torch.Tensor
    hash_bits: int
    eps: float

    @property
    def num_buckets(self) -> int:
        return self.bucket_rid.shape[0]

    @property
    def num_items(self) -> int:
        return self.item_ids.shape[0]

    @property
    def num_ranges(self) -> int:
        return self.rank.shape[0]


def rank_table(upper: torch.Tensor, hash_bits: int,
               eps: float = DEFAULT_EPS) -> torch.Tensor:
    """(m, L+1) int32 position of each ``(j, l)`` pair in eq.-12 order."""
    tab = probe_table(upper, hash_bits, eps)
    m = upper.shape[0]
    n = m * (hash_bits + 1)
    flat = torch.zeros((n,), dtype=torch.int32, device=upper.device)
    flat[(tab.range_idx * (hash_bits + 1) + tab.match_cnt).long()] = \
        torch.arange(n, dtype=torch.int32, device=upper.device)
    return flat.reshape(m, hash_bits + 1)


def rank_from_scores(table: torch.Tensor) -> torch.Tensor:
    """(R, K+1) int32 rank of each ``(range, match count)`` pair in the
    stable descending order of a family score table (0 = probed first)."""
    flat = table.reshape(-1)
    n = flat.shape[0]
    order = torch.argsort(-flat, stable=True)
    rank = torch.zeros((n,), dtype=torch.int32, device=table.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=table.device)
    return rank.reshape(table.shape)


def build_buckets(codes: torch.Tensor, range_id: torch.Tensor,
                  upper: torch.Tensor, hash_bits: int,
                  eps: float = DEFAULT_EPS, *,
                  rank: Optional[torch.Tensor] = None,
                  packed: bool = True) -> BucketIndex:
    """Assemble the CSR store from raw index arrays (host numpy), on the
    device of ``codes``. ``rank`` overrides the eq.-12 rank table.
    ``packed``: the codes are sign-bit words, sorted as the reference's
    uint32 words; else signed integer hashes (L2-ALSH), sorted signed."""
    device = codes.device
    c = codes.cpu().numpy()
    rid = range_id.cpu().numpy().astype(np.int64)
    n, w = c.shape
    # packed words sort unsigned: an int32 word with bit 31 set is negative
    # and would sort before the small codes
    words = (c.view(np.uint32) if packed else c).astype(np.int64)
    keys = [words[:, j] for j in range(w - 1, -1, -1)] + [rid]
    order = np.lexsort(tuple(keys))          # stable: ties keep item id
    c_s = c[order]
    rid_s = rid[order]
    new = np.ones((n,), bool)
    if n > 1:
        new[1:] = (rid_s[1:] != rid_s[:-1]) | np.any(
            c_s[1:] != c_s[:-1], axis=1)
    first = np.flatnonzero(new)
    bucket_start = np.concatenate([first, [n]]).astype(np.int32)
    if rank is None:
        rank = rank_table(upper, hash_bits, eps)
    return BucketIndex(
        item_ids=torch.from_numpy(order.astype(np.int32)).to(device),
        bucket_start=torch.from_numpy(bucket_start).to(device),
        bucket_rid=torch.from_numpy(rid_s[first].astype(np.int32)).to(device),
        bucket_code=torch.from_numpy(np.ascontiguousarray(c_s[first])
                                     ).to(device),
        rank=rank.to(device),
        hash_bits=hash_bits,
        eps=eps,
    )


def build_bucket_index(index) -> BucketIndex:
    """The bucket store of any supported index: a spec-built
    :class:`~repro_torch.core.index.ComposedIndex` (its family score table
    defines the probe rank), a legacy ``RangeLSHIndex`` (``range_id``,
    raw per-range ``upper``, ``hash_bits``, ``eps``: the eq.-12 rank
    table) or ``SimpleLSHIndex`` (one range at the global max norm U;
    eq. 12 with m = 1 is Hamming order)."""
    if getattr(index, "codes", None) is not None and index.codes.ndim == 3:
        raise ValueError("multi-table single-probe has no bucket store; "
                         "query it via its own candidate_scores/query")
    if hasattr(index, "table"):
        return build_buckets(index.codes, index.range_id, index.upper_eff,
                             index.hash_bits, index.eps,
                             rank=rank_from_scores(index.table),
                             packed=index.family.packed)
    if hasattr(index, "range_id"):
        # raw per-range upper, as probe.item_scores: empty ranges are never
        # referenced by a bucket, so their table entries are inert
        return build_buckets(index.codes, index.range_id, index.upper,
                             index.hash_bits, index.eps)
    codes = index.codes
    rid = torch.zeros((codes.shape[0],), dtype=torch.int32,
                      device=codes.device)
    upper = torch.as_tensor(index.U, dtype=torch.float32,
                            device=codes.device).reshape(1)
    return build_buckets(codes, rid, upper, index.code_len, DEFAULT_EPS)


def bucket_sizes(bidx: BucketIndex) -> torch.Tensor:
    """(B,) int32 item count per bucket."""
    return bidx.bucket_start[1:] - bidx.bucket_start[:-1]

