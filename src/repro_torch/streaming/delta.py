"""Fixed-capacity delta buffer: the mutable half of a streaming index
(port of ``repro/streaming/delta.py``).

Inserts land here as an append log: raw vectors (on the index's device),
norms, packed codes, range ids, global ids and a liveness bitmap (unused
slots and tombstoned inserts are dead). Queries scan the whole buffer with
the ``delta_scan`` kernel and merge the live slots into the base bucket
traversal in the canonical ``(rank, CSR position)`` order; the compactor
folds the log into a fresh CSR store and resets it.

Exact-merge bookkeeping, kept on the host in numpy:

  * ``ord`` — where each slot's ``(range_id, code)`` key falls against the
    base directory: ``2*i`` when it *is* directory bucket ``i`` (the slot
    joins that bucket, after its base members — delta ids are always
    larger), ``2*i - 1`` when it falls in the gap before bucket ``i``.
  * ``perm`` — the slots in ``(range_id, code, id)`` order, so that
    stable-sort ties land in canonical order.

Codes are uint32 on the host and the int32 view of the same bits on the
device; every order here compares the unsigned words.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

WORD_BITS = 32


def composite_key(rid: int, code_row: np.ndarray) -> int:
    """(range_id, packed code) as one arbitrary-precision int, ordered
    exactly like the CSR lexsort: rid major, then code words 0..W-1."""
    k = int(rid)
    for w in code_row:
        k = (k << WORD_BITS) | int(w)
    return k


class DirectoryKeys(NamedTuple):
    """The base bucket directory in ``(rid, code words)`` order (unsigned
    words), searched by :meth:`bisect_left` for all slots at once."""

    rid: np.ndarray       # (B,) int32
    codes: np.ndarray     # (B, W) uint32

    def __len__(self) -> int:
        return int(self.rid.shape[0])

    def bisect_left(self, rid: np.ndarray, codes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """For each key ``(rid[s], codes[s])``: the number of directory keys
        below it and whether the key is in the directory — the
        ``bisect_left`` of :func:`composite_key` over the directory, as one
        binary search over all keys at once."""
        b = len(self)
        key = [np.asarray(rid, np.int32)] + list(
            np.asarray(codes, np.uint32).T)
        n = key[0].shape[0]
        lo = np.zeros((n,), np.int64)
        hi = np.full((n,), b, np.int64)
        while b and (lo < hi).any():
            act = lo < hi
            mid = (lo + hi) // 2
            row = self._columns(np.minimum(mid, b - 1))
            less = np.zeros((n,), bool)          # row < key, last column up
            for r, k in zip(row[::-1], key[::-1]):
                less = (r < k) | ((r == k) & less)
            lo = np.where(act & less, mid + 1, lo)
            hi = np.where(act & ~less, mid, hi)
        hit = np.zeros((n,), bool)
        if b:
            row = self._columns(np.minimum(lo, b - 1))
            hit = lo < b
            for r, k in zip(row, key):
                hit &= r == k
        return lo, hit

    def _columns(self, at: np.ndarray) -> list:
        return [self.rid[at]] + list(self.codes[at].T)


def directory_keys(bucket_rid: np.ndarray, bucket_code: np.ndarray
                   ) -> DirectoryKeys:
    """The sorted base bucket directory as searchable keys (no copy)."""
    return DirectoryKeys(np.asarray(bucket_rid, np.int32),
                         np.asarray(bucket_code, np.uint32))


class DeltaBuffer:
    """Append log of recent inserts with tombstones (host-managed state,
    device tensors of fixed shape).

    Slots are assigned 0..capacity-1 in insert order and never recycled
    until the compactor resets the buffer — global id ``store_rows + slot``
    stays a bijection for the whole delta generation.
    """

    def __init__(self, capacity: int, dim: int, words: int, *,
                 device=None):
        if capacity < 1:
            raise ValueError("delta capacity must be >= 1")
        self.capacity = capacity
        self.dim = dim
        self.words = words
        self.device = resolve_device(device)
        self.count = 0
        # host mirrors (source of truth for host-side bookkeeping)
        self._norms = np.zeros((capacity,), np.float32)
        self._codes = np.zeros((capacity, words), np.uint32)
        self._rid = np.zeros((capacity,), np.int32)
        self._ids = np.zeros((capacity,), np.int32)
        self._live = np.zeros((capacity,), bool)
        self._ord = np.zeros((capacity,), np.int32)
        self._perm = np.arange(capacity, dtype=np.int32)
        # device tensors (what the merge reads)
        self.items = torch.zeros((capacity, dim), dtype=torch.float32,
                                 device=self.device)
        self._sync()

    # -- mutation ------------------------------------------------------------

    @property
    def free(self) -> int:
        return self.capacity - self.count

    @property
    def live_count(self) -> int:
        return int(self._live.sum())

    def append(self, vectors: torch.Tensor, norms: np.ndarray,
               codes: np.ndarray, rid: np.ndarray, ids: np.ndarray,
               dir_keys: DirectoryKeys) -> np.ndarray:
        """Append a batch; returns the assigned slots. Caller guarantees
        capacity (compact first) and supplies the current directory keys."""
        k = int(norms.shape[0])
        if k > self.free:
            raise ValueError(
                f"delta buffer overflow: appending {k} rows with only "
                f"{self.free}/{self.capacity} slots free (compact first)")
        slots = np.arange(self.count, self.count + k, dtype=np.int32)
        self._norms[slots] = norms
        self._codes[slots] = codes
        self._rid[slots] = rid
        self._ids[slots] = ids
        self._live[slots] = True
        self.count += k
        self.items[self.count - k:self.count] = torch.as_tensor(
            vectors, dtype=torch.float32, device=self.device)
        self.refresh_order(dir_keys)
        return slots

    def tombstone(self, slot: int, sync: bool = True) -> None:
        """Mark a slot dead; pass ``sync=False`` inside a batch and call
        :meth:`_sync` once after it (the sync re-uploads every array)."""
        if not 0 <= slot < self.count:
            raise IndexError(
                f"delta slot {slot} outside the occupied range "
                f"[0, {self.count})")
        if not self._live[slot]:
            raise ValueError(f"delta slot {slot} is already tombstoned")
        self._live[slot] = False
        if sync:
            self._sync()

    def update_members(self, slots: np.ndarray, rid: np.ndarray,
                       codes: np.ndarray, dir_keys: DirectoryKeys) -> None:
        """Repartition hook: range ids / codes of ``slots`` changed (range
        re-encode); recompute placement against the new directory."""
        self._rid[slots] = rid
        self._codes[slots] = codes
        self.refresh_order(dir_keys)

    def reset(self) -> None:
        """Compaction folded every slot into the base store."""
        self.count = 0
        self._live[:] = False
        self._ord[:] = 0
        self._perm = np.arange(self.capacity, dtype=np.int32)
        self._sync()

    def refresh_order(self, dir_keys: DirectoryKeys) -> None:
        """Recompute ``ord`` (placement vs the base directory) and ``perm``
        (canonical slot order) for the used slots, then push to device."""
        n = self.count
        if n:
            i, hit = dir_keys.bisect_left(self._rid[:n], self._codes[:n])
            self._ord[:n] = np.where(hit, 2 * i, 2 * i - 1)
            used = np.lexsort(tuple(
                [self._ids[:n]]
                + [self._codes[:n, w].astype(np.int64)
                   for w in range(self.words - 1, -1, -1)]
                + [self._rid[:n].astype(np.int64)]))
            self._perm = np.concatenate(
                [used.astype(np.int32),
                 np.arange(n, self.capacity, dtype=np.int32)])
        else:
            self._perm = np.arange(self.capacity, dtype=np.int32)
        self._sync()

    # -- device view ---------------------------------------------------------

    def _sync(self) -> None:
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.norms = dev(self._norms)
        self.codes = dev(self._codes.view(np.int32))
        self.rid = dev(self._rid)
        self.ids = dev(self._ids)
        self.live = dev(self._live)
        self.ord = dev(self._ord)
        self.perm = dev(self._perm)
