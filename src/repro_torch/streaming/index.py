"""Mutable norm-range index: the streaming service core (port of
``repro/streaming/index.py``).

Layers a mutable surface over the immutable structures without giving up
their guarantees:

  * **storage** — append-only rows of every item ever assigned an id
    (id == storage row, stable forever; vectors on the index's device,
    norms, codes, range ids and liveness in host numpy). The CSR bucket
    store covers the rows that were live at its last rebuild; rows deleted
    since stay in CSR as tombstones, masked at query time and bounded by
    ``max_tombstones`` (exceeding it triggers compaction), which is what
    makes the query-time over-probe ``num_probe + max_tombstones`` safe.
  * **delta buffer** — recent inserts (:mod:`repro_torch.streaming.delta`),
    encoded under the frozen hash functions and the current per-range
    bounds, so a from-scratch rebuild over the mutated dataset produces
    the same codes.
  * **compactor** — folds the delta into storage and rebuilds the CSR.
  * **drift-triggered repartition** — inserts that overflow ``U_j`` (or
    land in an empty uniform bin) and occupancy skew repartition only the
    affected ranges: a range's items are contiguous in CSR (rid-major
    sort), so re-encode + re-sort is spliced into the store in place.
    ``repartition_policy="full"`` rebuilds everything instead.

With a tracker (``MutableIndex(tracker=)``, ``set_tracker`` or the
ambient one), writes count ``repro.streaming.inserts``/``deletes``, each
query batch runs in a ``repro.streaming.query`` span and records
``queries`` and ``probe_width``, every structural event is also a typed
``repro.streaming.<kind>`` event, and ``stats()`` reports the drift
monitor's gauges.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing, range_lsh
from repro_torch.core.bucket_index import BucketIndex, rank_from_scores
from repro_torch.core.engine import select_engine
from repro_torch.core.family import HashFamily, SimpleLSHFamily
from repro_torch.core.probe import DEFAULT_EPS
from repro_torch.obs.trace import span_or_null
from repro_torch.obs.tracker import resolve_tracker
from repro_torch.streaming.delta import DeltaBuffer, directory_keys
from repro_torch.streaming.drift import (DEFAULT_MIN_SKEW_COUNT,
                                         DEFAULT_SKEW_RATIO, DriftMonitor)
from repro_torch.streaming.engine import merged_candidates, merged_rerank

DEFAULT_CAPACITY = 1024
DEFAULT_MAX_TOMBSTONES = 256


class _CSR(NamedTuple):
    """Host-side CSR mirror (numpy) — the splice target for localized
    repartition; ``item_ids`` hold *global* storage rows."""

    item_ids: np.ndarray      # (Ncsr,)  int32
    bucket_start: np.ndarray  # (B+1,)   int32
    bucket_rid: np.ndarray    # (B,)     int32
    bucket_code: np.ndarray   # (B, W)   uint32
    csr_bucket: np.ndarray    # (Ncsr,)  int32 — bucket of each CSR position
    csr_codes: np.ndarray     # (Ncsr, W) uint32
    csr_rid: np.ndarray       # (Ncsr,)  int32


def _csr_from_rows(codes: np.ndarray, rid: np.ndarray, rows: np.ndarray
                   ) -> _CSR:
    """CSR over the given storage ``rows`` (ascending), same sort contract
    as ``core.bucket_index.build_buckets``: (range_id, code words, id),
    the words compared unsigned."""
    c = codes[rows]
    r = rid[rows].astype(np.int64)
    n, w = c.shape
    order = np.lexsort(tuple(
        [c[:, j].astype(np.int64) for j in range(w - 1, -1, -1)] + [r]))
    c_s = c[order]
    r_s = r[order]
    new = np.ones((n,), bool)
    if n > 1:
        new[1:] = (r_s[1:] != r_s[:-1]) | np.any(c_s[1:] != c_s[:-1], axis=1)
    first = np.flatnonzero(new)
    bucket_start = np.concatenate([first, [n]]).astype(np.int32)
    sizes = np.diff(bucket_start)
    return _CSR(
        item_ids=rows[order].astype(np.int32),
        bucket_start=bucket_start,
        bucket_rid=r_s[first].astype(np.int32),
        bucket_code=c_s[first].astype(np.uint32),
        csr_bucket=np.repeat(np.arange(first.size, dtype=np.int32), sizes),
        csr_codes=c_s.astype(np.uint32),
        csr_rid=r_s.astype(np.int32),
    )


def partition_edges(norms: np.ndarray, m: int, scheme: str) -> np.ndarray:
    """(m-1,) interior norm boundaries for assigning *future* inserts under
    frozen partition semantics (``searchsorted(edges, norm, 'left')``)."""
    if m <= 1:
        return np.zeros((0,), np.float32)
    if scheme == "percentile":
        s = np.sort(norms)
        n = s.shape[0]
        # max norm of slab j (ranks [ceil(jn/m), ceil((j+1)n/m)) per Alg. 1)
        idx = np.minimum(np.ceil(np.arange(1, m) * n / m).astype(np.int64),
                         n) - 1
        return s[idx].astype(np.float32)
    if scheme == "uniform":
        lo, hi = float(np.min(norms)), float(np.max(norms))
        width = max(hi - lo, 1e-12)
        return (lo + width * np.arange(1, m) / m).astype(np.float32)
    raise ValueError(f"unknown partition scheme: {scheme!r}")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class MutableIndex:
    """Mutable RANGE-LSH / SIMPLE-LSH index: insert/delete/query/compact.

    Global ids are storage rows (stable across compactions: a delta slot
    ``s`` becomes storage row ``N_store + s`` when folded). Queries are
    identical to a from-scratch rebuild of the mutated dataset under the
    frozen hash functions and current bounds (tested against the JAX
    package). Tensors live on ``device``: the card unless ``device="cpu"``.
    """

    def __init__(self, *, items, norms: np.ndarray,
                 codes: np.ndarray, range_id: np.ndarray, live: np.ndarray,
                 upper: np.ndarray, lower: np.ndarray, edges: np.ndarray,
                 A, code_len: int, hash_bits: int, eps: float,
                 capacity: int = DEFAULT_CAPACITY,
                 max_tombstones: int = DEFAULT_MAX_TOMBSTONES,
                 skew_ratio: float = DEFAULT_SKEW_RATIO,
                 min_skew_count: int = DEFAULT_MIN_SKEW_COUNT,
                 repartition_policy: str = "localized",
                 engine: str = "auto", impl: str = "auto",
                 csr: Optional[_CSR] = None,
                 delta: Optional[DeltaBuffer] = None, tomb_csr: int = 0,
                 family: Optional[HashFamily] = None, tracker=None,
                 device=None):
        if repartition_policy not in ("localized", "full"):
            raise ValueError(f"unknown policy {repartition_policy!r}")
        # observability first: structural paths below may emit events
        self.tracker = resolve_tracker(tracker)
        self.family = SimpleLSHFamily() if family is None else family
        if not self.family.packed:
            raise ValueError(
                f"streaming indexes need packed sign codes; family "
                f"{self.family.name!r} produces integer hashes")
        self.device = resolve_device(device)
        self.items = torch.as_tensor(items, dtype=torch.float32,
                                     device=self.device)
        self._norms = np.asarray(norms, np.float32).copy()
        self._codes = np.asarray(codes, np.uint32).copy()
        self._rid = np.asarray(range_id, np.int32).copy()
        self._live = np.asarray(live, bool).copy()
        self.upper = np.asarray(upper, np.float32).copy()
        self.lower = np.asarray(lower, np.float32).copy()
        self.edges = np.asarray(edges, np.float32).copy()
        self.A = torch.as_tensor(A, dtype=torch.float32, device=self.device)
        self.code_len = int(code_len)
        self.hash_bits = int(hash_bits)
        self.eps = float(eps)
        self.capacity = int(capacity)
        self.max_tombstones = int(max_tombstones)
        self.repartition_policy = repartition_policy
        self.engine = engine
        self.impl = impl
        self.num_compactions = 0
        self.num_repartitions = 0
        self.num_full_rebuilds = 0
        self.events: List[dict] = []
        self.tomb_csr = int(tomb_csr)
        # planner calibration: measured recall curves are only as good as
        # the partition they were measured under, so any event that moves
        # range boundaries flags them stale.
        self.calib = None
        self.calib_stale = False
        # ranges whose skew couldn't be rebalanced (e.g. all norms equal):
        # muted until the next structural event, so duplicate-heavy traffic
        # doesn't pay an O(N) no-op rebalance attempt per insert batch.
        self._skew_muted: set = set()
        if delta is None:
            delta = DeltaBuffer(self.capacity, int(self.items.shape[1]),
                                int(self._codes.shape[1]),
                                device=self.device)
        self.delta = delta
        if csr is None:
            self._rebuild_csr()
        else:
            self._csr = csr
            self.dir_keys = directory_keys(csr.bucket_rid, csr.bucket_code)
            self._push_csr()
            self._push_live()
        self.monitor = DriftMonitor(
            self._count_live(), self._norms, self._rid,
            skew_ratio=skew_ratio, min_skew_count=min_skew_count)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_range_lsh(cls, index: "range_lsh.RangeLSHIndex", *,
                       scheme: str = "percentile", **kw) -> "MutableIndex":
        """Mount a legacy :class:`~repro_torch.core.range_lsh.RangeLSHIndex`
        on the index's device."""
        norms = _host(index.norms)
        return cls(items=index.items, norms=norms,
                   codes=_host(index.codes).view(np.uint32),
                   range_id=_host(index.range_id),
                   live=np.ones((norms.shape[0],), bool),
                   upper=_host(index.upper), lower=_host(index.lower),
                   edges=partition_edges(norms, index.num_ranges, scheme),
                   A=index.A, code_len=index.code_len,
                   hash_bits=index.hash_bits, eps=index.eps,
                   **{"device": index.items.device, **kw})

    @classmethod
    def from_composed(cls, cidx, **kw) -> "MutableIndex":
        """Mount a spec-built :class:`repro_torch.core.index.ComposedIndex`
        of a packed family (SIMPLE-LSH or SIGN-ALSH), flat with m = 1 or
        ranged, on the index's device."""
        norms = _host(cidx.norms)
        return cls(items=cidx.items, norms=norms,
                   codes=_host(cidx.codes).view(np.uint32),
                   range_id=_host(cidx.range_id),
                   live=np.ones((norms.shape[0],), bool),
                   upper=_host(cidx.upper), lower=_host(cidx.lower),
                   edges=partition_edges(norms, int(cidx.upper.shape[0]),
                                         cidx.spec.scheme),
                   A=cidx.params, code_len=cidx.spec.code_len,
                   hash_bits=cidx.hash_bits, eps=cidx.eps,
                   family=cidx.family,
                   **{"impl": cidx.spec.impl,
                      "device": cidx.items.device, **kw})

    @classmethod
    def from_simple_lsh(cls, index, **kw) -> "MutableIndex":
        """Mount a legacy :class:`~repro_torch.core.simple_lsh.SimpleLSHIndex`
        (one range at the global max norm U) on the index's device."""
        norms = _host(index.norms)
        return cls(items=index.items, norms=norms,
                   codes=_host(index.codes).view(np.uint32),
                   range_id=np.zeros((norms.shape[0],), np.int32),
                   live=np.ones((norms.shape[0],), bool),
                   upper=np.asarray([float(index.U)], np.float32),
                   lower=np.asarray([float(norms.min())], np.float32),
                   edges=np.zeros((0,), np.float32),
                   A=index.A, code_len=index.code_len,
                   hash_bits=index.code_len, eps=DEFAULT_EPS,
                   **{"device": index.items.device, **kw})

    # -- sizes ---------------------------------------------------------------

    @property
    def store_size(self) -> int:
        return int(self._norms.shape[0])

    @property
    def num_ranges(self) -> int:
        return int(self.upper.shape[0])

    @property
    def num_csr_items(self) -> int:
        return int(self._csr.item_ids.shape[0])

    @property
    def live_count(self) -> int:
        return int(self._live.sum()) + self.delta.live_count

    # -- mutation ------------------------------------------------------------

    def insert(self, vectors) -> np.ndarray:
        """Insert a (k, d) batch (or one (d,) vector); returns global ids.

        Overflow/skew drift events are handled before encoding, so codes
        always reflect the final bounds. Auto-compacts when the delta is
        full or the batch alone exceeds capacity (chunked)."""
        vectors = torch.as_tensor(vectors, dtype=torch.float32,
                                  device=self.device)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        k = int(vectors.shape[0])
        if k > self.capacity:
            return np.concatenate([self.insert(vectors[i:i + self.capacity])
                                   for i in range(0, k, self.capacity)])
        norms = _host(hashing.l2_norm(vectors))
        rid = self._assign(norms)
        for j in np.unique(rid):
            in_j = norms[rid == j]
            top = float(in_j.max())
            old_lo = float(self.lower[j])
            self.lower[j] = min(old_lo, float(in_j.min())) \
                if old_lo > 0.0 else float(in_j.min())
            if DriftMonitor.overflow(top, float(self.upper[j])):
                self._handle_overflow(int(j), max(top, float(self.upper[j])))
        if self.delta.free < k:
            self.compact()
        codes = self._encode(vectors, rid)
        ids = self.store_size + np.arange(self.delta.count,
                                          self.delta.count + k,
                                          dtype=np.int32)
        self.delta.append(vectors, norms, codes, rid, ids, self.dir_keys)
        for r, n in zip(rid, norms):
            self.monitor.observe_insert(int(r), float(n))
        j = self.monitor.skew_range()
        if j is not None and j not in self._skew_muted:
            self._rebalance(j)
        if self.tracker is not None:
            self.tracker.count("repro.streaming.inserts", k)
            self.tracker.observe("repro.streaming.insert_batch", k)
        return ids

    def delete(self, ids) -> None:
        """Tombstone items by global id. Unknown/already-deleted ids raise.
        Auto-compacts when CSR tombstones exceed ``max_tombstones``."""
        n_store = self.store_size
        ids_arr = np.atleast_1d(np.asarray(ids, np.int64))
        if np.unique(ids_arr).size != ids_arr.size:
            raise ValueError("duplicate ids in delete batch")
        # validate the whole batch before mutating anything — a bad id
        # must not leave a half-applied batch or stale device mirrors
        for i in ids_arr:
            i = int(i)
            if i >= n_store:
                slot = i - n_store
                if not (0 <= slot < self.delta.count
                        and self.delta._live[slot]):
                    raise KeyError(f"unknown or deleted id {i}")
            elif not (0 <= i < n_store and self._live[i]):
                raise KeyError(f"unknown or deleted id {i}")
        delta_hits = False
        for i in ids_arr:
            i = int(i)
            if i >= n_store:
                slot = i - n_store
                self.delta.tombstone(slot, sync=False)
                delta_hits = True
                self.monitor.observe_delete(int(self.delta._rid[slot]))
            else:
                self._live[i] = False
                self.tomb_csr += 1
                self.monitor.observe_delete(int(self._rid[i]))
        if delta_hits:
            self.delta._sync()
        self._push_live()
        if self.tracker is not None:
            self.tracker.count("repro.streaming.deletes", ids_arr.size)
        if self.tomb_csr > self.max_tombstones:
            self.compact()

    def compact(self) -> None:
        """Fold the delta into storage and rebuild the CSR store — results
        are unchanged (parity), shapes and costs reset."""
        self._fold_delta()
        self._rebuild_csr()
        self.delta.refresh_order(self.dir_keys)
        self.monitor.set_counts(self._count_live())
        self.num_compactions += 1
        self._event("compaction")

    def rebuild_full(self) -> None:
        """The non-localized baseline: fold the delta, re-encode *every*
        live item under the current bounds, rebuild the whole CSR."""
        self._fold_delta()
        rows = np.flatnonzero(self._live)
        if rows.size:
            self._codes[rows] = self._encode_rows(self.items, rows,
                                                  self._rid[rows])
        self._rebuild_csr()
        self.delta.refresh_order(self.dir_keys)
        self.monitor.set_counts(self._count_live())
        self.num_full_rebuilds += 1
        self._event("full_rebuild")

    # -- query ---------------------------------------------------------------

    def set_calibration(self, calib) -> None:
        """Attach a :class:`repro_torch.core.planner.CalibrationTable` (from
        ``planner.calibrate_streaming``); clears the stale flag."""
        self.calib = calib
        self.calib_stale = False

    def _invalidate_calibration(self, why: str) -> None:
        if self.calib is not None and not self.calib_stale:
            self.calib_stale = True
            self._event("calibration_stale", why=why)

    def encode_queries(self, queries) -> torch.Tensor:
        return self.family.encode_queries(
            self.A, torch.as_tensor(queries, dtype=torch.float32,
                                    device=self.device), impl=self.impl)

    def candidates(self, queries, num_probe: int) -> torch.Tensor:
        """(Q, num_probe) global ids in canonical merged probe order.

        Strict parity surface: every emitted id is live, so ``num_probe``
        must not exceed the live count."""
        num_probe = int(num_probe)
        if not 0 < num_probe <= self.live_count:
            raise ValueError(f"num_probe={num_probe} outside (0, "
                             f"{self.live_count}]")
        return self._candidates(queries, num_probe)

    def _candidates(self, queries, num_probe: int) -> torch.Tensor:
        """Unchecked candidate generation; past the live count the tail is
        tombstoned rows (they sort last — re-rank masks them)."""
        q_codes = self.encode_queries(queries)
        n_csr = self.num_csr_items
        probe_base = min(n_csr, num_probe + self.max_tombstones)
        engine = self.engine
        if engine == "auto":
            engine = select_engine(int(self._csr.bucket_rid.shape[0]),
                                   max(n_csr, 1))
        return merged_candidates(
            self._arrs(), q_codes, num_probe=num_probe,
            probe_base=probe_base, hash_bits=self.hash_bits, engine=engine,
            impl=self.impl)

    def query(self, queries, k: int, num_probe: Optional[int] = None, *,
              recall_target: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probe + exact re-rank: (vals, global ids), each (Q, k).

        ``num_probe`` is capped at the total row count (CSR + delta), not
        the live count, so callers may pass a fixed budget (dead tail
        entries re-rank to ``-inf``).

        ``recall_target`` plans the budget from the attached calibration
        (the merged engine has one global probe order, so the scalar
        ``plan_global`` curve applies); a structural event that moved
        range boundaries marks the calibration stale and the contract
        unenforceable until ``set_calibration`` refreshes it."""
        if recall_target is not None:
            if num_probe is not None:
                raise ValueError("pass one of num_probe/recall_target")
            if self.calib is None:
                raise ValueError(
                    "recall_target needs planner.calibrate_streaming() "
                    "attached via set_calibration()")
            if self.calib_stale:
                raise ValueError(
                    "calibration is stale (a repartition moved range "
                    "boundaries) — recalibrate before planning")
            from repro_torch.core.planner import check_contract_k, plan_global
            check_contract_k(self.calib, k)
            num_probe = plan_global(self.calib, recall_target).num_probe
        if num_probe is None:
            raise ValueError("pass num_probe or recall_target")
        num_probe = min(int(num_probe),
                        self.num_csr_items + self.delta.capacity)
        if num_probe <= 0:
            raise ValueError("num_probe must be positive")
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        tr = self.tracker
        with span_or_null(tr, "repro.streaming.query") as sp:
            cand = self._candidates(queries, num_probe)
            vals, ids = merged_rerank(
                self.items, self.delta.items, self.live_dev,
                self.delta.live, queries, cand, int(k))
            sp.sync(ids)
        if tr is not None:
            tr.count("repro.streaming.queries", queries.shape[0])
            tr.observe("repro.streaming.probe_width", num_probe)
        return vals, ids

    def live_vectors(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(live item vectors, matching global ids) — storage rows first,
        then delta slots; the evaluation surface for exact-MIPS baselines."""
        rows = np.flatnonzero(self._live)
        slots = np.flatnonzero(self.delta._live[:self.delta.count])
        vecs = torch.cat([self.items[_dev(rows, self.device)],
                          self.delta.items[_dev(slots, self.device)]])
        gids = np.concatenate(
            [rows, self.store_size + slots]).astype(np.int32)
        return vecs, gids

    def stats(self) -> dict:
        # polling stats is the drift-reporting moment: the monitor's
        # quantiles also go out as gauges and an event to a tracker
        self.monitor.report(self.tracker)
        return {
            "live": self.live_count,
            "store_rows": self.store_size,
            "csr_items": self.num_csr_items,
            "csr_tombstones": self.tomb_csr,
            "delta_used": self.delta.count,
            "delta_live": self.delta.live_count,
            "num_buckets": int(self._csr.bucket_rid.shape[0]),
            "compactions": self.num_compactions,
            "repartitions": self.num_repartitions,
            "full_rebuilds": self.num_full_rebuilds,
            "drift": self.monitor.snapshot(),
        }

    # -- internals -----------------------------------------------------------

    def set_tracker(self, tracker) -> None:
        """Attach (or detach, with None) a :class:`repro_torch.obs.Tracker`."""
        self.tracker = tracker

    def _event(self, kind: str, **info) -> None:
        # the list stays the surface the parity tests read; a tracker also
        # gets each event as a typed record
        self.events.append(dict(kind=kind, **info))
        if self.tracker is not None:
            self.tracker.event(f"repro.streaming.{kind}", **info)

    def _assign(self, norms: np.ndarray) -> np.ndarray:
        if self.num_ranges == 1:
            return np.zeros(norms.shape, np.int32)
        return np.searchsorted(self.edges, norms,
                               side="left").astype(np.int32)

    def _encode(self, vectors: torch.Tensor, rid: np.ndarray) -> np.ndarray:
        """Encode a batch under the frozen hash family and current bounds;
        host uint32 codes."""
        U = _dev(self.upper[rid], self.device)
        codes = self.family.encode_items(self.A, vectors, U, impl=self.impl)
        return _host(codes).view(np.uint32)

    def _encode_rows(self, src: torch.Tensor, idx: np.ndarray,
                     rid: np.ndarray) -> np.ndarray:
        """Gather rows ``idx`` from ``src`` and encode them."""
        return self._encode(src[_dev(idx, self.device)], rid)

    def _count_live(self) -> np.ndarray:
        m = self.num_ranges
        counts = np.bincount(self._rid[self._live], minlength=m)
        n = self.delta.count
        dmask = self.delta._live[:n]
        return counts + np.bincount(self.delta._rid[:n][dmask], minlength=m)

    def _fold_delta(self) -> None:
        c = self.delta.count
        if not c:
            return
        self.items = torch.cat([self.items, self.delta.items[:c]], dim=0)
        self._norms = np.concatenate([self._norms, self.delta._norms[:c]])
        self._codes = np.concatenate([self._codes, self.delta._codes[:c]])
        self._rid = np.concatenate([self._rid, self.delta._rid[:c]])
        self._live = np.concatenate([self._live, self.delta._live[:c]])
        self.delta.reset()

    def _rebuild_csr(self) -> None:
        rows = np.flatnonzero(self._live)
        self._csr = _csr_from_rows(self._codes, self._rid, rows)
        self.dir_keys = directory_keys(self._csr.bucket_rid,
                                       self._csr.bucket_code)
        self.tomb_csr = 0
        self._skew_muted.clear()    # structural change: re-arm rebalance
        self._push_csr()
        self._push_live()

    def _rank_table(self) -> torch.Tensor:
        """(R, L+1) probe ranks from the family score table under the
        current bounds (eq.-12 order for SIMPLE-LSH)."""
        return rank_from_scores(self.family.score_table(
            _dev(self.upper, self.device), self.hash_bits, eps=self.eps))

    def _push_csr(self) -> None:
        c = self._csr
        dev = self.device
        self.buckets = BucketIndex(
            item_ids=_dev(c.item_ids, dev),
            bucket_start=_dev(c.bucket_start, dev),
            bucket_rid=_dev(c.bucket_rid, dev),
            bucket_code=_dev(c.bucket_code.view(np.int32), dev),
            rank=self._rank_table(),
            hash_bits=self.hash_bits, eps=self.eps)
        self.csr_bucket = _dev(c.csr_bucket, dev)
        self.csr_codes = _dev(c.csr_codes.view(np.int32), dev)
        self.csr_rid = _dev(c.csr_rid, dev)

    def _push_live(self) -> None:
        self.live_dev = _dev(self._live, self.device)

    def _arrs(self) -> dict:
        d = self.delta
        return dict(
            item_ids=self.buckets.item_ids,
            bucket_start=self.buckets.bucket_start,
            bucket_rid=self.buckets.bucket_rid,
            bucket_code=self.buckets.bucket_code,
            rank=self.buckets.rank,
            csr_bucket=self.csr_bucket, csr_codes=self.csr_codes,
            csr_rid=self.csr_rid, live=self.live_dev,
            d_codes=d.codes, d_rid=d.rid, d_ids=d.ids, d_live=d.live,
            d_perm=d.perm, d_ord=d.ord)

    # -- drift handling ------------------------------------------------------

    def _members(self, lo: int, hi: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(storage rows, delta slots) of live items in ranges [lo, hi]."""
        srows = np.flatnonzero(
            self._live & (self._rid >= lo) & (self._rid <= hi))
        n = self.delta.count
        dmask = self.delta._live[:n] & (self.delta._rid[:n] >= lo) & \
            (self.delta._rid[:n] <= hi)
        return srows, np.flatnonzero(dmask)

    def _handle_overflow(self, j: int, new_U: float) -> None:
        """An insert breaches ``U_j`` (or lands in an empty bin): raise the
        bound and re-encode only range ``j``'s members."""
        old_U = float(self.upper[j])
        self.upper[j] = new_U
        self._invalidate_calibration("overflow")
        srows, dslots = self._members(j, j)
        if srows.size == 0 and dslots.size == 0:
            # empty bin taking its first item: bound set, rank table moves
            self._refresh_rank()
            self._event("bin_init", range=j, upper=new_U)
        elif self.repartition_policy == "full":
            self.rebuild_full()
            self._event("overflow_full", range=j, old_upper=old_U,
                        upper=new_U)
        else:
            self._repartition_span(j, j)
            self._event("overflow_localized", range=j, old_upper=old_U,
                        upper=new_U, members=int(srows.size + dslots.size))

    def _rebalance(self, j: int) -> None:
        """Occupancy skew: split the combined items of range ``j`` and its
        lighter adjacent neighbor at their median norm."""
        m = self.num_ranges
        if m <= 1:
            return
        if j == 0:
            k = 1
        elif j == m - 1:
            k = m - 2
        else:
            k = j - 1 if self.monitor.counts[j - 1] <= \
                self.monitor.counts[j + 1] else j + 1
        lo, hi = min(j, k), max(j, k)
        srows, dslots = self._members(lo, hi)
        all_norms = np.concatenate(
            [self._norms[srows], self.delta._norms[dslots]])
        if all_norms.size < 2:
            self._skew_muted.add(j)
            return
        s = np.sort(all_norms)
        boundary = float(s[s.size // 2 - 1])
        if boundary >= s[-1]:   # all norms equal — nothing to split
            self._skew_muted.add(j)
            self._event("rebalance_blocked", range=j)
            return
        self._invalidate_calibration("skew_rebalance")
        self._rid[srows] = np.where(self._norms[srows] <= boundary, lo, hi)
        self.delta._rid[dslots] = np.where(
            self.delta._norms[dslots] <= boundary, lo, hi)
        self.edges[lo] = boundary
        for r in (lo, hi):
            sr, ds = self._members(r, r)
            member_norms = np.concatenate(
                [self._norms[sr], self.delta._norms[ds]])
            self.upper[r] = float(member_norms.max())
            self.lower[r] = float(member_norms.min())
        if self.repartition_policy == "full":
            self.rebuild_full()
        else:
            self._repartition_span(lo, hi)
        self.monitor.set_counts(self._count_live())
        self._skew_muted.clear()
        self._event("skew_rebalance", ranges=(lo, hi), boundary=boundary)

    def _repartition_span(self, lo: int, hi: int) -> None:
        """Localized repartition: re-encode live members of ranges
        [lo, hi] under the current bounds and splice the re-sorted span
        back into the CSR store — ranges outside the span are untouched
        (their items are contiguous elsewhere in the rid-major CSR)."""
        srows, dslots = self._members(lo, hi)
        if srows.size:
            self._codes[srows] = self._encode_rows(self.items, srows,
                                                   self._rid[srows])
        new_delta_codes = None
        if dslots.size:
            new_delta_codes = self._encode_rows(
                self.delta.items, dslots, self.delta._rid[dslots])
        # splice the span (bucket runs never straddle a range boundary)
        csr = self._csr
        pre_B = int(np.searchsorted(csr.bucket_rid, lo, side="left"))
        end_B = int(np.searchsorted(csr.bucket_rid, hi, side="right"))
        a = int(csr.bucket_start[pre_B])
        b = int(csr.bucket_start[end_B])
        sub = _csr_from_rows(self._codes, self._rid,
                             np.sort(csr.item_ids[a:b]))
        nb, old_nb = int(sub.bucket_rid.shape[0]), end_B - pre_B
        self._csr = _CSR(
            item_ids=np.concatenate(
                [csr.item_ids[:a], sub.item_ids, csr.item_ids[b:]]),
            bucket_start=np.concatenate(
                [csr.bucket_start[:pre_B], a + sub.bucket_start[:-1],
                 csr.bucket_start[end_B:]]).astype(np.int32),
            bucket_rid=np.concatenate(
                [csr.bucket_rid[:pre_B], sub.bucket_rid,
                 csr.bucket_rid[end_B:]]),
            bucket_code=np.concatenate(
                [csr.bucket_code[:pre_B], sub.bucket_code,
                 csr.bucket_code[end_B:]]),
            csr_bucket=np.concatenate(
                [csr.csr_bucket[:a], pre_B + sub.csr_bucket,
                 csr.csr_bucket[b:] + (nb - old_nb)]),
            csr_codes=np.concatenate(
                [csr.csr_codes[:a], sub.csr_codes, csr.csr_codes[b:]]),
            csr_rid=np.concatenate(
                [csr.csr_rid[:a], sub.csr_rid, csr.csr_rid[b:]]),
        )
        self.dir_keys = directory_keys(self._csr.bucket_rid,
                                       self._csr.bucket_code)
        self._push_csr()
        if new_delta_codes is not None:
            self.delta.update_members(dslots, self.delta._rid[dslots],
                                      new_delta_codes, self.dir_keys)
        else:
            self.delta.refresh_order(self.dir_keys)
        self.num_repartitions += 1
        self._event("repartition", lo=lo, hi=hi,
                    members=int(srows.size + dslots.size))

    def _refresh_rank(self) -> None:
        self.buckets = self.buckets._replace(rank=self._rank_table())


def build(items, generator: Optional[torch.Generator], code_len: int,
          m: int, *, scheme: str = "percentile", eps: float = DEFAULT_EPS,
          impl: str = "auto", params=None, device=None,
          **kw) -> MutableIndex:
    """Algorithm 1 build wrapped as a mutable index, on ``device`` (the
    card unless ``device="cpu"``): :func:`repro_torch.core.range_lsh.build`
    then :meth:`MutableIndex.from_range_lsh`. ``generator`` draws the
    projections unless ``params`` hands them in; ``kw`` (capacity,
    tracker, ...) goes to the index."""
    idx = range_lsh.build(items, generator, code_len, m, scheme=scheme,
                          eps=eps, impl=impl, params=params, device=device)
    return MutableIndex.from_range_lsh(idx, scheme=scheme, impl=impl, **kw)
