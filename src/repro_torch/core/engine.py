"""Query engines: dense scan, bucket traversal and the fused kernel behind
one front end (port of ``repro/core/engine.py``).

All three realize Algorithm 2's probe order in the canonical
``(rank, CSR position)`` order, so for one index, query batch and budget
they return identical candidate ids:

  * ``engine="dense"`` — Hamming scan over all N items, per-item rank,
    stable sort of N ranks;
  * ``engine="bucket"`` — scan the B-entry bucket directory, stable sort
    of B ranks, segmented gather of the probed runs (``bucket_gather``),
    exact re-rank;
  * ``engine="fused"`` — the same directory walk, then one
    ``fused_query`` launch that expands the runs, scores, keeps the top
    k' and rescores them.

An engine serves a spec-built :class:`~repro_torch.core.index.ComposedIndex`
(encode and match through its family) or a legacy RANGE-LSH / SIMPLE-LSH
tuple (``core/range_lsh.py``, ``core/simple_lsh.py``): their queries
encode as ``P(q) = [q; 0]`` against the projection ``A`` and match the
directory through ``ops.bucket_match``.

With a tracker (``QueryEngine(tracker=)``, or the ambient one of
:func:`repro_torch.obs.set_default_tracker`), every stage runs in a span
named and costed as the reference's (``repro.engine.hash_encode``,
``directory_match``, ``segmented_gather`` | ``fused_query`` | the dense
``dense_match``/``dense_select``, ``re_rank``, ``top_k``, under
``repro.engine.query``), synchronised at its end, and each batch records
``repro.engine.queries``, ``probe_width`` and, under budgets,
``probes_used.range{j}`` (the budget, as the reference records it).
Child spans of the port's own (``obs.cost.PORT_STAGES``, uncosted, each
synchronised on what it produces) split two stages:
``repro.engine.directory_scan`` (the match counter) and ``rank_sort``
(the rank gather and stable argsort) inside ``directory_match``;
``repro.engine.runs`` (``_planned_runs``/``_probe_runs``: the per-range
take and the run offsets) and ``fused_score`` (the ``fused_query``
launch and the id gather) inside ``fused_query``. A call that names a
recall target plans inside ``repro.engine.query``, in
``repro.planner.resolve_budgets`` (host only, no sync). Without a
tracker nothing is synchronised or computed for it; while
``torch.profiler`` records, every one of these spans is also a
``record_function`` range of the same name (:mod:`repro_torch.obs.trace`),
tracked or not.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing
from repro_torch.core.bucket_index import BucketIndex, build_bucket_index
from repro_torch.core.topk import rerank
from repro_torch.kernels import ops
from repro_torch.kernels.ref import exclusive_cum, range_cum_before
from repro_torch.obs import cost
from repro_torch.obs.trace import costed_span, span_or_null
from repro_torch.obs.tracker import resolve_tracker

ENGINES = ("auto", "dense", "bucket", "fused")

# engine="auto": bucket traversal when the directory is meaningfully
# smaller than the item table (the reference's measured split)
AUTO_DENSE_RATIO = 0.75


def select_engine(num_buckets: int, num_items: int) -> str:
    """Resolve ``engine="auto"`` to "bucket" or "dense"."""
    return "bucket" if num_buckets < AUTO_DENSE_RATIO * num_items else "dense"


def encode_queries(index, queries: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """Hash queries under the index's family: its asymmetric query
    transform, then its hash (packed sign codes or integer hashes). A
    legacy index has no family: its (d+1, L) projection ``A`` holds the
    augmentation row last, and queries hash as ``P(q) = [q; 0]``."""
    fam = getattr(index, "family", None)
    if fam is not None:
        return fam.encode_queries(index.params, queries, impl=impl)
    q = hashing.normalize(queries.to(torch.float32))
    zeros = torch.zeros((q.shape[0],), dtype=q.dtype, device=q.device)
    return ops.hash_encode(q, index.A[:-1], zeros, index.A[-1], impl=impl)


def _default_match(buckets: BucketIndex, impl: str):
    """Packed-code match counter of legacy indexes:
    ``l = L - hamming`` through ``ops.bucket_match``."""
    return lambda q_codes, codes: ops.bucket_match(
        q_codes, codes, buckets.hash_bits, impl=impl)


def _directory_order(buckets: BucketIndex, q_codes: torch.Tensor,
                     match_fn, impl: str = "auto",
                     tracker=None) -> torch.Tensor:
    """(Q, B) probe-ordered bucket indices: directory match -> per-bucket
    rank -> stable sort (ties by CSR bucket position). ``match_fn`` (the
    family's match counter) None is the packed ``bucket_match`` of legacy
    indexes."""
    if match_fn is None:
        match_fn = _default_match(buckets, impl)
    with costed_span(tracker, "repro.engine.directory_match",
                     cost.directory_match_cost, q_codes.shape[0],
                     buckets.num_buckets, buckets.hash_bits) as sp:
        with span_or_null(tracker, "repro.engine.directory_scan") as sc:
            matches = sc.sync(match_fn(q_codes, buckets.bucket_code))
        with span_or_null(tracker, "repro.engine.rank_sort") as rs:
            bucket_rank = buckets.rank[buckets.bucket_rid[None, :], matches]
            order = rs.sync(torch.argsort(bucket_rank, dim=-1, stable=True))
        return sp.sync(order)                                   # (Q, B)


def _probe_runs(buckets: BucketIndex, order: torch.Tensor, num_probe: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cum (Q, S+1), starts (Q, S)) runs of the first ``num_probe``
    probed items; every bucket holds >= 1 item, so the first min(B, P)
    buckets cover the budget."""
    sel = order[:, :min(buckets.num_buckets, num_probe)]
    sizes = (buckets.bucket_start[1:] - buckets.bucket_start[:-1])[sel]
    starts = buckets.bucket_start[:-1][sel]
    return exclusive_cum(sizes), starts


@functools.lru_cache(maxsize=64)
def _caps(budgets: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(R,) int32 budgets on ``device``, made once per plan: a fresh copy
    each batch would wait for the stream's queued work."""
    return torch.tensor(budgets, dtype=torch.int32, device=device)


def _planned_runs(buckets: BucketIndex, order: torch.Tensor,
                  budgets: Sequence[int], *, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cum (Q, B+1), starts (Q, B)) runs realizing per-range budgets:
    each probe-ordered bucket takes what is left of its range's budget
    (one ``ops.planned_runs`` launch on the card)."""
    caps = _caps(tuple(int(b) for b in budgets), order.device)
    return ops.planned_runs(order, buckets.bucket_start, buckets.bucket_rid,
                            caps, impl=impl)


def bucket_candidates(buckets: BucketIndex, q_codes: torch.Tensor,
                      num_probe: int, *, impl: str = "auto",
                      match_fn=None, tracker=None) -> torch.Tensor:
    """(Q, num_probe) candidate item ids via bucket traversal."""
    num_probe = int(num_probe)
    if not 0 < num_probe <= buckets.num_items:
        raise ValueError(f"num_probe={num_probe} outside "
                         f"(0, N={buckets.num_items}]")
    order = _directory_order(buckets, q_codes, match_fn, impl, tracker)
    with costed_span(tracker, "repro.engine.segmented_gather",
                     cost.segmented_gather_cost, q_codes.shape[0],
                     num_probe) as sp:
        cum, starts = _probe_runs(buckets, order, num_probe)
        csr_pos = ops.bucket_gather(cum, starts, num_probe, impl=impl)
        return sp.sync(buckets.item_ids[csr_pos])


def check_budgets(budgets: Sequence[int], range_counts: np.ndarray
                  ) -> Tuple[Tuple[int, ...], int]:
    """Validate per-range budgets against per-range item counts; returns
    (clipped budgets, total planned width)."""
    budgets = tuple(int(b) for b in budgets)
    if len(budgets) != range_counts.shape[0]:
        raise ValueError(f"{len(budgets)} budgets for "
                         f"{range_counts.shape[0]} ranges")
    if any(b < 0 for b in budgets):
        raise ValueError(f"budgets must be >= 0, got {budgets}")
    eff = tuple(min(b, int(c)) for b, c in zip(budgets, range_counts))
    total = sum(eff)
    if total <= 0:
        raise ValueError("planned budgets probe zero items")
    return eff, total


def bucket_range_counts(buckets: BucketIndex) -> np.ndarray:
    """(R,) per-range item counts from the bucket directory (host)."""
    start = buckets.bucket_start.cpu().numpy()
    return np.bincount(buckets.bucket_rid.cpu().numpy(),
                       weights=(start[1:] - start[:-1]),
                       minlength=buckets.rank.shape[0]).astype(np.int64)


def planned_bucket_candidates(buckets: BucketIndex, q_codes: torch.Tensor,
                              budgets: Sequence[int], *,
                              impl: str = "auto", match_fn=None,
                              range_counts: Optional[np.ndarray] = None,
                              tracker=None) -> torch.Tensor:
    """(Q, sum_j min(b_j, n_j)) candidates: for each range j, its first
    ``min(b_j, n_j)`` items in canonical order, emitted in global
    canonical order."""
    if range_counts is None:
        range_counts = bucket_range_counts(buckets)
    budgets, total = check_budgets(budgets, range_counts)
    order = _directory_order(buckets, q_codes, match_fn, impl, tracker)
    with costed_span(tracker, "repro.engine.segmented_gather",
                     cost.segmented_gather_cost, q_codes.shape[0],
                     total) as sp:
        cum, starts = _planned_runs(buckets, order, budgets, impl=impl)
        csr_pos = ops.bucket_gather(cum, starts, total, impl=impl)
        return sp.sync(buckets.item_ids[csr_pos])


def fused_bucket_query(buckets: BucketIndex, q_codes: torch.Tensor,
                       queries: torch.Tensor, items_csr: torch.Tensor,
                       k: int, *, num_probe: Optional[int] = None,
                       budgets: Optional[Sequence[int]] = None,
                       payload: Optional[torch.Tensor] = None,
                       scale: Optional[torch.Tensor] = None,
                       impl: str = "auto", match_fn=None,
                       range_counts: Optional[np.ndarray] = None,
                       tracker=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Directory walk, then one ``fused_query`` launch for run expansion,
    phase-1 scoring, survivor selection and f32 rescore. Returns (vals,
    ids, probed width)."""
    if (num_probe is None) == (budgets is None):
        raise ValueError("pass exactly one of num_probe/budgets")
    if budgets is not None:
        if range_counts is None:
            range_counts = bucket_range_counts(buckets)
        budgets, total = check_budgets(budgets, range_counts)
    else:
        total = int(num_probe)
        if not 0 < total <= buckets.num_items:
            raise ValueError(f"num_probe={total} outside "
                             f"(0, N={buckets.num_items}]")
    order = _directory_order(buckets, q_codes, match_fn, impl, tracker)
    with costed_span(tracker, "repro.engine.fused_query",
                     cost.fused_query_cost, q_codes.shape[0], total,
                     queries.shape[1], int(k),
                     max(int(k), min(max(4 * int(k), 32), total))) as sp:
        with span_or_null(tracker, "repro.engine.runs") as rn:
            if budgets is not None:
                cum, starts = _planned_runs(buckets, order, budgets,
                                            impl=impl)
            else:
                cum, starts = _probe_runs(buckets, order, total)
            rn.sync((cum, starts))
        with span_or_null(tracker, "repro.engine.fused_score") as fs:
            vals, pos = ops.fused_query(queries, cum, starts, items_csr,
                                        total, k, payload=payload,
                                        scale=scale, impl=impl)
            ids = fs.sync(buckets.item_ids[pos])
        sp.sync(ids)
    return vals, ids, total


def quantize_payload(items_csr: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-item int8 quantization: (payload (N, d) int8, scale
    (N, 1) f32), ``rows ~= payload * scale``, scale = max|row| / 127.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    mx = torch.amax(torch.abs(items_csr), dim=1, keepdim=True)
    scale = torch.clamp_min(mx, torch.finfo(torch.float32).tiny) / 127.0
    payload = torch.clamp(torch.round(items_csr / scale), -127, 127)
    return payload.to(torch.int8), scale.to(torch.float32)


def _keep_canonical(keep: torch.Tensor, total: int) -> torch.Tensor:
    """(Q, total) columns of the ``total`` True entries of each row, in
    column order (every row holds exactly ``total``)."""
    cols = torch.nonzero(keep, as_tuple=True)[1]
    if cols.numel() != keep.shape[0] * total:
        raise RuntimeError("planned dense selection kept a ragged set")
    return cols.reshape(keep.shape[0], total)


def planned_dense_candidates(buckets: BucketIndex, q_codes: torch.Tensor,
                             db_codes: torch.Tensor,
                             range_id: torch.Tensor,
                             budgets: Sequence[int], *,
                             impl: str = "auto", match_fn=None,
                             range_counts: Optional[np.ndarray] = None,
                             tracker=None) -> torch.Tensor:
    """Dense-scan realization of :func:`planned_bucket_candidates`'s
    contract; identical candidate ids."""
    if range_counts is None:
        range_counts = np.bincount(range_id.cpu().numpy(),
                                   minlength=buckets.rank.shape[0]
                                   ).astype(np.int64)
    budgets, total = check_budgets(budgets, range_counts)
    order = _dense_order(buckets, q_codes, db_codes, range_id, impl,
                         match_fn, tracker)
    with costed_span(tracker, "repro.engine.dense_select",
                     cost.dense_select_cost, q_codes.shape[0],
                     buckets.num_items) as sp:
        rid_o = range_id[buckets.item_ids][order]
        wpos = range_cum_before(rid_o, torch.ones_like(rid_o),
                                len(budgets))
        caps = torch.tensor(budgets, dtype=torch.int32,
                            device=rid_o.device)
        # exactly ``total`` kept per query; row-major nonzero keeps them in
        # canonical order (the reference's stable argsort of ~keep)
        sel = _keep_canonical(wpos < caps[rid_o], total)
        return sp.sync(buckets.item_ids[torch.gather(order, 1, sel)])


def _dense_order(buckets: BucketIndex, q_codes: torch.Tensor,
                 db_codes: torch.Tensor, range_id: torch.Tensor, impl: str,
                 match_fn, tracker) -> torch.Tensor:
    """(Q, N) CSR positions in canonical order: match every item, rank,
    stable sort with the columns in CSR order (ties on CSR position)."""
    if match_fn is None:
        match_fn = _default_match(buckets, impl)
    with costed_span(tracker, "repro.engine.dense_match",
                     cost.dense_match_cost, q_codes.shape[0],
                     buckets.num_items, buckets.hash_bits) as sp:
        matches = match_fn(q_codes, db_codes)                   # (Q, N)
        item_rank = buckets.rank[range_id[None, :], matches]
        rank_csr = item_rank[:, buckets.item_ids]
        return sp.sync(torch.argsort(rank_csr, dim=-1, stable=True))


def dense_candidates(buckets: BucketIndex, q_codes: torch.Tensor,
                     db_codes: torch.Tensor, range_id: torch.Tensor,
                     num_probe: int, *, impl: str = "auto",
                     match_fn=None, tracker=None) -> torch.Tensor:
    """(Q, num_probe) candidate ids via the dense scan, in the canonical
    order of :func:`bucket_candidates`."""
    order = _dense_order(buckets, q_codes, db_codes, range_id, impl,
                         match_fn, tracker)
    with costed_span(tracker, "repro.engine.dense_select",
                     cost.dense_select_cost, q_codes.shape[0],
                     buckets.num_items) as sp:
        return sp.sync(buckets.item_ids[order[:, :int(num_probe)]])


# bounded LRU of engines for the convenience surface (ComposedIndex.query
# / candidates): repeat calls over one index reuse its host-built bucket
# store. An entry holds strong references to its index and tracker, so an
# id() key cannot be a stale reuse; the ``repro.engine.memo_size`` gauge
# shows the occupancy.
_ENGINE_MEMO_CAP = 8
_engine_memo: OrderedDict = OrderedDict()


def engine_for(index, *, engine: str, buckets=None,
               impl: str = "auto", tracker=None) -> "QueryEngine":
    """A :class:`QueryEngine` over ``index`` on the index's device,
    memoized when no prebuilt ``buckets`` are given. The ambient tracker
    is resolved here and keys the memo, so installing one redirects even
    an already-memoized convenience path."""
    tracker = resolve_tracker(tracker)
    device = index.items.device
    if buckets is not None:
        return QueryEngine(index, engine=engine, buckets=buckets, impl=impl,
                           tracker=tracker, device=device)
    key = (id(index), engine, impl, id(tracker))
    ent = _engine_memo.get(key)
    if ent is None:
        eng = QueryEngine(index, engine=engine, impl=impl, tracker=tracker,
                          device=device)
        _engine_memo[key] = (index, tracker, eng)
        while len(_engine_memo) > _ENGINE_MEMO_CAP:
            _engine_memo.popitem(last=False)
    else:
        _engine_memo.move_to_end(key)
        eng = ent[-1]
    if tracker is not None:
        tracker.gauge("repro.engine.memo_size", len(_engine_memo))
    return eng


class QueryEngine:
    """Batched candidate generation + exact re-rank over one index.

    Args:
      index:     a :class:`~repro_torch.core.index.ComposedIndex`, or a
                 legacy ``RangeLSHIndex`` / ``SimpleLSHIndex``.
      engine:    "dense" | "bucket" | "fused" | "auto".
      buckets:   optional prebuilt BucketIndex (else built here, a host
                 O(N log N) step: reuse the engine across batches).
      impl:      kernel dispatch ("auto" | "cuda" | "ref").
      tracker:   optional :class:`repro_torch.obs.Tracker`; None falls back
                 to the ambient default (resolved once, here). It adds
                 stage spans and query records; results stay identical.
      quantized: fused engine only — phase 1 scores the int8 payload.
      device:    the device the engine runs on; the card unless
                 ``device="cpu"``. The index must live there.
    """

    def __init__(self, index, *, engine: str = "auto",
                 buckets: Optional[BucketIndex] = None, impl: str = "auto",
                 tracker=None, quantized: bool = False, device=None):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine: {engine!r}")
        if quantized and engine != "fused":
            raise ValueError("quantized phase-1 scoring is a fused-engine "
                             "arm; pass engine=\"fused\"")
        device = resolve_device(device)
        if index.items.device.type != device.type:
            raise ValueError(f"the index lives on {index.items.device}, "
                             f"the engine was asked for {device}")
        if buckets is None:
            buckets = build_bucket_index(index)
        if engine == "auto":
            engine = select_engine(buckets.num_buckets, buckets.num_items)
        self.index = index
        self.engine = engine
        self.buckets = buckets
        self.impl = impl
        self.quantized = quantized
        self.tracker = resolve_tracker(tracker)
        self._range_counts_cache = None
        self._fused_cache = None

    @property
    def _fused_arrays(self):
        """(items_csr, payload, scale): item rows in CSR order, made once
        per engine, plus the int8 payload and scales when quantized."""
        if self._fused_cache is None:
            items_csr = self.index.items.to(torch.float32)[
                self.buckets.item_ids]
            payload = scale = None
            if self.quantized:
                payload, scale = quantize_payload(items_csr)
            self._fused_cache = (items_csr, payload, scale)
        return self._fused_cache

    @property
    def _range_id(self) -> torch.Tensor:
        """(N,) int32 range of each item (all zero for SIMPLE-LSH)."""
        if hasattr(self.index, "range_id"):
            return self.index.range_id
        return torch.zeros((self.index.codes.shape[0],), dtype=torch.int32,
                           device=self.index.codes.device)

    @property
    def _range_counts(self) -> np.ndarray:
        if self._range_counts_cache is None:
            self._range_counts_cache = bucket_range_counts(self.buckets)
        return self._range_counts_cache

    @property
    def _match_fn(self):
        """The family's match counter; None (the packed ``bucket_match``)
        for a legacy index."""
        idx = self.index
        fam = getattr(idx, "family", None)
        if fam is None:
            return None
        return lambda q_codes, codes: fam.match_counts(
            idx.params, q_codes, codes, idx.hash_bits, impl=self.impl)

    def _encode(self, queries: torch.Tensor) -> torch.Tensor:
        with costed_span(self.tracker, "repro.engine.hash_encode",
                         cost.hash_encode_cost, queries.shape[0],
                         queries.shape[1],
                         getattr(self.index, "code_len",
                                 self.buckets.hash_bits)) as sp:
            return sp.sync(encode_queries(self.index, queries,
                                          impl=self.impl))

    def candidates(self, queries: torch.Tensor,
                   num_probe: Optional[int] = None, *,
                   budgets: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
        """(Q, P) item ids in canonical probe order: the global prefix of
        ``num_probe``, or the per-range prefixes of ``budgets``."""
        if (num_probe is None) == (budgets is None):
            raise ValueError("pass exactly one of num_probe/budgets")
        tr = self.tracker
        q_codes = self._encode(queries)
        if budgets is not None:
            if self.engine in ("bucket", "fused"):
                return planned_bucket_candidates(
                    self.buckets, q_codes, budgets, impl=self.impl,
                    match_fn=self._match_fn,
                    range_counts=self._range_counts, tracker=tr)
            return planned_dense_candidates(
                self.buckets, q_codes, self.index.codes, self._range_id,
                budgets, impl=self.impl, match_fn=self._match_fn,
                range_counts=self._range_counts, tracker=tr)
        num_probe = int(num_probe)
        if not 0 < num_probe <= self.buckets.num_items:
            raise ValueError(f"num_probe={num_probe} outside "
                             f"(0, N={self.buckets.num_items}]")
        if self.engine in ("bucket", "fused"):
            return bucket_candidates(self.buckets, q_codes, num_probe,
                                     impl=self.impl,
                                     match_fn=self._match_fn, tracker=tr)
        return dense_candidates(self.buckets, q_codes, self.index.codes,
                                self._range_id, num_probe, impl=self.impl,
                                match_fn=self._match_fn, tracker=tr)

    def query(self, queries: torch.Tensor, k: int,
              num_probe: Optional[int] = None, *,
              recall_target: Optional[float] = None,
              budgets: Optional[Sequence[int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Algorithm 2 end to end: probe, exact re-rank, (vals, ids) (Q,
        k). Exactly one of ``num_probe``, ``budgets`` or ``recall_target``
        (resolved through the index's calibration table)."""
        if recall_target is not None and (num_probe is not None
                                          or budgets is not None):
            raise ValueError("pass one of num_probe/budgets/recall_target")
        tr = self.tracker
        with span_or_null(tr, "repro.engine.query"):
            if recall_target is not None:
                from repro_torch.core.planner import resolve_budgets
                with span_or_null(tr, "repro.planner.resolve_budgets"):
                    budgets = resolve_budgets(
                        getattr(self.index, "calib", None), recall_target,
                        k=k).budgets
            if self.engine == "fused":
                if (num_probe is None) == (budgets is None):
                    raise ValueError("pass exactly one of "
                                     "num_probe/budgets")
                items_csr, payload, scale = self._fused_arrays
                vals, ids, width = fused_bucket_query(
                    self.buckets, self._encode(queries), queries,
                    items_csr, int(k), num_probe=num_probe,
                    budgets=budgets, payload=payload, scale=scale,
                    impl=self.impl, match_fn=self._match_fn,
                    range_counts=self._range_counts, tracker=tr)
            else:
                cand = self.candidates(queries, num_probe, budgets=budgets)
                if not 0 < int(k) <= cand.shape[1]:
                    raise ValueError(f"k={k} outside (0, probed width "
                                     f"{cand.shape[1]}]")
                vals, ids = rerank(queries, self.index.items, cand, int(k),
                                   tracker=tr)
                width = cand.shape[1]
        if tr is not None:
            tr.count("repro.engine.queries", queries.shape[0])
            tr.observe("repro.engine.probe_width", width)
            if budgets is not None:
                for j, b in enumerate(budgets):
                    tr.observe(f"repro.engine.probes_used.range{j}", b)
        return vals, ids
