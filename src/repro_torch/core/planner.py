"""Recall-contract query planner (port of ``repro/core/planner.py``).

:func:`calibrate` measures, for held-out queries, where the brute-force
top-k items land in the index's canonical probe order, per range and
globally; :func:`plan` turns a recall target into per-range probe budgets
by greedy marginal-gain allocation over those curves. The engines execute
a budget vector as: for each range j, probe its first ``min(b_j, n_j)``
items in canonical (rank, CSR position) order.

The (Q, N) work of calibration runs as torch ops on the index's device,
a block of queries at a time and with int32 positions; the curves and the
greedy planning loop are small and stay on the host in numpy.

:func:`adaptive_query` walks the planned candidates grouped by descending
range cap and stops a query once its running k-th exact inner product
meets the best score any unprobed candidate could reach (``||q|| U_j``
for sign families): the same top-k as the full planned re-rank, with
the provably futile tail of the budget skipped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hashing, topk
from repro_torch.kernels.ref import full_f32, range_cum_before

DEFAULT_CAL_QUERIES = 256
DEFAULT_CAL_K = 10
GRID_FACTOR = 1.3
CAL_CHUNK = 32            # queries per (chunk, N) block of the calibration
ADAPTIVE_CHUNK = 32       # candidates a step of adaptive_query re-ranks
ADAPTIVE_SYNC_STEPS = 8   # steps between adaptive_query's host checks


class CalibrationTable(NamedTuple):
    """Measured recall curves in canonical probe order (numpy, host).

    Attributes:
      probe_grid:    (G,) int64 ascending probe counts, 0 .. >= N.
      recall_range:  (R, G) f32 — P(truth item of range j is within the
                     first ``min(grid[g], n_j)`` probed items of range j).
      recall_global: (G,) f32 — recall of the global canonical prefix.
      truth_mass:    (R,) f32 — fraction of all truth items in range j.
      range_counts:  (R,) int64 items per range.
      k:             top-k the curves were measured at.
      num_queries:   calibration sample size.
    """

    probe_grid: np.ndarray
    recall_range: np.ndarray
    recall_global: np.ndarray
    truth_mass: np.ndarray
    range_counts: np.ndarray
    k: int
    num_queries: int

    @property
    def num_items(self) -> int:
        return int(self.range_counts.sum())

    @property
    def num_ranges(self) -> int:
        return int(self.range_counts.shape[0])


class Plan(NamedTuple):
    """A resolved recall contract: per-range budgets (clipped to the
    range sizes) and the predicted recall."""

    budgets: Tuple[int, ...]
    num_probe: int
    predicted_recall: float
    recall_target: float


def default_grid(n: int, factor: float = GRID_FACTOR) -> np.ndarray:
    """Geometric probe-count grid {0, 1, ..., n}."""
    vals = {0, int(n)}
    v = 1.0
    while v < n:
        vals.add(int(round(v)))
        v *= factor
    return np.asarray(sorted(vals), np.int64)


def check_target(recall_target: float) -> float:
    recall_target = float(recall_target)
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(
            f"recall_target must be in (0, 1], got {recall_target}")
    return recall_target


# -- calibration --------------------------------------------------------------


def _truth_positions(order_ids: torch.Tensor, range_id: torch.Tensor,
                     truth_ids: torch.Tensor, num_ranges: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global and within-range probe positions of the truth items, both
    (Q, k), for one block of queries."""
    q, n = order_ids.shape
    order = order_ids.long()
    arange = torch.arange(n, dtype=torch.int32, device=order.device)
    gpos = torch.empty((q, n), dtype=torch.int32, device=order.device)
    gpos.scatter_(1, order, arange.expand(q, n))
    sorted_rid = range_id[order]
    wpos_sorted = range_cum_before(
        sorted_rid, torch.ones_like(sorted_rid, dtype=torch.int32),
        num_ranges)
    wpos = torch.empty_like(gpos).scatter_(1, order, wpos_sorted)
    t = truth_ids.long()
    return torch.gather(gpos, 1, t), torch.gather(wpos, 1, t)


def calibrate_from_order(order_ids, range_id, truth_ids, *,
                         num_ranges: Optional[int] = None,
                         grid: Optional[np.ndarray] = None
                         ) -> CalibrationTable:
    """Fit the table from an explicit probe order.

    order_ids: (Q, N) item ids in canonical probe order per query.
    range_id:  (N,) range of each item id.
    truth_ids: (Q, k) brute-force ground-truth ids.
    Tensors (or arrays) may live on any device; the per-query positions
    are found there, ``CAL_CHUNK`` queries at a time."""
    order_ids = torch.as_tensor(order_ids)
    device = order_ids.device
    range_id = torch.as_tensor(range_id, device=device)
    truth_ids = torch.as_tensor(truth_ids, device=device)
    q, n = order_ids.shape
    k = truth_ids.shape[1]
    rid_host = range_id.cpu().numpy().astype(np.int64)
    if num_ranges is None:
        num_ranges = int(rid_host.max()) + 1 if rid_host.size else 1
    m = int(num_ranges)
    counts = np.bincount(rid_host, minlength=m).astype(np.int64)
    grid = default_grid(n) if grid is None else np.asarray(grid, np.int64)

    g_parts, w_parts = [], []
    for s in range(0, q, CAL_CHUNK):
        g, w = _truth_positions(order_ids[s:s + CAL_CHUNK], range_id,
                                truth_ids[s:s + CAL_CHUNK], m)
        g_parts.append(g)
        w_parts.append(w)
    t_rid = rid_host[truth_ids.reshape(-1).cpu().numpy()]
    return _fit(g_parts, w_parts, t_rid, counts, grid, int(k), int(q))


def _fit(g_parts, w_parts, t_rid: np.ndarray, counts: np.ndarray,
         grid: np.ndarray, k: int, q: int) -> CalibrationTable:
    """The table from the truth items' global and within-range probe
    positions (blocks of (Q_block, k) tensors) and their ranges."""
    m = counts.shape[0]
    t_gpos = torch.cat(g_parts).reshape(-1).cpu().numpy().astype(np.int64)
    t_wpos = torch.cat(w_parts).reshape(-1).cpu().numpy().astype(np.int64)
    total = t_rid.size

    recall_global = (t_gpos[None, :] < grid[:, None]).mean(
        axis=1).astype(np.float32)
    recall_range = np.zeros((m, grid.size), np.float32)
    mass = np.zeros((m,), np.float32)
    for j in range(m):
        sel = t_rid == j
        mass[j] = sel.sum() / total
        eff = np.minimum(grid, counts[j])
        if sel.any():
            recall_range[j] = (t_wpos[sel][None, :]
                               < eff[:, None]).mean(axis=1)
        # the full range holds all its truth items
        recall_range[j, eff >= counts[j]] = 1.0
    return CalibrationTable(grid, recall_range, recall_global, mass,
                            counts, k, q)


def canonical_order(index, queries: torch.Tensor, *, buckets=None
                    ) -> torch.Tensor:
    """(Q, N) int32 item ids in the engines' canonical ``(rank, CSR
    position)`` probe order, on the index's device."""
    from repro_torch.core.bucket_index import build_bucket_index

    if buckets is None:
        buckets = build_bucket_index(index)
    fam = index.family
    q_codes = fam.encode_queries(index.params, queries, impl=index.spec.impl)
    parts = []
    for s in range(0, q_codes.shape[0], CAL_CHUNK):
        matches = fam.match_counts(index.params, q_codes[s:s + CAL_CHUNK],
                                   index.codes, index.hash_bits,
                                   impl=index.spec.impl)
        rank_csr = buckets.rank[index.range_id[None, :], matches][
            :, buckets.item_ids]
        order = torch.argsort(rank_csr, dim=1, stable=True)
        parts.append(buckets.item_ids[order])
    return torch.cat(parts)


def calibrate(index, queries: Optional[torch.Tensor] = None, *,
              k: int = DEFAULT_CAL_K,
              generator: Optional[torch.Generator] = None,
              num_queries: int = DEFAULT_CAL_QUERIES,
              grid: Optional[np.ndarray] = None,
              buckets=None) -> CalibrationTable:
    """Calibrate a :class:`~repro_torch.core.index.ComposedIndex` on
    held-out ``queries``, or on standard-normal queries drawn from
    ``generator`` (which must live on the index's device)."""
    device = index.items.device
    if queries is None:
        if generator is None:
            raise ValueError("pass calibration queries or a generator to "
                             "sample them")
        queries = torch.randn((num_queries, index.items.shape[-1]),
                              generator=generator, device=device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=device)
    n = int(index.items.shape[0])
    if not 0 < int(k) <= n:
        raise ValueError(f"calibration k={k} outside (0, N={n}]")
    order_ids = canonical_order(index, queries, buckets=buckets)
    _, truth = topk.exact_mips(queries, index.items, int(k))
    return calibrate_from_order(order_ids, index.range_id, truth,
                                num_ranges=int(index.table.shape[0]),
                                grid=grid)


def calibrate_streaming(mindex, queries, *, k: int = DEFAULT_CAL_K,
                        grid: Optional[np.ndarray] = None
                        ) -> CalibrationTable:
    """Calibrate a :class:`repro_torch.streaming.MutableIndex` over its
    live set (merged base+delta canonical order). Attach with
    ``mindex.set_calibration(table)``; structural events that move range
    boundaries flag it stale.

    Live items get compact ids ``[0, live)`` (storage rows first, then
    delta slots, as :meth:`MutableIndex.live_vectors` orders them). The
    queries run ``CAL_CHUNK`` at a time: each chunk's full merged order
    (chunk, live) is made, reduced to its truth positions and dropped, so
    no (Q, live) array is ever held."""
    device = mindex.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=device)
    live = mindex.live_count
    if not 0 < int(k) <= live:
        raise ValueError(f"calibration k={k} outside (0, live={live}]")
    vecs, gids = mindex.live_vectors()
    remap = np.full((mindex.store_size + mindex.delta.capacity,), -1,
                    np.int32)
    remap[gids] = np.arange(gids.size, dtype=np.int32)
    rid_all = np.concatenate([
        mindex._rid, mindex.delta._rid[:mindex.delta.count]])
    rid_live = rid_all[gids].astype(np.int64)
    m = mindex.num_ranges
    remap_t = torch.from_numpy(remap).to(device)
    rid_t = torch.from_numpy(rid_live).to(device)
    g_parts, w_parts, t_parts = [], [], []
    for s in range(0, queries.shape[0], CAL_CHUNK):
        qb = queries[s:s + CAL_CHUNK]
        order = remap_t[mindex.candidates(qb, live)]   # (chunk, live)
        _, truth = topk.exact_mips(qb, vecs, int(k))    # compact ids
        g, w = _truth_positions(order, rid_t, truth, m)
        g_parts.append(g)
        w_parts.append(w)
        t_parts.append(truth.reshape(-1).cpu().numpy())
        del order
    counts = np.bincount(rid_live, minlength=m).astype(np.int64)
    grid = default_grid(live) if grid is None else np.asarray(grid, np.int64)
    return _fit(g_parts, w_parts, rid_live[np.concatenate(t_parts)], counts,
                grid, int(k), int(queries.shape[0]))


# -- planning -----------------------------------------------------------------


def plan(calib: CalibrationTable, recall_target: float) -> Plan:
    """Per-range budgets predicted to meet the target: advance the range
    with the best Δrecall/Δprobes (ties: cheaper step, then lower range
    id) until ``sum_j mass_j r_j(b_j) >= target``. Deterministic, so
    plans for increasing targets are nested."""
    recall_target = check_target(recall_target)
    grid = calib.probe_grid
    counts = calib.range_counts
    m, g_max = calib.recall_range.shape
    level = np.zeros((m,), np.int64)
    eff = np.minimum(grid[None, :], counts[:, None])         # (R, G)
    contrib = calib.truth_mass[:, None] * calib.recall_range
    predicted = float(contrib[np.arange(m), level].sum())
    while predicted < recall_target:
        best, best_key = -1, None
        for j in range(m):
            lv = level[j]
            if lv + 1 >= g_max or eff[j, lv + 1] <= eff[j, lv]:
                continue                 # range exhausted
            dcost = int(eff[j, lv + 1] - eff[j, lv])
            dgain = float(contrib[j, lv + 1] - contrib[j, lv])
            key = (-dgain / dcost, dcost, j)
            if best_key is None or key < best_key:
                best, best_key = j, key
        if best < 0:                     # every range at full coverage
            break
        level[best] += 1
        predicted = float(contrib[np.arange(m), level].sum())
    budgets = tuple(int(eff[j, level[j]]) for j in range(m))
    return Plan(budgets, int(sum(budgets)), predicted, recall_target)


def plan_global(calib: CalibrationTable, recall_target: float) -> Plan:
    """The smallest grid ``num_probe`` whose measured global-prefix recall
    meets the target (``budgets`` is empty)."""
    recall_target = check_target(recall_target)
    ok = np.flatnonzero(calib.recall_global >= recall_target)
    g = int(ok[0]) if ok.size else int(calib.probe_grid.size - 1)
    num_probe = int(min(calib.probe_grid[g], calib.num_items))
    return Plan((), max(num_probe, 1),
                float(calib.recall_global[g]), recall_target)


def check_contract_k(calib: CalibrationTable, k) -> None:
    """Refuse a query k deeper than the calibrated one."""
    if k is not None and int(k) > calib.k:
        raise ValueError(
            f"recall contract was calibrated at k={calib.k} but queried "
            f"at k={k} — recalibrate with calibration_k >= {k}")


def resolve_budgets(calib: Optional[CalibrationTable],
                    recall_target: float, k=None) -> Plan:
    """Shared entry of the engines: a calibrated index and a covered k."""
    if calib is None:
        raise ValueError(
            "recall_target needs a calibrated index — build with "
            "IndexSpec(recall_target=...) or attach planner.calibrate()")
    check_contract_k(calib, k)
    return plan(calib, recall_target)


# -- adaptive early termination ----------------------------------------------


def adaptive_query(engine, queries, k: int, *,
                   recall_target: Optional[float] = None,
                   budgets: Optional[Sequence[int]] = None,
                   num_probe: Optional[int] = None,
                   chunk: int = ADAPTIVE_CHUNK, tracker=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Planned probing with provable per-query early termination.

    The planned candidates of ``engine`` (a
    :class:`~repro_torch.core.engine.QueryEngine`) are re-walked grouped
    by descending range cap (the stable reorder keeps canonical order
    within a cap), ``chunk`` at a time, each step an exact re-rank merged
    into the running top-k. A candidate's bound is its range's full-match
    score-table entry times ``||q||``; the cap-descending walk makes the
    next candidate's bound the best any unprobed one can reach. A query
    stops once its k-th value meets that bound, so ``(vals, ids)`` equal
    the full planned re-rank (up to exact-tie order) and ``probes_used``
    counts the candidates actually scored. Every ``ADAPTIVE_SYNC_STEPS``
    steps the host loop reads whether any query is still active, and ends
    when none is; a step after the last query stopped changes nothing (its
    scores are -inf, its count 0), so the results do not depend on how
    often it reads.

    ``tracker`` (default: the engine's) records each query's probes_used
    and the share of the planned width it saved, once, after the loop:
    the one extra read of ``probes_used`` to the host is made only when
    a tracker is set.

    Returns ``(vals, ids, probes_used)``: (Q, k) f32, (Q, k) int32 (-1
    past the finite values) and (Q,) int32."""
    index = engine.index
    if recall_target is not None:
        if budgets is not None or num_probe is not None:
            raise ValueError("pass one of recall_target/budgets/num_probe")
        budgets = resolve_budgets(getattr(index, "calib", None),
                                  recall_target, k=k).budgets
    if (budgets is None) == (num_probe is None):
        raise ValueError("pass exactly one of budgets/num_probe "
                         "(or recall_target)")
    items = index.items
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=items.device)
    if budgets is not None:
        cand = engine.candidates(queries, budgets=budgets)
    else:
        cand = engine.candidates(queries, num_probe)
    p = int(cand.shape[1])
    k = int(k)
    if not 0 < k <= p:
        raise ValueError(f"k={k} outside (0, planned width {p}]")

    # hard per-candidate bound: the full-match score-table entry of its
    # range (the table rises in l, so the last column), times ||q||
    cap = index.table[:, -1][index.range_id[cand.long()].long()]
    reorder = torch.argsort(-cap, dim=-1, stable=True)
    cand = torch.gather(cand, 1, reorder)
    bound = torch.gather(cap, 1, reorder).to(torch.float32) \
        * hashing.l2_norm(queries)[:, None]                    # descending
    q = queries.shape[0]
    dev = items.device
    vals = torch.full((q, k), float("-inf"), dtype=torch.float32,
                      device=dev)
    ids = torch.full((q, k), -1, dtype=cand.dtype, device=dev)
    used = torch.zeros((q,), dtype=torch.int32, device=dev)
    active = torch.ones((q,), dtype=torch.bool, device=dev)
    for step, c in enumerate(range(0, p, chunk)):
        if step % ADAPTIVE_SYNC_STEPS == 0 and not bool(active.any()):
            break
        sl = cand[:, c:c + chunk]
        with full_f32():
            ip = torch.einsum("qd,qpd->qp", queries, items[sl.long()])
        ip = torch.where(active[:, None], ip, float("-inf"))
        # lax.top_k over [vals, ip]: a stable descending sort keeps equal
        # values in column order
        av, order = torch.sort(torch.cat([vals, ip], dim=1), dim=1,
                               descending=True, stable=True)
        vals = av[:, :k]
        ids = torch.gather(torch.cat([ids, sl], dim=1), 1, order[:, :k])
        used += torch.where(active, sl.shape[1], 0).to(torch.int32)
        if c + chunk >= p:
            break
        active &= vals[:, k - 1] < bound[:, c + chunk]
    ids = torch.where(torch.isfinite(vals), ids, -1)
    tr = tracker if tracker is not None else getattr(engine, "tracker",
                                                     None)
    if tr is not None:
        for u in used.cpu().numpy():
            tr.observe("repro.planner.probes_used", float(u))
            tr.observe("repro.planner.adaptive_savings",
                       float(p - u) / float(p))
        tr.count("repro.planner.adaptive_queries", q)
        tr.gauge("repro.planner.planned_width", p)
    return vals, ids.to(torch.int32), used
