"""Distributed serving on the composable spec API (port of
``repro/core/distributed.py``).

Algorithm 2 of the paper ("take the best across sub-datasets") is exactly
a distributed merge, and the norm-range partition composes with any base
hash, so the distributed layer is built on the same two pieces as the
single-device path:

  * **shard-aligned layout** (:func:`build_sharded`): the spec-built index
    is laid out in its *global CSR bucket order*, items sorted by
    ``(range_id, code, id)``, and split into ``num_shards`` contiguous
    spans whose boundaries land on bucket starts (``align="range"``
    restricts them to range starts). Every shard owns whole buckets and a
    contiguous run of norm ranges. Per-shard rows are padded to a common
    length and masked by ``valid`` / ``perm == -1``.
  * **replicated directory**: ``(rid, code, size)`` of every bucket plus
    its owning shard and local CSR offset, O(B); the O(N) item payload is
    what shards.
  * **per-shard traversal** (:func:`_shard_query`): every shard computes
    the *global* bucket probe order from the replicated directory, derives
    how many items of each bucket the global ``num_probe`` budget (or the
    planner's per-range budgets) takes, and gathers and re-ranks only the
    probed items it owns. The probed union across shards is exactly the
    first ``num_probe`` items of the single-device canonical order, so the
    merged ids equal ``QueryEngine.query``'s (tested). ``engine="dense"``
    scans the local codes instead (same probed set).
  * **merge** (:func:`merge_shards`): per-shard stable top-k, one all-gather of
    ``(vals, ids)`` and a stable re-top-k. Shards whose probed count falls
    short of ``k`` pad with ``(-inf, -1)``.

The reference runs the body inside ``shard_map`` over a mesh axis. Here a
**shard group** takes the mesh's place, with two implementations:

  * :class:`ProcessShardGroup` — a ``torch.distributed`` group, one rank
    per shard (NCCL on the card, gloo on the CPU); each rank runs its own
    shard's body and the merge all-gathers with
    ``all_gather_into_tensor``;
  * :class:`InProcessShardGroup` — the S shard bodies run in turn on one
    device and their (vals, ids) are stacked (the counterpart of the
    reference's multi-device CPU mesh).

Both give the same result. ``query_axis`` (the number of query shards, the
group's second axis) splits the batch: a group of ``S * T`` members runs
member ``m`` on item shard ``m % S`` and query block ``m // S``; the merge
gathers over items first and then over queries, restoring the (Q, k)
answer.

The reference keys a jitted collective per ``(num_probe, k, budgets)``
(``repro.engine.distributed.jit_cache.hit``/``miss``); the port runs
eagerly, and those counters count its memo of the checked per-key plans.
``trace_count`` has no counterpart.

The legacy surface (``build`` / ``query``) is kept as thin shims over this
path; ``num_probe_per_shard`` maps onto the global budget
``min(N, num_probe_per_shard * num_shards)``.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bucket_index import (build_bucket_index,
                                           rank_from_scores)
from repro_torch.core.engine import check_budgets, select_engine
from repro_torch.core.index import ComposedMultiTable, IndexSpec, _check_probe
from repro_torch.core.index import build as build_spec
from repro_torch.core.probe import DEFAULT_EPS
from repro_torch.core.topk import gathered_scores
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (planned_take, range_cum_before,
                                    stable_topk)
from repro_torch.obs.trace import span_or_null
from repro_torch.obs.tracker import resolve_tracker

ALIGNMENTS = ("bucket", "range")
_INT32_MAX = 2 ** 31 - 1


# -- shard groups ---------------------------------------------------------------


class InProcessShardGroup:
    """``size`` members on one device: every member's body runs in this
    process, in turn, and a gather stacks their results."""

    def __init__(self, size: int):
        if int(size) < 1:
            raise ValueError(f"a shard group needs >= 1 member, got {size}")
        self.size = int(size)

    def members(self) -> List[int]:
        return list(range(self.size))

    def all_gather(self, local: Sequence[torch.Tensor]) -> torch.Tensor:
        """(size, ...) stack of the members' tensors (one per member)."""
        return torch.stack(list(local))

    def all_reduce(self, local: Sequence[torch.Tensor],
                   op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of the members' tensors
        (one per member), the value every member receives."""
        return _reduce(torch.stack(list(local)), op)


def _reduce(stacked: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return stacked.sum(0)
    if op == "max":
        return stacked.amax(0)
    raise ValueError(f"unknown reduction {op!r}; expected 'sum' or 'max'")


class ProcessShardGroup:
    """A ``torch.distributed`` group, one member (rank) per process: the
    default group, or ``group`` (a sub-group, e.g. one dimension of a
    ``DeviceMesh``: :func:`mesh_shard_group`). The caller initializes the
    default group (``init_process_group`` with its address, world size
    and rank)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessShardGroup needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def members(self) -> List[int]:
        return [self.rank]

    def all_reduce(self, local: Sequence[torch.Tensor],
                   op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of every rank's tensor,
        through one ``all_reduce``."""
        import torch.distributed as dist
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"unknown reduction {op!r}; expected 'sum' or "
                             f"'max'")
        (mine,) = local
        out = mine.contiguous().clone()
        dist.all_reduce(out, op=ops[op], group=self.group)
        return out

    def all_gather(self, local: Sequence[torch.Tensor]) -> torch.Tensor:
        """(size, ...) tensors of every rank, rank order, through one
        ``all_gather_into_tensor``."""
        import torch.distributed as dist
        (mine,) = local
        mine = mine.contiguous()
        out = torch.empty((self.size * mine.shape[0],) + mine.shape[1:],
                          dtype=mine.dtype, device=mine.device)
        dist.all_gather_into_tensor(out, mine, group=self.group)
        return out.reshape((self.size,) + tuple(mine.shape))


def mesh_shard_group(mesh, name: str) -> ProcessShardGroup:
    """The shard group of the ranks along dimension ``name`` of a
    ``DeviceMesh`` that hold this rank's other coordinates; its member is
    this rank's index along ``name``."""
    group = ProcessShardGroup(mesh.get_group(name))
    group.rank = mesh.get_local_rank(name)
    return group


# -- the shard-aligned index ---------------------------------------------------


class ShardedIndex(NamedTuple):
    """Spec-built index in shard-aligned global CSR layout.

    Replicated (small): ``params`` (family hash parameters), ``rank``
    (probe rank per ``(range, match count)``), and the bucket directory
    ``dir_*`` — per bucket its code, range, item count, owning shard and
    start offset *within the owner's local rows*.

    Sharded (O(N)): ``(num_shards * rows_per_shard, ...)`` arrays, shard
    ``s`` owning rows ``[s * rows_per_shard, (s+1) * rows_per_shard)`` —
    its contiguous global-CSR span first, then padding (``valid`` False,
    ``perm`` -1). After :func:`shard_index` on a process group a rank
    holds only its own ``rows_per_shard`` rows. ``bucket_of`` /
    ``bucket_off`` place each row in its (global) bucket, which is how the
    dense arm recovers the item's global canonical probe position.
    """

    spec: IndexSpec
    params: Any
    rank: torch.Tensor             # (R, n_hashes+1) int32
    dir_code: torch.Tensor         # (B, W) int32 (packed bits) | (B, K)
    dir_rid: torch.Tensor          # (B,)  int32
    dir_size: torch.Tensor         # (B,)  int32
    dir_shard: torch.Tensor        # (B,)  int32 owning shard
    dir_local_start: torch.Tensor  # (B,)  int32 offset within the owner rows
    items: torch.Tensor            # (S*rows, d) f32
    codes: torch.Tensor            # (S*rows, W|K) int32
    range_id: torch.Tensor         # (S*rows,) int32
    bucket_of: torch.Tensor        # (S*rows,) int32
    bucket_off: torch.Tensor       # (S*rows,) int32
    perm: torch.Tensor             # (S*rows,) int32 original item id (-1 pad)
    valid: torch.Tensor            # (S*rows,) bool
    num_shards: int
    rows_per_shard: int
    num_items: int
    hash_bits: int
    calib: Optional[object] = None  # planner CalibrationTable (host-side)

    @property
    def num_buckets(self) -> int:
        return self.dir_rid.shape[0]

    @property
    def family(self):
        return self.spec.resolve_family()

    def shard_rows(self, s: int) -> slice:
        """The rows of shard ``s`` in this index's per-item arrays (all
        shards' rows, or after :func:`shard_index` on a process group the
        rank's own)."""
        r = self.rows_per_shard
        if self.items.shape[0] == r:
            return slice(0, r)
        return slice(s * r, (s + 1) * r)


def _split_offsets(bounds: np.ndarray, n: int, num_shards: int
                   ) -> np.ndarray:
    """(S+1,) non-decreasing item offsets: each interior cut is the legal
    boundary nearest the ideal equal-item split."""
    cut = np.zeros((num_shards + 1,), np.int64)
    cut[-1] = n
    for s in range(1, num_shards):
        ideal = int(round(s * n / num_shards))
        j = int(np.searchsorted(bounds, ideal))
        cands = [int(bounds[i]) for i in (j - 1, j)
                 if 0 <= i < bounds.size]
        best = min(cands, key=lambda b: abs(b - ideal)) if cands else 0
        cut[s] = max(best, cut[s - 1])
    return cut


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_sharded(spec: IndexSpec, items, generator=None,
                  num_shards: int = 1, *, align: str = "bucket",
                  strict: bool = True, calibration_queries=None,
                  calibration_k: Optional[int] = None, params=None,
                  device=None) -> ShardedIndex:
    """Build the shard-aligned index for any spec, on ``device`` (the card
    unless ``device="cpu"``).

    ``align="bucket"`` (default) splits at bucket boundaries balancing
    item counts; ``align="range"`` restricts cuts to norm-range
    boundaries. Planner calibration (a spec ``recall_target`` or explicit
    calibration kwargs) happens on the pre-layout index — the calibrated
    canonical order is what every shard traverses — and the table rides
    replicated on the result. ``params`` hands in the hash parameters in
    place of drawing them from ``generator`` (as ``core.index.build``).
    """
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if align not in ALIGNMENTS:
        raise ValueError(f"unknown align {align!r}; "
                         f"expected one of {ALIGNMENTS}")
    cidx = build_spec(spec, items, generator, params=params, strict=strict,
                      calibration_queries=calibration_queries,
                      calibration_k=calibration_k, device=device)
    if isinstance(cidx, ComposedMultiTable):
        raise ValueError("multi-table single-probe has no sharded path")
    buckets = build_bucket_index(cidx)
    device = cidx.items.device

    bstart = _host(buckets.bucket_start).astype(np.int64)     # (B+1,)
    brid = _host(buckets.bucket_rid)
    item_ids = _host(buckets.item_ids).astype(np.int64)
    n, num_b = item_ids.shape[0], brid.shape[0]

    if align == "range":
        new_range = np.ones((num_b,), bool)
        if num_b > 1:
            new_range[1:] = brid[1:] != brid[:-1]
        bounds = bstart[:-1][new_range]
    else:
        bounds = bstart[:-1]
    cut = _split_offsets(bounds, n, num_shards)
    rows = max(int(np.max(np.diff(cut))), 1)

    sizes = np.diff(bstart)
    bucket_of_g = np.repeat(np.arange(num_b, dtype=np.int64), sizes)
    off_g = np.arange(n, dtype=np.int64) - bstart[bucket_of_g]

    total = num_shards * rows
    src = np.zeros((total,), np.int64)        # global item id per slot
    perm = np.full((total,), -1, np.int32)
    valid = np.zeros((total,), bool)
    bof = np.zeros((total,), np.int32)
    boff = np.zeros((total,), np.int32)
    for s in range(num_shards):
        a, b = int(cut[s]), int(cut[s + 1])
        sl = slice(s * rows, s * rows + (b - a))
        src[sl] = item_ids[a:b]
        perm[sl] = item_ids[a:b]
        valid[sl] = True
        bof[sl] = bucket_of_g[a:b]
        boff[sl] = off_g[a:b]

    src_t = torch.as_tensor(src, device=device)
    valid_t = torch.as_tensor(valid, device=device)
    items_sh = torch.where(valid_t[:, None], cidx.items[src_t], 0.0)
    codes_sh = torch.where(valid_t[:, None], cidx.codes[src_t], 0)
    rid_sh = torch.where(valid_t, cidx.range_id[src_t], 0).to(torch.int32)

    dir_shard = (np.searchsorted(cut, bstart[:-1], side="right") - 1)
    dir_shard = np.clip(dir_shard, 0, num_shards - 1).astype(np.int32)
    dir_local_start = (bstart[:-1] - cut[dir_shard]).astype(np.int32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return ShardedIndex(
        spec=spec,
        params=cidx.params,
        rank=rank_from_scores(cidx.table),
        dir_code=buckets.bucket_code,
        dir_rid=buckets.bucket_rid,
        dir_size=dev(sizes.astype(np.int32)),
        dir_shard=dev(dir_shard),
        dir_local_start=dev(dir_local_start),
        items=items_sh.contiguous(),
        codes=codes_sh.contiguous(),
        range_id=rid_sh,
        bucket_of=dev(bof),
        bucket_off=dev(boff),
        perm=dev(perm),
        valid=valid_t,
        num_shards=num_shards,
        rows_per_shard=rows,
        num_items=n,
        hash_bits=cidx.hash_bits,
        calib=cidx.calib,
    )


ROW_FIELDS = ("items", "codes", "range_id", "bucket_of", "bucket_off",
              "perm", "valid")


def shard_index(index: ShardedIndex, group, *, query_axis: int = 1
                ) -> ShardedIndex:
    """Place the index on ``group``: an in-process group keeps every
    shard's rows; a process group keeps only this rank's shard (member
    ``m`` serves item shard ``m % num_shards``). The group must have
    ``num_shards * query_axis`` members."""
    query_axis = int(query_axis)
    if group.size != index.num_shards * query_axis:
        raise ValueError(
            f"index was built for {index.num_shards} shards x {query_axis} "
            f"query shard(s) but the group has {group.size} members")
    if isinstance(group, InProcessShardGroup):
        return index
    (m,) = group.members()
    sl = index.shard_rows(m % index.num_shards)
    return index._replace(**{f: getattr(index, f)[sl].contiguous()
                             for f in ROW_FIELDS})


def _shard_query(q_codes, queries, index: ShardedIndex, my: int, *,
                 num_probe: int, k: int, engine: str, impl: str,
                 budgets: Optional[Tuple[int, ...]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard body: global directory traversal -> local probe of the
    owned slice of the canonical first-``num_probe`` items (or, with
    ``budgets``, of the planner's per-range prefixes totalling
    ``num_probe``) -> exact local top-k, padded with ``(-inf, -1)``.
    Returns the shard's (vals, ids), each (Q, k), for :func:`merge_shards`."""
    fam = index.family
    sl = index.shard_rows(my)
    items, codes = index.items[sl], index.codes[sl]
    range_id, perm = index.range_id[sl], index.perm[sl]
    dev = q_codes.device
    q_local = q_codes.shape[0]

    # global bucket probe order, identical on every shard (replicated
    # inputs): matches -> rank -> stable argsort
    matches = fam.match_counts(index.params, q_codes, index.dir_code,
                               index.hash_bits, impl=impl)      # (Q, B)
    brank = index.rank[index.dir_rid[None, :].long(), matches.long()]
    order = torch.argsort(brank, dim=-1, stable=True)          # (Q, B)
    # a shard re-ranks at most its own rows, whatever the global budget
    width = min(num_probe, codes.shape[0])

    if engine == "bucket":
        # walk only the owned buckets' runs. Every bucket holds >= 1 item,
        # so the first min(B, P) probe-ordered buckets cover a global
        # budget; per-range budgets can land anywhere, so they walk the
        # full directory.
        if budgets is not None:
            sel = order
            sizes_o = index.dir_size[sel]
            take = planned_take(index.dir_rid[order], sizes_o, budgets)
        else:
            sel = order[:, :min(order.shape[1], num_probe)]
            sizes_o = index.dir_size[sel]
            cum = torch.cumsum(sizes_o, dim=-1, dtype=torch.int32)
            take = torch.clamp(num_probe - (cum - sizes_o), min=0)
            take = torch.minimum(take, sizes_o)
        owned = index.dir_shard[sel] == my
        ltake = torch.where(owned, take, 0)
        lcum = torch.cumsum(ltake, dim=-1, dtype=torch.int32)
        total = lcum[:, -1]                                    # (Q,)
        starts_o = index.dir_local_start[sel]
        zero = torch.zeros((q_local, 1), dtype=torch.int32, device=dev)
        # a covering run keeps the gather in-contract past ``total``; its
        # slots are masked below
        cum2 = torch.cat([zero, lcum, lcum[:, -1:] + width], dim=1)
        starts2 = torch.cat([starts_o, zero], dim=1)
        pos = ops.bucket_gather(cum2, starts2, width, impl=impl)
    else:
        # dense arm: score every local row, keep rows whose canonical
        # position (items before its bucket + in-bucket offset — global
        # under a scalar budget, within-range under planned budgets) is
        # under the budget — the same probed set as the bucket arm
        md = fam.match_counts(index.params, q_codes, codes,
                              index.hash_bits, impl=impl)      # (Q, rows)
        irank = index.rank[range_id[None, :].long(), md.long()]
        if budgets is not None:
            before = range_cum_before(index.dir_rid[order],
                                      index.dir_size[order], len(budgets))
        else:
            sizes_o = index.dir_size[order]
            before = torch.cumsum(sizes_o, dim=-1,
                                  dtype=torch.int32) - sizes_o
        cpb = torch.zeros_like(before).scatter_(1, order, before)
        bof = index.bucket_of[sl].long()
        wpos = cpb[:, bof] + index.bucket_off[sl][None, :]
        if budgets is not None:
            cap = torch.tensor(budgets, dtype=torch.int32,
                               device=dev)[range_id.long()][None, :]
        else:
            cap = num_probe
        probed = index.valid[sl][None, :] & (wpos < cap)
        key = torch.where(probed, irank, _INT32_MAX)
        order_l = torch.argsort(key, dim=-1, stable=True)
        pos = order_l[:, :width].to(torch.int32)
        total = torch.sum(probed.to(torch.int32), dim=-1)

    slot_ok = (torch.arange(width, dtype=torch.int32, device=dev)[None, :]
               < total[:, None])
    ip = torch.where(slot_ok, gathered_scores(queries, items, pos),
                     -torch.inf)
    if width < k:        # a shard smaller than k still merges cleanly
        ip = torch.cat([ip, torch.full((q_local, k - width), -torch.inf,
                                       device=dev)], dim=1)
        pos = torch.cat([pos, torch.zeros((q_local, k - width),
                                          dtype=pos.dtype, device=dev)],
                        dim=1)
    lvals, lpos = stable_topk(ip, k)
    lids = perm[torch.gather(pos.long(), 1, lpos)]
    # padded/tombstone slots must not leak ids into the merge
    lids = torch.where(lvals == -torch.inf, -1, lids)
    return lvals, lids


def merge_shards(av: torch.Tensor, ai: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2's merge of gathered (S, Q, k) shard results: a stable
    re-top-k over the S * k entries of each query (equal values to the
    lower shard, then the lower slot)."""
    s_all, q_all, kk = av.shape
    fv = av.permute(1, 0, 2).reshape(q_all, s_all * kk)
    fi = ai.permute(1, 0, 2).reshape(q_all, s_all * kk)
    bv, bp = stable_topk(fv, k)
    bi = torch.gather(fi, 1, bp)
    return bv, torch.where(bv == -torch.inf, -1, bi)


class _Plan(NamedTuple):
    """What one ``(num_probe, k, budgets)`` key needs on every call."""
    num_probe: int
    k: int
    budgets: Optional[Tuple[int, ...]]


class DistributedEngine:
    """Batched distributed MIPS over a placed :class:`ShardedIndex`.

    Args:
      index:  a ``build_sharded`` index placed with :func:`shard_index`.
      group:  the shard group it was placed on (:class:`InProcessShardGroup`
              or :class:`ProcessShardGroup`), ``num_shards * query_axis``
              members.
      engine: "bucket" | "dense" | "auto" (directory-size break-even);
              None takes the spec's engine.
      impl:   kernel dispatch; None takes the spec's.
      query_axis: the number of query shards (the group's second axis);
              the batch splits evenly over them.
      tracker: optional :class:`repro_torch.obs.Tracker` (None = ambient
              default). Records the encode and collective spans, query
              counters and the plan memo's hit/miss counts; results are
              unchanged.
    """

    def __init__(self, index: ShardedIndex, group, *,
                 engine: Optional[str] = None, impl: Optional[str] = None,
                 query_axis: Optional[int] = None, tracker=None):
        self.query_shards = 1 if query_axis is None else int(query_axis)
        if group.size != index.num_shards * self.query_shards:
            raise ValueError(
                f"index has {index.num_shards} shards x "
                f"{self.query_shards} query shard(s) but the group has "
                f"{group.size} members")
        engine = index.spec.engine if engine is None else engine
        if engine not in ("auto", "dense", "bucket"):
            raise ValueError(f"unknown engine: {engine!r}")
        if engine == "auto":
            engine = select_engine(index.num_buckets, index.num_items)
        self.index = index
        self.group = group
        self.engine = engine
        self.impl = index.spec.impl if impl is None else impl
        self.query_axis = query_axis
        self.family = index.spec.resolve_family()
        self.tracker = resolve_tracker(tracker)
        self._plans = {}
        self._range_counts_cache = None

    @property
    def _range_counts(self) -> np.ndarray:
        """Global per-range item counts from the replicated directory."""
        if self._range_counts_cache is None:
            idx = self.index
            self._range_counts_cache = np.bincount(
                _host(idx.dir_rid), weights=_host(idx.dir_size),
                minlength=idx.rank.shape[0]).astype(np.int64)
        return self._range_counts_cache

    def _plan(self, num_probe: int, k: int, budgets=None) -> _Plan:
        """The memoized plan of one ``(num_probe, k, budgets)`` key —
        repeat traffic (decode steps, fixed-budget batches) hits the memo
        (``repro.engine.distributed.jit_cache.hit``/``miss``, the
        reference's names for its jitted-collective cache)."""
        key = (num_probe, k, budgets)
        plan = self._plans.get(key)
        tr = self.tracker
        if plan is not None:
            if tr is not None:
                tr.count("repro.engine.distributed.jit_cache.hit")
            return plan
        if tr is not None:
            tr.count("repro.engine.distributed.jit_cache.miss")
        plan = _Plan(num_probe, k, budgets)
        self._plans[key] = plan
        return plan

    def _run(self, q_codes: torch.Tensor, queries: torch.Tensor,
             plan: _Plan) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every member's body, the gather over items, the merge, then
        the gather over query blocks."""
        S, T = self.index.num_shards, self.query_shards
        Q = queries.shape[0]
        if Q % T:
            raise ValueError(f"{Q} queries do not split over {T} query "
                             f"shards")
        qb = Q // T
        local_v, local_i = [], []
        for m in self.group.members():
            t, s = divmod(m, S)
            blk = slice(t * qb, (t + 1) * qb)
            v, i = _shard_query(
                q_codes[blk], queries[blk], self.index, s,
                num_probe=plan.num_probe, k=plan.k, engine=self.engine,
                impl=self.impl, budgets=plan.budgets)
            local_v.append(v)
            local_i.append(i)
        av = self.group.all_gather(local_v)          # (S * T, qb, k)
        ai = self.group.all_gather(local_i)
        av = av.reshape(T, S, qb, plan.k)
        ai = ai.reshape(T, S, qb, plan.k)
        merged = [merge_shards(av[t], ai[t], plan.k) for t in range(T)]
        return (torch.cat([v for v, _ in merged]),
                torch.cat([i for _, i in merged]))

    def query(self, queries: torch.Tensor, k: int,
              num_probe: Optional[int] = None, *,
              recall_target: Optional[float] = None,
              budgets=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Distributed Algorithm 2 under a *global* probe budget: the
        probed union across shards is exactly the first ``num_probe``
        items of the single-device canonical order, so the (vals, ids) —
        each (Q, k) — equal ``QueryEngine.query``'s on the same spec.

        ``budgets`` / ``recall_target`` select the planner's per-range
        contract instead: every shard derives the same per-range takes
        from the replicated directory, so the probed union is exactly the
        single-device *planned* candidate set."""
        idx = self.index
        if recall_target is not None:
            if num_probe is not None or budgets is not None:
                raise ValueError(
                    "pass one of num_probe/budgets/recall_target")
            from repro_torch.core.planner import resolve_budgets
            budgets = resolve_budgets(idx.calib, recall_target,
                                      k=k).budgets
        if budgets is not None:
            if num_probe is not None:
                raise ValueError("pass one of num_probe/budgets")
            budgets, num_probe = check_budgets(budgets, self._range_counts)
            if not 0 < int(k) <= num_probe:
                raise ValueError(f"k={k} outside (0, planned width "
                                 f"{num_probe}]")
        else:
            if num_probe is None:
                raise ValueError(
                    "pass num_probe, budgets or recall_target")
            num_probe = _check_probe(num_probe, k, idx.num_items)
        queries = queries.to(torch.float32)
        tr = self.tracker
        with span_or_null(tr, "repro.engine.hash_encode") as sp:
            q_codes = sp.sync(self.family.encode_queries(
                idx.params, queries, impl=self.impl))
        plan = self._plan(num_probe, int(k), budgets)
        # the re-rank uses the ORIGINAL queries (true inner products); the
        # family transform only affects the hash codes
        with span_or_null(tr, "repro.engine.distributed.collective") as sp:
            vals, ids = sp.sync(self._run(q_codes, queries, plan))
        if tr is not None:
            tr.count("repro.engine.queries", queries.shape[0])
            tr.observe("repro.engine.probe_width", num_probe)
            if budgets is not None:
                for j, b in enumerate(budgets):
                    tr.observe(f"repro.engine.probes_used.range{j}", b)
        return vals, ids


# -- legacy shims (seed-era dense RANGE-LSH surface) ---------------------------


def build(items, generator, code_len: int, num_ranges: int,
          num_shards: int, *, eps: float = DEFAULT_EPS, impl: str = "auto",
          params=None, device=None) -> ShardedIndex:
    """Legacy entry point: RANGE-LSH == ``IndexSpec(family="simple")``
    through :func:`build_sharded` (strict=False, as the old kwargs
    surface allowed any ``num_ranges``)."""
    spec = IndexSpec(family="simple", code_len=code_len, m=num_ranges,
                     engine="dense", eps=eps, impl=impl)
    return build_sharded(spec, items, generator, num_shards, strict=False,
                         params=params, device=device)


# one-slot engine memo for the legacy shim: repeat calls over the same
# (index, group) reuse the engine and its plan memo. The entry holds
# strong refs to index and group, so the id() key can't be a stale reuse.
_shim_engine: dict = {}


def query(index: ShardedIndex, queries: torch.Tensor, k: int,
          num_probe_per_shard: int, group, query_axis: Optional[int] = None,
          *, engine: Optional[str] = None, impl: Optional[str] = None,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Legacy entry point over :class:`DistributedEngine` (construct the
    engine directly for serving loops).

    The seed-era ``num_probe_per_shard`` bounded re-rank work per device
    with a per-shard local scan; the engine's budget is global and exact,
    so the shim maps it to ``num_probe = min(N, num_probe_per_shard *
    num_shards)`` — identical at full budget, and the same per-device
    probe ceiling otherwise."""
    num_probe = min(index.num_items,
                    int(num_probe_per_shard) * index.num_shards)
    key = (id(index), id(group), query_axis, engine, impl)
    ent = _shim_engine.get(key)
    if ent is None:
        eng = DistributedEngine(index, group, engine=engine, impl=impl,
                                query_axis=query_axis)
        _shim_engine.clear()
        _shim_engine[key] = (index, group, eng)
    else:
        eng = ent[2]
    return eng.query(queries, k, num_probe)

