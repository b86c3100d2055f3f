"""Composable index API (port of ``repro/core/index.py``).

One :class:`IndexSpec` names a hash family, a code budget, a partition
scheme and a query engine; :func:`build` turns it into a
:class:`ComposedIndex`:

    build(IndexSpec(family="simple", code_len=32, m=32), items, gen)
        == the paper's RANGE-LSH (Algorithm 1)
    build(IndexSpec(family="simple", code_len=32), items, gen)
        == SIMPLE-LSH (the m = 1 case)
    build(IndexSpec(family="l2_alsh", code_len=32, m=16), items, gen)
        == the §5 norm-ranged L2-ALSH
    build(IndexSpec(family="sign_alsh", code_len=32, m=16), items, gen)
        == ranged SIGN-ALSH
    build(IndexSpec(..., num_tables=8), items, gen)
        == multi-table single-probe over any family

With a ``recall_target`` the build also calibrates the planner, and
queries that name no budget are planned to meet the target.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import hashing
from repro_torch.core.family import FAMILY_NAMES, HashFamily, get_family
from repro_torch.core.partition import effective_upper, partition_by_scheme
from repro_torch.core.probe import DEFAULT_EPS
from repro_torch.core.topk import rerank
from repro_torch.kernels.ref import full_f32, stable_topk

SCHEMES = ("percentile", "uniform")
ENGINES = ("auto", "dense", "bucket", "fused")
IMPLS = ("auto", "cuda", "ref")


def index_bits(m: int) -> int:
    """Bits of the code budget consumed by the sub-dataset id (§4)."""
    return max(0, math.ceil(math.log2(m))) if m > 1 else 0


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Declarative index description, hashable by value (a memo key: lint
    rule R4 keeps it frozen, with ``tracker`` out of ``__eq__`` and
    ``__hash__``).

    Attributes:
      family:    base hash family ("simple" | "l2_alsh" | "sign_alsh").
      code_len:  total code budget L.
      m:         number of norm ranges (1 = un-partitioned).
      scheme:    "percentile" (Algorithm 1) | "uniform" (Fig 3a).
      engine:    default query engine ("dense" | "bucket" | "fused" |
                 "auto").
      impl:      kernel dispatch ("auto" | "cuda" | "ref").
      num_tables: T > 1 builds multi-table single-probe.
      eps:       eq.-12 slack.
      recall_target: default recall contract; ``build`` calibrates.
      charge_index_bits: override the family's §4 protocol.
      alsh_m/alsh_U/alsh_r: ALSH transform order / scaling /
                 quantization width overrides (None = the family's
                 recommended values).
      tracker:   optional :class:`repro_torch.obs.Tracker` the built
                 index's query surfaces report to. Left out of equality,
                 hash and repr: attaching observability never changes
                 what the spec is or what queries return.
    """

    family: str = "simple"
    code_len: int = 32
    m: int = 1
    scheme: str = "percentile"
    engine: str = "dense"
    impl: str = "auto"
    num_tables: int = 1
    eps: float = DEFAULT_EPS
    recall_target: Optional[float] = None
    charge_index_bits: Optional[bool] = None
    alsh_m: Optional[int] = None
    alsh_U: Optional[float] = None
    alsh_r: Optional[float] = None
    tracker: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    def resolve_family(self) -> HashFamily:
        return get_family(self.family, alsh_m=self.alsh_m,
                          alsh_U=self.alsh_U, alsh_r=self.alsh_r)

    @property
    def charges(self) -> bool:
        if self.charge_index_bits is not None:
            return self.charge_index_bits
        if self.num_tables > 1:
            return False
        return self.resolve_family().charges_index_bits

    @property
    def index_bits(self) -> int:
        return index_bits(self.m) if self.charges else 0

    @property
    def hash_bits(self) -> int:
        """Number of hash functions after the §4 index-bit charge."""
        return self.code_len - self.index_bits

    @property
    def ranged(self) -> bool:
        return self.m > 1

    def validate(self, strict: bool = True) -> "IndexSpec":
        """Raise ``ValueError`` on an inconsistent configuration (the
        reference's checks, in its order); returns self."""
        if self.family not in FAMILY_NAMES:
            raise ValueError(f"unknown hash family {self.family!r}; "
                             f"expected one of {FAMILY_NAMES}")
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown partition scheme {self.scheme!r}; "
                             f"expected one of {SCHEMES}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; "
                             f"expected one of {IMPLS}")
        if self.code_len < 1:
            raise ValueError(f"code_len must be >= 1, got {self.code_len}")
        if self.m < 1:
            raise ValueError(f"m (number of norm ranges) must be >= 1, "
                             f"got {self.m}")
        if self.num_tables < 1:
            raise ValueError(f"num_tables must be >= 1, "
                             f"got {self.num_tables}")
        if not 0.0 <= self.eps < 1.0:
            raise ValueError(f"eps must be in [0, 1), got {self.eps}")
        if self.num_tables > 1 and self.engine in ("bucket", "fused"):
            raise ValueError("multi-table single-probe has no bucket "
                             "store; use engine='dense'")
        if self.recall_target is not None:
            if not 0.0 < self.recall_target <= 1.0:
                raise ValueError(f"recall_target must be in (0, 1], got "
                                 f"{self.recall_target}")
            if self.num_tables > 1:
                raise ValueError("multi-table single-probe has no probe "
                                 "budget to plan; recall_target does not "
                                 "apply")
        if self.charges and self.hash_bits <= 0:
            raise ValueError(
                f"code_len={self.code_len} leaves {self.hash_bits} hash "
                f"bits after charging {self.index_bits} index bits for "
                f"m={self.m} ranges (§4 protocol) — raise code_len or "
                f"lower m")
        if strict and self.charges and self.m > 1 \
                and self.m & (self.m - 1) != 0:
            b = index_bits(self.m)
            raise ValueError(
                f"m={self.m} is not a power of two: the {b} charged index "
                f"bits address {2 ** b} ranges, silently wasting id space "
                f"— use m={2 ** (b - 1)} or m={2 ** b}, or set "
                f"charge_index_bits=False")
        if self.alsh_m is not None and self.alsh_m < 1:
            raise ValueError(f"alsh_m must be >= 1, got {self.alsh_m}")
        if self.alsh_U is not None and not 0.0 < self.alsh_U <= 1.0:
            raise ValueError(f"alsh_U must be in (0, 1], got {self.alsh_U}")
        if self.alsh_r is not None and self.alsh_r <= 0.0:
            raise ValueError(f"alsh_r must be > 0, got {self.alsh_r}")
        return self


def _check_probe(num_probe: int, k: Optional[int], n: int) -> int:
    num_probe = int(num_probe)
    if not 0 < num_probe <= n:
        raise ValueError(f"num_probe={num_probe} outside (0, N={n}]")
    if k is not None and not 0 < int(k) <= num_probe:
        raise ValueError(f"k={k} outside (0, num_probe={num_probe}]")
    return num_probe


class ComposedIndex(NamedTuple):
    """``NormRangePartitioned(family)`` over a dataset; every tensor on
    one device.

    Attributes:
      spec:      the IndexSpec that built it.
      items:     (N, d) item vectors.
      norms:     (N,) item 2-norms.
      codes:     (N, W) int32 packed codes, or (N, K) int32 hashes
                 for L2-ALSH.
      range_id:  (N,) int32 sub-dataset of each item.
      upper:     (R,) raw per-range max 2-norm U_j (0 for empty ranges).
      upper_eff: (R,) U_j with empty ranges mapped to the global max.
      lower:     (R,) min 2-norm per range.
      params:    the family's parameters: a projection matrix ((d+1, L)
                 SIMPLE-LSH, (d+m, L) SIGN-ALSH) or L2-ALSH's (a, b).
      table:     (R, L+1) score per (range, match count).
      hash_bits: number of hash functions drawn.
      calib:     optional :class:`~repro_torch.core.planner.CalibrationTable`.
    """

    spec: IndexSpec
    items: torch.Tensor
    norms: torch.Tensor
    codes: torch.Tensor
    range_id: torch.Tensor
    upper: torch.Tensor
    upper_eff: torch.Tensor
    lower: torch.Tensor
    params: object
    table: torch.Tensor
    hash_bits: int
    calib: Optional[object] = None

    @property
    def family(self) -> HashFamily:
        return self.spec.resolve_family()

    @property
    def num_ranges(self) -> int:
        return self.upper.shape[0]

    @property
    def code_len(self) -> int:
        return self.spec.code_len

    @property
    def eps(self) -> float:
        return self.spec.eps

    def encode_queries(self, queries: torch.Tensor) -> torch.Tensor:
        return self.family.encode_queries(self.params, queries,
                                          impl=self.spec.impl)

    def probe_scores(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, N) probe priority (higher = probed earlier)."""
        matches = self.family.match_counts(
            self.params, self.encode_queries(queries), self.codes,
            self.hash_bits, impl=self.spec.impl)
        return self.table[self.range_id[None, :], matches]

    def probe_order(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, N) item ids in global probe order (ties by item id)."""
        return torch.argsort(-self.probe_scores(queries), dim=-1,
                             stable=True)

    def candidates(self, queries: torch.Tensor,
                   num_probe: Optional[int] = None, *,
                   engine: Optional[str] = None, buckets=None,
                   budgets=None) -> torch.Tensor:
        """(Q, P) candidate ids; ``engine="dense"`` without ``buckets``
        is the flat scan with item-id ties, anything else goes through
        :class:`~repro_torch.core.engine.QueryEngine`."""
        engine = self.spec.engine if engine is None else engine
        if budgets is not None:
            if num_probe is not None:
                raise ValueError("pass one of num_probe/budgets")
        else:
            if num_probe is None:
                raise ValueError("pass exactly one of num_probe/budgets")
            num_probe = _check_probe(num_probe, None, self.items.shape[0])
            if engine == "dense" and buckets is None:
                return self.probe_order(queries)[:, :num_probe]
        from repro_torch.core.engine import engine_for
        eng = engine_for(self, engine=engine, buckets=buckets,
                         impl=self.spec.impl, tracker=self.spec.tracker)
        return eng.candidates(queries, num_probe, budgets=budgets)

    def query(self, queries: torch.Tensor, k: int,
              num_probe: Optional[int] = None, *,
              engine: Optional[str] = None, buckets=None,
              recall_target: Optional[float] = None, budgets=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Algorithm 2 end to end: (vals, ids) each (Q, k). With no
        ``num_probe``, ``budgets`` or ``recall_target``, the spec's
        ``recall_target`` is the contract."""
        if recall_target is None and num_probe is None and budgets is None:
            recall_target = self.spec.recall_target
        if recall_target is not None:
            if num_probe is not None or budgets is not None:
                raise ValueError(
                    "pass one of num_probe/budgets/recall_target")
            from repro_torch.core.planner import resolve_budgets
            budgets = resolve_budgets(self.calib, recall_target,
                                      k=k).budgets
        if budgets is None:
            if num_probe is None:
                raise ValueError(
                    "pass num_probe, budgets or recall_target (or build "
                    "from an IndexSpec with a recall_target)")
            num_probe = _check_probe(num_probe, k, self.items.shape[0])
        engine = self.spec.engine if engine is None else engine
        if engine == "fused":
            from repro_torch.core.engine import engine_for
            eng = engine_for(self, engine=engine, buckets=buckets,
                             impl=self.spec.impl, tracker=self.spec.tracker)
            return eng.query(queries, int(k), num_probe, budgets=budgets)
        cand = self.candidates(queries, num_probe, engine=engine,
                               buckets=buckets, budgets=budgets)
        if not 0 < int(k) <= cand.shape[1]:
            raise ValueError(f"k={k} outside (0, probed width "
                             f"{cand.shape[1]}]")
        from repro_torch.obs.tracker import resolve_tracker
        return rerank(queries, self.items, cand, int(k),
                      tracker=resolve_tracker(self.spec.tracker))


class ComposedMultiTable(NamedTuple):
    """Multi-table single-probe: T independent parameter draws over the
    (range-)normalized items; a candidate is any item whose hashes all
    match the query's in at least one table.

    ``upper`` is the effective per-range bound (the score scaling needs a
    nonzero value); ``codes`` stacks the T tables' codes (T, N, ...)."""

    spec: IndexSpec
    items: torch.Tensor
    norms: torch.Tensor
    codes: torch.Tensor
    range_id: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor
    params: Tuple[object, ...]
    hash_bits: int

    @property
    def family(self) -> HashFamily:
        return self.spec.resolve_family()

    @property
    def num_tables(self) -> int:
        return self.codes.shape[0]

    def candidate_scores(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, N) f32 number of tables with a full-hash match, scaled by
        the item's range bound when partitioned (0 = not a candidate)."""
        fam = self.family
        counts = torch.zeros((queries.shape[0], self.items.shape[0]),
                             dtype=torch.int32, device=self.items.device)
        for t in range(self.num_tables):
            qc = fam.encode_queries(self.params[t], queries,
                                    impl=self.spec.impl)
            matches = fam.match_counts(self.params[t], qc, self.codes[t],
                                       self.hash_bits, impl=self.spec.impl)
            counts += (matches == self.hash_bits).to(torch.int32)
        scores = counts.to(torch.float32)
        if self.spec.ranged:
            scores = scores * self.upper[self.range_id.long()][None, :]
        return scores

    def query(self, queries: torch.Tensor, k: int, *,
              max_candidates: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Exact re-rank of the first ``max_candidates`` items by score,
        restricted to true candidates (score > 0). Returns (vals, int32
        ids, int32 candidate counts (Q,)); slots past a query's candidate
        count come back as (-inf, -1). Equal scores keep item-id order and
        equal inner products go to the first position, as the
        reference's stable argsort and ``lax.top_k``."""
        scores = self.candidate_scores(queries)
        n_cand = torch.sum(scores > 0, dim=1, dtype=torch.int32)
        order = torch.argsort(-scores, dim=1, stable=True)
        top = order[:, :max_candidates]                        # (Q, C)
        top_scores = torch.gather(scores, 1, top)
        with full_f32():
            ip = torch.einsum("qd,qcd->qc", queries.to(torch.float32),
                              self.items[top])
        ip = torch.where(top_scores > 0, ip, float("-inf"))
        vals, pos = stable_topk(ip, int(k))
        ids = torch.gather(top, 1, pos)
        ids = torch.where(torch.isfinite(vals), ids, -1)
        return vals, ids.to(torch.int32), n_cand


def _partition(norms: torch.Tensor, spec: IndexSpec):
    """(range_id, raw upper, effective upper, lower) per the spec."""
    if spec.m > 1:
        part = partition_by_scheme(norms, spec.m, spec.scheme)
        return (part.range_id, part.upper, effective_upper(part),
                part.lower)
    upper = torch.max(norms)[None]
    rid = torch.zeros((norms.shape[0],), dtype=torch.int32,
                      device=norms.device)
    return rid, upper, upper, torch.min(norms)[None]


def build(spec: IndexSpec, items, generator=None, *, params=None,
          strict: bool = True, calibration_queries=None,
          calibration_k: Optional[int] = None, device=None):
    """Build a :class:`ComposedIndex` (a :class:`ComposedMultiTable` when
    ``spec.num_tables > 1``) on ``device`` (the card unless
    ``device="cpu"``).

    ``generator`` draws the hash parameters (unless ``params`` hands them
    in: the family's tensors or arrays, a pair ``(a, b)`` for L2-ALSH)
    and, when the spec has a ``recall_target`` and no
    ``calibration_queries`` are given, the calibration queries. With T
    tables, ``generator`` is one generator that draws the T parameter
    sets in turn or a sequence of T, and ``params`` a sequence of T
    parameter sets."""
    spec.validate(strict=strict)
    device = resolve_device(device)
    fam = spec.resolve_family()
    items = torch.as_tensor(items, dtype=torch.float32, device=device)
    norms = hashing.l2_norm(items)
    rid, upper, upper_eff, lower = _partition(norms, spec)
    hash_bits = spec.hash_bits
    upper_per_item = upper_eff[rid.long()]
    dim = int(items.shape[-1])
    if spec.num_tables > 1:
        if calibration_queries is not None or calibration_k is not None:
            raise ValueError("multi-table single-probe has no probe "
                             "budget to plan; calibration does not apply")
        tables = _table_params(fam, spec.num_tables, generator, params,
                               dim, hash_bits, device)
        codes = torch.stack([
            fam.encode_items(p, items, upper_per_item, impl=spec.impl)
            for p in tables])
        return ComposedMultiTable(spec, items, norms, codes, rid,
                                  upper_eff, lower, tables, hash_bits)
    if params is None:
        if generator is None:
            raise ValueError("pass a generator (or params) to draw the "
                             "hash parameters")
        params = fam.make_params(generator, dim, hash_bits, device=device)
    params = fam.params_on(params, device)
    codes = fam.encode_items(params, items, upper_per_item, impl=spec.impl)
    table = fam.score_table(upper_eff, hash_bits, eps=spec.eps)
    cidx = ComposedIndex(spec, items, norms, codes, rid, upper, upper_eff,
                         lower, params, table, hash_bits)
    if spec.recall_target is not None or calibration_queries is not None \
            or calibration_k is not None:
        from repro_torch.core import planner
        cidx = cidx._replace(calib=planner.calibrate(
            cidx, calibration_queries,
            k=(planner.DEFAULT_CAL_K if calibration_k is None
               else int(calibration_k)),
            generator=generator))
    return cidx


def _table_params(fam: HashFamily, num_tables: int, generator,
                  params: Optional[Sequence], dim: int, hash_bits: int,
                  device) -> Tuple[object, ...]:
    """The T parameter sets of a multi-table build: handed in, or drawn
    from one generator in turn or from T generators."""
    if params is not None:
        if len(params) != num_tables:
            raise ValueError(f"{len(params)} parameter sets for "
                             f"num_tables={num_tables}")
        return tuple(fam.params_on(p, device) for p in params)
    if generator is None:
        raise ValueError("pass a generator (or params) to draw the hash "
                         "parameters")
    gens = (generator if isinstance(generator, (list, tuple))
            else [generator] * num_tables)
    if len(gens) != num_tables:
        raise ValueError(f"{len(gens)} generators for "
                         f"num_tables={num_tables}")
    return tuple(fam.make_params(g, dim, hash_bits, device=device)
                 for g in gens)
