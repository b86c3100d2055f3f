"""Dtype and plan-memo contracts over the public query entry points (port
of ``repro/analysis/contracts.py``).

The checks drive ``QueryEngine.query`` (global and planned),
``ComposedIndex.query``, ``adaptive_query``, ``DistributedEngine.query``
and the streaming merge (``MutableIndex.query``) over a tiny
deterministic index (N = 256) on a device: the card when there is one
(the entry points then launch the CUDA kernels), else the CPU (their
plain versions), or the one the caller names:

  C1  plan-memo budget: the distributed engine builds its plan once per
      distinct ``(num_probe, k, budgets)`` class and hits its memo on
      repeat traffic, as its ``repro.engine.distributed.jit_cache.hit``/
      ``miss`` counters report (the reference's executable cache; the
      port's counters count the plan memo). An unhashable key reaching
      the memo is reported, not crashed on.
  C2  dtypes: every entry point returns f32 values and int32 ids
      (``adaptive_query`` also integer probe counts); ``delta_scan``'s
      match counts are int32.

The reference's C3 (no span opens while jax traces) has no counterpart:
eager torch traces nothing, and rule R2 keeps trackers out of compiled
and captured regions instead.

Findings carry the entry point's ``file:line`` and share the lint
baseline. :func:`run_contracts` returns a :class:`ContractReport` whose
``stats`` hold the measured memo counts and the device they ran on.
"""

from __future__ import annotations

import dataclasses
import inspect
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding

VALUE_DTYPE = "torch.float32"
ID_DTYPE = "torch.int32"
# plans built per (num_probe, k, budgets) class
PLANS_PER_CLASS = 1

HINTS = {
    "C1": "key the distributed plan memo on hashable (num_probe, k, "
          "budgets) tuples and reuse the plan for repeat classes "
          "(core/distributed.py DistributedEngine._plan)",
    "C2": "query surfaces return f32 values and int32 ids; cast at the "
          "boundary",
}


def _loc(obj) -> Tuple[str, int]:
    """(repo-relative path, first line) of a callable, for findings."""
    try:
        src = Path(inspect.getsourcefile(obj)).resolve()
        line = inspect.getsourcelines(obj)[1]
    except (TypeError, OSError):
        return "<unknown>", 1
    for parent in src.parents:
        if parent.name == "src":
            return src.relative_to(parent.parent).as_posix(), line
    return src.as_posix(), line


@dataclasses.dataclass
class ContractReport:
    """Findings plus the measured facts the tests pin."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)

    def add(self, rule: str, where, message: str) -> None:
        path, line = _loc(where) if not isinstance(where, tuple) else where
        self.findings.append(Finding(rule, path, line, message, HINTS[rule]))


def _tiny_setup(n: int = 256, d: int = 16, m: int = 4, device="cpu"):
    """A small long-tailed dataset and a calibrated spec on ``device``:
    every range has members, and the whole check runs in seconds."""
    import numpy as np
    import torch

    from repro_torch.core.index import IndexSpec, build

    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    scale = np.exp(0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    items = torch.as_tensor(vecs * scale, device=device)
    queries = torch.as_tensor(rng.standard_normal((4, d)).astype(np.float32),
                              device=device)
    spec = IndexSpec(family="simple", code_len=16, m=m, engine="bucket",
                     recall_target=0.9)
    cidx = build(spec, items, torch.Generator(device=device).manual_seed(11),
                 device=device)
    return cidx, items, queries


def _check_dtypes(report: ContractReport, where, what: str, vals, ids,
                  extra_int=None) -> None:
    if str(vals.dtype) != VALUE_DTYPE:
        report.add("C2", where, f"{what}: values dtype {vals.dtype}, "
                                f"expected {VALUE_DTYPE}")
    if str(ids.dtype) != ID_DTYPE:
        report.add("C2", where, f"{what}: ids dtype {ids.dtype}, expected "
                                f"{ID_DTYPE}")
    if extra_int is not None and (extra_int.dtype.is_floating_point
                                  or extra_int.dtype.is_complex):
        report.add("C2", where, f"{what}: probes_used dtype "
                                f"{extra_int.dtype}, expected an integer "
                                f"type")


def check_single_device(report: ContractReport, cidx, queries) -> None:
    """QueryEngine.query (global and planned), ComposedIndex.query under
    its recall contract, adaptive_query."""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.planner import adaptive_query

    eng = QueryEngine(cidx, engine="bucket", device=cidx.items.device)
    vals, ids = eng.query(queries, 5, 60)
    _check_dtypes(report, QueryEngine.query, "QueryEngine.query", vals, ids)
    budgets = tuple(min(20, int(c)) for c in eng._range_counts)
    vals, ids = eng.query(queries, 5, budgets=budgets)
    _check_dtypes(report, QueryEngine.query, "QueryEngine.query[planned]",
                  vals, ids)
    vals, ids = cidx.query(queries, 5)
    _check_dtypes(report, type(cidx).query, "ComposedIndex.query[contract]",
                  vals, ids)
    vals, ids, probes = adaptive_query(eng, queries, 5, recall_target=0.9)
    _check_dtypes(report, adaptive_query, "adaptive_query", vals, ids,
                  extra_int=probes)


def check_distributed(report: ContractReport, spec, items, queries, *,
                      classes: Sequence[Tuple[int, int]] = ((60, 5),
                                                           (90, 5)),
                      planned_budget: Optional[int] = 20) -> None:
    """DistributedEngine.query over one in-process shard: C1 over repeat
    traffic, C2 on its outputs."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.obs import Tracker

    sidx = distributed.build_sharded(
        spec, items, torch.Generator(device=items.device).manual_seed(11), 1,
        device=items.device)
    group = distributed.InProcessShardGroup(1)
    placed = distributed.shard_index(sidx, group)
    tracker = Tracker()
    eng = distributed.DistributedEngine(placed, group, engine="bucket",
                                        tracker=tracker)
    qe = distributed.DistributedEngine.query

    ran = 0
    for num_probe, k in classes:
        try:
            vals, ids = eng.query(queries, k, num_probe)
            eng.query(queries, k, num_probe)    # repeat: must hit the memo
            ran += 1
        except TypeError as e:
            report.add("C1", qe, f"unhashable key reached the plan memo "
                                 f"for class (num_probe={num_probe}, "
                                 f"k={k}): {e}")
            continue
        _check_dtypes(report, qe, f"DistributedEngine.query[{num_probe},"
                                  f"{k}]", vals, ids)
    planned = 0
    if planned_budget is not None:
        budgets = tuple(min(planned_budget, int(c))
                        for c in eng._range_counts)
        try:
            vals, ids = eng.query(queries, 5, budgets=budgets)
            eng.query(queries, 5, budgets=budgets)
            planned = 1
            _check_dtypes(report, qe, "DistributedEngine.query[planned]",
                          vals, ids)
        except TypeError as e:
            report.add("C1", qe, f"unhashable key reached the plan memo "
                                 f"for planned budgets: {e}")

    c = tracker.counters
    misses = int(c.get("repro.engine.distributed.jit_cache.miss", 0))
    hits = int(c.get("repro.engine.distributed.jit_cache.hit", 0))
    classes_run = ran + planned
    if misses != classes_run * PLANS_PER_CLASS:
        report.add("C1", qe, f"plan-memo budget violated: {misses} plans "
                             f"built for {classes_run} (num_probe, k, "
                             f"budgets) classes (budget "
                             f"{PLANS_PER_CLASS}/class)")
    if hits != classes_run:
        report.add("C1", qe, f"repeat traffic missed the plan memo: {hits} "
                             f"hits for {classes_run} repeated classes")
    report.stats.update({
        "distributed_classes": ran,
        "distributed_planned_classes": planned,
        "distributed_plans": misses,
        "distributed_memo_hits": hits,
        "distributed_memo_size": len(eng._plans),
    })


def check_delta_scan(report: ContractReport, device="cpu") -> None:
    """delta_scan's match counts are int32 (the streaming merge ranks
    them)."""
    import torch

    from repro_torch.kernels import ops

    q = ops._codes(4, 1, device)
    d = ops._codes(32, 1, device)
    live = torch.arange(32, device=device) % 2 == 0
    out = ops.delta_scan(q, d, live, 16)
    if str(out.dtype) != ID_DTYPE:
        report.add("C2", ops.delta_scan, f"delta_scan: match counts dtype "
                                         f"{out.dtype}, expected {ID_DTYPE}")


def check_streaming(report: ContractReport, cidx, queries) -> None:
    """The streaming merged path end to end (insert, then a merged
    query)."""
    import numpy as np
    import torch

    from repro_torch.streaming.index import MutableIndex

    mi = MutableIndex.from_composed(cidx, capacity=16)
    rng = np.random.default_rng(13)
    mi.insert(torch.as_tensor(
        rng.standard_normal((4, cidx.items.shape[1])).astype(np.float32),
        device=cidx.items.device))
    vals, ids = mi.query(queries, 5, 60)
    _check_dtypes(report, MutableIndex.query, "MutableIndex.query", vals,
                  ids)


def run_contracts(*, classes: Sequence[Tuple[int, int]] = ((60, 5),
                                                          (90, 5)),
                  device=None) -> ContractReport:
    """Run every contract check on ``device`` (default: the card when
    there is one, else the CPU); returns findings and measured stats.
    Deterministic (fixed seeds), tiny, no files touched."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    report = ContractReport()
    report.stats["device"] = device.type
    cidx, items, queries = _tiny_setup(device=device)
    check_single_device(report, cidx, queries)
    check_distributed(report, cidx.spec, items, queries, classes=classes)
    check_delta_scan(report, device)
    check_streaming(report, cidx, queries)
    return report
