"""The port's profiler ranges (``repro_torch.obs.trace``): while
``torch.profiler`` records, every span site of the served path opens a
``record_function`` range named as the span, tracked or not, and the
ranges nest as the tracked spans' paths; with the profiler off and no
tracker a span site is the shared no-op and never enters
``record_function`` or synchronises. Tracked, profiled and bare engines
return the same answers bit for bit. A tiny index on the CPU; no JAX.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.engine import QueryEngine
from repro_torch.core.index import IndexSpec, build
from repro_torch.obs import RingBufferSink, Tracker
from repro_torch.obs import trace as ptrace
from repro_torch.obs.cost import PORT_STAGES
from repro_torch.obs.trace import _NULL_SPAN, costed_span, span_or_null

PROBES = ({"num_probe": 200}, {"recall_target": 0.9})


@pytest.fixture(scope="module")
def served():
    """(a fused engine over a tiny calibrated index, its queries)."""
    g = torch.Generator().manual_seed(3)
    items = torch.randn(1500, 16, generator=g) \
        * (0.5 + torch.rand(1500, 1, generator=g))
    spec = IndexSpec(family="simple", code_len=16, m=8, recall_target=0.9)
    index = build(spec, items, torch.Generator().manual_seed(1),
                  calibration_queries=torch.randn(32, 16, generator=g),
                  calibration_k=10, device="cpu")
    engine = QueryEngine(index, engine="fused", device="cpu")
    return engine, torch.randn(8, 16, generator=g)


def _answers(engine, queries):
    return [engine.query(queries, 10, **kw) for kw in PROBES]


def _tracked(engine):
    ring = RingBufferSink()
    engine.tracker = Tracker([ring])
    return ring


def _range_paths(prof):
    """Sorted ``/``-joined paths of the host's ``repro.*`` annotation
    ranges, each under the ranges that hold it."""
    ranges = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.is_user_annotation() and e.name().startswith("repro.")]
    paths = []
    for r in ranges:
        outer = sorted((s, -e, n) for s, e, n in ranges
                       if s <= r[0] and r[1] <= e and (s, e, n) != r)
        paths.append("/".join([n for _, _, n in outer] + [r[2]]))
    return sorted(paths)


@pytest.mark.parametrize("tracked", [True, False])
def test_ranges_nest_as_the_span_paths(served, tracked):
    engine, queries = served
    ring = _tracked(engine)
    try:
        _answers(engine, queries)
        spans = sorted(r["path"] for r in ring.query(type="span"))
        if not tracked:
            engine.tracker = None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _answers(engine, queries)
    finally:
        engine.tracker = None
    names = {p.rsplit("/", 1)[-1] for p in spans}
    assert set(PORT_STAGES) | {"repro.planner.resolve_budgets",
                               "repro.engine.fused_query"} <= names
    assert _range_paths(prof) == spans
    if tracked:
        assert sorted(r["path"] for r in ring.query(type="span")) == \
            sorted(spans * 2)


def test_no_tracker_no_profiler_enters_nothing(served, monkeypatch):
    engine, queries = served
    entered, synced = [], []
    real = ptrace.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(ptrace, "record_function", counted)
    monkeypatch.setattr(ptrace, "block_until_ready", synced.append)
    assert not torch._C._autograd._profiler_enabled()
    assert span_or_null(None, "repro.engine.runs") is _NULL_SPAN
    assert costed_span(None, "repro.engine.fused_query", None) is _NULL_SPAN
    _answers(engine, queries)
    assert entered == [] and synced == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span_or_null(None, "repro.engine.runs") as sp:
            assert sp.sync(queries) is queries
    assert entered == ["repro.engine.runs"] and synced == []


def test_tracked_profiled_and_bare_answers_are_identical(served):
    engine, queries = served
    bare = _answers(engine, queries)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _answers(engine, queries)
    _tracked(engine)
    try:
        tracked = _answers(engine, queries)
        with profile(activities=[ProfilerActivity.CPU]):
            both = _answers(engine, queries)
    finally:
        engine.tracker = None
    for got in (profiled, tracked, both):
        for (v0, i0), (v1, i1) in zip(bare, got):
            assert torch.equal(i0, i1) and torch.equal(v0, v1)


def test_chip_smoke_counts_no_range_as_device_work(served):
    """``chip_smoke.py`` sums the profiler's device rows as busy time: the
    stage ranges' rows, whose device-side copies span their kernels, are
    left out with the profiler's step, and every operator row is kept."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    engine, queries = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _answers(engine, queries)
    for rows in (prof.key_averages(), prof.events()):
        ranges = {e.key for e in rows if smoke.is_range(e)}
        assert ranges >= set(PORT_STAGES) | {"repro.engine.query"}
        assert all(k.startswith(("repro.", "ProfilerStep")) for k in ranges)
        assert any(k.startswith("aten::") for k in
                   {e.key for e in rows if not smoke.is_range(e)})
