"""The port's observability layer (``repro_torch.obs``) and its wiring
through the engines, planner, kernels and streaming, against the JAX
package's ``repro.obs``.

The reference's own tests of ``tests/test_obs.py`` and
``tests/test_obs_export.py`` are ported as cases (all but the distributed
engine's, which is not ported yet), then the two packages are held
against each other in one process:

* the same records through both exporters give byte-equal JSON, and the
  same samples give equal histogram quantiles;
* tracked and untracked port engines (dense, bucket, fused) return
  bit-identical results;
* port and reference engines, tracked, on a reference index carried
  across, give the same span names and cost attrs for every span the
  reference emits, and equal ``queries``, ``probe_width`` and
  ``probes_used.range{j}`` records, and the same kernel dispatch and
  cost counters; the port's other spans are exactly its own
  (``cost.PORT_STAGES`` and ``repro.planner.resolve_budgets``);
* ``adaptive_query`` telemetry equals the reference's;
* the same streaming traffic gives the same event kinds and payloads
  (floats within rtol 1e-6: a torch f32 norm may differ by an ulp).
"""

import dataclasses
import itertools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from repro import obs as jobs
from repro import streaming as jstreaming
from repro.core import engine as jengine
from repro.core import index as jindex
from repro.core import planner as jplanner
from repro.data.synthetic import make_dataset as jax_dataset
from repro.kernels import ops as jops
from repro_torch import convert, obs, streaming
from repro_torch.core import planner
from repro_torch.core.engine import QueryEngine, engine_for
from repro_torch.core.index import IndexSpec, build
from repro_torch.kernels import ops
from repro_torch.obs import (JsonlSink, LogHistogram, RecallAuditor,
                             RequestClass, RingBufferSink, SloMonitor,
                             StdoutTableSink, Tracker, chrome_trace_events,
                             default_tracker, export_chrome_trace,
                             format_table, read_jsonl, resolve_tracker,
                             set_default_tracker, span_or_null,
                             validate_chrome_trace)
from repro_torch.obs import trace as ptrace
from repro_torch.obs.cost import (BUCKET_STAGES, PORT_STAGES,
                                  flop_counter_cost, hash_encode_cost,
                                  planned_runs_cost, query_stage_costs)
from repro_torch.obs.trace import _NULL_SPAN

GEN_SEED = 5


def _gen():
    return torch.Generator().manual_seed(GEN_SEED)


def _fake_clock_tracker(pkg=obs):
    """Tracker on a deterministic integer clock (1 s per reading)."""
    clk = itertools.count()
    ring = pkg.RingBufferSink(capacity=4096)
    return pkg.Tracker([ring], clock=lambda: float(next(clk))), ring


# -- histogram ----------------------------------------------------------------


def test_histogram_quantiles_vs_numpy_lognormal():
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=-7.0, sigma=1.0, size=20_000)
    h = LogHistogram()
    for s in samples:
        h.record(s)
    for q in (0.5, 0.9, 0.99):
        assert h.quantile(q) == pytest.approx(float(np.quantile(samples, q)),
                                              rel=0.08), f"q={q}"
    assert h.count == samples.size
    assert h.mean == pytest.approx(float(samples.mean()), rel=1e-6)
    assert h.min == pytest.approx(float(samples.min()))
    assert h.max == pytest.approx(float(samples.max()))


def test_histogram_edge_cases():
    h = LogHistogram()
    assert h.quantile(0.5) == 0.0
    h.record(0.0)
    h.record(-1.0)
    assert h.counts[0] == 2
    h2 = LogHistogram()
    h2.record(42.0)
    assert h2.quantile(0.5) == pytest.approx(42.0)
    assert h2.quantile(0.99) == pytest.approx(42.0)
    h2.record(1e20)
    assert h2.max == 1e20
    with pytest.raises(ValueError):
        h2.quantile(1.5)
    with pytest.raises(ValueError):
        LogHistogram(lo=0.0)


def test_histogram_summary_keys():
    h = LogHistogram()
    h.record(1.0)
    assert set(h.summary()) == {"count", "mean", "min", "max", "p50", "p90",
                                "p99"}


def test_histogram_merge_quantile_error_stays_bounded():
    rng = np.random.default_rng(3)
    a = rng.lognormal(mean=-7.0, sigma=1.0, size=8_000)
    b = rng.lognormal(mean=-5.5, sigma=0.7, size=4_000)
    ha, hb = LogHistogram(), LogHistogram()
    for s in a:
        ha.record(s)
    for s in b:
        hb.record(s)
    merged = ha.merge(hb)
    assert merged is ha
    both = np.concatenate([a, b])
    assert merged.count == both.size
    assert merged.mean == pytest.approx(float(both.mean()), rel=1e-6)
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == pytest.approx(
            float(np.quantile(both, q)), rel=0.08), f"q={q}"


def test_histogram_merge_mismatched_geometry_raises():
    h = LogHistogram()
    with pytest.raises(ValueError, match="geometry"):
        h.merge(LogHistogram(growth=1.5))
    with pytest.raises(ValueError, match="geometry"):
        h.merge(LogHistogram(lo=1e-6))
    with pytest.raises(TypeError):
        h.merge([1.0, 2.0])


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "spiky"])
def test_histogram_quantiles_equal_reference(dist):
    """Same geometry, same samples: every quantile and summary value of
    the port's histogram equals the reference's."""
    rng = np.random.default_rng(11)
    samples = {"lognormal": rng.lognormal(-6.0, 1.5, 5_000),
               "uniform": rng.uniform(0.0, 3.0, 5_000),
               "spiky": np.repeat([1e-3, 0.5, 7.0], [10, 3000, 1])}[dist]
    mine, ref = LogHistogram(), jobs.LogHistogram()
    for s in samples:
        mine.record(s)
        ref.record(s)
    assert mine.counts == ref.counts
    assert mine.summary((0.01, 0.25, 0.5, 0.9, 0.99, 1.0)) == \
        ref.summary((0.01, 0.25, 0.5, 0.9, 0.99, 1.0))
    assert (obs.HIST_LO, obs.HIST_HI, obs.HIST_GROWTH,
            obs.DEFAULT_QUANTILES) == (jobs.HIST_LO, jobs.HIST_HI,
                                       jobs.HIST_GROWTH,
                                       jobs.DEFAULT_QUANTILES)


# -- tracker surface ----------------------------------------------------------


def test_tracker_counter_gauge_observe_event():
    tr = Tracker()
    tr.count("c")
    tr.count("c", 4)
    tr.gauge("g", 2.5)
    tr.gauge("g", 3.5)
    tr.observe("h", 0.1)
    tr.event("e", kind="x", n=1)
    snap = tr.snapshot()
    assert snap["counters"]["c"] == 5
    assert snap["gauges"]["g"] == 3.5
    assert snap["hists"]["h"]["count"] == 1
    assert snap["num_events"] == 1
    assert tr.events[0] == {"name": "e", "kind": "x", "n": 1}


def test_records_carry_monotonic_t():
    clock_vals = iter([0.0, 1.0, 2.0, 3.0])
    ring = RingBufferSink()
    tr = Tracker([ring], clock=lambda: next(clock_vals))
    tr.count("a")
    tr.count("a")
    assert [r["t"] for r in ring.records] == [1.0, 2.0]


def test_tracker_merge_folds_aggregates():
    ring = RingBufferSink()
    fleet = Tracker([ring])
    fleet.count("q", 2)
    fleet.gauge("g", 1.0)
    fleet.observe("lat", 0.010)
    shard = Tracker()
    shard.count("q", 3)
    shard.count("only_shard")
    shard.gauge("g", 9.0)
    shard.observe("lat", 0.020)
    shard.observe("only_shard_lat", 0.5)
    shard.event("repro.streaming.repartition", range_id=2)
    n_sink_records = ring.total
    assert fleet.merge(shard) is fleet
    assert fleet.counters["q"] == 5
    assert fleet.counters["only_shard"] == 1
    assert fleet.gauges["g"] == 9.0
    assert fleet.hists["lat"].count == 2
    assert fleet.hists["only_shard_lat"].count == 1
    assert fleet.hists["only_shard_lat"].num_buckets == \
        shard.hists["only_shard_lat"].num_buckets
    assert fleet.events[-1]["name"] == "repro.streaming.repartition"
    assert ring.total == n_sink_records
    with pytest.raises(TypeError):
        fleet.merge({"counters": {}})


# -- spans --------------------------------------------------------------------


def test_span_nesting_paths_and_histograms():
    ring = RingBufferSink()
    tr = Tracker([ring])
    with tr.span("outer"):
        with tr.span("inner") as sp:
            sp.sync(torch.ones((4,)) * 2)
    recs = ring.query(type="span")
    assert [r["name"] for r in recs] == ["inner", "outer"]
    inner, outer = recs
    assert inner["path"] == "outer/inner" and inner["depth"] == 1
    assert outer["path"] == "outer" and outer["depth"] == 0
    assert tr.hists["inner"].count == 1 and tr.hists["outer"].count == 1
    assert outer["dur_s"] >= inner["dur_s"] >= 0.0


def test_span_sync_returns_value_unchanged():
    tr = Tracker()
    x = torch.arange(8)
    with tr.span("s") as sp:
        y = sp.sync(x)
    assert y is x
    with span_or_null(None, "s") as sp:
        z = sp.sync(x)
    assert z is x
    assert span_or_null(None, "anything") is _NULL_SPAN
    nested = {"a": (x, [x]), "b": 3}
    assert ptrace.block_until_ready(nested) is nested


def test_span_exception_drops_record_and_unwinds():
    ring = RingBufferSink()
    tr = Tracker([ring])
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert ring.query(type="span") == []
    assert "boom" not in tr.hists
    assert tr.tracer._stack == []
    with tr.span("after"):
        pass
    assert tr.hists["after"].count == 1


def test_span_exception_mid_sync_drops_record(monkeypatch):
    """A sync that raises is a failed span: nothing recorded, the
    exception propagates, the stack unwinds."""
    def boom(x):
        raise RuntimeError("device died")

    ring = RingBufferSink()
    tr = Tracker([ring])
    monkeypatch.setattr(ptrace, "block_until_ready", boom)
    with pytest.raises(RuntimeError, match="device died"):
        with tr.span("stage") as sp:
            sp.sync(torch.ones((2,)))
    assert ring.query(type="span") == []
    assert "stage" not in tr.hists
    assert tr.tracer._stack == []
    monkeypatch.undo()
    with tr.span("after") as sp:
        sp.sync(torch.ones((2,)))
    assert tr.hists["after"].count == 1


def test_span_sync_waits_only_for_cuda_devices(monkeypatch):
    """The sync synchronises the current stream of each CUDA device that
    holds a registered tensor, and nothing for CPU tensors."""
    seen = []

    class FakeStream:
        def __init__(self, device):
            self.device = device

        def synchronize(self):
            seen.append(self.device)

    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    tr = Tracker()
    with tr.span("cpu") as sp:
        sp.sync((torch.ones(2), {"x": [torch.zeros(3)]}))
    assert seen == []
    assert ptrace._cuda_devices([torch.ones(1), 2.0], set()) == set()


def test_span_attrs_land_in_record():
    ring = RingBufferSink()
    tr = Tracker([ring])
    with tr.span("stage", attrs={"flops": 10.0}) as sp:
        sp.set_attrs(hbm_bytes=4.0)
    rec, = ring.query(type="span")
    assert rec["attrs"] == {"flops": 10.0, "hbm_bytes": 4.0}
    assert rec["t0"] >= 0.0 and rec["dur_s"] >= 0.0
    with tr.span("bare"):
        pass
    assert "attrs" not in ring.query(type="span", name="bare")[0]


def test_costed_span_computes_nothing_without_a_tracker():
    calls = []

    def cost_fn(*a):
        calls.append(a)
        return {"flops": 1.0}
    assert ptrace.costed_span(None, "s", cost_fn, 1, 2) is _NULL_SPAN
    assert calls == []
    ring = RingBufferSink()
    with ptrace.costed_span(Tracker([ring]), "s", cost_fn, 1, 2):
        pass
    assert calls == [(1, 2)]
    assert ring.query(type="span")[0]["attrs"] == {"flops": 1.0}


# -- sinks --------------------------------------------------------------------


def test_ring_buffer_overflow_keeps_newest():
    ring = RingBufferSink(capacity=3)
    for i in range(10):
        ring.emit({"type": "counter", "name": f"n{i}"})
    assert ring.total == 10 and ring.dropped == 7
    assert [r["name"] for r in ring.records] == ["n7", "n8", "n9"]
    with pytest.raises(ValueError):
        RingBufferSink(capacity=0)


def test_jsonl_round_trip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    tr = Tracker([JsonlSink(path)])
    tr.count("c", 2)
    tr.gauge("g", 1.5)
    tr.observe("h", np.float32(0.25))
    tr.event("e", ids=np.arange(3), note="x", t_ids=torch.arange(2))
    with tr.span("s") as sp:
        sp.sync(torch.zeros((2,)))
    tr.close()
    recs = read_jsonl(path)
    assert [r["type"] for r in recs] == \
        ["counter", "gauge", "observe", "event", "span"]
    assert recs[0]["total"] == 2
    assert recs[2]["value"] == 0.25
    assert recs[3]["fields"]["ids"] == [0, 1, 2]
    assert recs[3]["fields"]["t_ids"] == [0, 1]
    assert recs[4]["name"] == "s" and recs[4]["dur_s"] >= 0.0
    json.dumps(recs)


def test_jsonl_rotation_keeps_last_file_and_round_trips(tmp_path):
    import os

    path = str(tmp_path / "events.jsonl")
    sink = JsonlSink(path, max_bytes=512)
    tr = Tracker([sink])
    for _ in range(200):
        tr.count("c", 1)
    tr.close()
    assert sink.total == 200 and sink.rotations >= 1
    live = read_jsonl(path)
    rolled = read_jsonl(path + ".1")
    assert os.path.getsize(path) <= 512
    assert os.path.getsize(path + ".1") <= 512
    tail = rolled + live
    assert [r["total"] for r in tail] == \
        list(range(200 - len(tail) + 1, 201))
    with pytest.raises(ValueError):
        JsonlSink(str(tmp_path / "x.jsonl"), max_bytes=0)


def test_jsonl_uncapped_never_rotates(tmp_path):
    path = str(tmp_path / "events.jsonl")
    sink = JsonlSink(path)
    tr = Tracker([sink])
    for _ in range(100):
        tr.count("c")
    tr.close()
    assert sink.rotations == 0
    assert len(read_jsonl(path)) == 100


def test_format_table_surfaces_sink_drops_and_counts():
    ring = RingBufferSink(capacity=4)
    tr = Tracker([ring])
    for _ in range(10):
        tr.observe("lat", 0.01)
    snap = tr.snapshot()
    assert snap["sinks"] == [
        {"sink": "RingBufferSink", "records": 10, "dropped": 6}]
    table = format_table(snap)
    assert "sinks" in table and "dropped" in table
    line = [ln for ln in table.splitlines() if "RingBufferSink" in ln][0]
    assert "10" in line and "6" in line
    hist = [ln for ln in table.splitlines() if ln.strip()
            .startswith("lat")][0]
    assert "10" in hist


def test_stdout_table_and_live_events(capsys):
    tr = Tracker([StdoutTableSink(live=True)])
    tr.event("repro.streaming.compaction", folded=7)
    tr.count("repro.engine.queries", 3)
    tr.observe("repro.engine.probe_width", 128.0)
    out = capsys.readouterr().out
    assert "repro.streaming.compaction" in out and "folded=7" in out
    table = format_table(tr.snapshot())
    assert "repro.engine.queries" in table and "p99" in table
    assert format_table({}) == "(no metrics recorded)"


def _emit_sequence(tr):
    """One fixed stream of every record kind, nested spans included."""
    tr.count("repro.engine.queries", 4)
    tr.gauge("repro.engine.memo_size", 2)
    tr.observe("repro.engine.probe_width", 300)
    tr.event("repro.streaming.compaction", folded=7, ranges=[1, 2])
    with tr.span("repro.engine.query"):
        with tr.span("repro.engine.hash_encode",
                     attrs={"flops": 8.0, "hbm_bytes": 64.0}):
            pass
        with tr.span("repro.engine.re_rank") as sp:
            sp.set_attrs(flops=1.5)


def test_exporters_and_sinks_give_byte_equal_json(tmp_path):
    """The same records through both packages' sinks and exporters give
    byte-equal JSON: the ring records, the JSONL file, the Chrome trace
    (one tracker and a two-label fleet) and the snapshot table."""
    mine, mring = _fake_clock_tracker(obs)
    ref, rring = _fake_clock_tracker(jobs)
    for tr, pkg, tag in ((mine, obs, "port"), (ref, jobs, "ref")):
        tr.sinks.append(pkg.JsonlSink(str(tmp_path / f"{tag}.jsonl")))
        _emit_sequence(tr)
        tr.close()
    assert json.dumps(mring.records) == json.dumps(rring.records)
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    a = export_chrome_trace(mine, str(tmp_path / "port.json"))
    b = jobs.export_chrome_trace(ref, str(tmp_path / "ref.json"))
    assert json.dumps(a) == json.dumps(b)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert validate_chrome_trace(a) == jobs.validate_chrome_trace(b)
    fleet = export_chrome_trace({"s1": mine, "s0": mine})
    assert json.dumps(fleet) == json.dumps(
        jobs.export_chrome_trace({"s1": ref, "s0": ref}))
    assert format_table(mine.snapshot()) == format_table(ref.snapshot())


# -- ambient default tracker --------------------------------------------------


def test_ambient_default_tracker_resolution():
    tr = Tracker()
    prev = set_default_tracker(tr)
    try:
        assert default_tracker() is tr
        assert resolve_tracker(None) is tr
        other = Tracker()
        assert resolve_tracker(other) is other
    finally:
        set_default_tracker(prev)
    assert resolve_tracker(None) is prev


def test_engine_for_sees_ambient_tracker(longtail_ds):
    """The engine memo must not hand back a pre-tracker engine after an
    ambient tracker is installed (it keys on the resolved tracker)."""
    spec = IndexSpec(family="simple", code_len=16, m=8)
    cidx = build(spec, np.asarray(longtail_ds.items[:500]), _gen(),
                 device="cpu")
    bare = engine_for(cidx, engine="bucket")
    assert bare.tracker is None
    tr = Tracker()
    prev = set_default_tracker(tr)
    try:
        eng = engine_for(cidx, engine="bucket")
        assert eng.tracker is tr
        assert tr.gauges["repro.engine.memo_size"] >= 2
    finally:
        set_default_tracker(prev)
    assert engine_for(cidx, engine="bucket") is bare


def test_indexspec_hash_ignores_tracker():
    tr = Tracker()
    a = IndexSpec(family="simple", code_len=16, m=8)
    b = IndexSpec(family="simple", code_len=16, m=8, tracker=tr)
    assert a == b and hash(a) == hash(b)
    assert "tracker" not in repr(b)
    assert convert.spec_from_fields({"family": "simple", "code_len": 16,
                                     "tracker": tr}).tracker is None


def test_spec_tracker_reaches_the_query_surfaces(calibrated):
    """``IndexSpec(tracker=)`` reports every ``ComposedIndex.query`` arm."""
    _, pidx, queries = calibrated
    tr = Tracker()
    idx = pidx._replace(spec=dataclasses.replace(pidx.spec, tracker=tr))
    idx.query(t(queries), 10, 300)
    idx.query(t(queries), 10, 300, engine="bucket")
    idx.query(t(queries), 10, 300, engine="fused")
    assert tr.hists["repro.engine.re_rank"].count == 2
    assert tr.hists["repro.engine.fused_query"].count == 1
    # as in the reference, only the fused arm goes through
    # QueryEngine.query, which counts queries
    assert tr.counters["repro.engine.queries"] == queries.shape[0]


# -- parity: instrumentation must not change results --------------------------


@pytest.fixture(scope="module")
def calibrated():
    """(reference index, the port's carried copy, held-out queries): the
    reference test's calibrated index."""
    ds = jax_dataset("imagenet", jax.random.PRNGKey(0), n=2000, d=24,
                     num_queries=48)
    spec = jindex.IndexSpec(family="simple", code_len=16, m=8,
                            charge_index_bits=False)
    jidx = jindex.build(spec, ds.items, jax.random.PRNGKey(5),
                        calibration_queries=ds.queries[:32],
                        calibration_k=10)
    pidx = convert.index_from_fields(
        {f: np.asarray(getattr(jidx, f)) for f in convert.INDEX_FIELDS},
        {f: getattr(jidx.spec, f) for f in convert.SPEC_FIELDS},
        jidx.hash_bits, calib=jidx.calib._asdict(), device="cpu")
    return jidx, pidx, np.asarray(ds.queries[32:])


PROBES = ({"num_probe": 300}, {"recall_target": 0.9})
PLAN_SPAN = "repro.planner.resolve_budgets"
STAGES = {
    "bucket": {"repro.engine.hash_encode", "repro.engine.directory_match",
               "repro.engine.directory_scan", "repro.engine.rank_sort",
               "repro.engine.segmented_gather", "repro.engine.re_rank",
               "repro.engine.top_k", "repro.engine.query", PLAN_SPAN},
    "dense": {"repro.engine.hash_encode", "repro.engine.dense_match",
              "repro.engine.dense_select", "repro.engine.re_rank",
              "repro.engine.top_k", "repro.engine.query", PLAN_SPAN},
    "fused": {"repro.engine.hash_encode", "repro.engine.directory_match",
              "repro.engine.directory_scan", "repro.engine.rank_sort",
              "repro.engine.fused_query", "repro.engine.runs",
              "repro.engine.fused_score", "repro.engine.query", PLAN_SPAN},
}
# the port's own spans (no reference counterpart) at their paths, once
# per call of PROBES: the directory walk's children in both bucket arms,
# the fused arm's runs and launch, the plan of the recall_target call
_Q, _DIR, _FQ = ("repro.engine.query", "repro.engine.directory_match",
                 "repro.engine.fused_query")
PORT_PATHS = {
    "bucket": [f"{_Q}/{_DIR}/repro.engine.directory_scan",
               f"{_Q}/{_DIR}/repro.engine.rank_sort"] * 2
    + [f"{_Q}/{PLAN_SPAN}"],
    "dense": [f"{_Q}/{PLAN_SPAN}"],
    "fused": [f"{_Q}/{_DIR}/repro.engine.directory_scan",
              f"{_Q}/{_DIR}/repro.engine.rank_sort",
              f"{_Q}/{_FQ}/repro.engine.runs",
              f"{_Q}/{_FQ}/repro.engine.fused_score"] * 2
    + [f"{_Q}/{PLAN_SPAN}"],
}


@pytest.mark.parametrize("arm", ["bucket", "dense", "fused",
                                 "fused_int8"])
def test_instrumented_query_ids_bit_identical(calibrated, arm):
    """A tracker observes, never participates: ids and values with full
    instrumentation equal the bare engine's, for both probe modes."""
    _, pidx, queries = calibrated
    quantized = arm == "fused_int8"
    arm = arm.split("_")[0]
    bare = QueryEngine(pidx, engine=arm, quantized=quantized, device="cpu")
    tr = Tracker([RingBufferSink()])
    inst = QueryEngine(pidx, engine=arm, quantized=quantized,
                       buckets=bare.buckets, tracker=tr, device="cpu")
    for kw in PROBES:
        v0, i0 = bare.query(t(queries), 10, **kw)
        v1, i1 = inst.query(t(queries), 10, **kw)
        assert torch.equal(i0, i1) and torch.equal(v0, v1)
    if arm != "fused":
        for kw in ({"num_probe": 300}, {"budgets": (40,) * 8}):
            assert torch.equal(bare.candidates(t(queries), **kw),
                               inst.candidates(t(queries), **kw))
    assert STAGES[arm] <= set(tr.hists)
    assert tr.counters["repro.engine.queries"] == 2 * queries.shape[0]


def _span_attrs(records):
    """name -> list of attrs dicts, in record order."""
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r.get("attrs"))
    return out


def _hist_values(h):
    return (h.count, h.total, h.min, h.max, list(h.counts))


@pytest.mark.parametrize("arm", ["bucket", "dense", "fused"])
def test_tracked_records_equal_reference(calibrated, arm):
    """Port and reference, tracked, over the same index and queries: the
    records the reference emits under the same span names, paths and
    cost attrs, and equal ``queries``, ``probe_width`` and
    ``probes_used.range{j}`` records; the port's other spans are exactly
    its own (``PORT_STAGES`` and the plan), uncosted, at their paths.
    Paths and attrs are compared, not durations: for the recall_target
    call the port's ``repro.engine.query`` also holds the plan, which
    the reference runs before its span opens."""
    jidx, pidx, queries = calibrated
    jr, pr = jobs.RingBufferSink(), RingBufferSink()
    jt, pt = jobs.Tracker([jr]), Tracker([pr])
    jeng = jengine.QueryEngine(jidx, engine=arm, tracker=jt)
    peng = QueryEngine(pidx, engine=arm, tracker=pt, device="cpu")
    for kw in PROBES:
        jeng.query(jnp.asarray(queries), 10, **kw)
        peng.query(t(queries), 10, **kw)
    jspans = jr.query(type="span")
    theirs = {r["name"] for r in jspans}
    shared = [r for r in pr.query(type="span") if r["name"] in theirs]
    own = [r for r in pr.query(type="span") if r["name"] not in theirs]
    assert {r["name"] for r in own} <= set(PORT_STAGES) | {PLAN_SPAN}
    assert sorted(r["path"] for r in own) == sorted(PORT_PATHS[arm])
    assert all("attrs" not in r for r in own)
    assert set(pt.hists) == set(jt.hists) | {r["name"] for r in own}
    assert [r["path"] for r in shared] == [r["path"] for r in jspans]
    assert _span_attrs(shared) == _span_attrs(jspans)
    assert pt.counters == jt.counters
    for name, h in jt.hists.items():
        if not any(name.startswith(p) for p in ("repro.engine.probe",)):
            continue
        assert _hist_values(pt.hists[name]) == _hist_values(h), name
    assert any(n.startswith("repro.engine.probes_used.range")
               for n in pt.hists)


@pytest.mark.parametrize("arm", ["bucket", "dense", "fused"])
def test_dispatch_and_cost_counts_equal_reference(calibrated, arm):
    """The reference calls its ops eagerly on this path, so each op's
    dispatch count and analytic cost totals must be the port's. The
    port's own op (``ops.PORT_KERNELS``: the per-range take, plain jnp in
    the reference) counts once for each budgeted call of the bucket
    arms, with its own cost, and nowhere else."""
    jidx, pidx, queries = calibrated
    jeng = jengine.QueryEngine(jidx, engine=arm)
    peng = QueryEngine(pidx, engine=arm, buckets=None, device="cpu")
    jt, pt = jobs.Tracker(), Tracker()
    jops.set_dispatch_tracker(jt)
    ops.set_dispatch_tracker(pt)
    try:
        for kw in PROBES:
            jeng.query(jnp.asarray(queries), 10, **kw)
            peng.query(t(queries), 10, **kw)
    finally:
        jops.set_dispatch_tracker(None)
        ops.set_dispatch_tracker(None)
    own = {k: v for k, v in pt.counters.items()
           if k.split(".")[3] in ops.PORT_KERNELS}
    assert {k: v for k, v in pt.counters.items() if k not in own} == \
        jt.counters
    assert any(k.startswith("repro.kernels.cost.") for k in pt.counters)
    budgeted = sum("recall_target" in kw for kw in PROBES)
    if arm == "dense":
        assert own == {}
    else:
        c = planned_runs_cost(queries.shape[0], peng.buckets.num_buckets,
                              peng.buckets.rank.shape[0])
        assert own == {
            "repro.kernels.dispatch.planned_runs.ref": budgeted,
            "repro.kernels.cost.planned_runs.flops": budgeted * c["flops"],
            "repro.kernels.cost.planned_runs.hbm_bytes":
                budgeted * c["hbm_bytes"]}


def test_adaptive_query_telemetry(calibrated):
    _, pidx, queries = calibrated
    tr = Tracker()
    eng = QueryEngine(pidx, engine="bucket", tracker=tr, device="cpu")
    pl = planner.plan(pidx.calib, 0.9)
    bare = QueryEngine(pidx, engine="bucket", buckets=eng.buckets,
                       device="cpu")
    v0, i0, u0 = planner.adaptive_query(bare, t(queries), 10,
                                        budgets=pl.budgets)
    v1, i1, u1 = planner.adaptive_query(eng, t(queries), 10,
                                        budgets=pl.budgets)
    assert torch.equal(i0, i1) and torch.equal(u0, u1) and torch.equal(v0, v1)
    h = tr.hists["repro.planner.probes_used"]
    assert h.count == queries.shape[0]
    assert h.max <= tr.gauges["repro.planner.planned_width"]
    assert tr.hists["repro.planner.adaptive_savings"].min >= 0.0
    assert tr.counters["repro.planner.adaptive_queries"] == queries.shape[0]
    other = Tracker()
    planner.adaptive_query(bare, t(queries), 10, budgets=pl.budgets,
                           tracker=other)
    assert other.counters["repro.planner.adaptive_queries"] == \
        queries.shape[0]


def test_adaptive_query_telemetry_equals_reference(calibrated):
    jidx, pidx, queries = calibrated
    jt, pt = jobs.Tracker(), Tracker()
    pl = jplanner.plan(jidx.calib, 0.9)
    jplanner.adaptive_query(jengine.QueryEngine(jidx, engine="bucket"),
                            jnp.asarray(queries), 10, budgets=pl.budgets,
                            tracker=jt)
    planner.adaptive_query(QueryEngine(pidx, engine="bucket", device="cpu"),
                           t(queries), 10, budgets=pl.budgets, tracker=pt)
    assert pt.counters == jt.counters and pt.gauges == jt.gauges
    assert set(pt.hists) == set(jt.hists)
    for name, h in jt.hists.items():
        assert _hist_values(pt.hists[name]) == _hist_values(h), name


def test_per_range_probe_budget_telemetry(calibrated):
    _, pidx, queries = calibrated
    tr = Tracker()
    QueryEngine(pidx, engine="bucket", tracker=tr, device="cpu").query(
        t(queries), 10, recall_target=0.9)
    per_range = [n for n in tr.hists
                 if n.startswith("repro.engine.probes_used.range")]
    assert len(per_range) == pidx.num_ranges
    assert all(tr.hists[n].count == 1 for n in per_range)


# -- recall auditor -----------------------------------------------------------


def test_auditor_sampling_is_deterministic_fraction():
    aud = RecallAuditor(Tracker(), sample_fraction=0.25)
    decisions = []
    for _ in range(40):
        decisions.append(aud.should_audit())
        aud.batches_seen += 1
    assert sum(decisions) == 10 + 1
    assert decisions[0] is True
    with pytest.raises(ValueError):
        RecallAuditor(Tracker(), sample_fraction=1.5)
    assert RecallAuditor(Tracker(), sample_fraction=0.0).should_audit() \
        is False


def test_auditor_measures_recall_and_shortfall():
    rng = np.random.default_rng(1)
    items = rng.normal(size=(200, 8)).astype(np.float32)
    queries = rng.normal(size=(6, 8)).astype(np.float32)
    truth = np.argsort(-(queries @ items.T), axis=1)[:, :5]
    tr = Tracker()
    aud = RecallAuditor(tr, recall_target=0.95, sample_fraction=1.0,
                        tolerance=0.02)
    assert aud.audit(t(queries), t(truth), t(items), k=5) == \
        pytest.approx(1.0)
    assert "repro.planner.audit.shortfall" not in tr.counters
    junk = np.full_like(truth, 199)
    achieved = aud.audit(queries, junk, items, k=5)
    assert achieved < 0.5
    assert tr.counters["repro.planner.audit.shortfall"] == 1
    evs = [e for e in tr.events if e["name"] == "repro.planner.audit"]
    assert len(evs) == 2 and evs[1]["shortfall"] is True
    assert tr.gauges["repro.planner.audit.achieved_recall.last"] == \
        pytest.approx(achieved)
    ref = jobs.Tracker()
    jaud = jobs.RecallAuditor(ref, recall_target=0.95, sample_fraction=1.0,
                              tolerance=0.02)
    jaud.audit(queries, truth, items, k=5)
    jaud.audit(queries, junk, items, k=5)
    assert tr.events == ref.events and tr.counters == ref.counters


def test_auditor_maps_storage_rows_to_global_ids():
    rng = np.random.default_rng(2)
    items = rng.normal(size=(50, 4)).astype(np.float32)
    queries = rng.normal(size=(3, 4)).astype(np.float32)
    gids = np.arange(50) * 7 + 3
    truth_rows = np.argsort(-(queries @ items.T), axis=1)[:, :4]
    aud = RecallAuditor(Tracker(), sample_fraction=1.0)
    assert aud.audit(queries, gids[truth_rows], items, item_ids=t(gids),
                     k=4) == pytest.approx(1.0)


# -- streaming events through the tracker -------------------------------------


def _stream_traffic(mi, items, queries, to_dev):
    """Inserts that breach the top bound, deletes, a query, stats()."""
    rng = np.random.default_rng(0)
    norms = np.linalg.norm(items, axis=1)
    v = rng.normal(size=(8, items.shape[1]))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    mi.insert(to_dev((v * (2.0 * norms.max())).astype(np.float32)))
    mi.delete(np.flatnonzero(mi._live)[:4].tolist())
    mi.query(to_dev(queries[:4]), 5, 50)
    mi.stats()


def test_streaming_events_mirrored_to_tracker(longtail_ds):
    """Every MutableIndex event also reaches the tracker, with the
    inserts/deletes/queries records, the query span and the drift
    gauges of ``stats()``."""
    items = np.asarray(longtail_ds.items[:600])
    tr = Tracker()
    mi = streaming.build(items, torch.Generator().manual_seed(1), 16, 4,
                         capacity=64, max_tombstones=32, tracker=tr,
                         device="cpu")
    _stream_traffic(mi, items, np.asarray(longtail_ds.queries), t)
    mirrored = [e for e in tr.events
                if e["name"].startswith("repro.streaming.")
                and e["name"] != "repro.streaming.drift.snapshot"]
    assert len(mirrored) == len(mi.events)
    for ev, rec in zip(mi.events, mirrored):
        assert rec["name"] == f"repro.streaming.{ev['kind']}"
        assert {k: v for k, v in rec.items() if k != "name"} == \
            {k: v for k, v in ev.items() if k != "kind"}
    assert "repartition" in {e["kind"] for e in mi.events}
    assert tr.counters["repro.streaming.inserts"] == 8
    assert tr.counters["repro.streaming.deletes"] == 4
    assert tr.counters["repro.streaming.queries"] == 4
    assert "repro.streaming.query" in tr.hists
    assert any(n.startswith("repro.streaming.drift.count.")
               for n in tr.gauges)
    assert any(e["name"] == "repro.streaming.drift.snapshot"
               for e in tr.events)


def test_streaming_query_parity_with_tracker(longtail_ds):
    items = np.asarray(longtail_ds.items[:500])
    kw = dict(capacity=64, max_tombstones=32, device="cpu")
    mi0 = streaming.build(items, torch.Generator().manual_seed(1), 16, 4,
                          **kw)
    mi1 = streaming.build(items, torch.Generator().manual_seed(1), 16, 4,
                          tracker=Tracker(), **kw)
    q = t(np.asarray(longtail_ds.queries[:6]))
    v0, i0 = mi0.query(q, 5, 80)
    v1, i1 = mi1.query(q, 5, 80)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    mi0.set_tracker(Tracker())
    mi0.set_tracker(None)
    assert mi0.tracker is None


def _close(a, b, path=""):
    """Equal structure; floats within rtol 1e-6, the rest equal."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, (float, np.floating)):
        assert a == pytest.approx(float(b), rel=1e-6), path
    else:
        assert a == b, path


def test_streaming_events_equal_reference(longtail_ds):
    """The same traffic on a reference index and its port copy: the same
    event kinds and payloads, records and drift gauges."""
    items = np.asarray(longtail_ds.items[:600])
    jmi = jstreaming.build(jnp.asarray(items), jax.random.PRNGKey(1), 16, 4,
                           capacity=64, max_tombstones=32, impl="ref")
    jt, pt = jobs.Tracker(), Tracker()
    tree = jax.tree.map(np.asarray, jstreaming.index_tree(jmi))
    pmi = convert.mutable_index_from_tree(tree, device="cpu", tracker=pt)
    jmi.set_tracker(jt)
    queries = np.asarray(longtail_ds.queries)
    _stream_traffic(jmi, items, queries, jnp.asarray)
    _stream_traffic(pmi, items, queries, t)
    assert [e["name"] for e in pt.events] == [e["name"] for e in jt.events]
    _close(pt.events, jt.events)
    assert pt.counters == jt.counters
    _close(pt.gauges, jt.gauges)
    assert set(pt.hists) == set(jt.hists)
    for name in ("repro.streaming.insert_batch",
                 "repro.streaming.probe_width"):
        assert _hist_values(pt.hists[name]) == _hist_values(jt.hists[name])


# -- kernel dispatch counters -------------------------------------------------


def test_kernel_dispatch_counters():
    tr = Tracker()
    ops.set_dispatch_tracker(tr)
    try:
        x = torch.ones((4, 8))
        A = torch.ones((8, 32))
        ops.hash_encode(x, A)
        ops.hash_encode(x, A, impl="ref")
        assert tr.counters["repro.kernels.dispatch.hash_encode.ref"] == 2
        assert not any(k.endswith(".cuda") for k in tr.counters)
    finally:
        ops.set_dispatch_tracker(None)
    ops.hash_encode(torch.ones((2, 8)), torch.ones((8, 32)))


def test_kernel_dispatch_charges_cost_counters():
    tr = Tracker()
    ops.set_dispatch_tracker(tr)
    try:
        q, d, L = 4, 8, 32
        codes = ops.hash_encode(torch.ones((q, d)), torch.ones((d, L)))
        ops.hamming_scan(codes, codes)
    finally:
        ops.set_dispatch_tracker(None)
    pred = hash_encode_cost(q, d, L)
    assert tr.counters["repro.kernels.cost.hash_encode.flops"] == \
        pred["flops"]
    assert tr.counters["repro.kernels.cost.hash_encode.hbm_bytes"] == \
        pred["hbm_bytes"]
    assert tr.counters["repro.kernels.cost.hamming_scan.flops"] == q * q


# -- chrome trace export ------------------------------------------------------


def test_nested_spans_export_balanced_and_carry_attrs(tmp_path):
    tr, _ = _fake_clock_tracker()
    with tr.span("query"):
        with tr.span("hash_encode", attrs={"flops": 8.0,
                                           "hbm_bytes": 64.0}):
            pass
        with tr.span("gather"):
            pass
    path = str(tmp_path / "trace.json")
    trace = export_chrome_trace(tr, path)
    stats = validate_chrome_trace(trace)
    assert stats["span_pairs"] == 3 and stats["num_pids"] == 1
    begins = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "B"}
    assert begins["hash_encode"]["args"]["flops"] == 8.0
    assert begins["hash_encode"]["args"]["path"] == "query/hash_encode"
    assert begins["gather"]["args"]["path"] == "query/gather"
    evs = [(e["ph"], e["name"]) for e in trace["traceEvents"]
           if e.get("ph") in "BE"]
    assert evs[0] == ("B", "query") and evs[-1] == ("E", "query")
    with open(path) as fh:
        assert validate_chrome_trace(json.load(fh)) == stats


def test_multi_shard_export_stable_pids():
    t0, _ = _fake_clock_tracker()
    t1, _ = _fake_clock_tracker()
    with t0.span("s"):
        pass
    with t1.span("s"):
        with t1.span("inner"):
            pass
    trace = export_chrome_trace({"shard1": t1, "shard0": t0})
    assert validate_chrome_trace(trace)["num_pids"] == 2
    meta = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M"}
    assert meta == {0: "shard0", 1: "shard1"}
    by_pid = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "B":
            by_pid.setdefault(e["pid"], []).append(e["name"])
    assert by_pid[0] == ["s"] and by_pid[1] == ["s", "inner"]


def test_export_without_ring_sink_raises():
    with pytest.raises(ValueError, match="RingBufferSink"):
        export_chrome_trace(Tracker())


def test_zero_duration_sibling_ties_stay_balanced():
    records = [
        {"type": "span", "name": "a", "path": "a", "depth": 0,
         "t0": 0.0, "dur_s": 1.0},
        {"type": "span", "name": "z", "path": "a/z", "depth": 1,
         "t0": 0.5, "dur_s": 0.0},
        {"type": "span", "name": "b", "path": "b", "depth": 0,
         "t0": 1.0, "dur_s": 1.0},
    ]
    events = chrome_trace_events(records)
    validate_chrome_trace({"traceEvents": events})
    assert json.dumps(events) == json.dumps(
        jobs.chrome_trace_events(records))


def test_validate_rejects_malformed_traces():
    common = {"pid": 0, "tid": 0, "cat": "x"}
    ok_b = {**common, "ph": "B", "name": "s", "ts": 0.0,
            "args": {"path": "s"}}
    with pytest.raises(ValueError, match="dangling"):
        validate_chrome_trace({"traceEvents": [ok_b]})
    with pytest.raises(ValueError, match="without matching B"):
        validate_chrome_trace({"traceEvents": [
            {**common, "ph": "E", "name": "s", "ts": 0.0}]})
    with pytest.raises(ValueError, match="unbalanced"):
        validate_chrome_trace({"traceEvents": [
            ok_b, {**common, "ph": "E", "name": "other", "ts": 1.0}]})
    with pytest.raises(ValueError, match="monotonic"):
        validate_chrome_trace({"traceEvents": [
            {**ok_b, "ts": 5.0},
            {**common, "ph": "E", "name": "s", "ts": 1.0}]})
    with pytest.raises(ValueError, match="args.path"):
        validate_chrome_trace({"traceEvents": [
            {**common, "ph": "B", "name": "s", "ts": 0.0}]})
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({})


# -- device-cost attribution --------------------------------------------------


def test_query_stage_costs_cover_all_stages():
    shape = {"q": 32, "n": 30_000, "d": 32, "code_len": 16,
             "num_buckets": 27_800, "probe_width": 917.0, "k": 10}
    costs = query_stage_costs(shape)
    assert set(costs) == set(BUCKET_STAGES)
    for name, c in costs.items():
        assert c["flops"] > 0 and c["hbm_bytes"] > 0, name
    assert costs["repro.engine.re_rank"]["flops"] > \
        costs["repro.engine.hash_encode"]["flops"]
    assert costs == jobs.query_stage_costs(shape)


def test_engine_spans_carry_predicted_cost_attrs(longtail_ds):
    spec = IndexSpec(family="simple", code_len=16, m=8)
    cidx = build(spec, np.asarray(longtail_ds.items[:800]), _gen(),
                 device="cpu")
    tr = Tracker([RingBufferSink()])
    QueryEngine(cidx, engine="bucket", tracker=tr, device="cpu").query(
        t(np.asarray(longtail_ds.queries[:4])), 5, 100)
    trace = export_chrome_trace(tr)
    validate_chrome_trace(trace)
    begins = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "B"}
    for stage in ("repro.engine.hash_encode",
                  "repro.engine.directory_match",
                  "repro.engine.segmented_gather",
                  "repro.engine.re_rank", "repro.engine.top_k"):
        args = begins[stage]["args"]
        assert args["flops"] > 0 and args["hbm_bytes"] > 0, stage
    assert begins["repro.engine.segmented_gather"]["args"]["flops"] == \
        pytest.approx(4 * 100)


def test_dense_engine_spans_carry_cost_attrs(longtail_ds):
    spec = IndexSpec(family="simple", code_len=16, m=8)
    cidx = build(spec, np.asarray(longtail_ds.items[:800]), _gen(),
                 device="cpu")
    tr = Tracker([RingBufferSink()])
    QueryEngine(cidx, engine="dense", tracker=tr, device="cpu").query(
        t(np.asarray(longtail_ds.queries[:4])), 5, 100)
    recs = {r["name"]: r for r in tr.sinks[0].query(type="span")}
    for stage in ("repro.engine.dense_match", "repro.engine.dense_select"):
        assert recs[stage]["attrs"]["flops"] > 0, stage


def test_flop_counter_cost_cross_checks_analytic_hash_encode():
    """The analytic encode model sits within a small factor of the FLOPs
    torch counts for the projection (the reference's ``xla_cost`` check,
    against torch's flop counter)."""
    q, d, L = 16, 32, 64
    got = flop_counter_cost(lambda x, A: torch.sign(x @ A),
                            torch.ones((q, d)), torch.ones((d, L)))
    pred = hash_encode_cost(q, d, L)["flops"]
    assert 0.2 * pred <= got["flops"] <= 5.0 * pred
    assert flop_counter_cost(lambda x: x + 1, torch.ones(3)) is None


def test_obs_exports_the_reference_names():
    """Every public name of ``repro.obs`` but ``xla_cost``, whose place
    ``flop_counter_cost`` takes."""
    want = set(jobs.__all__) - {"xla_cost"} | {"flop_counter_cost"}
    assert set(obs.__all__) == want
    assert all(hasattr(obs, n) for n in obs.__all__)


# -- SLO monitor --------------------------------------------------------------


def test_request_class_validation():
    with pytest.raises(ValueError, match="slo_p50_s"):
        RequestClass(name="a", recall_target=0.9, k=10,
                     slo_p50_s=0.1, slo_p99_s=0.05)
    with pytest.raises(ValueError, match="weight"):
        RequestClass(name="a", recall_target=0.9, k=10,
                     slo_p50_s=0.01, slo_p99_s=0.05, weight=0.0)


def test_slo_monitor_burn_rate_and_breach():
    tr = Tracker()
    cls = RequestClass(name="standard", recall_target=0.95, k=10,
                       slo_p50_s=0.01, slo_p99_s=0.05)
    mon = SloMonitor(tr, [cls], tolerance=0.0, budget_quantile=0.99,
                     min_samples=10)
    for _ in range(98):
        mon.record("standard", 0.005)
    mon.record("standard", 0.2)
    mon.record("standard", 0.2)
    assert mon.burn_rate("standard") == pytest.approx(2.0)
    v = mon.evaluate()["standard"]
    assert v["n"] == 100 and v["over_budget"] == 2
    assert v["evaluated"] is True
    assert v["p50_s"] == pytest.approx(0.005, rel=0.05)
    assert v["breached"] is True
    assert tr.counters["repro.slo.breach"] == 1
    ev, = [e for e in tr.events if e["name"] == "repro.slo.breach"]
    assert ev["request_class"] == "standard"
    assert ev["burn_rate"] == pytest.approx(2.0)
    assert tr.gauges["repro.slo.burn_rate.standard"] == pytest.approx(2.0)
    assert tr.hists["repro.slo.latency.standard"].count == 100
    ref = jobs.Tracker()
    jmon = jobs.SloMonitor(ref, [jobs.RequestClass(
        name="standard", recall_target=0.95, k=10, slo_p50_s=0.01,
        slo_p99_s=0.05)], tolerance=0.0, budget_quantile=0.99,
        min_samples=10)
    for x in [0.005] * 98 + [0.2, 0.2]:
        jmon.record("standard", x)
    assert jmon.evaluate() == mon.evaluate()


def test_slo_monitor_within_slo_never_breaches():
    tr = Tracker()
    cls = RequestClass(name="a", recall_target=0.9, k=10,
                       slo_p50_s=0.01, slo_p99_s=0.05)
    mon = SloMonitor(tr, [cls], min_samples=5)
    for _ in range(50):
        mon.record("a", 0.004)
    v = mon.evaluate()["a"]
    assert v["breached"] is False and v["burn_rate"] == 0.0
    assert "repro.slo.breach" not in tr.counters


def test_slo_monitor_min_samples_gate():
    tr = Tracker()
    cls = RequestClass(name="a", recall_target=0.9, k=10,
                       slo_p50_s=0.001, slo_p99_s=0.002)
    mon = SloMonitor(tr, [cls], min_samples=20)
    for _ in range(5):
        mon.record("a", 1.0)
    v = mon.evaluate()["a"]
    assert v["evaluated"] is False and v["breached"] is False
    assert mon.burn_rate("a") > 1.0


def test_slo_monitor_validation():
    tr = Tracker()
    c = RequestClass(name="a", recall_target=0.9, k=10,
                     slo_p50_s=0.01, slo_p99_s=0.05)
    with pytest.raises(ValueError, match="duplicate"):
        SloMonitor(tr, [c, c])
    with pytest.raises(ValueError, match="budget_quantile"):
        SloMonitor(tr, [c], budget_quantile=1.0)
    mon = SloMonitor(tr, [c])
    with pytest.raises(KeyError, match="unknown request class"):
        mon.record("nope", 0.01)
    assert math.isfinite(mon.burn_rate("a"))
