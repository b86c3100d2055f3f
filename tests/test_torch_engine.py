"""The port end to end against the JAX package: an index built by the
reference is carried across with ``repro_torch.convert`` and both answer
the same queries.

Candidate ids (dense and bucket arms, ``num_probe`` and ``budgets``) must
be equal. Query results are compared tie-aware with values within
ATOL/RTOL (re-rank dots summed in another order). Calibration tables and
plans must be equal: they are integer positions and counts on the same
order. Also here: the port's own build on the reference's projections,
``IndexSpec.validate``'s errors, the device rule, and a scan that keeps
JAX and the reference package out of the port.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_codes_match, assert_topk_tie_aware,
                           imports_of, t)
from repro.core import engine as jengine
from repro.core import index as jindex
from repro.core import planner as jplanner
from repro_torch import convert
from repro_torch.core import planner
from repro_torch.core.engine import QueryEngine
from repro_torch.core.index import IndexSpec, build
from repro_torch.core.family import get_family
from repro_torch.data.synthetic import make_dataset

ROOT = Path(__file__).resolve().parents[1]
N, D, M, K = 3000, 16, 8, 10
BUDGETS = (60, 40, 30, 20, 12, 8, 5, 5)
ARMS = {"dense": {}, "bucket": {}, "fused": {},
        "fused_int8": {"quantized": True}}


@pytest.fixture(scope="module")
def pair():
    """(reference index, port index, items, query and calibration sets)."""
    rng = np.random.default_rng(2024)
    items = (rng.standard_normal((N, D))
             * np.exp(0.8 * rng.standard_normal((N, 1)))).astype(np.float32)
    queries = rng.standard_normal((24, D)).astype(np.float32)
    cal_q = rng.standard_normal((32, D)).astype(np.float32)
    jspec = jindex.IndexSpec(family="simple", code_len=16, m=M,
                             engine="bucket", recall_target=0.9)
    jidx = jindex.build(jspec, jnp.asarray(items), jax.random.PRNGKey(3),
                        calibration_queries=jnp.asarray(cal_q))
    pidx = convert.index_from_fields(
        {f: np.asarray(getattr(jidx, f)) for f in convert.INDEX_FIELDS},
        {f: getattr(jidx.spec, f) for f in convert.SPEC_FIELDS},
        jidx.hash_bits, calib=jidx.calib._asdict(), device="cpu")
    return jidx, pidx, items, queries, cal_q


@pytest.fixture(scope="module")
def engines(pair):
    jidx, pidx = pair[:2]
    jb = jengine.QueryEngine(jidx, engine="bucket")
    pb = QueryEngine(pidx, engine="bucket", device="cpu")
    ref = {a: jengine.QueryEngine(jidx, engine=a.split("_")[0],
                                  buckets=jb.buckets, **kw)
           for a, kw in ARMS.items()}
    port = {a: QueryEngine(pidx, engine=a.split("_")[0], buckets=pb.buckets,
                           device="cpu", **kw)
            for a, kw in ARMS.items()}
    return ref, port


def _probe(mode):
    # one width for both modes, so the reference compiles each shape once
    return ({"num_probe": sum(BUDGETS)} if mode == "num_probe"
            else {"budgets": BUDGETS})


def test_carried_index_has_the_reference_bucket_store(pair, engines):
    ref, port = engines
    jb, pb = ref["bucket"].buckets, port["bucket"].buckets
    for field in ("item_ids", "bucket_start", "bucket_rid", "rank"):
        np.testing.assert_array_equal(getattr(pb, field).numpy(),
                                      np.asarray(getattr(jb, field)))


@pytest.mark.parametrize("mode", ["num_probe", "budgets"])
@pytest.mark.parametrize("arm", ["dense", "bucket"])
def test_candidates_equal_reference(pair, engines, arm, mode):
    q = pair[3]
    want = engines[0][arm].candidates(jnp.asarray(q), **_probe(mode))
    got = engines[1][arm].candidates(t(q), **_probe(mode))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["num_probe", "budgets"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_query_equals_reference(pair, engines, arm, mode):
    q = pair[3]
    wv, wi = engines[0][arm].query(jnp.asarray(q), K, **_probe(mode))
    gv, gi = engines[1][arm].query(t(q), K, **_probe(mode))
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


@pytest.mark.parametrize("engine", ["bucket", "fused", "dense"])
def test_composed_index_recall_contract_equals_reference(pair, engine):
    jidx, pidx, _, q, _ = pair
    wv, wi = jidx.query(jnp.asarray(q), K, engine=engine)
    gv, gi = pidx.query(t(q), K, engine=engine)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


def test_flat_dense_candidates_equal_reference(pair):
    jidx, pidx, _, q, _ = pair
    want = jidx.candidates(jnp.asarray(q), 200, engine="dense")
    got = pidx.candidates(t(q), 200, engine="dense")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_calibration_and_plans_equal_reference(pair):
    jidx, pidx, _, _, cal_q = pair
    got = planner.calibrate(pidx, t(cal_q), k=K)
    want = jidx.calib
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for target in (0.5, 0.8, 0.9, 0.95, 1.0):
        assert planner.plan(got, target) == jplanner.plan(want, target)
        assert planner.plan_global(got, target) == \
            jplanner.plan_global(want, target)


def test_calibrate_from_order_equals_reference():
    rng = np.random.default_rng(5)
    q, n, m = 12, 500, 6
    order = np.stack([rng.permutation(n) for _ in range(q)])
    rid = rng.integers(0, m, size=n)
    truth = np.stack([rng.choice(n, 7, replace=False) for _ in range(q)])
    want = jplanner.calibrate_from_order(order, rid, truth, num_ranges=m)
    got = planner.calibrate_from_order(t(order, np.int32), t(rid, np.int32),
                                       t(truth), num_ranges=m)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_contract_errors_match_reference(pair):
    jidx, pidx, _, q, _ = pair
    for idx, qq in ((jidx, jnp.asarray(q)), (pidx, t(q))):
        with pytest.raises(ValueError, match="calibrated at k=10"):
            idx.query(qq, 11)
        with pytest.raises(ValueError, match="pass one of"):
            idx.query(qq, 5, 100, recall_target=0.9)


def test_port_build_on_reference_projections(pair):
    """The port's own build: same partition, codes equal up to near-zero
    projections, and its arms agree with each other."""
    jidx, _, items, q, cal_q = pair
    spec = IndexSpec(family="simple", code_len=16, m=M, engine="bucket")
    idx = build(spec, items, params=np.array(jidx.params), device="cpu",
                calibration_queries=t(cal_q))
    np.testing.assert_allclose(idx.norms.numpy(), np.asarray(jidx.norms),
                               rtol=1e-6)
    np.testing.assert_array_equal(idx.range_id.numpy(),
                                  np.asarray(jidx.range_id))
    x = items / np.asarray(jidx.upper_eff)[np.asarray(jidx.range_id)][:, None]
    tail = np.sqrt(np.maximum(0.0, 1 - (x.astype(np.float64) ** 2).sum(1)))
    P = np.asarray(jidx.params, np.float64)
    proj = x @ P[:-1] + tail[:, None] * P[-1]
    assert_codes_match(idx.codes.numpy(), jidx.codes, proj,
                       np.sqrt((x.astype(np.float64) ** 2).sum(1)
                               + tail ** 2))
    b = QueryEngine(idx, engine="bucket", device="cpu")
    d = QueryEngine(idx, engine="dense", buckets=b.buckets, device="cpu")
    f = QueryEngine(idx, engine="fused", buckets=b.buckets, device="cpu")
    budgets = planner.resolve_budgets(idx.calib, 0.9, k=K).budgets
    np.testing.assert_array_equal(b.candidates(t(q), budgets=budgets).numpy(),
                                  d.candidates(t(q), budgets=budgets).numpy())
    sv, si = b.query(t(q), K, budgets=budgets)
    fv, fi = f.query(t(q), K, budgets=budgets)
    assert_topk_tie_aware(fi.numpy(), fv.numpy(), si.numpy(), sv.numpy())


@pytest.mark.parametrize("kwargs", [
    {"family": "nope"}, {"scheme": "nope"}, {"engine": "nope"},
    {"code_len": 0}, {"m": 0}, {"num_tables": 0}, {"eps": 1.0},
    {"recall_target": 0.0}, {"recall_target": 1.5},
    {"code_len": 4, "m": 32}, {"m": 12}, {"num_tables": 2, "engine": "fused"},
    {"alsh_m": 0}, {"alsh_U": 1.5}, {"alsh_r": -1.0},
])
def test_index_spec_validate_raises_like_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jindex.IndexSpec(**kwargs).validate()
    with pytest.raises(ValueError) as got:
        IndexSpec(**kwargs).validate()
    assert str(got.value) == str(want.value)


def test_impl_values_and_unported_families():
    """The port's impl names, and every family of the reference resolves,
    its ALSH overrides included (both ALSH families were once refused)."""
    from repro.core.family import get_family as j_get_family
    with pytest.raises(ValueError, match="unknown impl 'pallas'"):
        IndexSpec(impl="pallas").validate()
    IndexSpec(impl="cuda").validate()
    for name in ("l2_alsh", "sign_alsh"):
        for kw in ({}, {"alsh_m": 4, "alsh_U": 0.6, "alsh_r": 1.5}):
            want = j_get_family(name, **kw)
            got = IndexSpec(family=name, **kw).validate().resolve_family()
            assert got == get_family(name, **kw)
            assert (got.name, got.packed, got.m, got.U) == \
                (want.name, want.packed, want.m, want.U)
            assert getattr(got, "r", None) == getattr(want, "r", None)


def test_make_dataset_profiles_on_cpu():
    for name in ("imagenet", "netflix", "yahoomusic"):
        ds = make_dataset(name, 1, n=500, d=12, num_queries=7, device="cpu")
        assert ds.items.shape == (500, 12) and ds.queries.shape == (7, 12)
        assert bool(torch.isfinite(ds.items).all())
    a = make_dataset("imagenet", 3, n=50, d=4, device="cpu").items
    assert torch.equal(a, make_dataset("imagenet", 3, n=50, d=4,
                                       device="cpu").items)
    with pytest.raises(ValueError, match="unknown dataset profile"):
        make_dataset("sift", 0, device="cpu")


def test_entry_points_refuse_to_fall_back_to_the_cpu(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    pidx = pair[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(IndexSpec(), np.ones((8, 4), np.float32),
              torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(pidx, engine="bucket")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dataset("imagenet", 0, n=10, d=4)


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "streaming/delta", "streaming/drift", "streaming/engine",
        "streaming/index", "streaming/persist", "checkpoint/manager",
        "kernels/ops", "obs/tracker", "obs/trace", "obs/cost",
        "core/simple_lsh", "core/range_lsh")} <= names
    for path in files:
        bad = imports_of(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
