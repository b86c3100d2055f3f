"""The port's SIGN-ALSH and L2-ALSH families, multi-table single-probe,
adaptive early termination, the probed-recall curves and the rho module
against the JAX package, on the same numpy inputs.

Each family is built by the reference (flat and ranged, code_len 16 and
32) and carried across with ``convert.index_from_fields``; everything
downstream of the codes must then equal the reference exactly: bucket
stores, candidate ids in the dense and bucket arms, calibration tables
and plans. Query values agree within ATOL/RTOL (re-rank dots summed in
another order), ids tie-aware. The port's own encode of the reference's
parameters is held to the bands of the two hash rules: a sign bit may
differ only where its projection lies within FLIP_REL of zero, an L2
hash only where ``(x.a + b)/r`` lies within ``1e-5 (1 + |.|)`` of an
integer. The L2-ALSH score table agrees within rtol 1e-6 (erf rounds
differently in XLA and torch) and its probe ranks exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_codes_match, assert_topk_tie_aware, t)
from repro.core import engine as jengine
from repro.core import hashing as jhashing
from repro.core import index as jindex
from repro.core import planner as jplanner
from repro.core import rho as jrho
from repro.core import topk as jtopk
from repro.core.bucket_index import rank_from_scores as j_rank_from_scores
from repro_torch import convert
from repro_torch.core import hashing, planner, rho, topk
from repro_torch.core.bucket_index import (bucket_sizes, build_bucket_index,
                                           rank_from_scores)
from repro_torch.core.engine import QueryEngine, encode_queries
from repro_torch.core.family import get_family
from repro_torch.core.index import ComposedMultiTable, IndexSpec, build

N, D, K = 2000, 14, 10
# (family, code_len, m, calibrated): flat and ranged, one and two widths
CONFIGS = [("sign_alsh", 32, 8, True), ("sign_alsh", 16, 1, False),
           ("l2_alsh", 16, 8, True), ("l2_alsh", 32, 1, False)]
IDS = [f"{f}-L{c}-m{m}" for f, c, m, _ in CONFIGS]
PROBE = 150
L2_BAND = 1e-5


def _items(seed=2024, n=N, d=D):
    rng = np.random.default_rng(seed)
    items = (rng.standard_normal((n, d))
             * np.exp(0.8 * rng.standard_normal((n, 1)))).astype(np.float32)
    return items, rng.standard_normal((16, d)).astype(np.float32), \
        rng.standard_normal((32, d)).astype(np.float32)


def _fields(jidx):
    arrays = {f: np.asarray(getattr(jidx, f)) for f in convert.INDEX_FIELDS
              if f != "params"}
    arrays["params"] = jax.tree.map(np.asarray, tuple(jidx.params)) \
        if isinstance(jidx.params, tuple) else np.asarray(jidx.params)
    return arrays


def _carry(jidx):
    return convert.index_from_fields(
        _fields(jidx), {f: getattr(jidx.spec, f) for f in convert.SPEC_FIELDS},
        jidx.hash_bits,
        calib=None if jidx.calib is None else jidx.calib._asdict(),
        device="cpu")


@pytest.fixture(scope="module")
def data():
    return _items()


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def pair(request, data):
    """(config, reference index, carried port index, reference engines,
    port engines)."""
    fam, code_len, m, calibrated = request.param
    items, _, cal_q = data
    jspec = jindex.IndexSpec(family=fam, code_len=code_len, m=m,
                             engine="bucket",
                             recall_target=0.9 if calibrated else None)
    jidx = jindex.build(jspec, jnp.asarray(items), jax.random.PRNGKey(7),
                        calibration_queries=(jnp.asarray(cal_q)
                                             if calibrated else None))
    pidx = _carry(jidx)
    jb = jengine.QueryEngine(jidx, engine="bucket")
    pb = QueryEngine(pidx, engine="bucket", device="cpu")
    jeng = {a: jengine.QueryEngine(jidx, engine=a, buckets=jb.buckets)
            for a in ("dense", "bucket", "fused")}
    peng = {a: QueryEngine(pidx, engine=a, buckets=pb.buckets, device="cpu")
            for a in ("dense", "bucket", "fused")}
    return request.param, jidx, pidx, jeng, peng


def _budgets(jidx):
    """The planned budgets at target 0.9, or one budget of PROBE for a
    flat index built without calibration."""
    if jidx.calib is None:
        return (PROBE,)
    return jplanner.resolve_budgets(jidx.calib, 0.9, k=K).budgets


# -- families ----------------------------------------------------------------


def test_get_family_resolves_like_reference():
    from repro.core.family import get_family as j_get_family
    for name in ("simple", "l2_alsh", "sign_alsh"):
        for kw in ({}, {"alsh_m": 2, "alsh_U": 0.7, "alsh_r": 3.0}):
            want, got = j_get_family(name, **kw), get_family(name, **kw)
            assert (got.name, got.packed, got.charges_index_bits) == \
                (want.name, want.packed, want.charges_index_bits)
            for attr in ("m", "U", "r"):
                assert getattr(got, attr, None) == getattr(want, attr, None)
    spec = IndexSpec(family="l2_alsh", alsh_m=2, alsh_r=3.0)
    assert (spec.resolve_family().m, spec.resolve_family().r) == (2, 3.0)
    with pytest.raises(ValueError, match="unknown hash family"):
        get_family("nope")


def test_port_encode_of_reference_params_is_within_the_bands(pair, data):
    """The port's build on the reference's parameters: same partition,
    codes within the hash rule's band, score table within rtol 1e-6 and
    ranks equal; the port's own arms agree with each other."""
    (fam, code_len, m, _), jidx, _, _, _ = pair
    items, q, _ = data
    params = _fields(jidx)["params"]
    idx = build(IndexSpec(family=fam, code_len=code_len, m=m), items,
                params=params, device="cpu")
    np.testing.assert_array_equal(idx.range_id.numpy(),
                                  np.asarray(jidx.range_id))
    scale = jidx.family.U / np.asarray(jidx.upper_eff, np.float64)[
        np.asarray(jidx.range_id)]
    x = items.astype(np.float64) * scale[:, None]
    n2 = (x ** 2).sum(1)
    pows = [n2 ** (2 ** i) for i in range(jidx.family.m)]
    if fam == "sign_alsh":
        px = np.concatenate([x] + [(0.5 - p)[:, None] for p in pows], 1)
        proj = px @ np.asarray(params, np.float64)
        flips = assert_codes_match(idx.codes.numpy(), jidx.codes, proj,
                                   np.linalg.norm(px, axis=1))
        assert flips <= N * code_len // 1000
    else:
        px = np.concatenate([x] + [p[:, None] for p in pows], 1)
        a, b = (np.asarray(p, np.float64) for p in params)
        v = (px @ a + b) / jidx.family.r
        diff = idx.codes.numpy() != np.asarray(jidx.codes)
        near = np.abs(v - np.round(v)) < L2_BAND * (1 + np.abs(v))
        assert not (diff & ~near).any(), "L2 hashes differ off the band"
        assert diff.sum() <= N * code_len // 1000
    np.testing.assert_allclose(idx.table.numpy(), np.asarray(jidx.table),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        rank_from_scores(idx.table).numpy(),
        np.asarray(j_rank_from_scores(jidx.table)))
    b = QueryEngine(idx, engine="bucket", device="cpu")
    d = QueryEngine(idx, engine="dense", buckets=b.buckets, device="cpu")
    np.testing.assert_array_equal(b.candidates(t(q), PROBE).numpy(),
                                  d.candidates(t(q), PROBE).numpy())


def test_l2_alsh_score_table_and_inversion_match_reference():
    from repro.core.family import _invert_l2_collision as j_invert
    from repro_torch.core.family import _invert_l2_collision
    p = np.linspace(0.01, 0.99, 41).astype(np.float32)
    for r in (2.5, 4.0):
        np.testing.assert_allclose(_invert_l2_collision(t(p), r).numpy(),
                                   np.asarray(j_invert(jnp.asarray(p), r)),
                                   rtol=1e-6)
    upper = np.asarray([0.3, 0.9, 1.7, 4.2, 4.2], np.float32)
    for K_ in (16, 32):
        want = jindex.IndexSpec(family="l2_alsh").resolve_family() \
            .score_table(jnp.asarray(upper), K_)
        got = get_family("l2_alsh").score_table(t(upper), K_)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(rank_from_scores(got).numpy(),
                                      np.asarray(j_rank_from_scores(want)))


def test_carried_index_has_the_reference_bucket_store(pair):
    _, _, pidx, jeng, peng = pair
    jb, pb = jeng["bucket"].buckets, peng["bucket"].buckets
    for field in ("item_ids", "bucket_start", "bucket_rid", "rank"):
        np.testing.assert_array_equal(getattr(pb, field).numpy(),
                                      np.asarray(getattr(jb, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(
        pb.bucket_code.numpy(),
        np.ascontiguousarray(np.asarray(jb.bucket_code)).view(np.int32))
    np.testing.assert_array_equal(bucket_sizes(pb).numpy(),
                                  np.diff(np.asarray(jb.bucket_start)))
    if not pidx.family.packed:      # signed hashes sort as signed int64
        assert (pidx.codes < 0).any()


@pytest.mark.parametrize("mode", ["num_probe", "budgets"])
def test_candidates_equal_reference(pair, mode):
    """The bucket arm against the reference's; the dense arm against the
    reference's dense arm (planned budgets) or the port's bucket arm
    (global prefix, whose dense realization the engine tests hold)."""
    _, jidx, pidx, jeng, peng = pair
    q = _items()[1]
    kw = ({"budgets": _budgets(jidx)} if mode == "budgets"
          else {"num_probe": PROBE})
    got = peng["bucket"].candidates(t(q), **kw).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jeng["bucket"].candidates(jnp.asarray(q), **kw)))
    dense = peng["dense"].candidates(t(q), **kw).numpy()
    if mode == "budgets":
        np.testing.assert_array_equal(
            dense, np.asarray(jeng["dense"].candidates(jnp.asarray(q),
                                                       **kw)))
    np.testing.assert_array_equal(dense, got)


def test_probe_order_and_flat_dense_prefix_equal_reference(pair):
    _, jidx, pidx, _, _ = pair
    q = _items()[1]
    np.testing.assert_array_equal(
        pidx.probe_order(t(q)).numpy(),
        np.asarray(jidx.probe_order(jnp.asarray(q))))
    np.testing.assert_array_equal(
        encode_queries(pidx, t(q)).numpy(),
        np.ascontiguousarray(np.asarray(
            jengine.encode_queries(jidx, jnp.asarray(q)))).view(np.int32))


@pytest.mark.parametrize("arm", ["dense", "bucket", "fused"])
def test_query_equals_reference(pair, arm):
    _, jidx, _, jeng, peng = pair
    q = _items()[1]
    kw = {"budgets": _budgets(jidx)}
    wv, wi = jeng[arm].query(jnp.asarray(q), K, **kw)
    gv, gi = peng[arm].query(t(q), K, **kw)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


def test_calibration_plans_and_recall_contract_equal_reference(pair, data):
    _, jidx, pidx, _, _ = pair
    q, cal_q = data[1], data[2]
    if jidx.calib is None:          # a flat build: calibrate both sides
        jidx = jidx._replace(spec=dataclasses.replace(
            jidx.spec, recall_target=0.9), calib=jplanner.calibrate(
                jidx, jnp.asarray(cal_q), k=K))
    got = planner.calibrate(pidx, t(cal_q), k=K)
    for field in jidx.calib._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(jidx.calib, field)),
                                      err_msg=field)
    assert got.num_ranges == pidx.num_ranges == jidx.num_ranges
    assert pidx.code_len == jidx.code_len
    for target in (0.5, 0.9, 1.0):
        assert planner.plan(got, target) == jplanner.plan(jidx.calib, target)
    pidx = pidx._replace(calib=got, spec=dataclasses.replace(
        pidx.spec, recall_target=0.9))
    wv, wi = jidx.query(jnp.asarray(q), K)
    gv, gi = pidx.query(t(q), K)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


# -- adaptive early termination ------------------------------------------------


@pytest.fixture(scope="module")
def adaptive_pair():
    """A RANGE-LSH index with many ranges on the long-tail profile (the
    reference test's setting), carried across."""
    items, q, _ = _items(11, n=2000, d=16)
    cal_q = np.random.default_rng(12).standard_normal((64, 16)).astype(
        np.float32)
    spec = jindex.IndexSpec(family="simple", code_len=16, m=32,
                            charge_index_bits=False)
    jidx = jindex.build(spec, jnp.asarray(items), jax.random.PRNGKey(3),
                        calibration_queries=jnp.asarray(cal_q))
    pidx = _carry(jidx)
    jeng = jengine.QueryEngine(jidx, engine="bucket")
    peng = QueryEngine(pidx, engine="bucket", device="cpu")
    return jidx, pidx, jeng, peng, np.concatenate([q, q[:8] * 3.0])


@pytest.mark.parametrize("target,chunk", [(0.999, 16), (0.9, 7)])
def test_adaptive_query_equals_reference(adaptive_pair, target, chunk):
    jidx, _, jeng, peng, q = adaptive_pair
    budgets = jplanner.plan(jidx.calib, target).budgets
    wv, wi, wu = jplanner.adaptive_query(jeng, jnp.asarray(q), K,
                                         budgets=budgets, chunk=chunk)
    gv, gi, gu = planner.adaptive_query(peng, t(q), K, budgets=budgets,
                                        chunk=chunk)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)
    # and the full planned re-rank, which early termination must not move
    fv, fi = peng.query(t(q), K, budgets=budgets)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), fi.numpy(), fv.numpy())
    if target == 0.999:
        assert gu.numpy().mean() < sum(budgets), "no query stopped early"


@pytest.mark.parametrize("sync_steps", [1, 3, 1000])
def test_adaptive_query_host_check_interval_changes_nothing(
        adaptive_pair, monkeypatch, sync_steps):
    """Steps taken after every query stopped add -inf scores and no
    probes, so reading ``active`` every step, every few steps or never
    gives the reference's (vals, ids, probes_used) exactly."""
    jidx, _, jeng, peng, q = adaptive_pair
    budgets = jplanner.plan(jidx.calib, 0.999).budgets
    wv, wi, wu = jplanner.adaptive_query(jeng, jnp.asarray(q), K,
                                         budgets=budgets, chunk=16)
    monkeypatch.setattr(planner, "ADAPTIVE_SYNC_STEPS", sync_steps)
    gv, gi, gu = planner.adaptive_query(peng, t(q), K, budgets=budgets,
                                        chunk=16)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


def test_adaptive_query_recall_target_num_probe_and_errors(adaptive_pair):
    jidx, pidx, jeng, peng, q = adaptive_pair
    got = planner.adaptive_query(peng, t(q), K, recall_target=0.9)
    want = planner.adaptive_query(
        peng, t(q), K, budgets=planner.plan(pidx.calib, 0.9).budgets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    wv, wi, wu = jplanner.adaptive_query(jeng, jnp.asarray(q[:3]), 4,
                                         num_probe=20)
    gv, gi, gu = planner.adaptive_query(peng, t(q[:3]), 4, num_probe=20)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)
    for kw, match in (({}, "exactly one"),
                      ({"recall_target": 0.9, "num_probe": 50}, "one of"),
                      ({"num_probe": 5}, "k=")):
        with pytest.raises(ValueError, match=match):
            planner.adaptive_query(peng, t(q[:2]), K, **kw)


# -- multi-table single-probe ---------------------------------------------------


@pytest.fixture(scope="module", params=[("simple", 8, 4), ("sign_alsh", 8, 1),
                                        ("l2_alsh", 4, 4)],
                ids=["simple-m4", "sign_alsh-m1", "l2_alsh-m4"])
def multi(request, data):
    fam, code_len, m = request.param
    items, q, _ = data
    jmt = jindex.build(jindex.IndexSpec(family=fam, code_len=code_len, m=m,
                                        num_tables=4),
                       jnp.asarray(items), jax.random.PRNGKey(5))
    params = tuple(jax.tree.map(np.asarray, tuple(p)) if isinstance(p, tuple)
                   else np.asarray(p) for p in jmt.params)
    spec = IndexSpec(family=fam, code_len=code_len, m=m, num_tables=4)
    fam_t = spec.resolve_family()
    carried = ComposedMultiTable(
        spec, t(items), t(jmt.norms), t(np.ascontiguousarray(
            np.asarray(jmt.codes)).view(np.int32)), t(jmt.range_id),
        t(jmt.upper), t(jmt.lower),
        tuple(fam_t.params_on(p, "cpu") for p in params), jmt.hash_bits)
    return jmt, carried, params, spec


def test_multi_table_scores_and_query_equal_reference(multi):
    jmt, pmt, _, _ = multi
    q = _items()[1]
    np.testing.assert_array_equal(
        pmt.candidate_scores(t(q)).numpy(),
        np.asarray(jmt.candidate_scores(jnp.asarray(q))))
    for k, cap in ((K, 512), (3, 40)):
        wv, wi, wn = jmt.query(jnp.asarray(q), k, max_candidates=cap)
        gv, gi, gn = pmt.query(t(q), k, max_candidates=cap)
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
        np.testing.assert_array_equal(np.isfinite(gv.numpy()),
                                      np.isfinite(np.asarray(wv)))
        np.testing.assert_array_equal(gi.numpy() < 0, np.asarray(wi) < 0)
        fin = np.isfinite(np.asarray(wv))
        assert_topk_tie_aware(np.where(fin, gi.numpy(), -1),
                              np.where(fin, gv.numpy(), 0),
                              np.where(fin, np.asarray(wi), -1),
                              np.where(fin, np.asarray(wv), 0))
    assert pmt.num_tables == 4 and (gn.numpy() > 0).any()


def test_multi_table_build_on_reference_params(multi, data):
    jmt, pmt, params, spec = multi
    items, q, _ = data
    got = build(spec, items, params=params, device="cpu")
    assert isinstance(got, ComposedMultiTable)
    assert got.codes.shape == pmt.codes.shape
    np.testing.assert_array_equal(got.range_id.numpy(),
                                  np.asarray(jmt.range_id))
    np.testing.assert_array_equal(got.upper.numpy(), np.asarray(jmt.upper))
    # a code differs only at a rounding edge: almost all rows are equal
    same = (got.codes == pmt.codes).reshape(4, N, -1).all(-1)
    assert same.float().mean() > 0.99
    gens = [torch.Generator().manual_seed(s) for s in range(4)]
    a = build(spec, items, gens, device="cpu")
    b = build(spec, items, [torch.Generator().manual_seed(s)
                            for s in range(4)], device="cpu")
    assert torch.equal(a.codes, b.codes)
    with pytest.raises(ValueError, match="3 generators"):
        build(spec, items, gens[:3], device="cpu")
    with pytest.raises(ValueError, match="calibration does not apply"):
        build(spec, items, gens, calibration_k=5, device="cpu")
    with pytest.raises(ValueError, match="no bucket store"):
        build_bucket_index(a)


# -- probed-recall curves, transforms, rho --------------------------------------


@pytest.mark.parametrize("chunk", [5, 64])
def test_probed_recall_curve_equals_reference(pair, monkeypatch, chunk):
    _, jidx, _, _, _ = pair
    q, items = _items()[1], _items()[0]
    order = np.asarray(jidx.probe_order(jnp.asarray(q)))
    _, truth = jtopk.exact_mips(jnp.asarray(q), jnp.asarray(items), K)
    counts = [1, 7, 20, 100, 500, N]
    want = jtopk.probed_recall_curve(jnp.asarray(order), truth, counts)
    monkeypatch.setattr(topk, "RECALL_CHUNK", chunk)
    got = topk.probed_recall_curve(t(order), t(truth), counts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transforms_hashes_and_collision_probs_match_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((300, 9))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)
         * rng.uniform(0.1, 0.9, (300, 1))).astype(np.float32)
    q = rng.standard_normal((20, 9)).astype(np.float32)
    for name, args in (("simple_lsh_transform", (x,)),
                       ("simple_lsh_query_transform", (q,)),
                       ("l2_alsh_item_transform", (x, 3, 0.83)),
                       ("l2_alsh_query_transform", (q, 3)),
                       ("sign_alsh_item_transform", (x, 2, 0.75)),
                       ("sign_alsh_query_transform", (q, 2))):
        want = getattr(jhashing, name)(*[jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in args])
        got = getattr(hashing, name)(*[t(a) if isinstance(a, np.ndarray)
                                       else a for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    A = rng.standard_normal((10, 40)).astype(np.float32)
    xs = np.asarray(jhashing.simple_lsh_transform(jnp.asarray(x)))
    proj = xs.astype(np.float64) @ A
    norm = np.linalg.norm(xs.astype(np.float64), axis=1)
    for fused in (False, True):
        want = jhashing.encode_packed(jnp.asarray(x if fused else xs),
                                      jnp.asarray(A), fused_simple=fused)
        got = hashing.encode_packed(t(x if fused else xs), t(A),
                                    fused_simple=fused)
        assert_codes_match(got.numpy(), want, proj, norm)
    np.testing.assert_array_equal(
        hashing.srp_hash(t(xs), t(A)).numpy(),
        np.asarray(jhashing.srp_hash(jnp.asarray(xs), jnp.asarray(A))))
    a = rng.standard_normal((9, 12)).astype(np.float32)
    b = (rng.random(12) * 2.5).astype(np.float32)
    v = (x.astype(np.float64) @ a + b) / 2.5
    got = hashing.l2_hash(t(x), t(a), t(b), 2.5).numpy()
    diff = got != np.asarray(jhashing.l2_hash(jnp.asarray(x), jnp.asarray(a),
                                              jnp.asarray(b), 2.5))
    assert not (diff & ~(np.abs(v - np.round(v))
                         < L2_BAND * (1 + np.abs(v)))).any()
    gen = torch.Generator().manual_seed(3)
    a_t, b_t = hashing.l2_hash_params(gen, 9, 12, 2.5)
    assert a_t.shape == (9, 12) and bool(((b_t >= 0) & (b_t < 2.5)).all())
    s = np.linspace(-1.2, 1.2, 49).astype(np.float32)
    np.testing.assert_allclose(
        hashing.srp_collision_prob(t(s)).numpy(),
        np.asarray(jhashing.srp_collision_prob(jnp.asarray(s))), rtol=1e-6)
    dist = np.linspace(0.0, 30.0, 61).astype(np.float32)
    for r in (1.0, 2.5):
        np.testing.assert_allclose(
            hashing.l2_collision_prob(t(dist), r).numpy(),
            np.asarray(jhashing.l2_collision_prob(jnp.asarray(dist), r)),
            rtol=1e-6, atol=1e-7)


def test_rho_module_matches_reference():
    c = np.linspace(0.3, 0.9, 7).astype(np.float32)
    S0 = np.linspace(0.2, 0.95, 7).astype(np.float32)
    cases = (
        ("rho_simple_lsh", (c, S0)),
        ("rho_ranged_simple_lsh", (c, S0, np.float32(0.8))),
        ("rho_l2_alsh", (S0, c, 3, 0.83, 2.5)),
        ("rho_ranged_l2_alsh", (S0, c, 3, 0.83, 2.5, np.float32(0.3),
                                np.float32(0.9))),
    )
    for name, args in cases:
        want = getattr(jrho, name)(*[jnp.asarray(a) if isinstance(
            a, (np.ndarray, np.floating)) else a for a in args])
        got = getattr(rho, name)(*[t(a) if isinstance(
            a, (np.ndarray, np.floating)) else a for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   err_msg=name)
    grid = dict(ms=(2, 3), Us=(0.7, 0.83), rs=(2.0, 2.5, 3.0))
    want = jrho.grid_search_l2_alsh(0.5, 0.7, **grid)
    got = rho.grid_search_l2_alsh(0.5, 0.7, **grid)
    assert (got.m, got.r) == (want.m, want.r)
    np.testing.assert_allclose((got.U, got.rho), (want.U, want.rho),
                               rtol=1e-5)
    assert tuple(rho.RECOMMENDED_L2_ALSH)[:3] == \
        tuple(jrho.RECOMMENDED_L2_ALSH)[:3]
    for args in ((0.6, 0.3, 0.2, 0.1), (0.6, 0.3, 0.5, 0.1),
                 (0.6, 0.3, 0.2, 0.2)):
        assert rho.theorem1_conditions(*args) == \
            jrho.theorem1_conditions(*args)
    np.testing.assert_allclose(
        rho.query_complexity_ratio(1e6, 0.3, 0.1, 0.6, 0.3),
        jrho.query_complexity_ratio(1e6, 0.3, 0.1, 0.6, 0.3), rtol=1e-5)
