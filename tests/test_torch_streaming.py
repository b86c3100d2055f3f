"""The port's streaming index against the JAX package's.

A JAX ``streaming.build`` index is carried into the port through
``convert.mutable_index_from_tree`` (its ``index_tree`` as numpy arrays),
then both run the same interleaving on the same numpy inputs: inserts,
base and delta deletes, an overflow insert (localized repartition), a
skew rebalance, auto and explicit compactions. At every stage the merged
candidate ids of both engines must be equal, and equal to a from-scratch
rebuild made with the port's own bucket store; codes, range ids,
liveness, bounds, events and ``stats()`` must be equal. Query results are
compared tie-aware (re-rank dots summed in another order, ATOL/RTOL).

Inserted rows are encoded on each side by its own ``hash_encode``; a code
bit may differ only where the projection is within 1e-5 of zero, and the
equal codes asserted here show that this data has no such bit.

Also here: calibration tables (chunked and unchunked) against the
reference, snapshots mounted across the two packages, the checkpoint
manager's contract (NamedTuple trees keyed ``.field`` as the reference
keys them, crossing both ways), and the delta buffer's typed errors.
"""

import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_tie_aware, t
from repro import streaming as jstreaming
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.core import planner as jplanner
from repro.data.synthetic import make_dataset as jax_dataset
from repro_torch import convert, streaming
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.tree import flatten_with_paths, tree_map
from repro_torch.core import planner
from repro_torch.core.bucket_index import build_buckets
from repro_torch.core.engine import bucket_candidates, dense_candidates
from repro_torch.kernels import ops
from repro_torch.obs import Tracker
from repro_torch.streaming.delta import (DeltaBuffer, composite_key,
                                         directory_keys)

PROBE = 111
STAGES = ("fresh", "insert_delete", "overflow", "delta_delete", "skew",
          "compact")
KW = dict(capacity=64, max_tombstones=16, skew_ratio=1.5, min_skew_count=50)


@pytest.fixture(scope="module")
def data():
    """(items, queries, insert pool) as numpy, the reference tests' sets."""
    ds = jax_dataset("imagenet", jax.random.PRNGKey(0), n=500, d=16,
                     num_queries=6)
    extra = jax_dataset("imagenet", jax.random.PRNGKey(9), n=200, d=16,
                        num_queries=1)
    return (np.asarray(ds.items), np.asarray(ds.queries),
            np.asarray(extra.items))


def _tree(jmi):
    return jax.tree.map(np.asarray, jstreaming.index_tree(jmi))


def _pair(items, **kw):
    jmi = jstreaming.build(jnp.asarray(items), jax.random.PRNGKey(1), 12, 8,
                           impl="ref", **kw)
    # capacity and max_tombstones ride in the tree; the rest are knobs
    knobs = {k: v for k, v in kw.items()
             if k not in ("capacity", "max_tombstones")}
    pmi = convert.mutable_index_from_tree(_tree(jmi), device="cpu", **knobs)
    return jmi, pmi


def rebuild_candidates(mi, queries, num_probe, engine):
    """Oracle: a bucket store rebuilt from scratch over the live set with
    the port's ``build_buckets`` and core engines, mapped to global ids."""
    rows = np.flatnonzero(mi._live)
    slots = np.flatnonzero(mi.delta._live[:mi.delta.count])
    codes = np.concatenate([mi._codes[rows], mi.delta._codes[slots]])
    rid = np.concatenate([mi._rid[rows], mi.delta._rid[slots]])
    gids = np.concatenate([rows, mi.store_size + slots]).astype(np.int32)
    ctens = t(codes.view(np.int32))
    b = build_buckets(ctens, t(rid), t(mi.upper), mi.hash_bits, mi.eps)
    q_codes = mi.encode_queries(queries)

    def match(qc, db):
        return ops.bucket_match(qc, db, mi.hash_bits)
    if engine == "bucket":
        local = bucket_candidates(b, q_codes, num_probe, match_fn=match)
    else:
        local = dense_candidates(b, q_codes, ctens, t(rid), num_probe,
                                 match_fn=match)
    return gids[local.numpy()]


def _snapshot(jmi, pmi, q):
    out = {"cand": {}, "oracle": {}}
    for engine in ("bucket", "dense"):
        jmi.engine = pmi.engine = engine
        out["cand"][engine] = (
            np.asarray(jmi.candidates(jnp.asarray(q), PROBE)),
            pmi.candidates(t(q), PROBE).numpy())
        out["oracle"][engine] = rebuild_candidates(pmi, t(q), PROBE, engine)
    jmi.engine = pmi.engine = "auto"
    out["state"] = [(_state(m), m.stats(), list(m.events))
                    for m in (jmi, pmi)]
    return out


def _state(m):
    n = m.delta.count
    return {k: np.array(v) for k, v in {
        "codes": m._codes, "rid": m._rid, "live": m._live,
        "d_codes": m.delta._codes[:n], "d_rid": m.delta._rid[:n],
        "d_live": m.delta._live[:n], "d_ord": m.delta._ord[:n],
        "d_perm": m.delta._perm, "csr_item_ids": m._csr.item_ids,
        "csr_bucket_code": m._csr.bucket_code,
        # f32 norms of inserted rows: summed in another order by torch
        "norms": m._norms, "d_norms": m.delta._norms[:n], "upper": m.upper,
        "lower": m.lower, "edges": m.edges}.items()}


FLOAT_FIELDS = ("norms", "d_norms", "upper", "lower", "edges")
NORM_RTOL = 1e-6          # an insert's norm may differ by an ulp


@pytest.fixture(scope="module")
def run(data):
    """Both indexes through the same interleaving; results per stage."""
    items, q, pool = data
    jmi, pmi = _pair(items, **KW)
    stages = {"fresh": _snapshot(jmi, pmi, q)}

    def both(fn):
        return fn(jmi, jnp.asarray), fn(pmi, t)

    ids, pids = both(lambda m, f: m.insert(f(pool[:30])))
    np.testing.assert_array_equal(ids, pids)
    both(lambda m, f: m.delete([0, 7, 13, int(ids[4]), int(ids[20])]))
    stages["insert_delete"] = _snapshot(jmi, pmi, q)
    big = pool[:1] / np.linalg.norm(pool[:1]) * float(jmi.upper.max()) * 2.5
    both(lambda m, f: m.insert(f(big)))
    stages["overflow"] = _snapshot(jmi, pmi, q)
    both(lambda m, f: m.delete(ids[5:9].tolist()))
    both(lambda m, f: m.insert(f(pool[30:45])))
    stages["delta_delete"] = _snapshot(jmi, pmi, q)
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(80, 16)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    both(lambda m, f: m.insert(f(dirs * float(np.median(jmi._norms)))))
    stages["skew"] = _snapshot(jmi, pmi, q)
    both(lambda m, f: m.compact())
    stages["compact"] = _snapshot(jmi, pmi, q)
    return jmi, pmi, stages


@pytest.mark.parametrize("engine", ["bucket", "dense"])
@pytest.mark.parametrize("stage", STAGES)
def test_merged_candidates_equal_reference_and_rebuild(run, stage, engine):
    snap = run[2][stage]
    want, got = snap["cand"][engine]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, snap["oracle"][engine])


@pytest.mark.parametrize("stage", STAGES)
def test_state_events_and_stats_equal_reference(run, stage):
    (jstate, jstats, jevents), (pstate, pstats, pevents) = \
        run[2][stage]["state"]
    for field, want in jstate.items():
        if field in FLOAT_FIELDS:
            np.testing.assert_allclose(pstate[field], want, rtol=NORM_RTOL,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(pstate[field], want, err_msg=field)
    assert pstats == jstats
    assert len(pevents) == len(jevents)
    for got, want in zip(pevents, jevents):
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, float):
                assert got[key] == pytest.approx(value, rel=NORM_RTOL), key
            else:
                assert got[key] == value, key


def test_interleaving_saw_every_structural_event(run):
    kinds = {e["kind"] for e in run[1].events}
    assert {"overflow_localized", "repartition", "skew_rebalance",
            "compaction"} <= kinds
    assert run[1].num_compactions >= 2


def test_query_equals_reference(run, data):
    jmi, pmi, _ = run
    q = data[1]
    wv, wi = jmi.query(jnp.asarray(q), 5, PROBE)
    gv, gi = pmi.query(t(q), 5, PROBE)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


def test_full_budget_query_is_exact(run, data):
    """num_probe == live count covers everything: the query equals exact
    MIPS over the live set (``ops.mips_topk``)."""
    pmi, q = run[1], t(data[1])
    vecs, gids = pmi.live_vectors()
    ev, ei = ops.mips_topk(q, vecs, 5)
    sv, si = pmi.query(q, 5, pmi.live_count)
    np.testing.assert_allclose(sv.numpy(), ev.numpy(), atol=1e-5)
    np.testing.assert_array_equal(si.numpy(), gids[ei.numpy()])


@pytest.fixture(scope="module")
def calibrated(data):
    items, q, pool = data
    jmi, pmi = _pair(items, capacity=64)
    for m, f in ((jmi, jnp.asarray), (pmi, t)):
        ids = m.insert(f(pool[:40]))
        m.delete([2, 3, int(ids[0])])
    cal_q = np.random.default_rng(11).standard_normal((40, 16)).astype(
        np.float32)
    want = jplanner.calibrate_streaming(jmi, jnp.asarray(cal_q), k=5)
    jmi.set_calibration(want)
    return jmi, pmi, cal_q, want


@pytest.mark.parametrize("chunk", [3, 64])
def test_calibrate_streaming_equals_reference(calibrated, chunk,
                                              monkeypatch):
    """The chunked calibration (3 queries a block) and the unchunked one
    (all 40 at once) give the reference's table exactly."""
    _, pmi, cal_q, want = calibrated
    monkeypatch.setattr(planner, "CAL_CHUNK", chunk)
    got = planner.calibrate_streaming(pmi, t(cal_q), k=5)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_recall_target_query_and_staleness_match_reference(calibrated, data):
    jmi, _, cal_q, _ = calibrated
    q = data[1]
    pmi = convert.mutable_index_from_tree(_tree(jmi), device="cpu")
    pmi.set_calibration(planner.calibrate_streaming(pmi, t(cal_q), k=5))
    wv, wi = jmi.query(jnp.asarray(q), 5, recall_target=0.8)
    gv, gi = pmi.query(t(q), 5, recall_target=0.8)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)
    with pytest.raises(ValueError, match="calibrated at k=5"):
        pmi.query(t(q), 6, recall_target=0.8)
    hi = np.zeros((1, 16), np.float32)
    hi[0, 0] = float(pmi.upper.max()) * 2.0
    pmi.insert(t(hi))
    assert pmi.calib_stale
    assert any(e["kind"] == "calibration_stale" for e in pmi.events)
    with pytest.raises(ValueError, match="stale"):
        pmi.query(t(q), 5, recall_target=0.8)


def test_jax_snapshot_mounts_in_port(calibrated, data, tmp_path):
    jmi, _, _, _ = calibrated
    q = data[1]
    jstreaming.save_index(JaxManager(str(tmp_path)), 4, jmi)
    pmi = streaming.load_index(str(tmp_path), device="cpu")
    assert pmi.calib is not None and not pmi.calib_stale
    for field in jmi.calib._fields:
        np.testing.assert_array_equal(np.asarray(getattr(pmi.calib, field)),
                                      np.asarray(getattr(jmi.calib, field)))
    for engine in ("bucket", "dense"):
        jmi.engine = pmi.engine = engine
        np.testing.assert_array_equal(
            pmi.candidates(t(q), PROBE).numpy(),
            np.asarray(jmi.candidates(jnp.asarray(q), PROBE)))
    jmi.engine = "auto"


def test_port_snapshot_mounts_in_jax(calibrated, data, tmp_path):
    jmi, _, _, _ = calibrated
    q = data[1]
    pmi = convert.mutable_index_from_tree(_tree(jmi), device="cpu")
    pmi.set_calibration(jmi.calib)
    ids = pmi.insert(t(data[2][100:110]))
    pmi.delete([5, int(ids[2])])
    mgr = CheckpointManager(str(tmp_path))
    streaming.save_index(mgr, 9, pmi)
    loaded = jstreaming.load_index(str(tmp_path))
    assert loaded.live_count == pmi.live_count
    assert loaded.tomb_csr == pmi.tomb_csr
    np.testing.assert_array_equal(
        np.asarray(loaded.candidates(jnp.asarray(q), PROBE)),
        pmi.candidates(t(q), PROBE).numpy())
    # and back: the port mounts its own snapshot unchanged
    again = streaming.load_index(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(again.candidates(t(q), PROBE).numpy(),
                                  pmi.candidates(t(q), PROBE).numpy())
    with pytest.raises(FileNotFoundError):
        streaming.load_index(str(tmp_path / "empty"), device="cpu")


def test_port_build_flat_and_ranged_match_a_rebuild(data):
    """The port's own build (torch generator) and a flat m = 1 index
    mounted through ``from_composed`` stay equal to a from-scratch
    rebuild through inserts, deletes and an overflow."""
    from repro_torch.core.index import IndexSpec, build
    items, q, pool = (np.array(a) for a in data)
    gen = torch.Generator().manual_seed(5)
    ranged = streaming.build(items, gen, 12, 8, capacity=32, device="cpu")
    flat = streaming.MutableIndex.from_composed(
        build(IndexSpec(code_len=12, m=1), items, gen, device="cpu"),
        capacity=32)
    assert flat.num_ranges == 1 and flat.edges.size == 0
    for mi in (ranged, flat):
        ids = mi.insert(t(pool[:40]))
        mi.delete([1, 4, int(ids[3])])
        mi.insert(t(pool[:1] * 3 * float(mi.upper.max())
                    / np.linalg.norm(pool[0])))
        for engine in ("bucket", "dense"):
            mi.engine = engine
            np.testing.assert_array_equal(
                mi.candidates(t(q), 60).numpy(),
                rebuild_candidates(mi, t(q), 60, engine))
    # a tracker is accepted and mirrors every event of the index
    tr = Tracker()
    mi = streaming.build(items, gen, 12, 8, capacity=32, device="cpu",
                         tracker=tr)
    mi.insert(t(pool[:1] * 3 * float(mi.upper.max())
                / np.linalg.norm(pool[0])))
    assert mi.events and [e["name"] for e in tr.events] == \
        [f"repro.streaming.{e['kind']}" for e in mi.events]
    assert tr.counters["repro.streaming.inserts"] == 1


def _drift_case(case, items, pool):
    """(build items, build kwargs, traffic) of one drift path."""
    if case == "full_policy":            # overflow -> full rebuild
        def traffic(m, f):
            m.insert(f(np.ones((1, 16), np.float32) * float(m.upper.max())))
        return items, dict(capacity=32, repartition_policy="full"), traffic
    if case == "muted_skew":
        # copies of one row above every bound: after the overflow the top
        # range's median norm is its max, so the skew cannot be split
        def traffic(m, f):
            v = pool[:1] / np.linalg.norm(pool[0]) * 1.5 * float(
                m.upper.max())
            m.insert(f(np.repeat(v, 160, axis=0)))
            m.insert(f(np.repeat(v, 40, axis=0)))   # muted: no new attempt
        return items, dict(capacity=512, skew_ratio=1.2,
                           min_skew_count=20), traffic

    def traffic(m, f):                   # first insert into an empty bin
        j = int(np.flatnonzero(m._count_live() == 0)[0])
        lo = float(m.edges[j - 1]) if j else 0.0
        v = np.ones((1, 16), np.float32)
        m.insert(f(v / np.linalg.norm(v) * (lo + float(m.edges[j])) / 2))
    return items, dict(capacity=32, scheme="uniform"), traffic


@pytest.mark.parametrize("case", ["full_policy", "muted_skew", "bin_init"])
def test_drift_paths_match_reference(data, case):
    """The full-rebuild policy, the muted (unsplittable) skew and the first
    insert into an empty uniform bin: same events, codes and candidates
    as the reference, and as a from-scratch rebuild."""
    items, kw, traffic = _drift_case(case, data[0], data[2])
    scheme = kw.pop("scheme", "percentile")
    jmi = jstreaming.build(jnp.asarray(items), jax.random.PRNGKey(1), 12,
                           16 if scheme == "uniform" else 8, scheme=scheme,
                           impl="ref", **kw)
    knobs = {k: v for k, v in kw.items() if k != "capacity"}
    pmi = convert.mutable_index_from_tree(_tree(jmi), device="cpu", **knobs)
    traffic(jmi, jnp.asarray)
    traffic(pmi, t)
    assert [e["kind"] for e in pmi.events] == [e["kind"] for e in jmi.events]
    assert {"full_policy": "overflow_full", "muted_skew": "rebalance_blocked",
            "bin_init": "bin_init"}[case] in {e["kind"] for e in pmi.events}
    assert sum(e["kind"] == "rebalance_blocked" for e in pmi.events) <= 1
    np.testing.assert_array_equal(pmi._codes, np.asarray(jmi._codes))
    q = data[1]
    np.testing.assert_array_equal(
        pmi.candidates(t(q), 60).numpy(),
        np.asarray(jmi.candidates(jnp.asarray(q), 60)))
    np.testing.assert_array_equal(pmi.candidates(t(q), 60).numpy(),
                                  rebuild_candidates(pmi, t(q), 60,
                                                     "bucket"))


def test_top_bit_codes_match_reference(data):
    """A flat index with 32 hash bits sets bit 31 of half the codes (a
    negative int32 on the device): the CSR order, the delta placement
    and the merge must order the words unsigned, as the reference does."""
    items, q, pool = data
    # unit rows: the SIMPLE-LSH tail is ~0, so code bits follow directions
    unit = items / np.linalg.norm(items, axis=1, keepdims=True)
    pool = 0.9 * pool / np.linalg.norm(pool, axis=1, keepdims=True)
    jmi = jstreaming.build(jnp.asarray(unit), jax.random.PRNGKey(4), 32, 1,
                           capacity=32, impl="ref")
    pmi = convert.mutable_index_from_tree(_tree(jmi), device="cpu")
    assert (pmi._codes >= 2 ** 31).mean() > 0.3
    for m, f in ((jmi, jnp.asarray), (pmi, t)):
        ids = m.insert(f(pool[:40]))          # fills and compacts
        m.delete([3, int(ids[-1])])
    np.testing.assert_array_equal(pmi.delta._ord, np.asarray(jmi.delta._ord))
    np.testing.assert_array_equal(pmi.delta._perm,
                                  np.asarray(jmi.delta._perm))
    for engine in ("bucket", "dense"):
        jmi.engine = pmi.engine = engine
        got = pmi.candidates(t(q), 90).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jmi.candidates(jnp.asarray(q), 90)))
        np.testing.assert_array_equal(
            got, rebuild_candidates(pmi, t(q), 90, engine))


@pytest.fixture(scope="module")
def sign_run(data):
    """A ranged SIGN-ALSH index built by the reference, mounted in both
    packages (the port through ``index_tree``), then the same inserts,
    deletes, an overflow and a compaction on both; per-stage merged
    candidates of both engines, and the rebuild oracle's."""
    from repro.core import index as jindex
    items, q, pool = data
    jidx = jindex.build(jindex.IndexSpec(family="sign_alsh", code_len=16,
                                         m=4, impl="ref"),
                        jnp.asarray(items), jax.random.PRNGKey(6))
    jmi = jstreaming.MutableIndex.from_composed(jidx, capacity=32,
                                                max_tombstones=8)
    pmi = convert.mutable_index_from_tree(_tree(jmi), device="cpu")
    stages = {"fresh": _snapshot(jmi, pmi, q)}

    def both(fn):
        return fn(jmi, jnp.asarray), fn(pmi, t)

    ids, pids = both(lambda m, f: m.insert(f(pool[:20])))
    np.testing.assert_array_equal(ids, pids)
    both(lambda m, f: m.delete([1, 9, int(ids[3]), int(ids[11])]))
    stages["insert_delete"] = _snapshot(jmi, pmi, q)
    big = pool[20:21] / np.linalg.norm(pool[20]) * float(jmi.upper.max()) * 2
    both(lambda m, f: m.insert(f(big)))
    both(lambda m, f: m.insert(f(pool[21:40])))    # fills and compacts
    stages["overflow_compact"] = _snapshot(jmi, pmi, q)
    return jmi, pmi, stages


@pytest.mark.parametrize("stage", ["fresh", "insert_delete",
                                   "overflow_compact"])
def test_sign_alsh_interleaving_equals_reference_and_rebuild(sign_run,
                                                             stage):
    """SIGN-ALSH codes come from the port's ``hash_encode`` (inserts) and
    its delta from ``delta_scan``: state and merged candidates equal the
    reference's and a rebuild of the live set."""
    snap = sign_run[2][stage]
    for engine in ("bucket", "dense"):
        want, got = snap["cand"][engine]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, snap["oracle"][engine])
    (jstate, jstats, _), (pstate, pstats, _) = snap["state"]
    for field, want in jstate.items():
        if field in FLOAT_FIELDS:
            np.testing.assert_allclose(pstate[field], want, rtol=NORM_RTOL,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(pstate[field], want, err_msg=field)
    assert pstats == jstats
    if stage == "overflow_compact":
        assert {"overflow_localized", "compaction"} <= {
            e["kind"] for e in sign_run[1].events}


def test_sign_alsh_snapshot_is_refused(sign_run, data, tmp_path):
    """SIGN-ALSH snapshots, once refused, now cross both ways with
    ``family_id`` 1 and the family's ``fam_m``/``fam_U``: the mounted
    index answers with the same candidates and query results."""
    jmi, pmi, _ = sign_run
    q = data[1]
    assert pmi.family.name == "sign_alsh"
    assert (pmi.family.m, pmi.family.U) == (jmi.family.m, jmi.family.U)
    tree = streaming.index_tree(pmi)
    assert int(tree["meta"]["family_id"]) == 1
    jstreaming.save_index(JaxManager(str(tmp_path / "jax")), 2, jmi)
    streaming.save_index(CheckpointManager(str(tmp_path / "port")), 3, pmi)
    mounted_port = streaming.load_index(str(tmp_path / "jax"), device="cpu")
    mounted_jax = jstreaming.load_index(str(tmp_path / "port"))
    assert mounted_port.family == pmi.family
    assert mounted_jax.family.name == "sign_alsh"
    for engine in ("bucket", "dense"):
        for m in (jmi, pmi, mounted_port, mounted_jax):
            m.engine = engine
        want = np.asarray(jmi.candidates(jnp.asarray(q), 60))
        np.testing.assert_array_equal(
            mounted_port.candidates(t(q), 60).numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(mounted_jax.candidates(jnp.asarray(q), 60)), want)
    wv, wi = jmi.query(jnp.asarray(q), 5, 60)
    gv, gi = mounted_port.query(t(q), 5, 60)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)
    bad = _tree(jmi)
    bad["meta"]["family_id"] = np.asarray(7, np.int32)
    with pytest.raises(ValueError, match="unknown snapshot family_id"):
        convert.mutable_index_from_tree(bad, device="cpu")


def test_streaming_refuses_an_unpacked_family(data):
    from repro_torch.core.family import get_family
    from repro_torch.core.index import IndexSpec, build
    cidx = build(IndexSpec(family="l2_alsh", code_len=8, m=2), data[0],
                 torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="need packed sign codes"):
        streaming.MutableIndex.from_composed(cidx)
    assert not get_family("l2_alsh").packed


# -- directory placement ------------------------------------------------------


@pytest.mark.parametrize("w", [1, 2])
def test_directory_placement_matches_bisect_on_composite_keys(w):
    """Words with bit 31 set order as unsigned: the vectorized search
    equals ``bisect_left`` over the reference's composite keys."""
    import bisect
    rng = np.random.default_rng(20 + w)
    rid = rng.integers(0, 4, 300).astype(np.int32)
    codes = rng.integers(0, 2 ** 32, (300, w), dtype=np.uint64
                         ).astype(np.uint32)
    codes[::2, 0] = rng.integers(0, 3, 150) + np.uint32(2 ** 31)
    keys = sorted({composite_key(r, c) for r, c in zip(rid, codes)})
    drid = np.asarray([k >> (32 * w) for k in keys], np.int32)
    dcode = np.asarray([[(k >> (32 * (w - 1 - j))) & 0xFFFFFFFF
                         for j in range(w)] for k in keys], np.uint32)
    qr = np.concatenate([rid[:100], rng.integers(0, 5, 100)]).astype(
        np.int32)
    qc = np.concatenate([codes[:100], codes[100:200] ^ np.uint32(1)])
    at, hit = directory_keys(drid, dcode).bisect_left(qr, qc)
    for s in range(qr.size):
        key = composite_key(qr[s], qc[s])
        i = bisect.bisect_left(keys, key)
        assert (at[s], hit[s]) == (i, i < len(keys) and keys[i] == key)


# -- typed errors of the delta buffer ----------------------------------------


def _tiny_delta():
    buf = DeltaBuffer(capacity=4, dim=2, words=1, device="cpu")
    empty = directory_keys(np.zeros((0,), np.int32),
                           np.zeros((0, 1), np.uint32))
    buf.append(torch.ones((2, 2)), np.ones((2,), np.float32),
               np.zeros((2, 1), np.uint32), np.zeros((2,), np.int32),
               np.arange(2, dtype=np.int32), empty)
    return buf, empty


def test_delta_overflow_raises_value_error():
    buf, empty = _tiny_delta()
    with pytest.raises(ValueError, match="delta buffer overflow"):
        buf.append(torch.ones((3, 2)), np.ones((3,), np.float32),
                   np.zeros((3, 1), np.uint32), np.zeros((3,), np.int32),
                   np.arange(3, dtype=np.int32), empty)
    assert buf.count == 2, "failed append must not mutate the buffer"


def test_delta_tombstone_out_of_range_raises_index_error():
    buf, _ = _tiny_delta()
    for slot in (-1, 2, 7):
        with pytest.raises(IndexError, match="outside the occupied"):
            buf.tombstone(slot)


def test_delta_double_tombstone_raises_value_error():
    buf, _ = _tiny_delta()
    buf.tombstone(1)
    with pytest.raises(ValueError, match="already tombstoned"):
        buf.tombstone(1)
    assert buf.live_count == 1


# -- checkpoint manager -------------------------------------------------------


def _ckpt_tree():
    return {
        "w": torch.full((4, 3), 1.5, dtype=torch.bfloat16),
        "b": np.arange(5, dtype=np.float32),
        "step": np.asarray(7, np.int32),
        "nested": {"m": torch.ones((2, 2)), "codes": np.asarray(
            [2 ** 31 + 5, 3], np.uint32)},
    }


def test_checkpoint_roundtrip_including_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _ckpt_tree()
    mgr.save(3, tree)
    got = mgr.restore(3, tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            tree["w"])
    assert isinstance(got["b"], np.ndarray)
    np.testing.assert_array_equal(got["nested"]["codes"],
                                  tree["nested"]["codes"])
    assert got["nested"]["codes"].dtype == np.uint32
    assert torch.equal(got["nested"]["m"], tree["nested"]["m"])


def test_checkpoint_keys_are_the_reference_tree_paths(tmp_path):
    tree = {"a": {"x": np.ones(2, np.float32)}, "b": [np.zeros(1)]}
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    JaxManager(str(tmp_path / "jax")).save(
        1, jax.tree.map(jnp.asarray, tree))
    keys = [set(json.load(open(os.path.join(
        tmp_path, side, "step_000000001", "manifest.json")))["leaves"])
        for side in ("port", "jax")]
    assert keys[0] == keys[1] == {"['a']/['x']", "['b']/[0]"}


def test_checkpoint_latest_gc_async_and_restart(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _ckpt_tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4 and mgr.all_steps() == [3, 4]
    mgr.save_async(11, tree)
    mgr.wait()
    step, _ = CheckpointManager(str(tmp_path)).restore_latest(tree)
    assert step == 11


def test_checkpoint_crc_and_shape_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _ckpt_tree()
    path = mgr.save(5, tree)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(5, dict(tree, b=np.zeros((2, 2), np.float32)))
    mpath = os.path.join(path, "manifest.json")
    man = json.load(open(mpath))
    first = next(iter(man["leaves"]))
    man["leaves"][first]["crc32"] ^= 0xFF
    json.dump(man, open(mpath, "w"))
    with pytest.raises(IOError):
        mgr.restore(5, tree)


class _Opt(NamedTuple):
    step: object
    mu: object


class _State(NamedTuple):
    params: object
    opt: _Opt
    pair: tuple


def _nt_tree():
    """Nested NamedTuples around dicts and a plain tuple, bf16 and f32
    leaves, as a training state nests them (numpy leaves)."""
    import ml_dtypes
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16)
    return _State(
        params={"w": w, "blk": {"norm": rng.standard_normal(4).astype(
            np.float32)}},
        opt=_Opt(np.asarray(5, np.int32),
                 {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "blk": {"norm": np.zeros(4, np.float32)}}),
        pair=(np.arange(3, dtype=np.int32), np.ones(2, np.float32)))


def _port(tree_np):
    """A numpy tree as CPU tensors (bf16 bit for bit), NamedTuples and
    tuples kept."""
    return tree_map(lambda a: convert._param_tensor(a, "cpu"), tree_np)


def _equal_bits(got, want):
    for (kg, a), (kw, b) in zip(flatten_with_paths(got),
                                flatten_with_paths(want)):
        assert kg == kw
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        assert a.dtype == b.dtype and torch.equal(a, b), kg


def test_checkpoint_namedtuple_roundtrip_in_the_port(tmp_path):
    tree = _port(_nt_tree())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    got = mgr.restore(2, tree)
    assert type(got) is _State and type(got.opt) is _Opt
    assert type(got.pair) is tuple
    _equal_bits(got, tree)


def test_checkpoint_namedtuple_leaf_keys_equal_the_reference(tmp_path):
    tree = _nt_tree()
    CheckpointManager(str(tmp_path / "port")).save(1, _port(tree))
    JaxManager(str(tmp_path / "jax")).save(
        1, jax.tree.map(jnp.asarray, tree))
    keys = [set(json.load(open(os.path.join(
        tmp_path, side, "step_000000001", "manifest.json")))["leaves"])
        for side in ("port", "jax")]
    assert keys[0] == keys[1] == {
        ".params/['w']", ".params/['blk']/['norm']", ".opt/.step",
        ".opt/.mu/['w']", ".opt/.mu/['blk']/['norm']", ".pair/[0]",
        ".pair/[1]"}


def test_checkpoint_namedtuple_reference_save_port_restore(tmp_path):
    tree = _nt_tree()
    JaxManager(str(tmp_path)).save(3, jax.tree.map(jnp.asarray, tree))
    template = tree_map(torch.zeros_like, _port(tree))
    got = CheckpointManager(str(tmp_path)).restore(3, template)
    _equal_bits(got, _port(tree))


def test_checkpoint_namedtuple_port_save_reference_restore(tmp_path):
    tree = _nt_tree()
    CheckpointManager(str(tmp_path)).save(3, _port(tree))
    template = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), tree)
    got = JaxManager(str(tmp_path)).restore(3, template)
    assert type(got) is _State
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))
