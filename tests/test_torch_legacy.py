"""The port's legacy index shims (``core/simple_lsh.py``, ``range_lsh.py``,
``sign_alsh.py``, ``l2_alsh.py``, ``multi_table.py``) against the JAX
package's.

Each port shim is built on the reference shim's parameters from the same
numpy items: codes, hashes, range ids and parameters must be equal, and
norm-derived floats (norms, bounds, scales) within rtol 1e-6 (a torch
f32 sum may differ from XLA's by an ulp, ROADMAP §3). A reference index
carried across with ``convert.legacy_index_from_fields`` must then give
the reference's ``probe_order``, ``query`` ids (dense and bucket
engines), ``bucket_stats``, ``sorted_probe_table``, bucket store and
``candidate_scores`` exactly, with query values within ATOL/RTOL (dots
summed in another order). ``MutableIndex.from_range_lsh`` and
``from_simple_lsh`` must mount the state the reference's mounts hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ATOL, RTOL, t
from repro import streaming as jstreaming
from repro.core import bucket_index as jbucket
from repro.core import engine as jengine
from repro.core import l2_alsh as jl2
from repro.core import multi_table as jmt
from repro.core import range_lsh as jrange
from repro.core import sign_alsh as jsign
from repro.core import simple_lsh as jsimple
from repro_torch import convert, streaming
from repro_torch.core import (bucket_index, engine, l2_alsh, multi_table,
                              range_lsh, sign_alsh, simple_lsh)
from repro_torch.core.index import IndexSpec, build
from repro_torch.kernels import ops
from repro_torch.obs import Tracker

N, D, Q, K = 1500, 20, 12, 10
PROBE = 200
# name -> (port module, reference build, port build kwargs on its params)
CASES = {
    "simple_lsh": (simple_lsh, lambda x, key: jsimple.build(x, key, 16),
                   lambda m, x, p: m.build(x, None, 16, params=p,
                                           device="cpu")),
    "range_lsh": (range_lsh, lambda x, key: jrange.build(x, key, 16, 8),
                  lambda m, x, p: m.build(x, None, 16, 8, params=p,
                                          device="cpu")),
    "range_lsh_uniform_uncharged": (
        range_lsh,
        lambda x, key: jrange.build(x, key, 24, 6, scheme="uniform",
                                    charge_index_bits=False),
        lambda m, x, p: m.build(x, None, 24, 6, scheme="uniform",
                                charge_index_bits=False, params=p,
                                device="cpu")),
    "sign_alsh": (sign_alsh, lambda x, key: jsign.build(x, key, 16),
                  lambda m, x, p: m.build(x, None, 16, params=p,
                                          device="cpu")),
    "sign_alsh_ranged": (
        sign_alsh, lambda x, key: jsign.build(x, key, 32, num_ranges=8),
        lambda m, x, p: m.build(x, None, 32, num_ranges=8, params=p,
                                device="cpu")),
    "l2_alsh": (l2_alsh, lambda x, key: jl2.build(x, key, 16),
                lambda m, x, p: m.build(x, None, 16, params=p,
                                        device="cpu")),
    "l2_alsh_ranged": (
        l2_alsh, lambda x, key: jl2.build_ranged(x, key, 16, 4),
        lambda m, x, p: m.build_ranged(x, None, 16, 4, params=p,
                                       device="cpu")),
}
KIND = {"simple_lsh": "simple_lsh", "range_lsh": "range_lsh",
        "range_lsh_uniform_uncharged": "range_lsh",
        "sign_alsh": "sign_alsh", "sign_alsh_ranged": "sign_alsh",
        "l2_alsh": "l2_alsh", "l2_alsh_ranged": "l2_alsh"}
# norm-derived float fields (an ulp apart at most); the rest are exact
NEAR = ("norms", "U", "upper", "lower", "scale")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2025)
    items = (rng.standard_normal((N, D))
             * np.exp(0.8 * rng.standard_normal((N, 1)))).astype(np.float32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    return items, queries


def _ref_params(name, jidx):
    if KIND[name] == "l2_alsh":
        return (np.array(jidx.a), np.array(jidx.b))
    return np.array(jidx.A)


def _fields(jidx):
    """The reference tuple's fields: arrays as numpy, scalars as-is."""
    return {f: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f, v in jidx._asdict().items()}


@pytest.fixture(scope="module")
def built(data):
    """name -> (reference index, port index built on its params, port
    index carried from its arrays)."""
    items, _ = data
    out = {}
    for s, (name, (mod, jbuild, pbuild)) in enumerate(CASES.items()):
        jidx = jbuild(jnp.asarray(items), jax.random.PRNGKey(10 + s))
        pidx = pbuild(mod, items, _ref_params(name, jidx))
        carried = convert.legacy_index_from_fields(KIND[name], _fields(jidx),
                                                   device="cpu")
        out[name] = (jidx, pidx, carried)
    return out


def _np(v):
    """A port tensor as the reference holds it: packed int32 code words
    as uint32."""
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    return np.asarray(v)


def _words(v):
    return _np(v).view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_shim_build_on_reference_params_equals_reference(built, name):
    jidx, pidx, _ = built[name]
    assert type(pidx).__name__ == type(jidx).__name__
    assert pidx._fields == jidx._fields
    for f in jidx._fields:
        want, got = getattr(jidx, f), getattr(pidx, f)
        if not isinstance(want, jax.Array):
            assert got == want, f
        elif f in NEAR:
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, err_msg=f)
        elif f == "codes":
            np.testing.assert_array_equal(_words(got), np.asarray(want),
                                          err_msg=f)
        else:
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_carried_probe_order_equals_reference(built, data, name):
    jidx, _, carried = built[name]
    _, q = data
    jmod = {"simple_lsh": jsimple, "range_lsh": jrange,
            "sign_alsh": jsign, "l2_alsh": jl2}[KIND[name]]
    mod = CASES[name][0]
    want = np.asarray(jmod.probe_order(jidx, jnp.asarray(q)))
    got = mod.probe_order(carried, t(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(mod.probe_scores(carried, t(q)).numpy(),
                               np.asarray(jmod.probe_scores(jidx,
                                                            jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)


def test_probe_order_runs_in_query_blocks(built, data, monkeypatch):
    """Blocks of 5 queries give the order of one default block, and each
    block scores only its own queries."""
    _, _, carried = built["range_lsh"]
    _, q = data
    from repro_torch.core import probe
    want = range_lsh.probe_order(carried, t(q))
    calls = []

    def scores(x):
        calls.append(x.shape[0])
        return range_lsh.probe_scores(carried, x)
    got = probe.blocked_probe_order(scores, t(q), block=5)
    assert calls == [5, 5, 2]
    assert torch.equal(got, want)


QUERY_CASES = [("simple_lsh", "dense"), ("simple_lsh", "bucket"),
               ("range_lsh", "dense"), ("range_lsh", "bucket"),
               ("range_lsh", "fused"),
               ("range_lsh_uniform_uncharged", "bucket"),
               ("sign_alsh", "dense"), ("sign_alsh_ranged", "dense"),
               ("l2_alsh", "dense"), ("l2_alsh_ranged", "dense")]


@pytest.mark.parametrize("name,eng", QUERY_CASES)
def test_carried_query_equals_reference(built, data, name, eng):
    jidx, _, carried = built[name]
    _, q = data
    kind = KIND[name]
    jmod = {"simple_lsh": jsimple, "range_lsh": jrange,
            "sign_alsh": jsign, "l2_alsh": jl2}[kind]
    mod = CASES[name][0]
    if kind in ("simple_lsh", "range_lsh"):
        jv, ji = jmod.query(jidx, jnp.asarray(q), K, PROBE, engine=eng)
        pv, pi = mod.query(carried, t(q), K, PROBE, engine=eng)
    else:
        jv, ji = jmod.query(jidx, jnp.asarray(q), K, PROBE)
        pv, pi = mod.query(carried, t(q), K, PROBE)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", ["simple_lsh", "range_lsh",
                                  "range_lsh_uniform_uncharged"])
def test_bucket_stats_and_store_equal_reference(built, name):
    jidx, _, carried = built[name]
    jmod = jsimple if KIND[name] == "simple_lsh" else jrange
    mod = CASES[name][0]
    assert mod.bucket_stats(carried) == jmod.bucket_stats(jidx)
    want = jbucket.build_bucket_index(jidx)
    got = bucket_index.build_bucket_index(carried)
    for f in ("item_ids", "bucket_start", "bucket_rid", "rank"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_words(got.bucket_code),
                                  np.asarray(want.bucket_code))
    assert (got.hash_bits, got.eps) == (want.hash_bits, want.eps)


@pytest.mark.parametrize("name", ["range_lsh", "range_lsh_uniform_uncharged"])
def test_sorted_probe_table_equals_reference(built, name):
    jidx, _, carried = built[name]
    want = jrange.sorted_probe_table(jidx)
    got = range_lsh.sorted_probe_table(carried)
    np.testing.assert_array_equal(got.range_idx.numpy(),
                                  np.asarray(want.range_idx))
    np.testing.assert_array_equal(got.match_cnt.numpy(),
                                  np.asarray(want.match_cnt))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["simple_lsh", "range_lsh"])
def test_legacy_engine_encodes_and_matches_like_reference(built, data,
                                                          name):
    """The engine's legacy path: ``P(q) = [q; 0]`` encode, the
    ``bucket_match`` directory match (no ``hamming_scan``), zero range
    ids for SIMPLE-LSH, candidates equal to the reference's."""
    jidx, _, carried = built[name]
    _, q = data
    np.testing.assert_array_equal(
        _words(engine.encode_queries(carried, t(q))),
        np.asarray(jengine.encode_queries(jidx, jnp.asarray(q))))
    jeng = jengine.QueryEngine(jidx, engine="bucket")
    tr = Tracker()
    ops.set_dispatch_tracker(tr)
    try:
        peng = engine.QueryEngine(carried, engine="bucket", device="cpu")
        got = peng.candidates(t(q), PROBE)
    finally:
        ops.set_dispatch_tracker(None)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jeng.candidates(jnp.asarray(q),
                                                             PROBE)))
    assert tr.counters["repro.kernels.dispatch.bucket_match.ref"] == 1
    assert "repro.kernels.dispatch.hamming_scan.ref" not in tr.counters
    np.testing.assert_array_equal(peng._range_id.numpy(),
                                  np.asarray(jeng._range_id))
    dense = engine.QueryEngine(carried, engine="dense",
                               buckets=peng.buckets, device="cpu")
    assert torch.equal(dense.candidates(t(q), PROBE), got)


def test_shim_bucket_query_equals_spec_api(built, data):
    """``range_lsh.query(engine="bucket")`` equals a spec-API index built
    from the same parameters (the chip smoke's phase-6 check)."""
    items, q = data
    _, pidx, _ = built["range_lsh"]
    spec = IndexSpec(family="simple", code_len=16, m=8, engine="bucket")
    cidx = build(spec, items, params=pidx.A, device="cpu")
    sv, si = range_lsh.query(pidx, t(q), K, PROBE, engine="bucket")
    cv, ci = cidx.query(t(q), K, PROBE)
    assert torch.equal(si, ci) and torch.equal(sv, cv)


@pytest.mark.parametrize("ranged", [False, True])
def test_multi_table_shim_equals_reference(data, ranged):
    items, q = data
    nr = 8 if ranged else 1
    jidx = jmt.build(jnp.asarray(items), jax.random.PRNGKey(21), 12, 4,
                     num_ranges=nr)
    pidx = multi_table.build(items, None, 12, 4, num_ranges=nr,
                             params=[np.array(a) for a in jidx.As],
                             device="cpu")
    np.testing.assert_array_equal(_words(pidx.codes),
                                  np.asarray(jidx.codes))
    np.testing.assert_array_equal(pidx.As.numpy(), np.asarray(jidx.As))
    np.testing.assert_allclose(pidx.upper.numpy(), np.asarray(jidx.upper),
                               rtol=1e-6)
    assert (pidx.code_len, pidx.ranged) == (jidx.code_len, jidx.ranged)
    carried = convert.legacy_index_from_fields("multi_table", _fields(jidx),
                                               device="cpu")
    np.testing.assert_array_equal(
        multi_table.candidate_scores(carried, t(q)).numpy(),
        np.asarray(jmt.candidate_scores(jidx, jnp.asarray(q))))
    jv, ji, jn = jmt.query(jidx, jnp.asarray(q), K)
    pv, pi, pn = multi_table.query(carried, t(q), K)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=RTOL)


def _tree_equal(got, want, path=""):
    assert set(got) == set(want), path
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _tree_equal(g, w, f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{path}/{key}")


@pytest.mark.parametrize("name", ["range_lsh", "simple_lsh"])
def test_mutable_mount_of_legacy_index_equals_reference(built, data, name):
    jidx, _, carried = built[name]
    _, q = data
    kw = dict(capacity=32, max_tombstones=16)
    if name == "range_lsh":
        jmi = jstreaming.MutableIndex.from_range_lsh(jidx, impl="ref", **kw)
        pmi = streaming.MutableIndex.from_range_lsh(carried, **kw)
    else:
        jmi = jstreaming.MutableIndex.from_simple_lsh(jidx, impl="ref", **kw)
        pmi = streaming.MutableIndex.from_simple_lsh(carried, **kw)
    want = jax.tree.map(np.asarray, jstreaming.index_tree(jmi))
    _tree_equal(streaming.index_tree(pmi), want)
    jv, ji = jmi.query(jnp.asarray(q), K, PROBE)
    pv, pi = pmi.query(t(q), K, PROBE)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=RTOL)


def test_streaming_build_goes_through_the_range_lsh_shim(data):
    """``streaming.build`` is ``range_lsh.build`` + ``from_range_lsh``:
    the same state as mounting the shim's index by hand."""
    items, _ = data
    a = streaming.build(items, torch.Generator().manual_seed(3), 16, 8,
                        capacity=32, device="cpu")
    idx = range_lsh.build(items, torch.Generator().manual_seed(3), 16, 8,
                          device="cpu")
    b = streaming.MutableIndex.from_range_lsh(idx, capacity=32)
    _tree_equal(streaming.index_tree(a), streaming.index_tree(b))


def test_legacy_fields_refuse_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown legacy index"):
        convert.legacy_index_from_fields("vocab", {}, device="cpu")
