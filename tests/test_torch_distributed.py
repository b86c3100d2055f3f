"""The port's distributed layer (``repro_torch.core.distributed``) against
the JAX package and against its own single-device engine.

The reference's claim (``repro/core/distributed.py``): the merged ids of
the sharded engine equal ``QueryEngine.query``'s on the same index. Here:

  * the port's in-process shard group at S = 1, 2 and 4 (and S = 2 items x
    2 query shards) equals the port's ``QueryEngine`` — ids exactly,
    values within 2e-6 (re-rank dots in another order) — for every
    family, both arms, a scalar and a planned budget;
  * a reference ``ShardedIndex`` carried across (``convert``) answers with
    the reference ``DistributedEngine``'s ids exactly (S = 1: the
    reference's multi-device mesh needs a fresh process);
  * the port's own layout on the reference's hash parameters equals the
    reference's;
  * one spawned gloo run of 4 processes (file rendezvous, no network)
    equals the in-process group in both arms; it joins within 120 s and
    fails, never hangs, past that.
"""

import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist_worker as worker
from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.core import index as jindex
from repro_torch import convert
from repro_torch.core import distributed
from repro_torch.core.engine import QueryEngine
from repro_torch.core.index import IndexSpec, build
from repro_torch.obs import RingBufferSink, Tracker

K, NUM_PROBE = 10, 200
BUDGETS = (40, 30, 30, 20, 20, 20, 20, 20)
VAL_TOL = 2e-6
FAMILIES = ("simple", "sign_alsh", "l2_alsh")
GLOO_TIMEOUT = 120.0


def _probe(mode):
    return ({"num_probe": NUM_PROBE} if mode == "scalar"
            else {"budgets": BUDGETS})


@pytest.fixture(scope="module")
def data(longtail_ds):
    items = np.asarray(longtail_ds.items, np.float32)
    queries = np.asarray(longtail_ds.queries, np.float32)[:8]
    return items, queries


@pytest.fixture(scope="module")
def reference(data):
    """Per family: the reference's composed index, its S = 1 sharded
    index, and the hash parameters as numpy."""
    items, _ = data
    out = {}
    for fam in FAMILIES:
        spec = jindex.IndexSpec(family=fam, code_len=16, m=8)
        cidx = jindex.build(spec, jnp.asarray(items), jax.random.PRNGKey(3))
        sidx = jdist.build_sharded(spec, jnp.asarray(items),
                                   jax.random.PRNGKey(3), 1)
        params = jax.tree.map(np.asarray, cidx.params)
        out[fam] = (spec, cidx, sidx, params)
    return out


def _port_params(params):
    return tuple(params) if isinstance(params, tuple) else params


@pytest.fixture(scope="module")
def port(data, reference):
    """Per family: the port's composed index and its sharded indexes at
    S = 1, 2, 4, all on the reference's hash parameters."""
    items, _ = data
    out = {}
    for fam in FAMILIES:
        params = _port_params(reference[fam][3])
        spec = IndexSpec(family=fam, code_len=16, m=8)
        cidx = build(spec, items, params=params, device="cpu")
        sharded = {S: distributed.build_sharded(spec, items, None, S,
                                                params=params, device="cpu")
                   for S in (1, 2, 4)}
        out[fam] = (cidx, sharded)
    return out


@pytest.mark.parametrize("mode", ["scalar", "planned"])
@pytest.mark.parametrize("engine", ["bucket", "dense"])
@pytest.mark.parametrize("family", FAMILIES)
def test_in_process_groups_equal_the_single_device_engine(
        data, port, family, engine, mode):
    _, queries = data
    cidx, sharded = port[family]
    q = torch.as_tensor(queries)
    want_v, want_i = QueryEngine(cidx, engine=engine, device="cpu").query(
        q, K, **_probe(mode))
    for S, sidx in sharded.items():
        group = distributed.InProcessShardGroup(S)
        eng = distributed.DistributedEngine(
            distributed.shard_index(sidx, group), group, engine=engine)
        got_v, got_i = eng.query(q, K, **_probe(mode))
        np.testing.assert_array_equal(got_i.numpy(), want_i.numpy(),
                                      err_msg=f"S={S}")
        np.testing.assert_allclose(got_v.numpy(), want_v.numpy(),
                                   rtol=VAL_TOL, atol=VAL_TOL)
        assert (got_i >= 0).all()


@pytest.mark.parametrize("mode", ["scalar", "planned"])
@pytest.mark.parametrize("engine", ["bucket", "dense"])
@pytest.mark.parametrize("family", FAMILIES)
def test_carried_index_equals_the_reference_engine(data, reference,
                                                   family, engine, mode):
    """The reference's S = 1 sharded index carried across: the port's
    engine gives the reference DistributedEngine's ids and the reference
    QueryEngine's."""
    _, queries = data
    spec, cidx, sidx, _ = reference[family]
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jeng = jdist.DistributedEngine(jdist.shard_index(sidx, mesh), mesh,
                                   engine=engine)
    want_v, want_i = jeng.query(jnp.asarray(queries), K, **_probe(mode))
    _, single_i = jengine.QueryEngine(cidx, engine=engine).query(
        jnp.asarray(queries), K, **_probe(mode))
    np.testing.assert_array_equal(np.asarray(want_i), np.asarray(single_i))
    fields = {f: (np.asarray(getattr(sidx, f))
                  if f != "params" else jax.tree.map(np.asarray, sidx.params))
              for f in convert.SHARDED_FIELDS}
    psidx = convert.sharded_index_from_fields(
        fields, {f: getattr(spec, f) for f in convert.SPEC_FIELDS},
        device="cpu")
    group = distributed.InProcessShardGroup(1)
    eng = distributed.DistributedEngine(psidx, group, engine=engine)
    got_v, got_i = eng.query(torch.as_tensor(queries), K, **_probe(mode))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=VAL_TOL, atol=VAL_TOL)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("align", ["bucket", "range"])
def test_layout_equals_the_reference(data, reference, S, align):
    """build_sharded on the reference's projections: the same directory,
    owners, local starts, row placement and padding."""
    items, _ = data
    spec, _, _, params = reference["simple"]
    want = jdist.build_sharded(spec, jnp.asarray(items),
                               jax.random.PRNGKey(3), S, align=align)
    got = distributed.build_sharded(IndexSpec(family="simple", code_len=16,
                                              m=8), items, None, S,
                                    align=align, params=params,
                                    device="cpu")
    assert (got.num_shards, got.rows_per_shard, got.num_items,
            got.hash_bits) == (want.num_shards, want.rows_per_shard,
                               want.num_items, want.hash_bits)
    for f in ("dir_rid", "dir_size", "dir_shard", "dir_local_start",
              "range_id", "bucket_of", "bucket_off", "perm", "valid",
              "rank"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(
        got.dir_code.numpy().view(np.uint32), np.asarray(want.dir_code))
    np.testing.assert_array_equal(got.items.numpy(), np.asarray(want.items))


def test_shards_own_whole_buckets_and_ranges(data, port):
    items, _ = data
    sidx = port["simple"][1][4]
    sizes, shard = sidx.dir_size.numpy(), sidx.dir_shard.numpy()
    lstart = sidx.dir_local_start.numpy()
    counts = sidx.valid.numpy().reshape(4, sidx.rows_per_shard).sum(1)
    assert (lstart + sizes <= counts[shard]).all()
    assert int(sizes.sum()) == sidx.num_items
    rsidx = distributed.build_sharded(
        IndexSpec(family="simple", code_len=16, m=8), items,
        torch.Generator().manual_seed(1), 4, align="range", device="cpu")
    rid, valid = rsidx.range_id.numpy(), rsidx.valid.numpy()
    owners = {}
    for s in range(4):
        sl = rsidx.shard_rows(s)
        for r in np.unique(rid[sl][valid[sl]]):
            assert owners.setdefault(int(r), s) == s


@pytest.mark.parametrize("engine", ["bucket", "dense"])
def test_query_axis_splits_the_batch(data, port, engine):
    """2 item shards x 2 query shards: gathered over items, then queries,
    the single-device engine's ids."""
    _, queries = data
    cidx, sharded = port["simple"]
    q = torch.as_tensor(queries)
    _, want_i = QueryEngine(cidx, engine=engine, device="cpu").query(
        q, K, NUM_PROBE)
    group = distributed.InProcessShardGroup(4)
    eng = distributed.DistributedEngine(
        distributed.shard_index(sharded[2], group, query_axis=2), group,
        engine=engine, query_axis=2)
    _, got_i = eng.query(q, K, NUM_PROBE)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    with pytest.raises(ValueError, match="query shards"):
        eng.query(q[:3], K, NUM_PROBE)


def test_shards_smaller_than_k_pad_the_merge():
    """8 shards over 18 items, k = 5 at full budget: every id real, equal
    to the single-device engine's."""
    rng = np.random.default_rng(6)
    items = rng.standard_normal((18, 8)).astype(np.float32)
    q = torch.as_tensor(rng.standard_normal((3, 8)).astype(np.float32))
    spec = IndexSpec(family="simple", code_len=8, m=1)
    gen = torch.Generator().manual_seed(2)
    cidx = build(spec, items, gen, device="cpu")
    _, want_i = QueryEngine(cidx, engine="dense", device="cpu").query(
        q, 5, 18)
    sidx = distributed.build_sharded(spec, items, None, 8,
                                     params=cidx.params, device="cpu")
    for engine in ("bucket", "dense"):
        group = distributed.InProcessShardGroup(8)
        eng = distributed.DistributedEngine(sidx, group, engine=engine)
        _, got_i = eng.query(q, 5, 18)
        np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())


def test_query_validation(data, port):
    _, queries = data
    q = torch.as_tensor(queries[:2])
    sidx = port["simple"][1][2]
    group = distributed.InProcessShardGroup(2)
    eng = distributed.DistributedEngine(sidx, group)
    with pytest.raises(ValueError, match="num_probe"):
        eng.query(q, 5)
    with pytest.raises(ValueError, match="num_probe"):
        eng.query(q, 5, sidx.num_items + 1)
    with pytest.raises(ValueError, match="k="):
        eng.query(q, 50, 10)
    with pytest.raises(ValueError, match="one of"):
        eng.query(q, 5, 10, budgets=BUDGETS)
    with pytest.raises(ValueError, match="shards"):
        distributed.DistributedEngine(sidx, distributed.InProcessShardGroup(3))
    with pytest.raises(ValueError, match="shards"):
        distributed.shard_index(sidx, distributed.InProcessShardGroup(4))
    with pytest.raises(ValueError, match="unknown engine"):
        distributed.DistributedEngine(sidx, group, engine="fused")
    with pytest.raises(ValueError, match="align"):
        distributed.build_sharded(IndexSpec(family="simple", code_len=16,
                                            m=8), data[0], None, 2,
                                  align="diagonal", device="cpu")
    with pytest.raises(ValueError, match="multi-table"):
        distributed.build_sharded(
            IndexSpec(family="simple", code_len=16, num_tables=2), data[0],
            torch.Generator().manual_seed(0), 2, device="cpu")


def test_recall_target_plans_the_budgets(data):
    """A calibrated sharded index answers recall_target queries with the
    planner's budgets, as QueryEngine over the same calibration does."""
    items, queries = data
    rng = np.random.default_rng(9)
    cal = rng.standard_normal((32, items.shape[1])).astype(np.float32)
    spec = IndexSpec(family="simple", code_len=16, m=8)
    gen = torch.Generator().manual_seed(4)
    sidx = distributed.build_sharded(spec, items, gen, 2,
                                     calibration_queries=cal, device="cpu")
    cidx = build(spec, items, params=sidx.params, calibration_queries=cal,
                 device="cpu")
    q = torch.as_tensor(queries)
    _, want_i = QueryEngine(cidx, engine="bucket", device="cpu").query(
        q, K, recall_target=0.9)
    eng = distributed.DistributedEngine(
        sidx, distributed.InProcessShardGroup(2), engine="bucket")
    _, got_i = eng.query(q, K, recall_target=0.9)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())


def test_tracker_names_and_plan_memo(data, port):
    """The reference's span and counter names; the plan memo counts hits
    and misses under the reference's jit-cache names, keyed by budgets
    too."""
    _, queries = data
    q = torch.as_tensor(queries[:4])
    sink = RingBufferSink()
    tracker = Tracker([sink])
    eng = distributed.DistributedEngine(
        port["simple"][1][2], distributed.InProcessShardGroup(2),
        engine="bucket", tracker=tracker)
    bare = distributed.DistributedEngine(
        port["simple"][1][2], distributed.InProcessShardGroup(2),
        engine="bucket")
    for _ in range(2):
        got = eng.query(q, 5, 60)
    eng.query(q, 5, 61)
    eng.query(q, 5, budgets=BUDGETS)
    assert torch.equal(got[1], bare.query(q, 5, 60)[1])
    c = tracker.counters
    assert c["repro.engine.distributed.jit_cache.miss"] == 3
    assert c["repro.engine.distributed.jit_cache.hit"] == 1
    assert c["repro.engine.queries"] == 16
    spans = {r["name"] for r in sink.query(type="span")}
    assert {"repro.engine.hash_encode",
            "repro.engine.distributed.collective"} <= spans
    assert "repro.engine.probe_width" in tracker.hists
    assert "repro.engine.probes_used.range0" in tracker.hists


def test_legacy_shims_equal_the_engine(data):
    items, queries = data
    q = torch.as_tensor(queries[:4])
    gen = torch.Generator().manual_seed(5)
    sidx = distributed.build(items, gen, 32, 8, 2, device="cpu")
    group = distributed.InProcessShardGroup(2)
    v1, i1 = distributed.query(sidx, q, 10, 100, group)
    v2, i2 = distributed.query(sidx, q, 10, 100, group)   # memoized engine
    eng = distributed.DistributedEngine(sidx, group)
    assert eng.engine == "dense"
    _, want = eng.query(q, 10, 200)
    assert torch.equal(i1, want) and torch.equal(i2, want)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """4 spawned processes, one shard each, gloo over a file rendezvous
    (``_torch_dist_worker.run``); the directory their results are in."""
    tmp_path = tmp_path_factory.mktemp("gloo")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, worker.SHARDS, str(tmp_path / "rdv"),
                               str(tmp_path)))
             for r in range(worker.SHARDS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {GLOO_TIMEOUT} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert [p.exitcode for p in procs] == [0] * worker.SHARDS
    return tmp_path


def test_gloo_process_group_equals_the_in_process_group(gloo_run):
    """4 spawned processes, one shard each, gloo over a file rendezvous:
    both arms, scalar and planned budgets, equal the in-process group."""
    got = np.load(gloo_run / "rank0.npz")
    sidx, queries = worker.build()
    group = distributed.InProcessShardGroup(worker.SHARDS)
    for engine in ("bucket", "dense"):
        eng = distributed.DistributedEngine(sidx, group, engine=engine)
        for mode, kw in (("scalar", {"num_probe": worker.NUM_PROBE}),
                         ("planned", {"budgets": worker.BUDGETS})):
            v, i = eng.query(queries, worker.K, **kw)
            np.testing.assert_array_equal(got[f"{engine}_{mode}_ids"],
                                          i.numpy())
            np.testing.assert_array_equal(got[f"{engine}_{mode}_vals"],
                                          v.numpy())


def test_gloo_sequence_sharded_decode(gloo_run):
    """The same 4 ranks, one sequence shard each: the combine over the
    process group equals ``decode_attention`` on the whole cache, and
    ``gqa_decode(seq_axis="model")`` on a DTensor cache over the (1, 4)
    mesh writes the new key and value on the owning shard only and
    equals the meshless step (f32, atol 1e-5)."""
    from repro_torch.models import attention as attn
    cfg, p, x, k, v, q = worker.seq_inputs()
    want_o = attn.decode_attention(q, k, v, worker.SEQ_POS)
    cache = attn.AttnCache(k.clone(), v.clone())
    want_out, cache = attn.gqa_decode(p, x, cache, worker.SEQ_POS, cfg,
                                      layer_is_local=False)
    s_loc = worker.SEQ // worker.SHARDS
    owner = worker.SEQ_POS // s_loc
    for r in range(worker.SHARDS):
        got = np.load(gloo_run / f"seq{r}.npz")
        np.testing.assert_allclose(got["combine"], want_o.numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["out"], want_out.numpy(), atol=1e-5,
                                   rtol=1e-5)
        mine = slice(r * s_loc, (r + 1) * s_loc)
        for name, before, after in (("k", k, cache.k), ("v", v, cache.v)):
            shard = got[name]
            if r == owner:
                np.testing.assert_allclose(shard, after[:, mine].numpy(),
                                           atol=1e-6)
                assert not np.array_equal(shard, before[:, mine].numpy())
            else:
                np.testing.assert_array_equal(shard, before[:, mine].numpy())


def test_gloo_expert_parallel_moe(gloo_run):
    """The same 4 ranks: reduced granite-moe's layer with its expert
    stacks sharded over the (1, 4) mesh's ``model`` dimension (each rank
    routes the tokens and runs only its own experts, the outputs summed
    over the ranks) equals the meshless layer (f32, atol 1e-5)."""
    from repro_torch.models import moe
    cfg, p, x = worker.moe_inputs()
    want, aux = moe.moe_forward(p, x, cfg)
    held = []
    for r in range(worker.SHARDS):
        got = np.load(gloo_run / f"moe{r}.npz")
        np.testing.assert_allclose(got["out"], want.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got["aux"], aux.numpy(), rtol=1e-6)
        held.append(int(got["experts"]))
    assert sum(held) == cfg.moe.num_experts and max(held) < sum(held)


def test_gloo_sequence_sharded_mla_decode(gloo_run):
    """The same 4 ranks: reduced minicpm3's MLA decode with its latent and
    rope-key caches sharded along the sequence over ``model`` writes the
    slot on the owning shard only and equals the meshless decode (f32,
    atol 1e-5)."""
    from repro_torch.models import attention as attn
    cfg, p, x, c, r = worker.mla_inputs()
    cache = attn.AttnCache(c.clone(), r.clone())
    want, cache = attn.mla_decode(p, x, cache, worker.SEQ_POS, cfg)
    s_loc = worker.SEQ // worker.SHARDS
    for rank in range(worker.SHARDS):
        got = np.load(gloo_run / f"mla{rank}.npz")
        np.testing.assert_allclose(got["out"], want.numpy(), atol=1e-5,
                                   rtol=1e-5)
        mine = slice(rank * s_loc, (rank + 1) * s_loc)
        np.testing.assert_allclose(got["c"], cache.k[:, mine].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(got["r"], cache.v[:, mine].numpy(),
                                   atol=1e-6)
        if rank != worker.SEQ_POS // s_loc:
            np.testing.assert_array_equal(got["c"], c[:, mine].numpy())


def test_gloo_label_logits_from_a_vocab_sharded_table(gloo_run):
    """The same 4 ranks: the loss's label logits picked from logits
    sharded unevenly along the vocabulary (each rank its slice, the picks
    summed) equal ``torch.gather`` on the whole logits."""
    logits, labels = worker.vocab_inputs()
    want = torch.gather(logits, -1, labels[..., None])[..., 0].numpy()
    for r in range(worker.SHARDS):
        np.testing.assert_array_equal(
            np.load(gloo_run / f"vocab{r}.npz")["got"], want)

