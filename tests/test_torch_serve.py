"""The port's LSH-decode heads (``models/lm_head.py``) and server
(``launch/serve.py``) against the JAX package, on the reduced Qwen3 with
the reference's bf16 weights carried bit for bit.

Heads: given identical hidden states (numpy, f32), the port's dense and
bucket LSH heads, exact head, calibration table and vocab-sharded head
give the reference's ids exactly; logit values within 1e-4 (f32 dots
summed in another order). Server: every LSH head at full probe equals the
exact server, as ``tests/test_serve.py`` holds the reference; the port's
first greedy token equals the reference's on each row whose reference
top-1 logit margin exceeds ``2 * LOGIT_ATOL`` (the stack's logit
tolerance, ``test_torch_models.py``), and at least half the rows must
qualify. On a mesh: ``param_count``/``serve_fsdp_axis`` equal the
reference's on every config, and prefill, decode and the LSH head on a
1 x 1 CPU mesh equal the meshless steps bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import gloo_world_of_one
from jax.sharding import Mesh

from repro.configs.base import get_config as jget_config
from repro.core import bucket_index as jbucket
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import lm_head as jhead
from repro_torch import convert
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import planner
from repro_torch.core.bucket_index import BucketIndex, build_bucket_index
from repro_torch.core.distributed import InProcessShardGroup
from repro_torch.core.engine import bucket_candidates, encode_queries
from repro_torch.launch import serve
from repro_torch.models import lm, lm_head
from repro_torch.obs import RingBufferSink, Tracker

VAL_TOL = 1e-4
LOGIT_ATOL = 5e-2
STEPS = 3


@pytest.fixture(scope="module")
def lm_pair():
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jget_config("qwen3_0_6b").reduced()
    cfg = get_config("qwen3_0_6b").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pp = convert.lm_params_from_tree(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, cfg, jp, pp


@pytest.fixture(scope="module")
def heads(lm_pair):
    """The reference's vocab index (code_len 64, 16 ranges) and the port's
    copy, the unembeddings, and 16 hidden states."""
    jcfg, cfg, jp, pp = lm_pair
    junembed = jlm._unembed_matrix(jp, jcfg)
    unembed = lm._unembed_matrix(pp, cfg)
    jv = jhead.build_vocab_index(junembed, jax.random.PRNGKey(5),
                                 code_len=64, num_ranges=16)
    pv = convert.vocab_index_from_fields(
        {f: (np.asarray(getattr(jv, f)) if hasattr(getattr(jv, f), "shape")
             else getattr(jv, f)) for f in convert.VOCAB_FIELDS},
        device="cpu")
    hidden = np.random.default_rng(1).standard_normal(
        (16, cfg.d_model)).astype(np.float32)
    return jv, pv, junembed, unembed, hidden


@pytest.fixture(scope="module")
def prompts(lm_pair):
    cfg = lm_pair[1]
    return np.random.default_rng(6).integers(0, cfg.vocab, (16, 5))


def _exact_server(cfg, params):
    return serve.BatchedServer(cfg, params, device="cpu")


def test_port_build_equals_the_reference_index(heads):
    """build_vocab_index on the reference's projection: the same
    partition and codes, and bounds within an ulp (the norms' f32 sums run
    in another order)."""
    jv, pv, _, unembed, _ = heads
    got = lm_head.build_vocab_index(unembed, code_len=64, num_ranges=16,
                                    params=pv.A)
    assert (got.code_len, got.hash_bits) == (jv.code_len, jv.hash_bits)
    np.testing.assert_array_equal(got.range_id.numpy(),
                                  np.asarray(jv.range_id))
    np.testing.assert_allclose(got.upper.numpy(), np.asarray(jv.upper),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.codes.numpy().view(np.uint32),
                                  np.asarray(jv.codes))


@pytest.mark.parametrize("num_probe", [64, 200, 512])
def test_dense_and_bucket_heads_equal_the_reference(heads, num_probe):
    jv, pv, junembed, unembed, hidden = heads
    h, jh = torch.as_tensor(hidden), jnp.asarray(hidden)
    want_v, want_i = jhead.lsh_topk_tokens(jv, jh, junembed, k=4,
                                           num_probe=num_probe)
    got_v, got_i = lm_head.lsh_topk_tokens(pv, h, unembed, k=4,
                                           num_probe=num_probe)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               atol=VAL_TOL, rtol=VAL_TOL)
    jb = jbucket.build_bucket_index(jv)
    pb = build_bucket_index(pv)
    want_v, want_i = jhead.lsh_topk_tokens(jv, jh, junembed, k=4,
                                           num_probe=num_probe, buckets=jb)
    got_v, got_i = lm_head.lsh_topk_tokens(pv, h, unembed, k=4,
                                           num_probe=num_probe, buckets=pb)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("true_vocab,cap", [(None, None), (500, 30.0)])
def test_exact_head_and_masks_equal_the_reference(heads, true_vocab, cap):
    jv, pv, junembed, unembed, hidden = heads
    want_v, want_i = jhead.exact_topk_tokens(jnp.asarray(hidden), junembed,
                                             5, final_softcap=cap,
                                             true_vocab=true_vocab)
    got_v, got_i = lm_head.exact_topk_tokens(torch.as_tensor(hidden),
                                             unembed, 5, final_softcap=cap,
                                             true_vocab=true_vocab)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               atol=VAL_TOL, rtol=VAL_TOL)
    want_v, want_i = jhead.lsh_topk_tokens(
        jv, jnp.asarray(hidden), junembed, k=3, num_probe=100,
        final_softcap=cap, true_vocab=true_vocab)
    got_v, got_i = lm_head.lsh_topk_tokens(
        pv, torch.as_tensor(hidden), unembed, k=3, num_probe=100,
        final_softcap=cap, true_vocab=true_vocab)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_calibration_and_recall_target_equal_the_reference(heads):
    """calibrate_vocab_index fits the reference's table (integer positions
    and counts, recall curves), and a recall_target query plans the same
    budget and returns the same ids."""
    jv, pv, junembed, unembed, hidden = heads
    cal = np.random.default_rng(2).standard_normal(
        (48, hidden.shape[1])).astype(np.float32)
    jcal = jhead.calibrate_vocab_index(jv, junembed, jnp.asarray(cal))
    pcal = lm_head.calibrate_vocab_index(pv, unembed, torch.as_tensor(cal))
    for f in ("probe_grid", "range_counts", "recall_range", "recall_global",
              "truth_mass"):
        np.testing.assert_array_equal(np.asarray(getattr(pcal, f)),
                                      np.asarray(getattr(jcal, f)),
                                      err_msg=f)
    jv2, pv2 = jv._replace(calib=jcal), pv._replace(calib=pcal)
    _, want_i = jhead.lsh_topk_tokens(jv2, jnp.asarray(hidden), junembed,
                                      k=1, recall_target=0.9)
    _, got_i = lm_head.lsh_topk_tokens(pv2, torch.as_tensor(hidden),
                                       unembed, k=1, recall_target=0.9)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    with pytest.raises(ValueError, match="calibrated"):
        lm_head.lsh_topk_tokens(pv, torch.as_tensor(hidden), unembed, k=1,
                                recall_target=0.9)
    with pytest.raises(ValueError, match="one of"):
        lm_head.lsh_topk_tokens(pv2, torch.as_tensor(hidden), unembed, k=1,
                                recall_target=0.9, num_probe=10)


def test_sharded_head_equals_the_reference_and_covers_the_vocab(heads):
    """One shard: the reference's vocab-sharded head (a 1-device model
    axis), id for id. Two and four in-process shards at a full per-shard
    probe: the exact head's ids."""
    jv, pv, junembed, unembed, hidden = heads
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    want_v, want_i = jhead.sharded_lsh_topk_tokens(
        jv, jnp.asarray(hidden), junembed, mesh, k=5,
        num_probe_per_shard=128)
    got_v, got_i = lm_head.sharded_lsh_topk_tokens(
        pv, torch.as_tensor(hidden), unembed, InProcessShardGroup(1), k=5,
        num_probe_per_shard=128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               atol=VAL_TOL, rtol=VAL_TOL)
    _, exact = lm_head.exact_topk_tokens(torch.as_tensor(hidden), unembed,
                                         5)
    V = unembed.shape[1]
    for S in (2, 4):
        _, got_i = lm_head.sharded_lsh_topk_tokens(
            pv, torch.as_tensor(hidden), unembed, InProcessShardGroup(S),
            k=5, num_probe_per_shard=V // S)
        np.testing.assert_array_equal(got_i.numpy(), exact.numpy())


def test_first_token_equals_the_reference_server(lm_pair, prompts):
    """The exact servers of both packages on carried weights: the first
    greedy token agrees wherever the reference's top-1 margin is wider
    than the logit tolerance, on at least half the rows."""
    jcfg, cfg, jp, pp = lm_pair
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    want = np.asarray(jserve.BatchedServer(jcfg, jp, mesh, max_seq=32)
                      .generate(jnp.asarray(prompts), steps=1))[:, 0]
    got = _exact_server(cfg, pp).generate(prompts, 1)[:, 0].numpy()
    h, _ = jlm.prefill(jp, jnp.asarray(prompts), jcfg)
    logits = np.asarray(jnp.asarray(h, jnp.float32)
                        @ jlm._unembed_matrix(jp, jcfg).astype(jnp.float32))
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
    assert clear.sum() >= len(clear) // 2, clear
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("engine,quantized", [
    ("dense", False), ("bucket", False), ("fused", False), ("fused", True)])
def test_lsh_heads_at_full_probe_equal_the_exact_server(lm_pair, prompts,
                                                        engine, quantized):
    _, cfg, _, pp = lm_pair
    vidx = lm_head.build_vocab_index(lm._unembed_matrix(pp, cfg),
                                     torch.Generator().manual_seed(5),
                                     code_len=64, num_ranges=16)
    server = serve.BatchedServer(cfg, pp, device="cpu", lsh_decode=True,
                                 vocab_index=vidx,
                                 num_probe=cfg.padded_vocab, engine=engine,
                                 quantized=quantized)
    want = _exact_server(cfg, pp).generate(prompts, STEPS)
    got = server.generate(prompts, STEPS)
    assert got.shape == (prompts.shape[0], STEPS)
    if quantized:
        # int8 phase 1 may drop the true top-1 from its k' survivors
        assert float((got == want).float().mean()) >= 0.9
    else:
        assert torch.equal(got, want)


def test_sharded_head_server_equals_the_exact_server(lm_pair, prompts):
    _, cfg, _, pp = lm_pair
    unembed = lm._unembed_matrix(pp, cfg)
    want = _exact_server(cfg, pp).generate(prompts, STEPS)
    for S in (1, 2):
        sidx = serve.build_sharded_vocab_index(
            unembed, torch.Generator().manual_seed(5), code_len=32,
            num_ranges=8, num_shards=S, true_vocab=cfg.vocab)
        server = serve.BatchedServer(cfg, pp, device="cpu",
                                     sharded_index=sidx,
                                     num_probe=cfg.padded_vocab)
        assert torch.equal(server.generate(prompts, STEPS), want)
    with pytest.raises(ValueError, match="token_map"):
        serve.BatchedServer(cfg, pp, device="cpu", sharded_index=sidx,
                            token_map=np.zeros((4,), np.int32))


def test_streaming_head_bans_and_upserts_tokens(lm_pair, prompts):
    """Full probe equals the exact server; delete_tokens bans a token;
    insert_tokens with a boosted alias row wins it back."""
    _, cfg, _, pp = lm_pair
    unembed = lm._unembed_matrix(pp, cfg)
    sidx = serve.build_streaming_vocab_index(
        unembed, torch.Generator().manual_seed(5), code_len=32,
        num_ranges=8, capacity=32)
    server = serve.BatchedServer(cfg, pp, device="cpu", streaming_index=sidx,
                                 num_probe=cfg.padded_vocab)
    want = _exact_server(cfg, pp).generate(prompts, STEPS)
    assert torch.equal(server.generate(prompts, STEPS), want)
    banned = int(want[0, 0])
    server.delete_tokens([banned])
    assert int(server.generate(prompts, 1)[0, 0]) != banned
    ids = server.insert_tokens(2.0 * unembed[:, banned][None, :].float(),
                               [banned])
    assert int(ids[0]) >= cfg.padded_vocab
    assert int(server.generate(prompts, 1)[0, 0]) == banned


def test_streaming_mount_with_pending_delta_needs_a_token_map(lm_pair,
                                                              prompts):
    _, cfg, _, pp = lm_pair
    sidx = serve.build_streaming_vocab_index(
        lm._unembed_matrix(pp, cfg), torch.Generator().manual_seed(5),
        code_len=32, num_ranges=8, capacity=32)
    pre = sidx.insert(1e-3 * torch.ones((2, cfg.d_model)))
    with pytest.raises(ValueError, match="token_map"):
        serve.BatchedServer(cfg, pp, device="cpu", streaming_index=sidx,
                            num_probe=cfg.padded_vocab)
    tmap = np.concatenate([np.arange(sidx.store_size), np.zeros(2)])
    server = serve.BatchedServer(cfg, pp, device="cpu", streaming_index=sidx,
                                 num_probe=cfg.padded_vocab, token_map=tmap)
    out = server.generate(prompts[:2], 2)
    assert bool((out < cfg.vocab).all())
    ids = server.insert_tokens(torch.ones((1, cfg.d_model)), [0])
    assert int(ids[0]) == int(pre[-1]) + 1
    live = server.streaming_index.live_count
    with pytest.raises(ValueError):     # mismatch rejected before mutation
        server.insert_tokens(torch.ones((2, cfg.d_model)), [0])
    assert server.streaming_index.live_count == live


def test_recall_target_server_and_validation(lm_pair, prompts):
    """A calibrated vocab index serves a recall contract (the planned
    num_probe); the contract's and the arms' misuse raise as the
    reference's."""
    _, cfg, _, pp = lm_pair
    unembed = lm._unembed_matrix(pp, cfg)
    vidx = lm_head.build_vocab_index(unembed,
                                     torch.Generator().manual_seed(5),
                                     code_len=64, num_ranges=16)
    cal, _ = lm.prefill(pp, torch.as_tensor(prompts), cfg)
    calib = lm_head.calibrate_vocab_index(vidx, unembed, cal)
    vidx = vidx._replace(calib=calib)
    server = serve.BatchedServer(cfg, pp, device="cpu", lsh_decode=True,
                                 vocab_index=vidx, recall_target=0.9)
    assert server.num_probe == planner.plan_global(calib, 0.9).num_probe
    assert server.generate(prompts, 2).shape == (prompts.shape[0], 2)
    with pytest.raises(ValueError, match="LSH head"):
        serve.BatchedServer(cfg, pp, recall_target=0.9, device="cpu")
    with pytest.raises(ValueError, match="calibrated"):
        serve.BatchedServer(cfg, pp, device="cpu", lsh_decode=True,
                            vocab_index=vidx._replace(calib=None),
                            recall_target=0.9)
    with pytest.raises(ValueError, match="fused"):
        serve.BatchedServer(cfg, pp, device="cpu", lsh_decode=True,
                            vocab_index=vidx, engine="bucket",
                            quantized=True)
    with pytest.raises(ValueError, match="params live on cpu"):
        serve.BatchedServer(cfg, pp, device="meta")


def test_tracked_server_records_the_reference_names(lm_pair, prompts):
    _, cfg, _, pp = lm_pair
    sink = RingBufferSink()
    tracker = Tracker([sink])
    server = serve.BatchedServer(cfg, pp, device="cpu", tracker=tracker)
    got = server.generate(prompts, STEPS)
    assert torch.equal(got, _exact_server(cfg, pp).generate(prompts, STEPS))
    spans = {r["name"] for r in sink.query(type="span")}
    assert {"repro.serve.prefill", "repro.serve.decode_step",
            "repro.serve.topk_head"} <= spans
    assert tracker.counters["repro.serve.generated_tokens"] == \
        prompts.size // 5 * STEPS
    assert tracker.gauges["repro.serve.batch_size"] == prompts.shape[0]


def test_decode_step_prefill_and_bucket_arrays(lm_pair, heads):
    """make_decode_step's full-logit and LSH steps, make_prefill, and the
    bucket-store plumbing: arrays shipped to the step rebuild a store that
    emits the engine's candidates."""
    _, cfg, _, pp = lm_pair
    _, pv, _, unembed, hidden = heads
    caches = lm.init_cache(cfg, 4, 16, device="cpu")
    logits, caches = serve.make_decode_step(cfg)(
        pp, torch.zeros(4, dtype=torch.long), caches, 0)
    assert logits.shape == (4, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    h, _ = serve.make_prefill(cfg)(pp, torch.zeros((4, 3),
                                                   dtype=torch.long))
    assert h.shape == (4, cfg.d_model)
    buckets = build_bucket_index(pv)
    arrs = serve.bucket_arrays(buckets)
    rebuilt = BucketIndex(arrs["item_ids"], arrs["bucket_start"],
                          arrs["bucket_rid"], arrs["bucket_code"],
                          arrs["rank"], pv.hash_bits, pv.eps)
    q = torch.as_tensor(hidden[:8])
    got = bucket_candidates(rebuilt, encode_queries(pv, q), 256)
    want = bucket_candidates(buckets, encode_queries(pv, q), 256)
    assert torch.equal(got, want)
    step = serve.make_decode_step(
        cfg, lsh_decode=True, topk=2, num_probe=cfg.padded_vocab,
        vocab_meta=(pv.code_len, pv.hash_bits, pv.eps), engine="bucket")
    (vals, ids), _ = step(pp, torch.zeros(4, dtype=torch.long),
                          lm.init_cache(cfg, 4, 16, device="cpu"), 0,
                          {"codes": pv.codes, "range_id": pv.range_id,
                           "upper": pv.upper, "A": pv.A, **arrs})
    assert ids.shape == (4, 2)


# -- on a mesh ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_and_serve_axis_equal_the_references(arch):
    params = lm.init_params(None, get_config(arch), device="meta")
    jparams = jax.eval_shape(functools.partial(
        jlm.init_params, cfg=jget_config(arch)), jax.random.PRNGKey(0))
    assert serve.param_count(params) == jserve.param_count(jparams)
    assert serve.serve_fsdp_axis(params) == jserve.serve_fsdp_axis(jparams)
    assert (serve.FSDP_SERVE_THRESHOLD, serve.MODEL_AXIS) == \
        (jserve.FSDP_SERVE_THRESHOLD, jserve.MODEL_AXIS)


def test_decode_on_a_mesh_equals_the_meshless_decode(lm_pair, heads,
                                                     tmp_path):
    """A 1 x 1 CPU mesh (a gloo world of one): ``make_prefill(mesh=)`` and
    ``make_decode_step(mesh=)`` (stationary params, caches sequence on
    ``model``, the local combine over one shard) give the meshless hidden
    state, logits and greedy tokens bit for bit, and so does the LSH head
    on the mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_local_mesh
    _, cfg, _, pp = lm_pair
    _, pv, _, _, _ = heads
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (4, 6)))
    h0, c0 = serve.make_prefill(cfg)(pp, toks)
    c0 = lm.extend_cache(cfg, c0, 12)
    with gloo_world_of_one(tmp_path):
        mesh = make_local_mesh(device_type="cpu")
        h1, c1 = serve.make_prefill(cfg, mesh=mesh)(pp, toks)
        assert isinstance(h1, DTensor)
        assert torch.equal(h1.full_tensor(), h0)
        c1 = lm.extend_cache(cfg, c1, 12)
        plain, meshed = (serve.make_decode_step(cfg),
                         serve.make_decode_step(cfg, mesh=mesh))
        n0 = n1 = toks[:, -1]
        for pos in range(6, 11):
            l0, c0 = plain(pp, n0, c0, pos)
            l1, c1 = meshed(pp, n1, c1, pos)
            assert not isinstance(l1, DTensor)
            assert torch.equal(l1, l0), pos
            n0, n1 = l0.argmax(-1), l1.argmax(-1)
        assert all(isinstance(x, DTensor) for c in c1 for x in c)
        kw = dict(lsh_decode=True, topk=2, num_probe=cfg.padded_vocab,
                  vocab_meta=(pv.code_len, pv.hash_bits, pv.eps))
        arrays = {"codes": pv.codes, "range_id": pv.range_id,
                  "upper": pv.upper, "A": pv.A}
        (v0, i0), _ = serve.make_decode_step(cfg, **kw)(pp, n0, c0, 11,
                                                        arrays)
        (v1, i1), _ = serve.make_decode_step(cfg, mesh=mesh, **kw)(
            pp, n1, c1, 11, arrays)
        assert torch.equal(i1, i0) and torch.equal(v1, v0)
