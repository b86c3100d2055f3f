"""The port's core modules against the JAX package on the same numpy
inputs: hashing, partitioning, the eq.-12 probe and rank tables, the
bucket store, exact MIPS and re-ranking.

Integer results (packed codes, Hamming counts, range ids, ranks, the CSR
layout) must be equal. Float results within the stated tolerance:
``l2_norm`` rtol 1e-6 (an f32 sum of d squares in another order), the
score table rtol 1e-6 (``cos`` of torch and XLA may differ by an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_tie_aware, t, u32_to_i32
from repro.core import bucket_index as jbi
from repro.core import hashing as jhash
from repro.core import partition as jpart
from repro.core import probe as jprobe
from repro.core import topk as jtopk
from repro_torch.core import bucket_index as bi
from repro_torch.core import hashing, partition, probe, topk


def _codes(rng, n, w):
    return rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64
                        ).astype(np.uint32)


def _longtail_norms(seed, n):
    rng = np.random.default_rng(seed)
    return np.exp(0.8 * rng.standard_normal(n)).astype(np.float32)


# -- hashing ------------------------------------------------------------------


@pytest.mark.parametrize("L", [5, 27, 32, 33, 64])
def test_pack_and_unpack_bits_match_reference(L):
    rng = np.random.default_rng(L)
    bits = rng.integers(0, 2, size=(50, L)).astype(np.uint8)
    want = jhash.pack_bits(jnp.asarray(bits))
    got = hashing.pack_bits(t(bits))
    np.testing.assert_array_equal(got.numpy(), u32_to_i32(want))
    np.testing.assert_array_equal(hashing.unpack_bits(got, L).numpy(), bits)


def test_hamming_matrix_with_top_bit_codes_matches_reference():
    rng = np.random.default_rng(3)
    q, db = _codes(rng, 9, 2), _codes(rng, 120, 2)
    db[:40, 1] |= np.uint32(2 ** 31)      # negative words in the int32 view
    want = jhash.hamming_matrix(jnp.asarray(q), jnp.asarray(db))
    got = hashing.hamming_matrix(t(u32_to_i32(q)), t(u32_to_i32(db)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_norms_and_normalize_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((200, 32)).astype(np.float32) * 3
    np.testing.assert_allclose(hashing.l2_norm(t(x)).numpy(),
                               np.asarray(jhash.l2_norm(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(hashing.normalize(t(x)).numpy(),
                               np.asarray(jhash.normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_srp_projections_draw_from_the_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = hashing.srp_projections(g1, 9, 27)
    assert a.shape == (9, 27) and a.dtype == torch.float32
    assert torch.equal(a, hashing.srp_projections(g2, 9, 27))


# -- partition (on the reference's norms) ------------------------------------


@pytest.mark.parametrize("scheme", ["percentile", "uniform"])
@pytest.mark.parametrize("m", [1, 4, 32])
def test_partition_on_reference_norms_is_exact(scheme, m):
    norms = _longtail_norms(m, 3000)
    norms[100:140] = norms[7]             # ties: broken by item index
    want = jpart.partition_by_scheme(jnp.asarray(norms), m, scheme)
    got = partition.partition_by_scheme(t(norms), m, scheme)
    for field in ("range_id", "upper", "lower", "counts"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(
        partition.effective_upper(got).numpy(),
        np.asarray(jpart.effective_upper(want)))


def test_uniform_partition_with_empty_range_maps_it_to_the_max():
    norms = np.asarray([0.1, 0.11, 0.12, 0.9, 1.0], np.float32)
    got = partition.uniform_partition(t(norms), 4)
    want = jpart.uniform_partition(jnp.asarray(norms), 4)
    assert int(got.counts.min()) == 0
    np.testing.assert_array_equal(partition.effective_upper(got).numpy(),
                                  np.asarray(jpart.effective_upper(want)))


def test_percentile_partition_overflow_guard():
    m = 2 ** 31 // 1000 + 1
    with pytest.raises(ValueError, match="overflow int32"):
        partition.percentile_partition(torch.ones(1000), m)
    with pytest.raises(ValueError, match="overflow int32"):
        jpart.percentile_partition(jnp.ones(1000), m)


# -- eq. 12: score table, probe table, rank tables ---------------------------


@pytest.mark.parametrize("m,L", [(4, 14), (32, 27), (8, 32)])
def test_probe_and_rank_tables_match_reference(m, L):
    upper = np.sort(_longtail_norms(L, m)).astype(np.float32)
    want_s = jprobe.similarity_estimate(jnp.asarray(upper)[:, None],
                                        jnp.arange(L + 1)[None, :], L)
    got_s = probe.similarity_estimate(t(upper)[:, None],
                                      torch.arange(L + 1)[None, :], L)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6,
                               atol=1e-7)
    want_t = jprobe.probe_table(jnp.asarray(upper), L)
    got_t = probe.probe_table(t(upper), L)
    np.testing.assert_array_equal(got_t.range_idx.numpy(),
                                  np.asarray(want_t.range_idx))
    np.testing.assert_array_equal(got_t.match_cnt.numpy(),
                                  np.asarray(want_t.match_cnt))
    np.testing.assert_array_equal(bi.rank_table(t(upper), L).numpy(),
                                  np.asarray(jbi.rank_table(
                                      jnp.asarray(upper), L)))
    # the rank of a carried-over score table is exact by construction
    np.testing.assert_array_equal(
        bi.rank_from_scores(t(want_s)).numpy(),
        np.asarray(jbi.rank_from_scores(want_s)))


# -- bucket store -------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 2])
def test_bucket_store_matches_reference_with_top_bit_codes(w):
    rng = np.random.default_rng(7 + w)
    n, m, L = 2500, 8, 32 * w - 3
    # few distinct codes so buckets collide, half with bit 31 set
    pool = _codes(rng, 60, w)
    pool[::2, 0] |= np.uint32(2 ** 31)
    codes = pool[rng.integers(0, 60, size=n)]
    rid = rng.integers(0, m, size=n).astype(np.int32)
    upper = np.sort(_longtail_norms(w, m))
    table = jprobe.similarity_estimate(jnp.asarray(upper)[:, None],
                                       jnp.arange(L + 1)[None, :], L)
    want = jbi.build_buckets(jnp.asarray(codes), jnp.asarray(rid),
                             jnp.asarray(upper), L,
                             rank=jbi.rank_from_scores(table))
    got = bi.build_buckets(t(u32_to_i32(codes)), t(rid), t(upper), L,
                           rank=bi.rank_from_scores(t(table)))
    for field in ("item_ids", "bucket_start", "bucket_rid", "rank"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(got.bucket_code.numpy(),
                                  u32_to_i32(want.bucket_code))
    assert got.num_buckets <= 60 * m      # buckets really collide


# -- exact MIPS, re-rank, recall ---------------------------------------------


def test_exact_mips_matches_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    x = rng.standard_normal((700, 16)).astype(np.float32)
    wv, wi = jtopk.exact_mips(jnp.asarray(q), jnp.asarray(x), 10)
    gv, gi = topk.exact_mips(t(q), t(x), 10)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


def test_rerank_masks_duplicate_ids_like_reference():
    rng = np.random.default_rng(12)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    cand = rng.integers(0, 50, size=(6, 30)).astype(np.int32)
    cand[:, 5] = cand[:, 0]               # a repeat in every row
    wv, wi = jtopk.rerank(jnp.asarray(q), jnp.asarray(x), jnp.asarray(cand),
                          8)
    gv, gi = topk.rerank(t(q), t(x), t(cand), 8)
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)
    for row in gi.numpy():
        assert len(set(row.tolist())) == row.size


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("max_bytes,blocks", [
    (4 * 8 * 30 * 3, (3, 30)),       # three queries a block
    (4 * 8 * 30, (1, 30)),           # one query a block
    (4 * 8 * 12, (1, 12)),           # one query in candidate blocks
    (4 * 8 * 2, (1, 7)),             # blocks never narrower than k
])
def test_rerank_blocks_give_the_unchunked_result(max_bytes, blocks,
                                                 integer, monkeypatch):
    """A budget that forces query blocks, then candidate blocks under the
    running top-k, returns exactly the one-block result: duplicates
    masked to their first occurrence, and exact ties (every item appears
    twice, integer rows score exactly) to the first position."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((40, 8))
    q = rng.standard_normal((7, 8))
    if integer:
        x, q = np.round(2 * x), np.round(2 * q)
    items = t(np.concatenate([x, x]), np.float32)
    cand = t(rng.integers(0, 80, size=(7, 30)), np.int32)
    cand[:, 9] = cand[:, 2]
    want = topk.rerank(t(q, np.float32), items, cand, 7)
    monkeypatch.setattr(topk, "RERANK_BYTES", max_bytes)
    assert topk.rerank_blocks(7, 30, 8, 7) == blocks
    got = topk.rerank(t(q, np.float32), items, cand, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for row in got[1].numpy():
        assert len(set(row.tolist())) == row.size


def test_rerank_blocks_stay_within_the_budget_at_any_width():
    """Every width ``_check_probe`` accepts on the slice-1 index, up to
    N, gathers at most RERANK_BYTES of rows at a time."""
    for p in (1, 10, 73_136, 1_000_000, 2_340_373):
        qb, pb = topk.rerank_blocks(64, p, 150, 10)
        assert 4 * 150 * qb * pb <= topk.RERANK_BYTES
        assert pb == p or qb == 1


def test_recall_at_matches_reference():
    rng = np.random.default_rng(13)
    got = rng.integers(0, 40, size=(10, 12))
    truth = rng.integers(0, 40, size=(10, 5))
    want = float(jtopk.recall_at(jnp.asarray(got), jnp.asarray(truth)))
    assert topk.recall_at(t(got), t(truth)) == pytest.approx(want, abs=1e-7)


def test_full_f32_restores_the_tf32_flag():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with topk.full_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
