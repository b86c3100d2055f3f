"""The port's kernel wrappers and plain versions against the JAX ops.

Same numpy inputs through ``repro.kernels.ops`` (its jnp oracles, and
its Pallas kernels in interpret mode at the padding-probe sizes) and
through ``repro_torch.kernels.ops`` with ``impl="ref"`` on CPU tensors.
Integer outputs must be equal; scores within ATOL/RTOL (f32 dots summed
in another order); code bits may differ only where the projection is
within FLIP_REL of zero. The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MISMATCHED, assert_codes_match,
                           assert_topk_tie_aware, make_runs,
                           mismatched_shape_calls, t, u32_to_i32)
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref


def _codes(rng, n, w):
    return rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64
                        ).astype(np.uint32)


# -- shared helpers -----------------------------------------------------------


def test_popcount32_counts_every_bit_pattern():
    rng = np.random.default_rng(0)
    words = np.concatenate([_codes(rng, 500, 1).ravel(),
                            np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1],
                                       np.uint32)])
    want = np.asarray([bin(int(w)).count("1") for w in words])
    got = ref.popcount32(t(u32_to_i32(words)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_stable_topk_breaks_ties_like_lax_top_k(k):
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, size=(6, 40)).astype(np.float32)   # many ties
    x[0, :] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = ref.stable_topk(t(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- hash_encode --------------------------------------------------------------


@pytest.mark.parametrize("L", [27, 32, 48, 64])
@pytest.mark.parametrize("folded", [True, False])
def test_hash_encode_matches_reference(L, folded):
    rng = np.random.default_rng(L)
    n, d = 400, 24
    x = rng.standard_normal((n, d)).astype(np.float32) / 8
    A = rng.standard_normal((d, L)).astype(np.float32)
    tail = np.sqrt(np.maximum(0.0, 1 - (x * x).sum(1))).astype(np.float32)
    a_tail = rng.standard_normal(L).astype(np.float32)
    extra = (tail, a_tail) if folded else (None, None)
    want = jops.hash_encode(jnp.asarray(x), jnp.asarray(A),
                            *[None if e is None else jnp.asarray(e)
                              for e in extra], impl="ref")
    got = ops.hash_encode(t(x), t(A), *[None if e is None else t(e)
                                         for e in extra], impl="ref")
    proj = x.astype(np.float64) @ A
    norm = np.linalg.norm(x.astype(np.float64), axis=1)
    if folded:
        proj += tail[:, None].astype(np.float64) * a_tail
        norm = np.sqrt(norm ** 2 + tail.astype(np.float64) ** 2)
    flips = assert_codes_match(got.numpy(), want, proj, norm)
    assert flips <= n * L // 1000         # reported: near-zero ties only


def test_hash_encode_pad_bits_probe_matches_pallas():
    """K4 probe: every projection positive, L=48 leaves 16 pad bits that
    must stay 0."""
    x, A = np.ones((3, 8), np.float32), np.ones((8, 48), np.float32)
    want = jops.hash_encode(jnp.asarray(x), jnp.asarray(A), impl="pallas")
    got = ops.hash_encode(t(x), t(A), impl="ref").numpy()
    np.testing.assert_array_equal(got, u32_to_i32(want))
    assert not (got[:, -1].view(np.uint32) >> 16).any()


# -- hamming_scan -----------------------------------------------------------


@pytest.mark.parametrize("w", [1, 2, 3])
def test_hamming_scan_matches_reference(w):
    rng = np.random.default_rng(10 + w)
    q, db = _codes(rng, 17, w), _codes(rng, 300, w)
    q[0] = 2 ** 31                        # top bit set, negative as int32
    want = jops.hamming_scan(jnp.asarray(q), jnp.asarray(db), impl="ref")
    got = ops.hamming_scan(t(u32_to_i32(q)), t(u32_to_i32(db)), impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hamming_scan_probe_below_tile_matches_pallas():
    q, db = jops._codes(3, 2), jops._codes(70, 2)
    want = jops.hamming_scan(q, db, impl="pallas")
    got = ops.hamming_scan(t(u32_to_i32(q)), t(u32_to_i32(db)), impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- bucket_gather ----------------------------------------------------------


def test_bucket_gather_matches_reference():
    rng = np.random.default_rng(20)
    cum, starts, total = make_runs(rng, 12, 30, 1000)
    want = jops.bucket_gather(jnp.asarray(cum), jnp.asarray(starts), total,
                              impl="ref")
    got = ops.bucket_gather(t(cum), t(starts), total, impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bucket_gather_probe_matches_pallas():
    q, s, p = 3, 4, 7
    cum = np.concatenate([np.zeros((q, 1), np.int32),
                          np.cumsum(np.full((q, s), 2, np.int32), 1)], 1)
    starts = (17 * np.arange(q * s, dtype=np.int32)).reshape(q, s)
    want = jops.bucket_gather(jnp.asarray(cum), jnp.asarray(starts), p,
                              impl="pallas")
    got = ops.bucket_gather(t(cum), t(starts), p, impl="ref")
    assert got.shape == (q, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- fused_query --------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_query_matches_reference(quantized):
    # one seed for both arms: shared shapes, so the reference compiles less
    rng = np.random.default_rng(30)
    n, d, q, k = 600, 16, 9, 5
    items = (rng.standard_normal((n, d))
             * np.exp(rng.standard_normal((n, 1)))).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    cum, starts, total = make_runs(rng, q, 24, n)
    kw_j, kw_t = {}, {}
    if quantized:
        pay, sc = _jax_quantize(items)
        kw_j = {"payload": jnp.asarray(pay), "scale": jnp.asarray(sc)}
        kw_t = {"payload": t(pay), "scale": t(sc)}
    wv, wp = jops.fused_query(jnp.asarray(queries), jnp.asarray(cum),
                              jnp.asarray(starts), jnp.asarray(items),
                              total, k, impl="ref", **kw_j)
    gv, gp = ops.fused_query(t(queries), t(cum), t(starts), t(items), total,
                             k, impl="ref", **kw_t)
    assert_topk_tie_aware(gp.numpy(), gv.numpy(), wp, wv)


def _jax_quantize(items):
    from repro.core.engine import quantize_payload
    pay, sc = quantize_payload(jnp.asarray(items))
    return np.asarray(pay), np.asarray(sc)


def test_fused_query_poison_and_int8_probes_match_pallas():
    """K4 probes: an unprobed poison row 0 must never surface; per-item
    scales 2^i/127 must ride the gather in the int8 arm."""
    q, n, d, k = 3, 8, 4, 4
    queries = np.ones((q, d), np.float32)
    items = (np.arange(n * d, dtype=np.float32) / (n * d)).reshape(n, d)
    items[0] = 100.0
    cum = np.tile(np.asarray([[0, 2, 4]], np.int32), (q, 1))
    starts = np.asarray([[2, 6], [4, 1], [6, 3]], np.int32)
    pay = np.ones((n, d), np.int8)
    sc = (2.0 ** np.arange(n, dtype=np.float32))[:, None] / 127.0
    for kw in ({}, {"payload": pay, "scale": sc}):
        wv, wp = jops.fused_query(
            jnp.asarray(queries), jnp.asarray(cum), jnp.asarray(starts),
            jnp.asarray(items), 4, k, impl="pallas",
            **{a: jnp.asarray(b) for a, b in kw.items()})
        gv, gp = ops.fused_query(t(queries), t(cum), t(starts), t(items), 4,
                                 k, impl="ref",
                                 **{a: t(b) for a, b in kw.items()})
        assert not (gp.numpy() == 0).any()
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-4,
                                   rtol=1e-5)


# -- bucket_match, delta_scan, mips_topk --------------------------------------


def _top_bit_codes(rng, n, w):
    c = _codes(rng, n, w)
    c[::2, 0] |= np.uint32(2 ** 31)        # negative in the int32 view
    return c


@pytest.mark.parametrize("q,c,w", [(8, 64, 1), (37, 130, 2), (64, 128, 4),
                                   (1, 1, 1)])
def test_bucket_match_and_delta_scan_match_pallas(q, c, w):
    """The streaming tests' shapes, words with bit 31 set: the plain
    versions equal the Pallas kernels (interpret mode) exactly."""
    rng = np.random.default_rng(100 + c)
    qc, dc = _top_bit_codes(rng, q, w), _top_bit_codes(rng, c, w)
    live = rng.random(c) < 0.5
    hash_bits = 32 * w - 3
    want = jops.bucket_match(jnp.asarray(qc), jnp.asarray(dc), hash_bits,
                             impl="pallas")
    got = ops.bucket_match(t(u32_to_i32(qc)), t(u32_to_i32(dc)), hash_bits,
                           impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # live as bool, uint8 and int32 (nonzero = live), each held to the
    # Pallas kernel given the same array
    for dtype in (np.bool_, np.uint8, np.int32):
        lv = (live.astype(dtype) if dtype == np.bool_
              else live.astype(dtype) * 3)
        want = jops.delta_scan(jnp.asarray(qc), jnp.asarray(dc),
                               jnp.asarray(lv), hash_bits, impl="pallas")
        got = ops.delta_scan(t(u32_to_i32(qc)), t(u32_to_i32(dc)), t(lv),
                             hash_bits, impl="auto")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[:, ~live] == -1).all()


# hamming.cu's wide kernel geometry: kThreads, kIPT, kQB
WIDE_THREADS, WIDE_IPT, WIDE_QB = 256, 4, 64


def _wide_scan_model(q_codes, db_codes, threads, ipt, qb):
    """hamming.cu's wide_scan_kernel in numpy: block (x, y) owns, in each
    of its rows q, the flat outputs [align8(qN + n0), align8(qN + n1))
    (the last row clipped at QN); thread p reads its items n0 + p + i,
    i < ipt + 7, into registers and takes register s_q + j for output j
    of row q; past the row's end, output f belongs to row q + 1 and item
    m = f - qN - N < 7 (staged codes). Rows of 7 items or fewer go to the
    narrow kernel, so N > 7 here.
    Returns (distances, writes per output, writing block per output, the
    first flat output of every 16-byte store)."""
    Q, W = q_codes.shape
    N = db_codes.shape[0]
    assert N > 7
    tile, total = threads * ipt, Q * N
    out = np.zeros(total, np.int64)
    writes = np.zeros(total, np.int64)
    owner = np.full(total, -1, np.int64)
    vector_starts = []

    def dist(rows, items):
        x = q_codes[rows] ^ db_codes[items]
        return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)

    def align8(x):
        return (x + 7) // 8 * 8

    p = np.arange(threads)[:, None] * ipt
    j = np.arange(ipt)[None, :]
    for x in range(-(-N // tile)):
        n0, n1 = x * tile, min(N, (x + 1) * tile)
        staged = n0 + p + np.arange(ipt + 7)[None, :]    # register items
        for y in range(-(-Q // qb)):
            for q in range(y * qb, min(Q, (y + 1) * qb)):
                row = q * N
                lo, hi = align8(row + n0), min(align8(row + n1), total)
                s = lo - row - n0
                assert 0 <= s <= 7
                f = lo + p + j
                own = f < hi
                n = f - row
                fast = own & (n < N)
                # register s + j holds item n0 + p + s + j: the output's own
                assert (staged[:, s:s + ipt][fast] == n[fast]).all()
                assert (n[fast] < min(N, n0 + tile + 7)).all()
                out[f[fast]] = dist(np.full(fast.sum(), q), n[fast])
                m = n - N
                nxt = own & ~fast
                assert (m[nxt] <= 6).all() and (q + 1 < Q or not nxt.any())
                out[f[nxt]] = dist(np.full(nxt.sum(), q + 1), m[nxt])
                np.add.at(writes, f[own], 1)
                owner[f[own]] = x * 100000 + y
                whole = own.all(1) & (n[:, -1] < N)
                vector_starts += [f[whole][:, k] for k in range(0, ipt, 4)]
    starts = np.concatenate(vector_starts) if vector_starts else np.zeros(0)
    return out.reshape(Q, N), writes, owner, starts.astype(np.int64)


def _wide_scan_model_checked(qc, db, threads, ipt, qb):
    """The model's distances, after checking that every output is written
    once, every 32-byte sector by one block (the output's last, partial
    sector included) and every 16-byte store at an aligned output."""
    got, writes, owner, starts = _wide_scan_model(qc, db, threads, ipt, qb)
    assert (writes == 1).all()
    assert (starts % 4 == 0).all()
    pad = (-owner.size) % 8
    sectors = np.concatenate([owner, np.full(pad, -1)]).reshape(-1, 8)
    assert ((sectors == sectors[:, :1]) | (sectors == -1)).all()
    return got


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("r", range(8))
def test_wide_scan_plan_owns_whole_sectors(r, w):
    """For N = r mod 8 (below one tile, one and two tiles plus a
    remainder), odd Q over up to four query groups and W words: every
    output is written once, no 32-byte sector by two blocks, every
    16-byte store is aligned, and the model's values equal hamming_ref
    (words with bit 31 set)."""
    rng = np.random.default_rng(160 + 8 * r + w)
    threads, ipt, qb = 4, 4, 2                  # 16-item tiles
    for N in (8 + r, 24 + r, 40 + r):
        for Q in (1, 3, 7):
            qc, db = _top_bit_codes(rng, Q, w), _top_bit_codes(rng, N, w)
            got = _wide_scan_model_checked(qc, db, threads, ipt, qb)
            want = ref.hamming_ref(t(u32_to_i32(qc)), t(u32_to_i32(db)))
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("r", [0, 5, 7])
def test_wide_scan_plan_at_the_kernel_geometry(r):
    """The kernel's own tile and query group: 65 rows (two groups) over a
    few tiles plus a remainder, N = r mod 8 (the path's item counts are
    5 and 7 mod 8, the directory's 0)."""
    rng = np.random.default_rng(170 + r)
    N, Q = 3 * WIDE_THREADS * WIDE_IPT + 16 + r, WIDE_QB + 1
    qc, db = _top_bit_codes(rng, Q, 1), _top_bit_codes(rng, N, 1)
    got = _wide_scan_model_checked(qc, db, WIDE_THREADS, WIDE_IPT, WIDE_QB)
    want = ref.hamming_ref(t(u32_to_i32(qc)), t(u32_to_i32(db)))
    np.testing.assert_array_equal(got, want.numpy())


def test_packed_scan_probes_match_pallas():
    """K4 probes: a directory far below the 512 tile, and a 5-slot delta
    whose dead slots must fuse to -1."""
    q, b = jops._codes(3, 1), jops._codes(21, 1)
    want = jops.bucket_match(q, b, 32, impl="pallas")
    got = ops.bucket_match(t(u32_to_i32(q)), t(u32_to_i32(b)), 32,
                           impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d = jops._codes(5, 1)
    live = np.asarray([True, False, True, False, True])
    want = jops.delta_scan(q, d, jnp.asarray(live), 32, impl="pallas")
    got = ops.delta_scan(t(u32_to_i32(q)), t(u32_to_i32(d)), t(live), 32,
                         impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("negative", [False, True])
def test_mips_topk_matches_pallas(negative):
    """Random rows, and the K4 probe's all-negative scores with k == N
    (a padded row must never surface): values within ATOL/RTOL, ids
    tie-aware."""
    if negative:
        queries = -3.0 * np.ones((3, 4), np.float32)
        items = 1.0 + np.arange(20, dtype=np.float32).reshape(5, 4) / 20
        k = 5
    else:
        rng = np.random.default_rng(110)
        queries = rng.standard_normal((9, 16)).astype(np.float32)
        items = rng.standard_normal((300, 16)).astype(np.float32)
        k = 7
    wv, wi = jops.mips_topk(jnp.asarray(queries), jnp.asarray(items), k,
                            impl="pallas")
    gv, gi = ops.mips_topk(t(queries), t(items), k, impl="ref")
    assert gi.dtype == torch.int32 and (gi.numpy() < items.shape[0]).all()
    assert_topk_tie_aware(gi.numpy(), gv.numpy(), wi, wv)


def test_mips_topk_ties_go_to_the_lower_id_like_the_reference():
    rng = np.random.default_rng(111)
    queries = rng.integers(-2, 3, (6, 8)).astype(np.float32)
    items = rng.integers(-2, 3, (400, 8)).astype(np.float32)   # exact dots
    wv, wi = jops.mips_topk(jnp.asarray(queries), jnp.asarray(items), 20,
                            impl="ref")
    gv, gi = ops.mips_topk(t(queries), t(items), 20, impl="ref")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_mips_topk_k_limits_raise_value_error():
    q, items = np.ones((2, 4), np.float32), np.ones((5, 4), np.float32)
    with pytest.raises(ValueError, match="must not exceed the item count"):
        jops.mips_topk(jnp.asarray(q), jnp.asarray(items), 6)
    with pytest.raises(ValueError, match="must not exceed the item count"):
        ops.mips_topk(t(q), t(items), 6)
    many = np.ones((300, 4), np.float32)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        ops.mips_topk(t(q), t(many), 257)


# -- validation and dispatch ------------------------------------------------


def _zero_size_calls():
    f, i = torch.float32, torch.int32
    return {
        "hash_encode": lambda: ops.hash_encode(torch.zeros((0, 4)),
                                               torch.zeros((4, 8))),
        "hamming_scan": lambda: ops.hamming_scan(
            torch.zeros((2, 0), dtype=i), torch.zeros((5, 0), dtype=i)),
        "bucket_gather": lambda: ops.bucket_gather(
            torch.zeros((2, 1), dtype=i), torch.zeros((2, 0), dtype=i), 3),
        "fused_query": lambda: ops.fused_query(
            torch.zeros((0, 4), dtype=f), torch.zeros((0, 3), dtype=i),
            torch.zeros((0, 2), dtype=i), torch.zeros((8, 4)), 4, 2),
        "bucket_match": lambda: ops.bucket_match(
            torch.zeros((2, 1), dtype=i), torch.zeros((0, 1), dtype=i), 32),
        "delta_scan": lambda: ops.delta_scan(
            torch.zeros((0, 1), dtype=i), torch.zeros((4, 1), dtype=i),
            torch.ones((4,), dtype=torch.bool), 32),
        "mips_topk": lambda: ops.mips_topk(torch.zeros((2, 4)),
                                           torch.zeros((0, 4)), 1),
    }


@pytest.mark.parametrize("op", ops.OPS)
def test_zero_size_inputs_raise_value_error(op):
    with pytest.raises(ValueError, match="zero-size"):
        _zero_size_calls()[op]()


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("case", MISMATCHED)
def test_mismatched_shapes_raise_value_error_on_every_impl(case, impl):
    """Arguments whose shapes disagree raise before any dispatch: the
    plain path too (it would have read the first d rows of a taller A)."""
    with pytest.raises(ValueError, match="must"):
        mismatched_shape_calls("cpu")[case](impl)


def _fused_args():
    queries = torch.ones((2, 4))
    cum = torch.tensor([[0, 2, 4]] * 2, dtype=torch.int32)
    starts = torch.tensor([[0, 4]] * 2, dtype=torch.int32)
    return queries, cum, starts, torch.ones((8, 4))


@pytest.mark.parametrize("kwargs,match", [
    ({"total": 4, "k": 5}, "must not exceed the planned probe width"),
    ({"total": 4, "k": 3, "kprime": 2}, "must be >= k"),
    ({"total": 4, "k": 2, "payload": torch.ones((8, 4), dtype=torch.int8)},
     "pass payload and scale together"),
    ({"total": 4, "k": 2, "scale": torch.ones((8, 1))},
     "pass payload and scale together"),
])
def test_fused_query_errors_match_reference(kwargs, match):
    args = _fused_args()
    with pytest.raises(ValueError, match=match):
        ops.fused_query(*args, **kwargs)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jkw = {a: jnp.asarray(b.numpy()) if isinstance(b, torch.Tensor) else b
           for a, b in kwargs.items()}
    with pytest.raises(ValueError, match=match):
        jops.fused_query(*jargs, **jkw)


def test_impl_cuda_on_cpu_tensors_raises_and_unknown_impl_raises():
    x, A = torch.ones((3, 4)), torch.ones((4, 8))
    with pytest.raises(ValueError, match="impl='cuda' needs"):
        ops.hash_encode(x, A, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.hash_encode(x, A, impl="pallas")


def test_auto_on_cpu_runs_plain_versions_and_launches_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(40)
    x = t(rng.standard_normal((20, 6)).astype(np.float32))
    A = t(rng.standard_normal((6, 9)).astype(np.float32))
    codes = ops.hash_encode(x, A)
    assert torch.equal(codes, ref.hash_encode_ref(x, A))
    ham = ops.hamming_scan(codes[:3], codes)
    assert torch.equal(ham, ref.hamming_ref(codes[:3], codes))
    cum = torch.tensor([[0, 3, 5]], dtype=torch.int32)
    starts = torch.tensor([[4, 10]], dtype=torch.int32)
    assert torch.equal(ops.bucket_gather(cum, starts, 5),
                       ref.bucket_gather_ref(cum, starts, 5))
    fv, fp = ops.fused_query(x[:1], cum, starts, x, 5, 2)
    rv, rp = ref.fused_query_ref(x[:1], cum, starts, x, 5, 2)
    assert torch.equal(fp, rp) and torch.equal(fv, rv)
    assert torch.equal(ops.bucket_match(codes[:3], codes, 9),
                       ref.bucket_match_ref(codes[:3], codes, 9))
    live = torch.arange(20) % 3 > 0
    assert torch.equal(ops.delta_scan(codes[:3], codes, live, 9),
                       ref.delta_scan_ref(codes[:3], codes, live, 9))
    mv, mi = ops.mips_topk(x[:3], x, 4)
    rv, ri = ref.mips_topk_ref(x[:3], x, 4)
    assert torch.equal(mi, ri) and torch.equal(mv, rv)
    plan = (torch.tensor([[1, 0], [0, 1]]), torch.tensor([0, 3, 5],
                                                         dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32),
            torch.tensor([2, 2], dtype=torch.int32))
    pc, ps = ops.planned_runs(*plan)
    rc, rs = ref.planned_runs_ref(*plan)
    assert torch.equal(pc, rc) and torch.equal(ps, rs)
    assert ops.launch_counts == {name: 0 for name in
                                 ops.KERNELS + ops.PORT_KERNELS}


# -- the CUDA kernels' launch plans and selection designs ---------------------
#
# fused_query.cu and mips_topk.cu split the selection across blocks and
# merge the blocks' lists in a second launch. The models below run that
# split-then-merge in plain torch, with the kernels' order rules, and must
# equal the plain versions exactly: the merges are the designs' correctness
# argument, and the card tests hold the kernels to the same outputs.


def test_fused_query_plan_sizes_spans_and_scratch():
    span = ops.FUSED_SPAN
    plan = ops.fused_query_plan(64, 73136, 150, 40)
    assert plan.nspan == -(-73136 // span) and plan.kb == 40
    assert plan.lists == (64, plan.nspan, 40)
    assert plan.counts == (64, plan.nspan)
    assert 64 * plan.nspan > 1000           # enough blocks for 132 SMs
    one = ops.fused_query_plan(1, 2 * span, 4, span + 1000)
    assert (one.nspan, one.kb) == (2, span)    # a list never outgrows a span
    assert ops.fused_query_plan(3, span + 1, 4, 4).nspan == 2
    assert plan.span_smem == 4 * (2 * (span + span // 32) + 3 * 40)
    assert plan.group == plan.nspan            # every list staged at once
    assert plan.merge_smem == 4 * (6 * 40 + (3 * 40 + 1) * plan.nspan)
    assert one.group == 1


@pytest.mark.parametrize("d,kprime", [(8192, 9000), (150, 20000)])
def test_fused_query_plan_guard_raises_value_error(d, kprime):
    with pytest.raises(ValueError, match="fused_query: d="):
        ops.fused_query_plan(4, 30000, d, kprime)


@pytest.mark.parametrize("q,n,bps,sms", [(64, 2341909, 4, 132),
                                         (70, 3001, 3, 132), (1, 5, 4, 1),
                                         (200, 1000, 1, 2)])
def test_mips_topk_plan_covers_the_items_in_whole_tiles(q, n, bps, sms):
    per_block, nblk = ops.mips_topk_plan(q, n, bps, sms)
    assert per_block % ops.MIPS_ITEM_TILE == 0
    assert (nblk - 1) * per_block < n <= nblk * per_block
    qtiles = -(-q // ops.MIPS_QUERY_TILE)
    assert nblk <= max(1, bps * sms // qtiles)


def _better(a, b):
    """(score desc, id asc): a = (score, id) comes before b."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_sorted(run, inc, width):
    """The fused merge kernel's step: each entry's place is its index plus
    the count of entries of the other list that beat it."""
    out = [None] * width
    for own, other in ((run, inc), (inc, run)):
        for i, e in enumerate(own):
            rank = i + sum(_better(o, e) for o in other)
            if rank < width:
                out[rank] = e
    return [e for e in out if e is not None]


def _span_top(scores, slots, kb):
    """The span kernel's selection: every key above the kb-th largest, then
    the lowest slots equal to it (-0 keyed as +0), sorted by rank."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    cut = torch.sort(s, descending=True).values[kb - 1]
    gt = [(float(v), int(p)) for v, p in zip(s, slots) if v > cut]
    eq = [(float(v), int(p)) for v, p in zip(s, slots) if v == cut]
    picked = gt + eq[:kb - len(gt)]
    return sorted(picked, key=lambda e: (-e[0], e[1]))


def _split_merge_fused(queries, cum, starts, items, total, k, kprime, span,
                       payload=None, scale=None):
    """fused_query.cu's design in plain torch: per-span top-k' lists of
    (phase-1 score, slot), merged two sorted lists at a time, rescored on
    the f32 rows, ordered by (rescored desc, survivor index asc)."""
    if payload is None:
        payload, scale = items, torch.ones((items.shape[0], 1))
    pos = ref.bucket_gather_ref(cum, starts, total)
    vals, out = [], []
    for q in range(queries.shape[0]):
        tot = min(int(cum[q, -1]), total)
        rows = payload[pos[q, :tot].long()].float() * scale[pos[q, :tot]
                                                            .long()]
        s1 = torch.einsum("d,pd->p", queries[q], rows)
        run = []
        for p0 in range(0, tot, span):
            n = min(span, tot - p0)
            lst = _span_top(s1[p0:p0 + n], range(p0, p0 + n), min(kprime, n))
            run = _merge_sorted(run, lst, kprime)
        surv = [int(pos[q, p]) for _, p in run]
        surv += [-1] * (kprime - len(surv))
        resc = torch.full((kprime,), ref.NEG)
        ok = torch.tensor(surv) >= 0
        resc[ok] = torch.einsum("d,pd->p", queries[q],
                                items[torch.tensor(surv)[ok].long()])
        order = torch.sort(resc, descending=True, stable=True).indices[:k]
        vals.append(resc[order])
        out.append(torch.tensor(surv)[order])
    return torch.stack(vals), torch.stack(out).to(torch.int32)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("span,kprime", [(7, 12), (16, 5), (5, 40),
                                         (32, 8)])
def test_split_merge_selection_equals_fused_query_ref(span, kprime,
                                                      quantized):
    """Random runs, rows with planted duplicates (exact phase-1 ties, some
    across span boundaries), one query whose takes stop short of total;
    k = k' so every survivor, ties at a span's cut included, is compared."""
    rng = np.random.default_rng(120 + span)
    n, d, q, k = 300, 4, 5, kprime
    items = rng.integers(-1, 2, (n, d)).astype(np.float32)
    items[rng.integers(0, n, 60)] = items[rng.integers(0, n, 60)]
    queries = rng.integers(-1, 2, (q, d)).astype(np.float32)
    cum, starts, _ = make_runs(rng, q, 20, n)
    cum[0] //= 8                  # query 0 ends early: NEG survivors at -1
    total = int(cum[1:, -1].min())
    cum, starts, items, queries = t(cum), t(starts), t(items), t(queries)
    kw = {}
    if quantized:
        pay = rng.integers(-127, 128, (n, d)).astype(np.int8)
        kw = {"payload": t(pay), "scale": t(np.full((n, 1), 0.5, np.float32))}
    wv, wp = ref.fused_query_ref(queries, cum, starts, items, total, k,
                                 kprime=kprime, **kw)
    gv, gp = _split_merge_fused(queries, cum, starts, items, total, k,
                                kprime, span, **kw)
    assert int(cum[0, -1]) < total
    assert torch.equal(gp, wp) and torch.equal(gv, wv)


def _chunked_mips_topk(scores, k, per_block, tile=128, seed=0):
    """mips_topk.cu's design: each item chunk keeps a running sorted top-k
    fed tile by tile (a tile's candidates are the scores that beat the
    list's last entry as the tile starts, or all while the list is not
    full, inserted in an arbitrary order); a second pass takes the k best
    of the chunks' lists."""
    rng = np.random.default_rng(seed)
    nq, n = scores.shape
    vals, ids = [], []
    for q in range(nq):
        lists = []
        for b0 in range(0, n, per_block):
            lst = []
            for t0 in range(b0, min(n, b0 + per_block), tile):
                full = len(lst) == k
                last = lst[-1] if full else None
                cand = [(float(scores[q, i]), i)
                        for i in range(t0, min(n, b0 + per_block, t0 + tile))]
                cand = [e for e in cand if not full or _better(e, last)]
                for j in rng.permutation(len(cand)):
                    e = cand[j]
                    if len(lst) == k and not _better(e, lst[-1]):
                        continue
                    lst = sorted(lst + [e], key=lambda x: (-x[0], x[1]))[:k]
            lists.append(lst)
        merged = sorted((e for lst in lists for e in lst),
                        key=lambda x: (-x[0], x[1]))[:k]
        vals.append([v for v, _ in merged])
        ids.append([i for _, i in merged])
    return torch.tensor(vals), torch.tensor(ids)


@pytest.mark.parametrize("per_block,k", [(128, 5), (256, 40), (512, 3)])
def test_chunked_mips_topk_equals_stable_topk(per_block, k):
    """Integer scores with many exact ties, a copy of the best rows in
    another chunk: equal to stable_topk id for id."""
    rng = np.random.default_rng(130 + k)
    n = 1100                                   # not a multiple of the tile
    scores = rng.integers(-6, 7, (3, n)).astype(np.float32)
    scores[:, n - 10:] = scores[:, :10]        # ties across two chunks
    scores[0, :] = 1.0                         # one row all tied
    wv, wi = ref.stable_topk(t(scores), k)
    gv, gi = _chunked_mips_topk(t(scores), k, per_block)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


# -- bucket_gather.cu's span expansion, modelled ------------------------------
#
# The kernel maps a span of threads * per slots: two warp searches bracket
# the span's live slots, each thread binary-searches its first slot's run
# inside the bracket and walks forward, galloping past a run's end; slots
# at or past cum[q, S] take run S-1. The model runs the same searches (with
# their loads recorded) and the same store plan, and must equal the plain
# version exactly.

# bucket_gather.cu's geometry: kThreads, kPer
GATHER_THREADS, GATHER_PER = 256, 8


def _find_run_model(c, S, p):
    """run_search.cuh find_run: the 32-way warp search (lane 31's probe,
    hi - 1, always holds)."""
    lanes = np.arange(32)
    lo, hi = 0, S
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        hit = c[np.minimum(lo + (lanes + 1) * step - 1, hi - 1) + 1] > p
        assert hit[31]
        first = int(np.argmax(hit))
        i_first = min(lo + (first + 1) * step - 1, hi - 1)
        lo = lo + first * step
        hi = i_first + 1
    i = lo + lanes
    hit = (i < hi) & (c[np.minimum(i, hi - 1) + 1] > p)
    assert hit.any()
    return lo + int(np.argmax(hit))


def _run_in_model(c, p, lo, hi, loads):
    while hi - lo > 1:
        mid = (lo + hi - 1) >> 1
        loads.append(mid + 1)
        if c[mid + 1] > p:
            hi = mid + 1
        else:
            lo = mid + 1
    return lo


def _gallop_model(c, p, lo, hi, loads):
    step = 1
    while lo + step < hi:
        loads.append(lo + step)
        if c[lo + step] > p:
            break
        lo += step
        step <<= 1
    return _run_in_model(c, p, lo, min(lo + step, hi), loads)


def _gather_model(cum, starts, P, threads, per):
    """bucket_gather.cu in Python. Returns (positions as int32, writes per
    output, the first slot of every 16-byte store, the loads of every
    gallop)."""
    Q, S = starts.shape
    span = threads * per
    vec = P % 4 == 0
    out = np.zeros((Q, P), np.int64)
    writes = np.zeros((Q, P), np.int64)
    vector_starts, gallops = [], []
    for q in range(Q):
        c, st = cum[q].astype(np.int64), starts[q].astype(np.int64)
        for p0 in range(0, P, span):
            n = min(span, P - p0)
            nl = max(0, min(n, int(c[S]) - p0))
            stage = np.zeros(n, np.int64)
            if nl > 0:
                j0 = _find_run_model(c, S, p0)
                j1 = _find_run_model(c, S, p0 + nl - 1) + 1
                loads = []                # cum entries the walks read
                for x0 in range(0, nl, per):
                    j = _run_in_model(c, p0 + x0, j0, j1, loads)
                    hi, base = c[j + 1], st[j] - c[j]
                    loads += [j, j + 1]
                    for x in range(x0, min(x0 + per, nl)):
                        if p0 + x >= hi:
                            steps = []
                            j = _gallop_model(c, p0 + x, j + 1, j1, steps)
                            gallops.append(steps)
                            hi, base = c[j + 1], st[j] - c[j]
                            loads += steps + [j, j + 1]
                        stage[x] = base + p0 + x
                assert j0 <= min(loads) and max(loads) <= j1
            stage[nl:] = st[S - 1] - c[S - 1] + p0 + np.arange(nl, n)
            if vec:
                assert n % 4 == 0
                vector_starts += list(range(q * P + p0, q * P + p0 + n, 4))
            out[q, p0:p0 + n] = stage
            writes[q, p0:p0 + n] += 1
    wrapped = ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    return wrapped, writes, np.asarray(vector_starts, np.int64), gallops


def _gather_model_checked(cum, starts, P, threads=4, per=4):
    got, writes, vstarts, gallops = _gather_model(cum, starts, P, threads,
                                                  per)
    assert (writes == 1).all()
    assert (vstarts % 4 == 0).all()
    want = ref.bucket_gather_ref(t(cum), t(starts), P).numpy()
    np.testing.assert_array_equal(got, want)
    return got, gallops


def _gather_case(kind, rng, q):
    """(cum, starts, P) of one run layout."""
    if kind == "dense":                   # every run non-empty, 1..3 slots
        sizes = rng.integers(1, 4, (q, 400))
    elif kind == "sparse":                # stretches of ~200 empty runs
        sizes = np.where(rng.random((q, 3000)) < 0.005,
                         rng.integers(1, 40, (q, 3000)), 0)
    else:                                 # long runs: spans straddle them
        sizes = rng.integers(0, 60, (q, 30))
    cum = np.concatenate([np.zeros((q, 1), np.int64),
                          np.cumsum(sizes, 1)], 1).astype(np.int32)
    starts = rng.integers(0, 10 ** 6, sizes.shape).astype(np.int32)
    return cum, starts, int(cum[:, -1].min())


@pytest.mark.parametrize("kind", ["dense", "sparse", "long"])
@pytest.mark.parametrize("extra", [0, 3, 37])
def test_gather_span_model_equals_plain(kind, extra):
    """Spans of 16 slots over dense, sparse and long runs; P = the
    smallest total (a multiple of 4 or not) plus `extra` slots past it,
    so some queries' tails take the clamped run S-1. Every output once,
    16-byte stores aligned, positions equal to the plain version."""
    rng = np.random.default_rng(300 + len(kind) + extra)
    cum, starts, total = _gather_case(kind, rng, 3)
    got, gallops = _gather_model_checked(cum, starts, total + extra)
    if kind == "dense":                   # the next run costs one load
        assert gallops and max(len(g) for g in gallops) <= 1
    if kind == "sparse":                  # ~200 empty runs in a few loads
        assert max(len(g) for g in gallops) <= 2 * 9 + 2


@pytest.mark.parametrize("P", [1, 5, 2047, 2048, 4100, 4103])
def test_gather_span_model_at_the_kernel_geometry(P):
    """The kernel's 2,048-slot spans: P below one span, one span, and two
    spans plus a remainder, a multiple of 4 or not; totals below P on one
    query. Against the JAX reference too."""
    rng = np.random.default_rng(310 + P)
    sizes = np.where(rng.random((2, 2500)) < 0.3,
                     rng.integers(1, 12, (2, 2500)), 0)
    sizes[1, ::2] = 0
    cum = np.concatenate([np.zeros((2, 1), np.int64),
                          np.cumsum(sizes, 1)], 1).astype(np.int32)
    starts = rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 2500), dtype=np.int64
                          ).astype(np.int32)  # sums wrap as int32 does
    got, _ = _gather_model_checked(cum, starts, P, GATHER_THREADS,
                                   GATHER_PER)
    want = jops.bucket_gather(jnp.asarray(cum), jnp.asarray(starts), P,
                              impl="ref")
    np.testing.assert_array_equal(got, np.asarray(want))


# -- hash_encode.cu's slabs, modelled -----------------------------------------
#
# A persistent grid of blocks whose warps each walk slabs of 4 * rows
# consecutive rows on their own (slab warp + warps * block, then strided
# by the grid's warps). A slab is one contiguous block of x, copied in
# 16-byte chunks when x's base is 16-byte aligned (the last words of a
# partial slab in 4-byte ones), else in 4-byte ones. A warp's lanes are 4
# bit groups x 8 row groups: lane 4 h + g holds `rows` rows of group h and
# bits g + 4 i (i < KB: 7 when L <= 28, else 8) of each word, summing in k
# order without FMA; one ballot per row and bit slot gathers the signs,
# and lane l packs row l's word. The model runs that mapping over a
# float32 storage buffer with numpy's rounded f32 ops.

ENCODE_BIT_GROUPS, ENCODE_ROW_GROUPS = 4, 8


def _encode_model(storage, offset, N, d, A, tail, a_tail, rows, warps,
                  blocks):
    """hash_encode.cu in numpy; x is storage[offset: offset + N d] (the
    buffer's base counts as 16-byte aligned). Returns (codes as int32,
    writes per output word, copies per x word, 16-byte copy sources)."""
    L = A.shape[1]
    W = -(-L // 32)
    G, H = ENCODE_BIT_GROUPS, ENCODE_ROW_GROUPS
    KB = 7 if L <= 28 else 8
    S = H * rows
    slabs = -(-N // S)
    aligned = offset % 4 == 0
    As = np.zeros((d, 32 * W), np.float32)
    As[:, :L] = A
    ats = np.zeros(32 * W, np.float32)
    ats[:L] = a_tail
    out = np.zeros((N, W), np.uint32)
    writes = np.zeros((N, W), np.int64)
    copies = np.zeros(N * d, np.int64)
    chunk_src = []
    g, i = np.arange(G)[:, None], np.arange(KB)[None, :]
    shift = (G * np.arange(H)[:, None] + np.arange(G)[None, :]
             ).astype(np.uint64)                       # ballot bit of (h, g)
    for blk in range(blocks):
        for w in range(warps):
            for sl in range(blk * warps + w, slabs, blocks * warps):
                w0 = sl * S
                words = min(S, N - w0) * d
                src = offset + w0 * d
                buf = np.full(S * d, np.nan, np.float32)
                if aligned:
                    chunk_src += list(range(src, src + words // 4 * 4, 4))
                buf[:words] = storage[src:src + words]
                copies[w0 * d:w0 * d + words] += 1
                xr = buf.reshape(H, rows, d)           # group h's rows
                row = w0 + np.arange(S).reshape(H, rows)
                live = row < N
                tr = np.where(live, tail[np.minimum(row, N - 1)], 0
                              ).astype(np.float32)
                for v in range(W):
                    b = 32 * v + g + G * i             # (G, KB): lane g's bits
                    acc = np.zeros((H, rows, G, KB), np.float32)
                    for k in range(d):
                        acc = acc + xr[:, :, k, None, None] * As[k, b]
                    proj = acc + tr[:, :, None, None] * ats[b]
                    sign = live[:, :, None, None] & (b < L) & (proj >= 0)
                    # ballot (r, i): bit 4 h + g is lane (g, h)'s sign
                    vote = (sign.transpose(1, 3, 0, 2).astype(np.uint64)
                            << shift).sum((2, 3))      # (rows, KB)
                    for lane in range(min(S, N - w0)):
                        hp, r = min(lane // rows, H - 1), lane % rows
                        word = sum(((int(vote[r, s]) >> (G * hp)) & 0xF)
                                   << (G * s) for s in range(KB))
                        out[w0 + lane, v] = word
                        writes[w0 + lane, v] += 1
    return out.view(np.int32), writes, copies, np.asarray(chunk_src)


@pytest.mark.parametrize("L", [27, 48, 64, 96])
@pytest.mark.parametrize("N,d,rows,warps,blocks,row_offset", [
    (1, 24, 1, 1, 1, 0),         # one row
    (37, 24, 1, 2, 3, 0),        # N not a multiple of the 4-row slab
    (37, 24, 1, 2, 3, 1),        # a view one row in: still 16-byte aligned
    (45, 30, 2, 3, 2, 1),        # one row in, 120 bytes: 4-byte copies
    (70, 33, 2, 2, 2, 0),        # odd d: slabs end mid-chunk
    (70, 33, 1, 4, 1, 1),        # odd d, one row in
    (300, 16, 4, 3, 2, 0),       # 4 rows a thread, a partial 32-row slab
])
def test_encode_slab_model_equals_plain(L, N, d, rows, warps, blocks,
                                        row_offset):
    """Every x word copied once (16-byte chunks at 16-byte sources when
    the view is aligned), every output word written once, codes equal to
    the plain version bit for bit, pad bits zero; a near-zero projection
    planted (a row on a bit's null space, tail 0)."""
    rng = np.random.default_rng(320 + N + d + L)
    x = (rng.standard_normal((N, d)) / 4).astype(np.float32)
    A = rng.standard_normal((d, L)).astype(np.float32)
    tail = rng.random(N).astype(np.float32)
    if N > 2:                            # row 1's bit 0 projects to ~0
        x[1] = x[2] - (x[2] @ A[:, 0]) / (A[:, 0] @ A[:, 0]) * A[:, 0]
        tail[1] = 0.0
    a_tail = rng.standard_normal(L).astype(np.float32)
    storage = np.zeros((N + row_offset) * d + 3, np.float32)
    storage[row_offset * d:(row_offset + N) * d] = x.ravel()
    got, writes, copies, chunks = _encode_model(
        storage, row_offset * d, N, d, A, tail, a_tail, rows, warps, blocks)
    assert (writes == 1).all() and (copies == 1).all()
    assert (chunks % 4 == 0).all()
    S = 8 * rows
    assert chunks.size == (0 if (row_offset * d) % 4 else
                           sum(min(S, N - w0) * d // 4
                               for w0 in range(0, N, S)))
    want = ref.hash_encode_ref(t(x), t(A), t(tail), t(a_tail)).numpy()
    np.testing.assert_array_equal(got, want)
    if L % 32:
        assert not (got[:, -1].view(np.uint32) >> (L % 32)).any()


def test_encode_slab_model_matches_the_jax_reference():
    """The model through the JAX reference: equal bits away from zero."""
    rng = np.random.default_rng(330)
    N, d, L = 150, 33, 27
    x = (rng.standard_normal((N, d)) / 8).astype(np.float32)
    A = rng.standard_normal((d, L)).astype(np.float32)
    tail = np.sqrt(np.maximum(0.0, 1 - (x * x).sum(1))).astype(np.float32)
    a_tail = rng.standard_normal(L).astype(np.float32)
    got, *_ = _encode_model(x.ravel(), 0, N, d, A, tail, a_tail, 2, 3, 2)
    want = jops.hash_encode(jnp.asarray(x), jnp.asarray(A),
                            jnp.asarray(tail), jnp.asarray(a_tail),
                            impl="ref")
    proj = x.astype(np.float64) @ A + tail[:, None].astype(np.float64) * \
        a_tail
    norm = np.sqrt((x.astype(np.float64) ** 2).sum(1) + tail.astype(
        np.float64) ** 2)
    assert_codes_match(got, want, proj, norm)


@pytest.mark.parametrize("N,rows,warps,blocks", [
    (1, 1, 8, 1), (64, 1, 8, 1), (256, 1, 8, 4), (8440, 1, 8, 132),
    (16880, 1, 16, 132), (16896, 2, 8, 132), (33792, 4, 8, 132),
    (2340373, 4, 11, 132)])
def test_hash_encode_plan_fills_the_sms(N, rows, warps, blocks):
    """Query batches (64 and 256 rows) one row a thread in 8-warp blocks;
    the build's 2.34 M rows 4 a thread, 11 warps (as many 32-row slabs of
    d = 150 as fit beside A) on each of 132 SMs."""
    plan = ops.hash_encode_plan(N, 150, 27, 132)
    assert (plan.rows, plan.warps, plan.blocks) == (rows, warps, blocks)
    assert plan.slab == 8 * rows and plan.slabs == -(-N // plan.slab)
    assert plan.smem == ops.hash_encode_smem(150, 27, rows, warps)
    assert plan.smem <= ops._SMEM_LIMIT
    assert plan.blocks * plan.warps >= min(plan.slabs, 132)


@pytest.mark.parametrize("L,d_max", [(27, 605), (32, 605), (48, 453),
                                     (64, 453), (96, 362)])
def test_hash_encode_plan_raises_past_the_shared_memory_limit(L, d_max):
    """The largest d whose A (padded to 32 W columns), a_tail and 8 warps'
    one-row slabs fit a block's shared memory keeps the resident design;
    one more goes to the tiled design, whose shared memory does not grow
    with d (so nothing raises, up to an LM's width of 8192)."""
    res = ops.hash_encode_plan(64, d_max, L, 132)
    assert res.layout is None and res.smem <= ops._SMEM_LIMIT
    assert res.smem == ops.hash_encode_smem(d_max, L, 1, 8)
    for d in (d_max + 1, 8192):
        tiled = ops.hash_encode_plan(64, d, L, 132)
        assert tiled.layout is not None
        assert tiled.smem == ops.hash_tile_smem(tiled.layout) <= 48 * 1024
