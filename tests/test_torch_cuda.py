"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes. Every test here needs a CUDA device and skips
without one; the file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Integer outputs must be equal; fused-query and mips_topk values within
atol 1e-4, rtol 1e-5 (f32 dots summed in another order), positions and
ids tie-aware.
``chip_smoke.py`` repeats the comparison at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (MISMATCHED, assert_topk_tie_aware,
                           make_directory, make_runs, mismatched_shape_calls)
from repro_torch.core.engine import quantize_payload
from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [27, 48, 64])
def test_hash_encode_and_hamming_kernels_equal_plain(cuda_device, L):
    rng = np.random.default_rng(50 + L)
    x = torch.as_tensor(rng.standard_normal((1000, 33)).astype(np.float32),
                        device=cuda_device)
    A = torch.as_tensor(rng.standard_normal((33, L)).astype(np.float32),
                        device=cuda_device)
    tail = torch.as_tensor(rng.random(1000).astype(np.float32),
                           device=cuda_device)
    a_tail = torch.as_tensor(rng.standard_normal(L).astype(np.float32),
                             device=cuda_device)
    codes = ops.hash_encode(x, A, tail, a_tail, impl="cuda")
    assert torch.equal(codes, ops.hash_encode(x, A, tail, a_tail,
                                              impl="ref"))
    assert not ((codes[:, -1].long() & 0xFFFFFFFF) >> (L % 32 or 32)).any()
    assert torch.equal(ops.hamming_scan(codes[:70], codes, impl="cuda"),
                       ops.hamming_scan(codes[:70], codes, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_gather_and_fused_kernels_equal_plain(cuda_device, quantized):
    rng = np.random.default_rng(60)
    n, d, q, k = 4000, 32, 16, 10
    items = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=cuda_device)
    queries = torch.as_tensor(rng.standard_normal((q, d)).astype(np.float32),
                              device=cuda_device)
    cum, starts, total = make_runs(rng, q, 300, n)
    cum = torch.as_tensor(cum, device=cuda_device)
    starts = torch.as_tensor(starts, device=cuda_device)
    assert torch.equal(ops.bucket_gather(cum, starts, total, impl="cuda"),
                       ops.bucket_gather(cum, starts, total, impl="ref"))
    kw = {}
    if quantized:
        payload, scale = quantize_payload(items)
        kw = {"payload": payload, "scale": scale}
    gv, gp = ops.fused_query(queries, cum, starts, items, total, k,
                             impl="cuda", **kw)
    wv, wp = ops.fused_query(queries, cum, starts, items, total, k,
                             impl="ref", **kw)
    assert_topk_tie_aware(gp.cpu().numpy(), gv.cpu().numpy(),
                          wp.cpu().numpy(), wv.cpu().numpy())


def _words(rng, n, w, device):
    """Random packed words, a third of them with bit 31 set (negative in
    the int32 view)."""
    u = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64)
    u[::3] |= np.uint64(2 ** 31)
    return torch.as_tensor(u.astype(np.uint32).view(np.int32), device=device)


# every row alignment N = r mod 8, below one 1,024-item wide tile and a few
# tiles plus a remainder, over one, two and three query groups
_ALIGNMENT_CASES = [(q, n, w) for r in range(8)
                    for q, w in [(1, 1), (63, 2), (64, 1), (65, 3), (130, 8)]
                    for n in (8 * 37 + r, 3 * 1024 + 8 * 5 + r)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,w", [(64, 1024, 1), (3, 70, 2), (65, 1031, 3)]
                         + _ALIGNMENT_CASES)
def test_bucket_match_and_delta_scan_kernels_equal_plain(cuda_device, q, n,
                                                         w):
    """hamming.cu's wide kernel (hamming_scan, bucket_match) and narrow
    kernel (delta_scan), words with bit 31 set; live as bool, uint8 and
    int32."""
    rng = np.random.default_rng(70 + n)
    qc, db = _words(rng, q, w, cuda_device), _words(rng, n, w, cuda_device)
    hash_bits = 32 * w - 5
    assert torch.equal(ops.hamming_scan(qc, db, impl="cuda"),
                       ops.hamming_scan(qc, db, impl="ref"))
    assert torch.equal(ops.bucket_match(qc, db, hash_bits, impl="cuda"),
                       ops.bucket_match(qc, db, hash_bits, impl="ref"))
    live = torch.as_tensor(rng.random(n) < 0.6, device=cuda_device)
    # a live slot holds the match count, which is negative where the
    # distance exceeds hash_bits (random words use all 32 bits a word)
    match = ops.bucket_match(qc, db, hash_bits, impl="ref")
    for lv in (live, live.to(torch.uint8), 7 * live.to(torch.int32)):
        got = ops.delta_scan(qc, db, lv, hash_bits, impl="cuda")
        assert torch.equal(got, ops.delta_scan(qc, db, lv, hash_bits,
                                               impl="ref"))
        assert bool((got[:, ~live] == -1).all())
        assert torch.equal(got[:, live], match[:, live])


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,w", [(3, 5, 1), (5, 3, 2), (65, 7, 1),
                                   (2, 1, 8), (5, 8, 1), (65, 9, 2),
                                   (3, 15, 8), (7, 301, 9), (66, 2053, 12)])
def test_packed_scans_equal_plain_at_short_rows_and_wide_codes(
        cuda_device, q, n, w):
    """Rows of 7 items or fewer and W > 8 words (the narrow kernel serves
    every scan), and the shortest rows the wide kernel takes (a block's
    span ends in the next row)."""
    rng = np.random.default_rng(230 + n + w)
    qc, db = _words(rng, q, w, cuda_device), _words(rng, n, w, cuda_device)
    hash_bits = 32 * w - 3
    assert torch.equal(ops.hamming_scan(qc, db, impl="cuda"),
                       ops.hamming_scan(qc, db, impl="ref"))
    assert torch.equal(ops.bucket_match(qc, db, hash_bits, impl="cuda"),
                       ops.bucket_match(qc, db, hash_bits, impl="ref"))
    live = torch.as_tensor(rng.random(n) < 0.5, device=cuda_device)
    assert torch.equal(ops.delta_scan(qc, db, live, hash_bits, impl="cuda"),
                       ops.delta_scan(qc, db, live, hash_bits, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d,k", [(64, 5000, 150, 10), (3, 5, 4, 5),
                                     (70, 3001, 33, 256), (1, 129, 7, 1)])
def test_mips_topk_kernel_equals_plain(cuda_device, q, n, d, k):
    rng = np.random.default_rng(80 + n)
    queries = torch.as_tensor(rng.standard_normal((q, d)).astype(np.float32),
                              device=cuda_device)
    items = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=cuda_device)
    if n == 5:                  # every score negative, k == N
        queries, items = -3.0 * queries.abs(), items.abs() + 1.0
    gv, gi = ops.mips_topk(queries, items, k, impl="cuda")
    wv, wi = ops.mips_topk(queries, items, k, impl="ref")
    assert bool(((gi >= 0) & (gi < n)).all())
    assert_topk_tie_aware(gi.cpu().numpy(), gv.cpu().numpy(),
                          wi.cpu().numpy(), wv.cpu().numpy())


@pytest.mark.cuda
def test_mips_topk_kernel_breaks_exact_ties_to_the_lower_id(cuda_device):
    """Small-integer rows give exact f32 dots with many equal scores:
    the kernel must pick the same ids as the plain version, slot by slot."""
    rng = np.random.default_rng(90)
    queries = torch.as_tensor(rng.integers(-2, 3, (40, 12)).astype(np.float32),
                              device=cuda_device)
    items = torch.as_tensor(rng.integers(-2, 3, (7000, 12)).astype(np.float32),
                            device=cuda_device)
    gv, gi = ops.mips_topk(queries, items, 50, impl="cuda")
    wv, wi = ops.mips_topk(queries, items, 50, impl="ref")
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.cuda
def test_auto_on_cuda_launches_the_kernels(cuda_device):
    ops.reset_launch_counts()
    x = torch.randn((64, 16), device=cuda_device)
    A = torch.randn((16, 27), device=cuda_device)
    codes = ops.hash_encode(x, A)
    ops.hamming_scan(codes[:8], codes)
    cum = torch.tensor([[0, 3, 5]], dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([[4, 10]], dtype=torch.int32, device=cuda_device)
    ops.bucket_gather(cum, starts, 5)
    ops.fused_query(x[:1], cum, starts, x, 5, 2)
    payload, scale = quantize_payload(x)
    ops.fused_query(x[:1], cum, starts, x, 5, 2, payload=payload, scale=scale)
    ops.bucket_match(codes[:8], codes, 27)
    ops.delta_scan(codes[:8], codes, torch.ones(64, dtype=torch.bool,
                                                device=cuda_device), 27)
    ops.mips_topk(x[:8], x, 3)
    rid = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    ops.planned_runs(torch.tensor([[1, 0]], device=cuda_device), cum[0], rid,
                     rid[:1] + 4)
    torch.cuda.synchronize()
    assert ops.launch_counts == {name: 1 for name in
                                 ops.KERNELS + ops.PORT_KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("q,b,r,caps,probe_like", [
    (1, 4096, 32, "half", True),         # one whole tile
    (3, 4095, 1, "half", False),         # one range, a tile less a slot
    (2, 4097, 64, "zero", True),         # R 64, a tile and a slot
    (1, 1, 1, "count", False),           # one bucket
    (5, 3 * 4096 + 77, 3, "above", False),
    (64, 136736, 32, "half", False),     # the served cell's shape, orders
                                         # that mix every range in a chunk
    (2, 9000, 1759, "half", False),      # the most ranges a block holds
])
def test_planned_runs_kernel_equals_plain(cuda_device, q, b, r, caps,
                                          probe_like):
    """The per-range take's kernel, bit for bit, at ragged row tails, one
    and many ranges, zero budgets and budgets at or above the counts."""
    rng = np.random.default_rng(600 + q + b + r)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in make_directory(rng, q, b, r, caps, probe_like)]
    got = ops.planned_runs(*args, impl="cuda")
    want = ops.planned_runs(*args, impl="ref")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_planned_runs_kernel_equals_plain_at_the_served_cell(cuda_device):
    """The served cell: 64 queries over a 136,736 x 300 catalogue with
    two clusters of norms, RANGE-LSH at code length 32 and m 32, the
    budgets a seeded plan gives at recall 0.9 and the served path's probe
    order."""
    import dataclasses

    from repro_torch.core import planner
    from repro_torch.core.engine import (_directory_order, check_budgets,
                                         engine_for)
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data.synthetic import make_dataset
    ds = make_dataset("yahoomusic", 5, n=136736, d=300, num_queries=64,
                      device=cuda_device)
    spec = IndexSpec(family="simple", code_len=32, m=32, scheme="percentile",
                     engine="fused", recall_target=0.9)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    idx = build(dataclasses.replace(spec, recall_target=None), ds.items, gen)
    idx = idx._replace(spec=spec, calib=planner.calibrate(idx, generator=gen))
    eng = engine_for(idx, engine="fused")
    budgets, _ = check_budgets(
        planner.resolve_budgets(idx.calib, 0.9, k=10).budgets,
        eng._range_counts)
    order = _directory_order(eng.buckets, eng._encode(ds.queries),
                             eng._match_fn)
    assert order.shape == (64, eng.buckets.num_buckets)
    args = (order, eng.buckets.bucket_start, eng.buckets.bucket_rid,
            torch.tensor(budgets, dtype=torch.int32, device=cuda_device))
    got = ops.planned_runs(*args, impl="cuda")
    want = ops.planned_runs(*args, impl="ref")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0][:, -1].min()) == sum(budgets)


@pytest.mark.cuda
def test_fused_engine_answers_unchanged_by_the_planned_runs_kernel(
        cuda_device):
    """A budgeted fused query launches planned_runs once and counts its
    dispatch once; its answers equal the fused kernel's on the plain
    version's runs bit for bit, and the all-plain engine's tie-aware."""
    from repro_torch.core.engine import (QueryEngine, _directory_order,
                                         check_budgets)
    from repro_torch.kernels import ref
    from repro_torch.obs import Tracker
    idx, queries = _small_index(cuda_device)
    eng = QueryEngine(idx, engine="fused")
    budgets, total = check_budgets((40, 30, 25, 20, 15, 10, 10, 10),
                                   eng._range_counts)
    tr = Tracker()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.set_dispatch_tracker(tr)
    try:
        vals, ids = eng.query(queries, 10, budgets=budgets)
    finally:
        ops.set_dispatch_tracker(None)
    torch.cuda.synchronize()
    assert ops.launch_counts["planned_runs"] == 1
    assert tr.counters["repro.kernels.dispatch.planned_runs.cuda"] == 1
    assert "repro.kernels.dispatch.planned_runs.ref" not in tr.counters
    order = _directory_order(eng.buckets, eng._encode(queries),
                             eng._match_fn)
    cum, starts = ref.planned_runs_ref(
        order, eng.buckets.bucket_start, eng.buckets.bucket_rid,
        torch.tensor(budgets, dtype=torch.int32, device=cuda_device))
    items_csr = eng._fused_arrays[0]
    pv, pos = ops.fused_query(queries, cum, starts, items_csr, total, 10,
                              impl="cuda")
    assert torch.equal(vals, pv)
    assert torch.equal(ids, eng.buckets.item_ids[pos])
    plain = QueryEngine(idx, engine="fused", impl="ref",
                        buckets=eng.buckets)
    wv, wi = plain.query(queries, 10, budgets=budgets)
    assert_topk_tie_aware(ids.cpu().numpy(), vals.cpu().numpy(),
                          wi.cpu().numpy(), wv.cpu().numpy())


@pytest.mark.cuda
def test_planned_runs_rejects_more_ranges_than_a_block_holds(cuda_device):
    args = [torch.as_tensor(a, device=cuda_device) for a in make_directory(
        np.random.default_rng(10), 2, 3000, 1760, "half")]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="must fit a block's shared memory"):
        ops.planned_runs(*args)
    assert not any(ops.launch_counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "cuda"])
@pytest.mark.parametrize("host", range(4))
def test_planned_runs_rejects_inputs_split_across_devices(cuda_device, impl,
                                                          host):
    """One input left on the CPU, the others on the card: ValueError
    before any launch."""
    args = [torch.as_tensor(a) for a in make_directory(
        np.random.default_rng(9), 2, 50, 3, "half")]
    args = [a if i == host else a.to(cuda_device)
            for i, a in enumerate(args)]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="needs every input on a CUDA"):
        ops.planned_runs(*args, impl=impl)
    assert not any(ops.launch_counts.values())


def _span_runs(rng, q, slots, n, short=False):
    """Runs over n rows whose takes reach ``slots`` (several spans of
    ``ops.FUSED_SPAN`` slots); with ``short``, query 0 takes fewer, so its
    tail slots are NEG at position -1."""
    cum, starts, total = make_runs(rng, q, slots // 4 + 200, n)
    assert total >= slots
    if short:
        cum[0] //= 3
    return cum, starts


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("q,slots,d,kprime,short", [
    (3, 3 * ops.FUSED_SPAN + 123, 150, None, False),  # ragged last span
    (2, ops.FUSED_SPAN + 1000, 33, "total", False),   # k' = total, odd d
    (1, 5000, 150, None, True),              # Q = 1, takes below total
    (65, 4500, 16, 64, True),                # Q = 65
])
def test_fused_query_span_kernel_equals_plain(cuda_device, quantized, q,
                                              slots, d, kprime, short):
    """Small-integer rows give exact f32 dots and ties everywhere, also at
    span boundaries: the f32 build must pick the plain version's positions
    slot for slot; the int8 build (dequantized rows, sums in another order)
    agrees tie-aware."""
    rng = np.random.default_rng(140 + q)
    n, k = 20000, 10
    items = rng.integers(-2, 3, (n, d)).astype(np.float32)
    queries = rng.integers(-2, 3, (q, d)).astype(np.float32)
    cum, starts = _span_runs(rng, q, slots, n, short)
    total = slots
    dev = cuda_device
    items_t, queries_t = (torch.as_tensor(a, device=dev)
                          for a in (items, queries))
    cum_t, starts_t = (torch.as_tensor(a, device=dev) for a in (cum, starts))
    kw = {"kprime": total if kprime == "total" else kprime}
    if quantized:
        payload, scale = quantize_payload(items_t)
        kw.update(payload=payload, scale=scale)
    gv, gp = ops.fused_query(queries_t, cum_t, starts_t, items_t, total, k,
                             impl="cuda", **kw)
    wv, wp = ops.fused_query(queries_t, cum_t, starts_t, items_t, total, k,
                             impl="ref", **kw)
    if quantized:
        assert_topk_tie_aware(gp.cpu().numpy(), gv.cpu().numpy(),
                              wp.cpu().numpy(), wv.cpu().numpy())
    else:
        assert torch.equal(gp, wp) and torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d,k,offset", [
    (8, 20000, 3, 10, 0),        # odd d: 4-byte copies; N not whole tiles
    (5, 20000, 150, 256, 0),     # the largest k
    (9, 4099, 150, 7, 1),        # a view 4 bytes off the pair alignment
    (4, 300000, 8, 10, 0),       # each block walks several item tiles
])
def test_mips_topk_kernel_exact_ties_across_blocks(cuda_device, q, n, d, k,
                                                   offset):
    """Small-integer rows, the first 300 copied to the end of the matrix
    (other item blocks): equal scores must go to the lower id, id for id."""
    rng = np.random.default_rng(150 + d)
    items = rng.integers(-2, 3, (n, d)).astype(np.float32)
    items[n - 300:] = items[:300]
    queries = rng.integers(-2, 3, (q, d)).astype(np.float32)
    flat = torch.zeros(n * d + offset, device=cuda_device)
    flat[offset:] = torch.as_tensor(items.ravel(), device=cuda_device)
    items_t = flat[offset:].view(n, d)
    queries_t = torch.as_tensor(queries, device=cuda_device)
    gv, gi = ops.mips_topk(queries_t, items_t, k, impl="cuda")
    wv, wi = ops.mips_topk(queries_t, items_t, k, impl="ref")
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.cuda
def test_launch_shapes_count_each_shape(cuda_device):
    ops.reset_launch_counts()
    x = torch.randn((64, 16), device=cuda_device)
    A = torch.randn((16, 27), device=cuda_device)
    ops.hash_encode(x, A)
    ops.hash_encode(x[:8], A)
    ops.hash_encode(x[8:16], A)
    torch.cuda.synchronize()
    assert ops.launch_counts["hash_encode"] == 3
    assert ops.launch_shapes[("hash_encode", (64, 16, 27, 1))] == 1
    assert ops.launch_shapes[("hash_encode", (8, 16, 27, 1))] == 2
    assert ops.last_shape["hash_encode"] == (8, 16, 27, 1)


def _encode_inputs(rng, n, d, L, device, row_offset=0, near_zero=False):
    """x (a view ``row_offset`` rows into its storage), A, tail, a_tail;
    with ``near_zero`` every third row is moved onto the null space of a
    bit's projection, with tail 0, so x @ A has entries within ~1e-6 of 0."""
    x = (rng.standard_normal((n, d)) / 4).astype(np.float32)
    A = rng.standard_normal((d, L)).astype(np.float32)
    tail = rng.random(n).astype(np.float32)
    if near_zero:
        for i in range(0, n, 3):
            a = A[:, i % L]
            x[i] -= (x[i] @ a) / (a @ a) * a
            tail[i] = 0.0
    flat = torch.zeros((n + row_offset) * d, device=device)
    flat[row_offset * d:] = torch.as_tensor(x.ravel(), device=device)
    return (flat[row_offset * d:].view(n, d),
            torch.as_tensor(A, device=device),
            torch.as_tensor(tail, device=device),
            torch.as_tensor(rng.standard_normal(L).astype(np.float32),
                            device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [27, 48, 64, 96])
@pytest.mark.parametrize("n,d,row_offset,near_zero", [
    (1, 150, 0, False),          # one row
    (64, 150, 0, True),          # a query batch, near-zero projections
    (256, 150, 1, False),        # a calibration batch, a view 600 B in
    (1037, 33, 0, True),         # odd d, N not a multiple of any tile
    (1037, 33, 1, False),        # odd d, a view one row in
    (40001, 150, 0, True),       # 4 rows a thread, warps walk slabs
    (40001, 150, 1, False),      # the same, 4-byte copies
    (40001, 151, 0, True),       # odd d: scalar row loads
    (40001, 151, 1, False),      # the same, a view one row in
])
def test_hash_encode_kernel_equals_plain(cuda_device, L, n, d, row_offset,
                                         near_zero):
    """hash_encode.cu bit for bit against the plain version (k-order sums
    without FMA): the rows a thread, warps and blocks the plan picks,
    views one row into their storage (slabs copied 4 bytes at a time),
    codes with pad bits zero."""
    rng = np.random.default_rng(400 + n + d + L)
    x, A, tail, a_tail = _encode_inputs(rng, n, d, L, cuda_device,
                                        row_offset, near_zero)
    got = ops.hash_encode(x, A, tail, a_tail, impl="cuda")
    assert torch.equal(got, ops.hash_encode(x, A, tail, a_tail, impl="ref"))
    if L % 32:
        assert not ((got[:, -1].long() & 0xFFFFFFFF) >> (L % 32)).any()


@pytest.mark.cuda
def test_hash_encode_kernel_raises_past_its_shared_memory(cuda_device):
    """d = 605 at L = 27 is the widest resident shape (A and 8 warps'
    slabs in shared memory); d = 606 and d = 1453 (past even one warp's
    slab) run the tiled design: nothing raises, and both designs equal
    the plain version."""
    rng = np.random.default_rng(450)
    for d in (605, 606, 1453):
        x = torch.as_tensor(rng.standard_normal((40, d)).astype(np.float32),
                            device=cuda_device)
        A = torch.as_tensor(rng.standard_normal((d, 27)).astype(np.float32),
                            device=cuda_device)
        assert torch.equal(ops.hash_encode(x, A, impl="cuda"),
                           ops.hash_encode(x, A, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [27, 60, 122, 256])
@pytest.mark.parametrize("d", [150, 768, 896, 1024, 2048, 2560, 4608, 5120,
                               8192])
@pytest.mark.parametrize("n", [37, 17001])
def test_hash_encode_kernel_equals_plain_at_lm_widths(cuda_device, n, d, L):
    """Every d_model of ``configs/`` (768 whisper, 896 internvl2, 1024,
    2048 xlstm, 2560 minicpm3, 4608, 5120 llama4, 8192 jamba) and L up to
    256 (W 1 to 8):
    d = 150 stays on the resident design, wider rows go to the tiled one,
    a few rows (one row and one bit a thread) and many (8 rows x 2, 4 or 8
    bits a thread; N ragged against the 128-row block). Codes equal the
    plain version bit for bit, pad bits zero."""
    rng = np.random.default_rng(460 + n + d + L)
    x, A, tail, a_tail = _encode_inputs(rng, n, d, L, cuda_device,
                                        near_zero=n < 100)
    plan = ops.hash_encode_plan(n, d, L, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert (plan.layout is None) == (d == 150)
    got = ops.hash_encode(x, A, tail, a_tail, impl="cuda")
    assert torch.equal(got, ops.hash_encode(x, A, tail, a_tail, impl="ref"))
    if L % 32:
        assert not ((got[:, -1].long() & 0xFFFFFFFF) >> (L % 32)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [150, 768, 1024, 5120, 8192])
def test_fused_query_kernel_equals_plain_at_lm_widths(cuda_device, d,
                                                      quantized):
    """The fused query at an LM's widths (the query's 512-column slices
    reloaded over d): small-integer rows give exact f32 dots, so the f32
    build equals the plain version slot for slot; the int8 build agrees
    tie-aware."""
    rng = np.random.default_rng(470 + d)
    n, q, k = 6000, 8, 10
    items = rng.integers(-2, 3, (n, d)).astype(np.float32)
    queries = rng.integers(-2, 3, (q, d)).astype(np.float32)
    cum, starts = _span_runs(rng, q, ops.FUSED_SPAN + 700, n, False)
    total = ops.FUSED_SPAN + 700
    items_t, queries_t = (torch.as_tensor(a, device=cuda_device)
                          for a in (items, queries))
    cum_t, starts_t = (torch.as_tensor(a, device=cuda_device)
                       for a in (cum, starts))
    kw = {}
    if quantized:
        payload, scale = quantize_payload(items_t)
        kw.update(payload=payload, scale=scale)
    gv, gp = ops.fused_query(queries_t, cum_t, starts_t, items_t, total, k,
                             impl="cuda", **kw)
    wv, wp = ops.fused_query(queries_t, cum_t, starts_t, items_t, total, k,
                             impl="ref", **kw)
    if quantized:
        assert_topk_tie_aware(gp.cpu().numpy(), gv.cpu().numpy(),
                              wp.cpu().numpy(), wv.cpu().numpy())
    else:
        assert torch.equal(gp, wp) and torch.equal(gv, wv)


def _gather_runs(rng, q, s, empty, most, device):
    """(cum, starts) of q queries over s runs, a fraction ``empty`` of them
    empty, the rest 1..``most`` slots; starts anywhere in int32 (sums
    wrap)."""
    sizes = rng.integers(1, most + 1, (q, s))
    sizes[rng.random((q, s)) < empty] = 0
    cum = np.concatenate([np.zeros((q, 1), np.int64),
                          np.cumsum(sizes, 1)], 1).astype(np.int32)
    starts = rng.integers(-2 ** 31, 2 ** 31 - 1, (q, s), dtype=np.int64
                          ).astype(np.int32)
    return (torch.as_tensor(cum, device=device),
            torch.as_tensor(starts, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("q,s,empty,most,P,extra", [
    (3, 400, 0.0, 3, None, 0),       # every run non-empty
    (3, 3000, 0.995, 3, None, 37),   # stretches of ~200 empty runs
    (2, 2500, 0.7, 3, 5, 0),         # P < 2,048, not a multiple of 4
    (2, 2500, 0.7, 3, 2047, 0),      # P < 2,048
    (2, 2500, 0.3, 3, 4100, 0),      # two spans and a remainder
    (2, 2500, 0.3, 3, 4103, 0),      # the same, P odd: 4-byte stores
    (64, 200000, 0.0, 1, 210000, 0),  # dense: one slot a run, 10,000
                                      # slots past every total (clamp)
    (64, 200000, 0.99, 3, None, 0),  # sparse: 99% of the runs empty
    (8, 30000, 0.1, 1, None, 0),     # a tenth of the runs empty
    (8, 30000, 0.2, 1, None, 0),     # a fifth
])
def test_bucket_gather_kernel_equals_plain(cuda_device, q, s, empty, most,
                                           P, extra):
    """bucket_gather.cu equal to the plain version at the span/bracket/
    gallop cases of the CPU model, at a dense shape with slots past every
    query's total and at a sparse one, and at one-slot runs with a tenth
    or a fifth of them empty; P None is the smallest total plus
    ``extra``."""
    rng = np.random.default_rng(500 + s + extra + (P or 0))
    cum, starts = _gather_runs(rng, q, s, empty, most, cuda_device)
    if P is None:
        P = int(cum[:, -1].min()) + extra
    got = ops.bucket_gather(cum, starts, P, impl="cuda")
    assert got.shape == (q, P)
    assert torch.equal(got, ops.bucket_gather(cum, starts, P, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "cuda"])
@pytest.mark.parametrize("case", MISMATCHED)
def test_mismatched_shapes_raise_before_any_launch(cuda_device, case, impl):
    call = mismatched_shape_calls(cuda_device)[case]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="must"):
        call(impl)
    assert not any(ops.launch_counts.values())


def _small_index(device):
    """A 3,000-item RANGE-LSH index (m 8, 16 bits) on ``device`` and 24
    queries."""
    from repro_torch.core.index import IndexSpec, build
    rng = np.random.default_rng(70)
    items = (rng.standard_normal((3000, 24))
             * np.exp(0.8 * rng.standard_normal((3000, 1)))).astype(
                 np.float32)
    queries = torch.as_tensor(rng.standard_normal((24, 24)).astype(
        np.float32), device=device)
    idx = build(IndexSpec(family="simple", code_len=16, m=8), items,
                torch.Generator(device=device).manual_seed(3),
                device=device)
    return idx, queries


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bucket", "dense", "fused", "fused_int8"])
def test_tracked_engine_equals_bare_on_the_card(cuda_device, arm):
    """A tracked engine returns the bare engine's results bit for bit on
    the card, records every stage span, and each op's ``.cuda`` dispatch
    count equals its launches (``fused_query``'s: both builds)."""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.obs import RingBufferSink, Tracker
    idx, queries = _small_index(cuda_device)
    quantized = arm == "fused_int8"
    eng = arm.split("_")[0]
    bare = QueryEngine(idx, engine=eng, quantized=quantized)
    tr = Tracker([RingBufferSink()])
    inst = QueryEngine(idx, engine=eng, quantized=quantized,
                       buckets=bare.buckets, tracker=tr)
    want = bare.query(queries, 10, 300)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.set_dispatch_tracker(tr)
    try:
        got = inst.query(queries, 10, 300)
    finally:
        ops.set_dispatch_tracker(None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert {"repro.engine.query", "repro.engine.hash_encode",
            "repro.engine.fused_query" if eng == "fused"
            else "repro.engine.re_rank"} <= set(tr.hists)
    launched = dict(ops.launch_counts)
    launched["fused_query"] += launched.pop("fused_query_int8")
    counted = {op: int(tr.counters.get(
        f"repro.kernels.dispatch.{op}.cuda", 0)) for op in launched}
    assert counted == launched
    assert not any(k.endswith(".ref") for k in tr.counters)


@pytest.mark.cuda
def test_span_sync_waits_for_the_stream_the_work_is_on(cuda_device):
    """A span's sync waits for the current stream of the registered
    tensor's device (a side stream here), so it ends after the work."""
    from repro_torch.obs import Tracker
    tr = Tracker()
    side = torch.cuda.Stream(device=cuda_device)
    a = torch.randn((2048, 2048), device=cuda_device)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        with tr.span("work") as sp:
            out = a
            for _ in range(8):
                out = out @ a
            assert sp.sync((out, [a])) is not None
        assert side.query()
    assert tr.hists["work"].count == 1


@pytest.mark.cuda
def test_legacy_bucket_query_launches_bucket_match(cuda_device):
    """The legacy RANGE-LSH shim's bucket engine matches the directory
    with bucket_match on the card and returns the spec API's ids."""
    from repro_torch.core import range_lsh
    from repro_torch.core.index import IndexSpec, build
    rng = np.random.default_rng(71)
    items = rng.standard_normal((3000, 24)).astype(np.float32)
    q = torch.as_tensor(rng.standard_normal((16, 24)).astype(np.float32),
                        device=cuda_device)
    idx = range_lsh.build(items, torch.Generator(device=cuda_device)
                          .manual_seed(4), 16, 8)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sv, si = range_lsh.query(idx, q, 10, 200, engine="bucket")
    assert ops.launch_counts["bucket_match"] == 1
    assert ops.launch_counts["hamming_scan"] == 0
    cidx = build(IndexSpec(family="simple", code_len=16, m=8,
                           engine="bucket"), items, params=idx.A)
    cv, ci = cidx.query(q, 10, 200)
    assert torch.equal(si, ci)


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or tree.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    "granite_moe_1b_a400m", "llama4_scout_17b_a16e", "jamba_1_5_large_398b",
    "minicpm3_4b", "xlstm_1_3b", "internvl2_1b", "whisper_small"])
def test_model_blocks_on_the_card_equal_the_cpu(cuda_device, arch):
    """Each family's blocks (MoE, MLA, Mamba, mLSTM and sLSTM, patches,
    the encoder-decoder) at ``reduced()`` size on the card against the same
    model on the CPU, f32 copies of one set of weights (TF32 off): prefill
    and two decode steps, hidden states within atol and rtol 1e-3 (f32
    sums in another order, through 2-16 layers)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import encdec, lm
    cfg = get_config(arch).reduced()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rng = np.random.default_rng(480)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))
    frames = torch.as_tensor((0.1 * rng.standard_normal(
        (2, cfg.encoder_frames, cfg.d_model))).astype(np.float32))
    patches = (0.1 * torch.ones((2, cfg.num_patches, cfg.d_model))
               if cfg.num_patches else None)
    runs = []
    for dev in ("cpu", cuda_device):
        p = _to(params, dev, torch.float32)
        t = toks.to(dev)
        if cfg.is_encoder_decoder:
            enc = encdec.encoder_forward(p["encoder"], frames.to(dev), cfg)
            caches = encdec.init_cache(cfg, 2, 20, device=dev)
            caches["cross_k"], caches["cross_v"] = encdec.cross_kv(
                p["layers"], enc, cfg)
            hs, start = [enc[:, -1]], 0
        else:
            h, caches = lm.prefill(p, t, cfg, None if patches is None
                                   else patches.to(dev))
            caches = lm.extend_cache(cfg, caches, 64)
            hs, start = [h], 16 + (cfg.num_patches if cfg.num_patches
                                   else 0)
        for step in range(2):
            h, caches = lm.decode_step(p, t[:, step], caches, start + step,
                                       cfg, logits_mode="none")
            hs.append(h)
        runs.append([x.float().cpu().numpy() for x in hs])
    for a, b in zip(*runs):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "granite_moe_1b_a400m",
                                  "internvl2_1b", "whisper_small"])
def test_train_steps_on_the_card_equal_the_cpu(cuda_device, arch):
    """Phase 9's step at ``reduced()`` size: two ``make_train_step`` steps
    on the card against the CPU from one f32 state (TF32 off), every
    param, moment and gradient on the card; loss, ce and aux within rtol
    1e-4, the global norm within 1e-3 (f32 sums in another order; a MoE
    combine's scatter order is not fixed on the card), params within 1e-5
    + 1e-2 x the lr summed so far (bf16 compression may round a gradient
    the other way)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch import train
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch).reduced()
    hp = train.TrainHParams(lr=1e-3, warmup=1, total_steps=10)
    state0 = train.init_state(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    state0 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                      state0)
    corpus = SyntheticCorpus(cfg.vocab, 16, device="cpu")
    batches = [train.stub_inputs(dict(corpus.sample(s, 0, 2)._asdict()),
                                 cfg) for s in range(2)]
    runs = []
    for dev in ("cpu", cuda_device):
        # a copy on each device: the step updates params in place
        state = tree_map(lambda t: t.to(dev, copy=True), state0)
        step = train.make_train_step(cfg, hp)
        ms = []
        for s, b in enumerate(batches):
            state, m = step(state, {k: v.to(dev) for k, v in b.items()}, s)
            ms.append({k: float(v) for k, v in m.items()})
        if dev != "cpu":
            _, _, grads = train.loss_and_grads(
                state.params, {k: v.to(dev) for k, v in batches[0].items()},
                cfg, hp)
            assert {t.device.type for t in leaves(state)} == {"cuda"}
            assert {t.device.type for t in leaves(grads)} == {"cuda"}
        runs.append((ms, [t.float().cpu() for t in leaves(state.params)]))
    (cpu_m, cpu_p), (gpu_m, gpu_p) = runs
    for a, b in zip(cpu_m, gpu_m):
        for k in ("loss", "ce", "aux", "lr"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(b["gnorm"], a["gnorm"], rtol=1e-3)
    lr_sum = sum(m["lr"] for m in cpu_m)
    for a, b in zip(cpu_p, gpu_p):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5 + 1e-2 * lr_sum)


@pytest.mark.cuda
def test_run_training_resumes_on_the_card(cuda_device, tmp_path):
    """Two ``make_train_step`` steps on the card saved as step 2: the
    restore (into a template of other values) equals the saved state bit
    for bit, on the card. ``run_training`` (no device named) resumes there
    and saves step 4, whose restore matches the crc32 the save wrote for
    each leaf."""
    import zlib

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch import train
    from repro_torch.tree import flatten_with_paths

    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8)

    cfg = get_config("qwen3_0_6b").reduced()
    hp = train.TrainHParams(lr=1e-3, warmup=1, total_steps=10)
    state = train.init_state(
        torch.Generator(device=cuda_device).manual_seed(0), cfg)
    step = train.make_train_step(cfg, hp)
    corpus = SyntheticCorpus(cfg.vocab, 16, device=cuda_device)
    for s in range(2):
        batch = train.stub_inputs(dict(corpus.sample(s, 0, 2)._asdict()),
                                  cfg)
        state, _ = step(state, batch, s)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    template = train.init_state(
        torch.Generator(device=cuda_device).manual_seed(9), cfg)
    restored = dict(flatten_with_paths(mgr.restore(2, template)))
    saved = flatten_with_paths(state)
    assert len(saved) == len(restored)
    for k, want in saved:
        got = restored[k]
        assert got.device.type == "cuda" and got.dtype == want.dtype, k
        assert torch.equal(raw(got), raw(want)), k
    seen = []
    train.run_training(cfg, hp, global_batch=2, seq_len=16, steps=4,
                       ckpt_dir=str(tmp_path), ckpt_every=2, log_every=1,
                       on_metrics=lambda s, m: seen.append(s))
    assert seen == [2, 3]
    digests = mgr.manifest(4)["leaves"]
    for k, got in flatten_with_paths(mgr.restore(4, template)):
        assert got.device.type == "cuda", k
        crc = zlib.crc32(raw(got).cpu().numpy().tobytes())
        assert crc == digests.pop(k)["crc32"], k
    assert not digests


@pytest.mark.cuda
def test_contracts_hold_on_the_card(cuda_device):
    """The dtype and plan-memo contracts through the entry points on the
    card, which launch the CUDA kernels there."""
    from repro_torch.analysis import contracts
    ops.reset_launch_counts()
    report = contracts.run_contracts(device=cuda_device)
    assert [f.format() for f in report.findings] == []
    assert report.stats["device"] == "cuda"
    assert report.stats["distributed_plans"] == (
        report.stats["distributed_classes"]
        + report.stats["distributed_planned_classes"])
    for kernel in ("hash_encode", "bucket_match", "delta_scan"):
        assert ops.launch_counts[kernel] > 0, kernel


@pytest.mark.cuda
def test_lint_kernels_and_contracts_exit_0_on_the_card(cuda_device, capsys):
    """``python -m repro_torch.analysis.lint --kernels --contracts`` on the
    card: the probes, timings and contracts run through the kernels."""
    from repro_torch.analysis import lint
    assert lint.run(["--kernels", "--contracts"]) == 0
    out = capsys.readouterr().out
    assert "contracts: 0 finding(s) on cuda" in out
    assert "kernelcheck: skipped" not in out
    assert "0 new finding(s)" in out
