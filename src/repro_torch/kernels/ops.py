"""Entry points of the hand-written CUDA kernels (port of
``repro/kernels/ops.py``).

Each wrapper validates its inputs as the reference does (same
``ValueError``s), then dispatches on ``impl``:

  * ``"auto"`` — the plain PyTorch version (kernels/ref.py) when every
    input is on the CPU, else the CUDA kernel (so inputs split across
    the CPU and the card raise as under ``"cuda"``);
  * ``"cuda"`` — the CUDA kernel; CPU tensors raise ``ValueError``;
  * ``"ref"``  — the plain version on any device (tests and the
    kernel-vs-plain comparison of ``chip_smoke.py``).

A wrapper that launches its kernel adds one to ``launch_counts[kernel]``
(the fused query's int8 build counts as ``fused_query_int8``) and to
``launch_shapes[(kernel, shape)]``, where ``shape`` is the tuple of sizes
the launch passes (``last_shape[kernel]`` keeps the latest), and raises
``RuntimeError`` when the launch is refused; nothing falls back to the
plain version on a CUDA tensor. Outputs are allocated here and the
kernels run on the current stream.

With a tracker installed (:func:`set_dispatch_tracker`), every wrapper
call counts ``repro.kernels.dispatch.<op>.<impl>`` (``impl`` resolved to
"cuda" or "ref") and adds its analytic cost to
``repro.kernels.cost.<op>.{flops,hbm_bytes}`` (:mod:`repro_torch.obs.cost`),
as the reference's ops do. The reference counts at trace time, so a
jitted caller counts once per compiled shape; here every call counts, and
on the card the ``.cuda`` count of an op equals its launches
(``fused_query``'s: ``fused_query`` plus ``fused_query_int8``).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.obs import cost as _cost

IMPLS = ("auto", "cuda", "ref")
OPS = ("hash_encode", "hamming_scan", "bucket_gather", "fused_query",
       "bucket_match", "delta_scan", "mips_topk")
KERNELS = OPS + ("fused_query_int8",)

# per-kernel launches since the last reset (plain-version calls never
# count)
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
# the same, by launch shape: (kernel, sizes) -> launches
launch_shapes: Dict[Tuple[str, Tuple[int, ...]], int] = {}
last_shape: Dict[str, Tuple[int, ...]] = {}

_SMEM_LIMIT = 232448          # dynamic shared memory a Hopper block may use

# the largest k of mips_topk: the reference kernel's item block (bn = 256)
MIPS_MAX_K = 256
MIPS_QUERY_TILE = 64          # queries per block of mips_topk.cu
MIPS_ITEM_TILE = 128          # items per tile; a block's chunk is whole tiles

# hash_encode.cu: a warp's slab rows per row a thread (8 row groups), the
# rows-a-thread choices, the most and fewest warps a block (256 threads
# stage A), and the slabs an SM should have (8 warps' worth) before a
# thread takes more rows
HASH_SLAB = 8
HASH_ROWS = (1, 2, 4)
HASH_MAX_WARPS = 16
_HASH_MIN_WARPS = 8
_HASH_FILL = 8
# hash_encode.cu's tiled design: (rows, bits) a thread, bits a block and
# the k tile of each thread layout, and its threads a block
HASH_TILE_LAYOUTS = ((1, 1, 32, 64), (8, 2, 32, 16), (8, 4, 64, 16),
                     (8, 8, 128, 16))
HASH_TILE_THREADS = 256

# fused_query.cu: probe slots per span block (its kSpan), span-list entries
# its merge stages at once (kMergeStage), and the span kernel's static
# shared memory; any query width (a wider query than 512 loops its
# register-held slice over d)
FUSED_SPAN = 2048
FUSED_MERGE_STAGE = 2048
_FUSED_STATIC_SMEM = 4 * (256 + 8 + 4)


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    launch_shapes.clear()
    last_shape.clear()


# optional dispatch observability: with a tracker installed, every wrapper
# call counts ``repro.kernels.dispatch.<op>.<impl>`` and its cost
_dispatch_tracker = None


def set_dispatch_tracker(tracker) -> None:
    """Install (or clear, with None) the module-level dispatch tracker."""
    global _dispatch_tracker
    _dispatch_tracker = tracker


def _charge(op: str, cost_fn, *args) -> None:
    """Accumulate the analytic device cost of one op call
    (``repro.kernels.cost.<op>.{flops,hbm_bytes}``); nothing is computed
    without a tracker."""
    tr = _dispatch_tracker
    if tr is None:
        return
    c = cost_fn(*args)
    tr.count(f"repro.kernels.cost.{op}.flops", c["flops"])
    tr.count(f"repro.kernels.cost.{op}.hbm_bytes", c["hbm_bytes"])


def _resolve(impl: str, op: str, *tensors: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"{op}: unknown impl {impl!r}; expected one of "
                         f"{IMPLS}")
    on_cuda = [t.is_cuda for t in tensors]
    if impl == "auto":
        impl = "cuda" if any(on_cuda) else "ref"
    if impl == "cuda":
        if not all(on_cuda):
            raise ValueError(f"{op}: impl='cuda' needs every input on a "
                             f"CUDA device, got "
                             f"{[str(t.device) for t in tensors]}")
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{op}: inputs span several devices")
    if _dispatch_tracker is not None:
        _dispatch_tracker.count(f"repro.kernels.dispatch.{op}.{impl}")
    return impl


def _require_nonempty(op: str, **dims: int) -> None:
    """Every listed dimension must be >= 1 (the reference's typed
    degenerate-shape guard)."""
    zero = [f"{k}={v}" for k, v in dims.items() if v <= 0]
    if zero:
        raise ValueError(
            f"{op}: zero-size input dimension(s) {', '.join(zero)} — "
            f"every listed dimension must be >= 1")


def _require(op: str, t: torch.Tensor, name: str, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        raise ValueError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    return t.contiguous()


def _current_stream() -> int:
    """The current device's CUDA stream handle. torch's raw-stream getter
    skips building a Stream object (8 us a call on the H100's host, a
    quarter of a small scan's wrapper); a torch without it gets the public
    call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())


def _launch(kernel: str, entry: str, *args, shape: Tuple[int, ...]) -> None:
    err = _build.function(entry)(*args, _current_stream())
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    launch_counts[kernel] += 1
    key = (kernel, tuple(int(v) for v in shape))
    launch_shapes[key] = launch_shapes.get(key, 0) + 1
    last_shape[kernel] = key[1]


def hash_encode(x: torch.Tensor, A: torch.Tensor,
                tail: Optional[torch.Tensor] = None,
                a_tail: Optional[torch.Tensor] = None, *,
                impl: str = "auto") -> torch.Tensor:
    """Sign-projection encode to packed codes.

    x: (N, d) f32; A: (d, L) f32; optional SIMPLE-LSH fold: tail (N,),
    a_tail (L,). Returns (N, ceil(L/32)) int32 (the uint32 bits). Any d
    and L: the kernel stages A whole in shared memory where it fits beside
    8 warps' slabs of x, and walks d in tiles otherwise (see
    ``hash_encode_plan``)."""
    N, d = x.shape
    L = A.shape[1]
    _require_nonempty("hash_encode", N=N, d=d, L=L)
    if A.shape[0] != d:
        raise ValueError(f"hash_encode: A {tuple(A.shape)} must have d={d} "
                         f"rows for x {tuple(x.shape)}")
    if (tail is None) != (a_tail is None):
        raise ValueError("hash_encode: pass tail and a_tail together")
    if tail is None:
        tail = torch.zeros((N,), dtype=x.dtype, device=x.device)
        a_tail = torch.zeros((L,), dtype=x.dtype, device=x.device)
    elif tuple(tail.shape) != (N,) or tuple(a_tail.shape) != (L,):
        raise ValueError(f"hash_encode: tail {tuple(tail.shape)} and a_tail "
                         f"{tuple(a_tail.shape)} must be ({N},) and ({L},)")
    impl = _resolve(impl, "hash_encode", x, A, tail, a_tail)
    _charge("hash_encode", _cost.hash_encode_cost, N, d, L)
    if impl == "ref":
        return _ref.hash_encode_ref(x, A, tail, a_tail)
    plan = hash_encode_plan(
        N, d, L, torch.cuda.get_device_properties(x.device)
        .multi_processor_count)
    args = [_require("hash_encode", t, n, torch.float32)
            for t, n in ((x, "x"), (A, "A"), (tail, "tail"),
                         (a_tail, "a_tail"))]
    W = (L + 31) // 32
    out = torch.empty((N, W), dtype=torch.int32, device=x.device)
    if plan.layout is None:
        _launch("hash_encode", "hash_encode", *(a.data_ptr() for a in args),
                out.data_ptr(), N, d, L, W, plan.rows, plan.warps,
                plan.blocks, shape=(N, d, L, W))
    else:
        _launch("hash_encode", "hash_encode_tiled",
                *(a.data_ptr() for a in args), out.data_ptr(), N, d, L, W,
                plan.layout, shape=(N, d, L, W))
    return out


class HashPlan(NamedTuple):
    """Launch plan of ``hash_encode.cu``.

    Resident design (``layout`` None): ``rows`` code rows a thread, slabs
    of ``slab`` rows (``slabs`` of them over N), ``warps`` a block and
    ``blocks`` in the grid, and the dynamic shared memory in bytes.
    Tiled design: ``layout`` names the thread layout (``HASH_TILE_LAYOUTS``),
    ``rows`` the rows a block, ``blocks`` the grid's blocks over rows and
    words, ``smem`` its static shared memory; ``slab``/``slabs``/``warps``
    are its k tile, the tiles over d and its warps."""
    rows: int
    slab: int
    slabs: int
    warps: int
    blocks: int
    smem: int
    layout: Optional[int] = None


def hash_encode_smem(d: int, L: int, rows: int, warps: int) -> int:
    """Shared memory of a resident hash_encode block: A padded to 32 W
    columns, a_tail, and one slab of ``HASH_SLAB * rows`` rows of x a
    warp."""
    return 4 * ((d + 1) * 32 * ((L + 31) // 32)
                + warps * HASH_SLAB * rows * d)


def _hash_tile_rows(layout: int) -> int:
    """Rows a block of the tiled design's thread layout holds."""
    tm, tn, bn, _ = HASH_TILE_LAYOUTS[layout]
    return (HASH_TILE_THREADS // (bn // tn)) * tm


def hash_tile_smem(layout: int) -> int:
    """Static shared memory of a tiled hash_encode block: double-buffered x
    (rows x (k tile + 1)) and A (k tile x bits) tiles and the rows' words."""
    _, _, bn, bk = HASH_TILE_LAYOUTS[layout]
    bm = _hash_tile_rows(layout)
    return 4 * (2 * bm * (bk + 1) + 2 * bk * bn + bm * (bn // 32))


@functools.lru_cache(maxsize=64)
def hash_encode_plan(N: int, d: int, L: int, sms: int) -> HashPlan:
    """The resident design when A and 8 warps' one-row slabs fit shared
    memory (``_HASH_MIN_WARPS``): the most rows a thread that still leaves
    every one of ``sms`` SMs 8 warps' worth of slabs, then as many warps a
    block as shared memory holds (at most 16) and the slabs spread over
    ``sms`` blocks need, but 8 or more so that A's staging is spread over
    256 threads (a 64-row batch runs as one 8-warp block).

    Otherwise the tiled design, which takes any d and L: the 8-row layout
    whose word group fits W (4, 2 or 1 words a block) when its blocks fill
    the ``sms`` SMs, else one row and one bit a thread (8 rows x 32 bits a
    block) so that a small batch still spreads over the card."""
    if hash_encode_smem(d, L, 1, _HASH_MIN_WARPS) > _SMEM_LIMIT:
        return _hash_tile_plan(N, d, L, sms)
    rows = 1
    for r in HASH_ROWS:
        if (-(-N // (HASH_SLAB * r)) >= _HASH_FILL * sms
                and hash_encode_smem(d, L, r, 1) <= _SMEM_LIMIT):
            rows = r
    slab = HASH_SLAB * rows
    slabs = -(-N // slab)
    fit = max(w for w in range(1, HASH_MAX_WARPS + 1)
              if hash_encode_smem(d, L, rows, w) <= _SMEM_LIMIT)
    warps = min(fit, max(_HASH_MIN_WARPS, -(-slabs // sms)))
    blocks = min(sms, -(-slabs // warps))
    return HashPlan(rows, slab, slabs, warps, blocks,
                    hash_encode_smem(d, L, rows, warps))


def _hash_tile_plan(N: int, d: int, L: int, sms: int) -> HashPlan:
    W = (L + 31) // 32
    wide = 3 if W >= 3 else W               # 4, 2 or 1 words a block
    layout = wide if _hash_tile_blocks(wide, N, W) >= sms else 0
    bk = HASH_TILE_LAYOUTS[layout][3]
    return HashPlan(_hash_tile_rows(layout), bk, -(-d // bk),
                    HASH_TILE_THREADS // 32, _hash_tile_blocks(layout, N, W),
                    hash_tile_smem(layout), layout)


def _hash_tile_blocks(layout: int, N: int, W: int) -> int:
    words = HASH_TILE_LAYOUTS[layout][2] // 32
    return -(-N // _hash_tile_rows(layout)) * -(-W // words)


def _check_packed(op: str, q_codes: torch.Tensor, db_codes: torch.Tensor,
                  rows: str, what: str) -> None:
    Q, W = q_codes.shape[0], q_codes.shape[1]
    R = db_codes.shape[0]
    if min(Q, R, W) <= 0:
        _require_nonempty(op, Q=Q, **{rows: R}, W=W)
    if W != db_codes.shape[1]:
        raise ValueError(f"{op}: query codes have {W} words, {what} "
                         f"{db_codes.shape[1]}")


def _packed_scan(op: str, entry: str, q_codes: torch.Tensor,
                 db_codes: torch.Tensor, *, hash_bits: Optional[int] = None,
                 live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one of ``hamming.cu``'s scans into a (Q, N) int32 output
    (``hash_bits`` for the match epilogues, ``live`` bytes for the
    delta scan)."""
    q = _require(op, q_codes, "q_codes", torch.int32)
    db = _require(op, db_codes, "db_codes", torch.int32)
    Q, W = q.shape
    N = db.shape[0]
    out = q.new_empty((Q, N))
    ptrs = [q.data_ptr(), db.data_ptr()]
    if live is not None:
        ptrs.append(live.data_ptr())
    sizes = [Q, N, W] + ([] if hash_bits is None else [int(hash_bits)])
    _launch(op, entry, *ptrs, out.data_ptr(), *sizes, shape=sizes)
    return out


def hamming_scan(q_codes: torch.Tensor, db_codes: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """All-pairs Hamming distances (Q, W) x (N, W) -> (Q, N) int32."""
    _check_packed("hamming_scan", q_codes, db_codes, "N", "item codes")
    impl = _resolve(impl, "hamming_scan", q_codes, db_codes)
    _charge("hamming_scan", _cost.packed_scan_cost, q_codes.shape[0],
            db_codes.shape[0], 32 * q_codes.shape[1])
    if impl == "ref":
        return _ref.hamming_ref(q_codes, db_codes)
    return _packed_scan("hamming_scan", "hamming", q_codes, db_codes)


def bucket_match(q_codes: torch.Tensor, bucket_codes: torch.Tensor,
                 hash_bits: int, *, impl: str = "auto") -> torch.Tensor:
    """Bucket-directory match counts: (Q, W) x (B, W) -> (Q, B) int32
    ``l = hash_bits - hamming`` (the eq.-12 input)."""
    _check_packed("bucket_match", q_codes, bucket_codes, "B",
                  "bucket codes")
    impl = _resolve(impl, "bucket_match", q_codes, bucket_codes)
    _charge("bucket_match", _cost.packed_scan_cost, q_codes.shape[0],
            bucket_codes.shape[0], hash_bits)
    if impl == "ref":
        return _ref.bucket_match_ref(q_codes, bucket_codes, hash_bits)
    return _packed_scan("bucket_match", "bucket_match", q_codes,
                        bucket_codes, hash_bits=hash_bits)


def delta_scan(q_codes: torch.Tensor, delta_codes: torch.Tensor,
               live: torch.Tensor, hash_bits: int, *,
               impl: str = "auto") -> torch.Tensor:
    """Delta-buffer scan: (Q, W) x (C, W) -> (Q, C) int32 match counts
    ``l = hash_bits - hamming`` with dead slots (``live`` falsy) fused to
    ``-1`` — the streaming merge ranks them last in one pass."""
    _check_packed("delta_scan", q_codes, delta_codes, "C", "delta codes")
    if tuple(live.shape) != (delta_codes.shape[0],):
        raise ValueError(f"delta_scan: live {tuple(live.shape)} must be "
                         f"(C={delta_codes.shape[0]},)")
    impl = _resolve(impl, "delta_scan", q_codes, delta_codes, live)
    _charge("delta_scan", _cost.packed_scan_cost, q_codes.shape[0],
            delta_codes.shape[0], hash_bits)
    if impl == "ref":
        return _ref.delta_scan_ref(q_codes, delta_codes, live, hash_bits)
    # the kernel reads one byte a slot, nonzero = live: a bool or uint8
    # tensor goes as it is, any other dtype is converted here
    if live.dtype not in (torch.bool, torch.uint8):
        live = live != 0
    return _packed_scan("delta_scan", "delta_scan", q_codes, delta_codes,
                        hash_bits=hash_bits, live=live.contiguous())


def mips_topk(queries: torch.Tensor, items: torch.Tensor, k: int, *,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products: vals (Q, k) f32 and ids (Q, k) int32,
    equal scores to the lower id. ``k`` is at most ``MIPS_MAX_K``."""
    k = int(k)
    _require_nonempty("mips_topk", Q=queries.shape[0], N=items.shape[0],
                      d=queries.shape[1], k=k)
    if k > items.shape[0]:
        raise ValueError(f"k={k} must not exceed the item count "
                         f"N={items.shape[0]}")
    if k > MIPS_MAX_K:
        raise ValueError(f"mips_topk: k={k} exceeds the kernel's limit "
                         f"of {MIPS_MAX_K}")
    if items.shape[1] != queries.shape[1]:
        raise ValueError(f"mips_topk: queries have d={queries.shape[1]}, "
                         f"items d={items.shape[1]}")
    impl = _resolve(impl, "mips_topk", queries, items)
    _charge("mips_topk", _cost.mips_topk_cost, queries.shape[0],
            items.shape[0], queries.shape[1], k)
    if impl == "ref":
        return _ref.mips_topk_ref(queries, items, k)
    queries = _require("mips_topk", queries, "queries", torch.float32)
    items = _require("mips_topk", items, "items", torch.float32)
    Q, d = queries.shape
    N = items.shape[0]
    dev = queries.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block, nblk = mips_topk_plan(Q, N, _mips_blocks_per_sm(k), sms)
    part_val = torch.empty((nblk, Q, k), dtype=torch.float32, device=dev)
    part_id = torch.empty((nblk, Q, k), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    _launch("mips_topk", "mips_topk", queries.data_ptr(), items.data_ptr(),
            part_val.data_ptr(), part_id.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), Q, N, d, k, per_block, nblk,
            shape=(Q, N, d, k))
    return vals, ids


def mips_topk_plan(Q: int, N: int, blocks_per_sm: int, sms: int
                   ) -> Tuple[int, int]:
    """(items per block, item blocks) of ``mips_topk``'s first launch:
    contiguous chunks of whole item tiles, as many as fill one wave of
    ``blocks_per_sm`` blocks on each of ``sms`` SMs across the query
    tiles."""
    qtiles = -(-Q // MIPS_QUERY_TILE)
    target = max(1, blocks_per_sm * sms // qtiles)
    per_block = -(-N // target)
    per_block = -(-per_block // MIPS_ITEM_TILE) * MIPS_ITEM_TILE
    return per_block, -(-N // per_block)


_mips_occupancy: Dict[int, int] = {}


def _mips_blocks_per_sm(k: int) -> int:
    """Blocks of mips_topk's partial kernel that fit one SM at this k, as
    the CUDA runtime reckons them from its registers and shared memory."""
    n = _mips_occupancy.get(k)
    if n is None:
        n = _build.function("mips_topk_blocks")(k)
        if n <= 0:
            raise RuntimeError(f"mips_topk: occupancy query failed ({n})")
        _mips_occupancy[k] = n
    return n


def bucket_gather(cum: torch.Tensor, starts: torch.Tensor, num_probe: int,
                  *, impl: str = "auto") -> torch.Tensor:
    """Segmented candidate gather: CSR positions (Q, num_probe) of the
    first ``num_probe`` probed items, given probe-ordered runs as
    (cum (Q, S+1), starts (Q, S)) int32 arrays."""
    num_probe = int(num_probe)
    _require_nonempty("bucket_gather", Q=cum.shape[0],
                      S=cum.shape[1] - 1, num_probe=num_probe)
    if starts.shape != (cum.shape[0], cum.shape[1] - 1):
        raise ValueError(f"bucket_gather: starts {tuple(starts.shape)} "
                         f"must be (Q, S) for cum {tuple(cum.shape)}")
    impl = _resolve(impl, "bucket_gather", cum, starts)
    _charge("bucket_gather", _cost.segmented_gather_cost, cum.shape[0],
            num_probe)
    if impl == "ref":
        return _ref.bucket_gather_ref(cum, starts, num_probe)
    cum = _require("bucket_gather", cum, "cum", torch.int32)
    starts = _require("bucket_gather", starts, "starts", torch.int32)
    Q, S = starts.shape
    out = torch.empty((Q, num_probe), dtype=torch.int32, device=cum.device)
    _launch("bucket_gather", "bucket_gather", cum.data_ptr(),
            starts.data_ptr(), out.data_ptr(), Q, S, num_probe,
            shape=(Q, S, num_probe))
    return out


def fused_query(queries: torch.Tensor, cum: torch.Tensor,
                starts: torch.Tensor, items: torch.Tensor, total: int,
                k: int, *, kprime: Optional[int] = None,
                payload: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused single-pass planned query: vals (Q, k) f32 and CSR positions
    (Q, k) int32.

    ``cum`` (Q, S+1) / ``starts`` (Q, S): probe-ordered take runs whose
    per-query sizes sum to the planned width ``total``. ``items`` (N, d):
    f32 rows in CSR order (the rescore rows). Optional ``payload`` (N, d)
    int8 + ``scale`` (N, 1) f32 select the quantized phase 1; by default
    phase 1 scores the f32 rows with unit scales. ``kprime`` is the
    phase-1 survivor width (>= k; default ``max(k, min(max(4k, 32),
    total))``)."""
    Q, d = queries.shape
    S = cum.shape[1] - 1
    N = items.shape[0]
    total = int(total)
    k = int(k)
    _require_nonempty("fused_query", Q=Q, d=d, S=S, N=N, k=k, total=total)
    if items.shape[1] != d:
        raise ValueError(f"fused_query: items {tuple(items.shape)} must "
                         f"have the queries' d={d} columns")
    if cum.shape[0] != Q or tuple(starts.shape) != (Q, S):
        raise ValueError(f"fused_query: cum {tuple(cum.shape)} and starts "
                         f"{tuple(starts.shape)} must be (Q, S+1) and (Q, S) "
                         f"for Q={Q} queries")
    if k > total:
        raise ValueError(f"k={k} must not exceed the planned probe "
                         f"width total={total}")
    if kprime is None:
        kprime = max(k, min(max(4 * k, 32), total))
    kprime = int(kprime)
    if kprime < k:
        raise ValueError(f"kprime={kprime} must be >= k={k}")
    if (payload is None) != (scale is None):
        raise ValueError("fused_query: pass payload and scale together "
                         "(the per-item dequant scales)")
    extra = () if payload is None else (payload, scale)
    impl = _resolve(impl, "fused_query", queries, cum, starts, items, *extra)
    _charge("fused_query", _cost.fused_query_cost, Q, total, d, k, kprime)
    if impl == "ref":
        return _ref.fused_query_ref(queries, cum, starts, items, total, k,
                                    kprime=kprime, payload=payload,
                                    scale=scale)
    queries = _require("fused_query", queries, "queries", torch.float32)
    cum = _require("fused_query", cum, "cum", torch.int32)
    starts = _require("fused_query", starts, "starts", torch.int32)
    items = _require("fused_query", items, "items", torch.float32)
    if payload is None:            # unit scales: the kernel reads none
        payload, scale = items, None
    elif payload.shape != (N, d) or tuple(scale.shape) != (N, 1):
        raise ValueError(f"fused_query: payload {tuple(payload.shape)} and "
                         f"scale {tuple(scale.shape)} must be ({N}, {d}) "
                         f"and ({N}, 1)")
    if payload.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"fused_query: payload must be int8 or float32, "
                         f"got {payload.dtype}")
    payload = payload.contiguous()
    if scale is not None:
        scale = _require("fused_query", scale, "scale", torch.float32)
    int8 = payload.dtype == torch.int8
    plan = fused_query_plan(Q, total, d, kprime)
    dev = queries.device
    part_val = torch.empty(plan.lists, dtype=torch.float32, device=dev)
    part_slot = torch.empty(plan.lists, dtype=torch.int32, device=dev)
    part_pos = torch.empty(plan.lists, dtype=torch.int32, device=dev)
    part_cnt = torch.empty(plan.counts, dtype=torch.int32, device=dev)
    vals = torch.empty((Q, kprime), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, kprime), dtype=torch.int32, device=dev)
    _launch("fused_query_int8" if int8 else "fused_query", "fused_query",
            queries.data_ptr(), cum.data_ptr(), starts.data_ptr(),
            payload.data_ptr(), int(int8),
            None if scale is None else scale.data_ptr(), items.data_ptr(),
            part_val.data_ptr(), part_slot.data_ptr(), part_pos.data_ptr(),
            part_cnt.data_ptr(), vals.data_ptr(), pos.data_ptr(), Q, S, d,
            total, kprime, FUSED_SPAN, plan.kb, plan.nspan,
            shape=(Q, S, d, total, kprime))
    return vals[:, :k], pos[:, :k]


class FusedPlan(NamedTuple):
    """Launch plan of ``fused_query.cu``: ``nspan`` span blocks per query,
    each keeping its ``kb`` best slots, merged ``group`` lists at a time;
    scratch lists of shape ``lists``
    and counts of shape ``counts``; dynamic shared memory of the span and
    merge kernels in bytes."""
    nspan: int
    kb: int
    group: int
    lists: Tuple[int, int, int]
    counts: Tuple[int, int]
    span_smem: int
    merge_smem: int


def fused_query_plan(Q: int, total: int, d: int, kprime: int) -> FusedPlan:
    """Span count, scratch shapes and shared memory of a fused_query
    launch; ``ValueError`` when the survivor buffers do not fit the
    kernels' shared memory (the query width does not enter: the kernels
    hold neither the query nor a row in shared memory)."""
    nspan = -(-total // FUSED_SPAN)
    kb = min(kprime, FUSED_SPAN)
    span_smem = 4 * (2 * (FUSED_SPAN + FUSED_SPAN // 32) + 3 * kb)
    group = max(1, min(nspan, FUSED_MERGE_STAGE // kb))
    merge_smem = 4 * (6 * kprime + (3 * kb + 1) * group)
    if max(span_smem + _FUSED_STATIC_SMEM, merge_smem) > _SMEM_LIMIT:
        raise ValueError(f"fused_query: d={d}, kprime={kprime} do not fit "
                         f"the kernel's shared-memory survivor buffer")
    return FusedPlan(nspan, kb, group, (Q, nspan, kb), (Q, nspan),
                     span_smem, merge_smem)
