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
kernels run on the current stream. The port's own kernels
(``PORT_KERNELS``: ``planned_runs``, the per-range take, which the
reference computes in plain jnp) count and dispatch the same way but stay
out of ``OPS``, ``KERNELS`` and ``KERNEL_REGISTRY``, which keep the
reference's keys.

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

import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.annotations import ANNOTATIONS, KernelAnnotation
from repro_torch.obs import cost as _cost

IMPLS = ("auto", "cuda", "ref")
OPS = ("hash_encode", "hamming_scan", "bucket_gather", "fused_query",
       "bucket_match", "delta_scan", "mips_topk")
KERNELS = OPS + ("fused_query_int8",)
# the port's own kernels, which no Pallas kernel of the reference stands
# behind (the registry keeps the reference's ops): the per-range take
PORT_KERNELS = ("planned_runs",)

# per-kernel launches since the last reset (plain-version calls never
# count)
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS + PORT_KERNELS}
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

# bucket_gather.cu's planned_runs: warps of the one block that walks a row
PLANNED_RUNS_WARPS = 32


def reset_launch_counts() -> None:
    for name in KERNELS + PORT_KERNELS:
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


def mips_topk_kernel_cost(q: int, n: int, d: int, k: int, nblk: int
                          ) -> Dict[str, float]:
    """The work ``mips_topk.cu`` itself does (the model K5 holds against
    its cold time; the op bills the reference's ``mips_topk_cost``): each
    item row read once for each ``MIPS_QUERY_TILE``-query tile, the
    queries once, the ``nblk`` partial top-k lists of
    :func:`mips_topk_plan` written and read back, the final lists written;
    ``2·q·n·d`` FLOPs of dots."""
    qtiles = -(-q // MIPS_QUERY_TILE)
    lists = (4 + 4) * q * k                  # f32 values and int32 ids
    bytes_ = 4 * (n * d * qtiles + q * d) + lists * (2 * nblk + 1)
    return {"flops": 2.0 * q * n * d, "hbm_bytes": float(bytes_)}


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


def planned_runs_smem(R: int) -> int:
    """Dynamic shared memory of a ``planned_runs`` block: each warp's
    per-range sums (32 warps x R, rows padded to an odd stride) and the R
    carries."""
    R = int(R)
    return 4 * (PLANNED_RUNS_WARPS * (R | 1) + R)


def planned_runs(order: torch.Tensor, bucket_start: torch.Tensor,
                 bucket_rid: torch.Tensor, caps: torch.Tensor, *,
                 impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs realizing per-range budgets over a probe order: (cum (Q, B+1),
    starts (Q, B)) int32, for ``bucket_gather`` and ``fused_query``.

    ``order`` (Q, B) int64: each row the directory's bucket indices in
    probe order; ``bucket_start`` (B+1,) int32 CSR offsets; ``bucket_rid``
    (B,) int32 range of each bucket, in [0, R); ``caps`` (R,) int32 budgets
    clipped to the ranges' counts. Bucket ``order[q, s]`` starts its run
    at ``bucket_start[b]`` and takes what is left of its range's cap after
    the same-range buckets before it in the row; ``cum`` is the exclusive
    prefix of the takes. One launch on the card, for any Q, B and R whose
    carries fit a block's shared memory."""
    op = "planned_runs"
    if order.dim() != 2 or caps.dim() != 1:
        raise ValueError(f"{op}: order {tuple(order.shape)} and caps "
                         f"{tuple(caps.shape)} must be (Q, B) and (R,)")
    Q, B = order.shape
    R = caps.shape[0]
    _require_nonempty(op, Q=Q, B=B, R=R)
    if (tuple(bucket_start.shape) != (B + 1,)
            or tuple(bucket_rid.shape) != (B,)):
        raise ValueError(f"{op}: bucket_start {tuple(bucket_start.shape)} "
                         f"and bucket_rid {tuple(bucket_rid.shape)} must be "
                         f"({B + 1},) and ({B},) for order "
                         f"{tuple(order.shape)}")
    for t, name, dtype in ((order, "order", torch.int64),
                           (bucket_start, "bucket_start", torch.int32),
                           (bucket_rid, "bucket_rid", torch.int32),
                           (caps, "caps", torch.int32)):
        _require(op, t, name, dtype)
    impl = _resolve(impl, op, order, bucket_start, bucket_rid, caps)
    _charge(op, _cost.planned_runs_cost, Q, B, R)
    if impl == "ref":
        return _ref.planned_runs_ref(order, bucket_start, bucket_rid, caps)
    static = ANNOTATIONS["bucket_gather"].static_smem["planned_runs_kernel"]
    if planned_runs_smem(R) + static > _SMEM_LIMIT:
        raise ValueError(f"{op}: R={R} ranges' carries must fit a block's "
                         f"shared memory ({_SMEM_LIMIT} bytes)")
    args = [t.contiguous() for t in (order, bucket_start, bucket_rid, caps)]
    cum = torch.empty((Q, B + 1), dtype=torch.int32, device=order.device)
    starts = torch.empty((Q, B), dtype=torch.int32, device=order.device)
    _launch(op, op, *(a.data_ptr() for a in args), starts.data_ptr(),
            cum.data_ptr(), Q, B, R, shape=(Q, B, R))
    return cum, starts


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
            total, kprime, FUSED_SPAN, plan.kb, plan.nspan, plan.group,
            plan.span_smem, plan.merge_smem, shape=(Q, S, d, total, kprime))
    return vals[:, :k], pos[:, :k]


class FusedPlan(NamedTuple):
    """Launch plan of ``fused_query.cu``: ``nspan`` span blocks per query,
    each keeping its ``kb`` best slots, merged ``group`` lists at a time;
    scratch lists of shape ``lists`` and counts of shape ``counts``;
    dynamic shared memory of the span and merge kernels in bytes. The
    wrapper passes all of it to the launch."""
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


# -- launch plans -------------------------------------------------------------
#
# Every op's launch as kernelcheck reads it (repro_torch/analysis/
# kernelcheck.py K1-K3): the stages, their grids, threads and dynamic
# shared memory. fused_query launches with its plan whole (spans, merge
# group, both kernels' shared memory), hash_encode and mips_topk with the
# parts of theirs that the wrappers pass (rows, warps and blocks; items a
# block and item blocks). The rest is chosen inside a library from the
# same sizes: hamming.cu's and bucket_gather.cu's grids, the resident
# hash_encode block's and mips_topk's partial kernel's shared memory.
# ``packed_scan_plan``, ``bucket_gather_plan``, ``hash_encode_smem`` and
# ``mips_partial_smem`` restate those choices, because the libraries' C
# entry points keep the signatures that tools/hamming_variants.py,
# tools/gather_encode_ab.py and tools/mips_phases.py bind. A restated
# choice that understated a launch would show on the card: every shape a
# path launches was launched there and held against its plain version.

H100_SMS = 132            # an H100 SXM's SMs: the plans' count off the card
MIPS_MIN_BLOCKS = 2       # mips_topk.cu's launch bound, its blocks an SM
SCAN_THREADS, SCAN_ITEMS, SCAN_QUERIES = 256, 4, 64   # hamming.cu's wide block
SCAN_HALO = 7             # rows of at most this many items scan narrow
SCAN_NARROW_THREADS = 128  # each thread of the narrow kernel owns 4 outputs
GATHER_SPAN, GATHER_THREADS = 2048, 256
GRID_Y_MAX = 65535
FUSED_THREADS = 256       # both kernels of fused_query.cu
MIPS_THREADS, MIPS_MERGE_THREADS = 128, 256


class Stage(NamedTuple):
    """One kernel launch of an op: its ``__global__`` function, grid (x,
    y, z), threads a block and dynamic shared memory (bytes), and for each
    grid axis the work axis it splits with the extent a block covers (0:
    the blocks loop over that axis, a grid-stride walk)."""
    function: str
    grid: Tuple[int, int, int]
    threads: int
    dynamic_smem: int
    tiles: Tuple[Tuple[str, int], ...]


class LaunchPlan(NamedTuple):
    """The stages of one op's launch, the size of each work axis they
    split, and the axes that index the op's result (a first-stage grid
    axis over any other axis feeds several blocks into one result row)."""
    stages: Tuple[Stage, ...]
    extents: Dict[str, int]
    result_axes: Tuple[str, ...]


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def packed_scan_plan(Q: int, N: int, W: int, live: bool = False
                     ) -> LaunchPlan:
    """``hamming.cu``'s launch: the wide design (item tiles of 1,024 by
    blocks of 64 queries) for rows longer than the halo and W <= 8, except
    the delta scan; else the narrow one (4 flat outputs a thread)."""
    if not live and N > SCAN_HALO and 1 <= W <= 8:
        tile = SCAN_THREADS * SCAN_ITEMS
        st = Stage("wide_scan_kernel", (_cdiv(N, tile), _cdiv(Q, SCAN_QUERIES),
                                        1), SCAN_THREADS, 0,
                   (("items", tile), ("queries", SCAN_QUERIES)))
        return LaunchPlan((st,), {"items": N, "queries": Q},
                          ("items", "queries"))
    per_block = 4 * SCAN_NARROW_THREADS
    st = Stage("narrow_scan_kernel", (_cdiv(Q * N, per_block), 1, 1),
               SCAN_NARROW_THREADS, 0, (("outputs", per_block),))
    return LaunchPlan((st,), {"outputs": Q * N}, ("outputs",))


def bucket_gather_plan(Q: int, S: int, P: int) -> LaunchPlan:
    """``bucket_gather.cu``'s launch: spans of 2,048 slots by queries, the
    queries past 65,535 walked by the blocks of the grid's y axis."""
    st = Stage("bucket_gather_kernel",
               (_cdiv(P, GATHER_SPAN), min(Q, GRID_Y_MAX), 1), GATHER_THREADS,
               0, (("slots", GATHER_SPAN),
                   ("queries", 1 if Q <= GRID_Y_MAX else 0)))
    return LaunchPlan((st,), {"slots": P, "queries": Q},
                      ("queries", "slots"))


def mips_partial_smem(k: int) -> int:
    """Dynamic shared memory of ``mips_topk.cu``'s partial kernel: the
    four-slice staging ring, a tile's scores, two k-lists a query, the
    list counts and a tile's candidate flags."""
    return 4 * (4 * (MIPS_QUERY_TILE + MIPS_ITEM_TILE) * 16
                + MIPS_QUERY_TILE * MIPS_ITEM_TILE + 2 * MIPS_QUERY_TILE * k
                + 4 * MIPS_QUERY_TILE) + MIPS_QUERY_TILE * MIPS_ITEM_TILE


def launch_plan(op: str, s: Dict[str, int], device=None) -> LaunchPlan:
    """The launch plan of ``op`` at the sizes ``s`` (a registry shape
    class's keys), with the card's SM count and occupancy when ``device``
    is a CUDA device, else an H100 SXM's (132 SMs, mips_topk at its launch
    bound of 2 blocks an SM)."""
    on_card = device is not None and torch.device(device).type == "cuda"
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if on_card else H100_SMS)
    if op == "hash_encode":
        N, d, L = s["n"], s["d"], s["L"]
        W = _cdiv(L, 32)
        p = hash_encode_plan(N, d, L, sms)
        if p.layout is None:
            st = Stage("hash_encode_kernel", (p.blocks, 1, 1), p.warps * 32,
                       p.smem, (("rows", 0),))
        else:
            words = HASH_TILE_LAYOUTS[p.layout][2] // 32
            st = Stage("hash_encode_tiled_kernel",
                       (_cdiv(N, p.rows), _cdiv(W, words), 1),
                       HASH_TILE_THREADS, 0, (("rows", p.rows),
                                              ("words", words)))
        return LaunchPlan((st,), {"rows": N, "words": W}, ("rows", "words"))
    if op == "hamming_scan":
        return packed_scan_plan(s["q"], s["n"], s["w"])
    if op == "bucket_match":
        return packed_scan_plan(s["q"], s["b"], s["w"])
    if op == "delta_scan":
        return packed_scan_plan(s["q"], s["c"], s["w"], live=True)
    if op == "bucket_gather":
        return bucket_gather_plan(s["q"], s["s"], s["p"])
    if op == "fused_query":
        Q, total = s["q"], s["total"]
        p = fused_query_plan(Q, total, s["d"], plan_kprime(s))
        return LaunchPlan(
            (Stage("fq_span_kernel", (p.nspan, Q, 1), FUSED_THREADS,
                   p.span_smem, (("slots", FUSED_SPAN), ("queries", 1))),
             Stage("fq_merge_kernel", (Q, 1, 1), FUSED_THREADS, p.merge_smem,
                   (("queries", 1),))),
            {"slots": total, "queries": Q}, ("queries",))
    if op == "mips_topk":
        Q, N, k = s["q"], s["n"], s["k"]
        bps = _mips_blocks_per_sm(k) if on_card else MIPS_MIN_BLOCKS
        per_block, nblk = mips_topk_plan(Q, N, bps, sms)
        return LaunchPlan(
            (Stage("mips_partial_kernel", (nblk, _cdiv(Q, MIPS_QUERY_TILE), 1),
                   MIPS_THREADS, mips_partial_smem(k),
                   (("items", per_block), ("queries", MIPS_QUERY_TILE))),
             Stage("mips_merge_kernel", (Q, 1, 1), MIPS_MERGE_THREADS, 0,
                   (("queries", 1),))),
            {"items": N, "queries": Q}, ("queries",))
    raise ValueError(f"launch_plan: unknown op {op!r}")


def launch_shape_class(kernel: str, sizes: Tuple[int, ...]
                       ) -> Tuple[str, Dict[str, int]]:
    """(op, sizes as a shape class) of a ``launch_shapes`` key."""
    if kernel == "hash_encode":
        return kernel, dict(zip(("n", "d", "L"), sizes[:3]))
    if kernel in ("hamming_scan", "bucket_match", "delta_scan"):
        rows = {"hamming_scan": "n", "bucket_match": "b", "delta_scan": "c"}
        return kernel, {"q": sizes[0], rows[kernel]: sizes[1],
                        "w": sizes[2]}
    if kernel == "bucket_gather":
        return kernel, dict(zip(("q", "s", "p"), sizes))
    if kernel in ("fused_query", "fused_query_int8"):
        return "fused_query", dict(zip(("q", "s", "d", "total", "kprime"),
                                       sizes))
    if kernel == "mips_topk":
        return kernel, dict(zip(("q", "n", "d", "k"), sizes))
    if kernel == "planned_runs":          # a port kernel: not in the registry
        return kernel, dict(zip(("q", "b", "r"), sizes))
    raise ValueError(f"launch_shape_class: unknown kernel {kernel!r}")


def plan_kprime(s: Dict[str, int]) -> int:
    """The survivor width of a fused_query shape class (its ``kprime``,
    else the wrapper's default for its ``k``)."""
    if "kprime" in s:
        return int(s["kprime"])
    k = int(s.get("k", 1))
    return max(k, min(max(4 * k, 32), int(s["total"])))


# -- kernel registry (kernelcheck metadata) -----------------------------------
#
# One entry per op, with the reference's keys and shape classes
# (``repro/kernels/ops.py`` KERNEL_REGISTRY): kernelcheck reads each op's
# launch plan at every class, bills the same cost model the op's
# ``_charge`` call bills, and on the card runs the K4 probes (the
# reference's adversarial padding cases, kernel against plain version)
# and times the kernel against its cost's bound.


def _codes(n: int, w: int, device=None) -> torch.Tensor:
    """Deterministic code patterns for the probes: the bits of the
    reference's uint32 ``i * 2654435761 + 12345`` (Knuth's multiplicative
    hash of the slot index) as int32."""
    i = torch.arange(n * w, dtype=torch.int64, device=device)
    v = (i * 2654435761 + 12345) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32
                                                         ).reshape(n, w)


def _parity_problems(op: str, got, want, *, atol: float = 0.0) -> List[str]:
    """Kernel-vs-plain comparison under adversarial padding; any mismatch
    means padded lanes leaked through the wrapper."""
    import numpy as np
    g = np.asarray(got.detach().cpu())
    w = np.asarray(want.detach().cpu())
    if g.shape != w.shape:
        return [f"{op}: kernel result shape {g.shape} != plain {w.shape} "
                f"under unaligned input shapes"]
    ok = (np.allclose(g, w, atol=atol, rtol=1e-5) if atol
          else bool((g == w).all()))
    if not ok:
        return [f"{op}: kernel/plain parity broke under padding "
                f"(max abs diff {np.abs(g.astype(np.float32) - w).max()})"]
    return []


def probe_inputs(op: str, device=None) -> List[Tuple[tuple, dict]]:
    """The (args, kwargs) of each call the op's K4 probe makes, the
    reference's inputs bit for bit."""
    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    if op == "hash_encode":               # L % 32 == 16 padding bits
        return [((f32(torch.ones(3, 8)), f32(torch.ones(8, 48))), {})]
    if op == "hamming_scan":              # n far below any tile
        return [((_codes(3, 2, device), _codes(70, 2, device)), {})]
    if op == "bucket_match":
        return [((_codes(3, 1, device), _codes(21, 1, device), 32), {})]
    if op == "delta_scan":                # dead slots between live ones
        live = torch.tensor([True, False, True, False, True], device=device)
        return [((_codes(3, 1, device), _codes(5, 1, device), live, 32),
                 {})]
    if op == "bucket_gather":             # 4 runs x 2 items >= 7 slots
        sizes = torch.full((3, 4), 2, dtype=torch.int32)
        cum = torch.cat([torch.zeros((3, 1), dtype=torch.int32),
                         torch.cumsum(sizes, 1, dtype=torch.int32)], 1)
        starts = (17 * torch.arange(12, dtype=torch.int32)).reshape(3, 4)
        return [((cum.to(device), starts.to(device), 7), {})]
    if op == "mips_topk":                 # every real score negative
        queries = -3.0 * torch.ones((3, 4))
        items = 1.0 + torch.arange(20, dtype=torch.float32).reshape(5, 4) / 20
        return [((f32(queries), f32(items), 5), {})]
    if op == "fused_query":               # the poison row 0, never probed
        items = torch.arange(32, dtype=torch.float32).reshape(8, 4) / 32
        items[0] = 100.0
        args = (f32(torch.ones((3, 4))),
                torch.tensor([[0, 2, 4]] * 3, dtype=torch.int32,
                             device=device),
                torch.tensor([[2, 6], [4, 1], [6, 3]], dtype=torch.int32,
                             device=device), f32(items), 4, 4)
        pay = torch.ones((8, 4), dtype=torch.int8, device=device)
        sc = f32((2.0 ** torch.arange(8, dtype=torch.float32))[:, None]
                 / 127.0)
        return [(args, {}), (args, {"payload": pay, "scale": sc})]
    raise ValueError(f"probe_inputs: unknown op {op!r}")


def _probe_calls(op: str, wrapper, device):
    """(kernel result, plain result, args, kwargs) of each probe call."""
    for args, kw in probe_inputs(op, device):
        yield (wrapper(*args, impl="cuda", **kw),
               wrapper(*args, impl="ref", **kw), args, kw)


def _probe_hash_encode(wrapper, device) -> List[str]:
    """Padding-bit discipline: with every projection positive, unmasked
    padding bits of the last word would read sign(0) = 1."""
    problems = []
    for got, want, _, _ in _probe_calls("hash_encode", wrapper, device):
        problems += _parity_problems("hash_encode", got, want)
        if bool(((got[:, -1].long() & 0xFFFFFFFF) >> 16).any()):
            problems.append(
                "hash_encode: padding bits of the final packed word are not "
                "0 (sign(0) leaked into the code)")
    return problems


def _probe_hamming(wrapper, device) -> List[str]:
    return [p for got, want, _, _ in _probe_calls("hamming_scan", wrapper,
                                                  device)
            for p in _parity_problems("hamming_scan", got, want)]


def _probe_bucket_match(wrapper, device) -> List[str]:
    return [p for got, want, _, _ in _probe_calls("bucket_match", wrapper,
                                                  device)
            for p in _parity_problems("bucket_match", got, want)]


def _probe_delta_scan(wrapper, device) -> List[str]:
    problems = []
    for got, want, args, _ in _probe_calls("delta_scan", wrapper, device):
        live = args[2]
        problems += _parity_problems("delta_scan", got, want)
        if bool((got[:, ~live] != -1).any()):
            problems.append("delta_scan: dead slots did not fuse to the -1 "
                            "sentinel")
        if bool((got[:, live] < 0).any()):
            problems.append("delta_scan: live slots carried the dead-slot "
                            "sentinel")
    return problems


def _probe_bucket_gather(wrapper, device) -> List[str]:
    problems = []
    for got, want, args, _ in _probe_calls("bucket_gather", wrapper, device):
        problems += _parity_problems("bucket_gather", got, want)
        if tuple(got.shape) != (args[0].shape[0], args[2]):
            problems.append("bucket_gather: rows beyond the queries' leaked "
                            "through the result")
    return problems


def _probe_mips_topk(wrapper, device) -> List[str]:
    """All real scores strongly negative: an out-of-range item scored 0
    would win."""
    problems = []
    for (gv, gi), (wv, wi), args, _ in _probe_calls("mips_topk", wrapper,
                                                    device):
        n = args[1].shape[0]
        if bool(((gi < 0) | (gi >= n)).any()):
            problems.append("mips_topk: an id outside [0, N) surfaced in the "
                            "returned top-k")
        problems += _parity_problems("mips_topk.ids", gi, wi)
        problems += _parity_problems("mips_topk.vals", gv, wv, atol=1e-4)
    return problems


def _probe_fused_query(wrapper, device) -> List[str]:
    """total = 4 probed slots of a 2,048-slot span, and item row 0
    dominating every real candidate while CSR position 0 is never probed:
    an unmasked slot would win every query. The int8 call gives the rows
    scales 2^i apart, so any payload/scale misalignment surfaces."""
    problems = []
    for (gv, gp), (wv, wp), _, kw in _probe_calls("fused_query", wrapper,
                                                  device):
        tag = "fused_query.int8" if kw else "fused_query"
        if bool((gp == 0).any()):
            problems.append(f"{tag}: an unprobed CSR position surfaced in "
                            f"the returned top-k (padded slots not masked "
                            f"to NEG)")
        problems += _parity_problems(f"{tag}.pos", gp, wp)
        problems += _parity_problems(f"{tag}.vals", gv, wv, atol=1e-4)
    return problems


def _seeded(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


def _runs(q: int, s: int, take: int, n: int, device):
    """(cum, starts) of ``s`` equal runs a query that hold ``take`` slots
    or more, starts spread over ``n`` rows."""
    size = take // s + 1
    cum = (size * torch.arange(s + 1, dtype=torch.int32)).repeat(q, 1)
    starts = ((997 * torch.arange(q * s, dtype=torch.int64))
              % max(1, n - size)).to(torch.int32).reshape(q, s)
    return cum.to(device), starts.to(device)


def _inputs_fused(s, device):
    cum, starts = _runs(s["q"], s["s"], s["total"], s["n"], device)
    return ((_seeded((s["q"], s["d"]), 1, device), cum, starts,
             _seeded((s["n"], s["d"]), 2, device)),
            {"total": s["total"], "k": s["k"], "kprime": s["kprime"]})


def _int8_payload(s, device):
    """fused_query's int8 build: seeded int8 rows and per-row scales."""
    g = torch.Generator().manual_seed(5)
    pay = torch.randint(-127, 128, (s["n"], s["d"]), generator=g,
                        dtype=torch.int8)
    scale = torch.rand((s["n"], 1), generator=g) / 127.0
    return {"payload": pay.to(device), "scale": scale.to(device)}


@dataclasses.dataclass(frozen=True)
class RegisteredKernel:
    """Registry entry of one CUDA op, for analysis only.

    ``entry`` names the C entry point ``_build.function`` loads (the
    reference's ``pallas_symbol``); ``plan(shapes, device)`` gives the
    launch plan the wrapper launches with; ``make_inputs(shapes, device)``
    builds seeded wrapper inputs for one shape class and
    ``cost_args(shapes)`` positions the class for ``cost_fn``, the very
    model the op's ``_charge`` call bills; ``kernel_cost_fn`` with
    ``kernel_cost_args(shapes, device)`` is the kernel's own work where it
    differs from the billed model (default: ``cost_fn``), the model K5
    holds against a cold time; ``probe(wrapper, device)`` runs
    the K4 padding probes through ``wrapper`` on the card and returns the
    problems found; ``fma``
    says whether the kernel's multiply-adds fuse (hash_encode rounds each
    multiply and add apart, at half the rate); each of ``variants`` is a
    (label, ``fn(shapes, device)``) whose keyword arguments select another
    build of the kernel (fused_query's int8 payload)."""

    op: str
    wrapper: Callable
    entry: str
    annotation: KernelAnnotation
    cost_fn: Callable
    cost_args: Callable
    ref_fn: Callable
    plan: Callable
    make_inputs: Callable
    shape_classes: Tuple[Dict[str, int], ...]
    probe: Optional[Callable] = None
    fma: bool = True
    variants: Tuple[Tuple[str, Callable], ...] = ()
    kernel_cost_fn: Optional[Callable] = None
    kernel_cost_args: Optional[Callable] = None

    def kernel_cost(self, shapes: Dict[str, int], device=None
                    ) -> Dict[str, float]:
        """{flops, hbm_bytes} of the kernel's own work at ``shapes``
        (``device``: the card whose launch plan it counts, else an
        H100's)."""
        if self.kernel_cost_fn is None:
            return self.cost_fn(*self.cost_args(shapes))
        return self.kernel_cost_fn(*self.kernel_cost_args(shapes, device))


def _entry(op, wrapper, entry, cost_fn, cost_args, ref_fn, make_inputs,
           classes, probe, **kw) -> RegisteredKernel:
    return RegisteredKernel(
        op=op, wrapper=wrapper, entry=entry, annotation=ANNOTATIONS[op],
        cost_fn=cost_fn, cost_args=cost_args, ref_fn=ref_fn,
        plan=functools.partial(launch_plan, op), make_inputs=make_inputs,
        shape_classes=classes, probe=probe, **kw)


KERNEL_REGISTRY: Dict[str, RegisteredKernel] = {
    "hash_encode": _entry(
        "hash_encode", hash_encode, "hash_encode", _cost.hash_encode_cost,
        lambda s: (s["n"], s["d"], s["L"]), _ref.hash_encode_ref,
        lambda s, dev: ((_seeded((s["n"], s["d"]), 1, dev),
                         _seeded((s["d"], s["L"]), 2, dev),
                         _seeded((s["n"],), 3, dev).abs(),
                         _seeded((s["L"],), 4, dev)), {}),
        ({"n": 256, "d": 96, "L": 64}, {"n": 128, "d": 1024, "L": 128}),
        _probe_hash_encode, fma=False),
    "hamming_scan": _entry(
        "hamming_scan", hamming_scan, "hamming", _cost.packed_scan_cost,
        lambda s: (s["q"], s["n"], 32 * s["w"]), _ref.hamming_ref,
        lambda s, dev: ((_codes(s["q"], s["w"], dev),
                         _codes(s["n"], s["w"], dev)), {}),
        ({"q": 64, "n": 2048, "w": 2}, {"q": 8, "n": 512, "w": 8}),
        _probe_hamming),
    "mips_topk": _entry(
        "mips_topk", mips_topk, "mips_topk", _cost.mips_topk_cost,
        lambda s: (s["q"], s["n"], s["d"], s["k"]), _ref.mips_topk_ref,
        lambda s, dev: ((_seeded((s["q"], s["d"]), 1, dev),
                         _seeded((s["n"], s["d"]), 2, dev)), {"k": s["k"]}),
        ({"q": 8, "n": 1024, "d": 64, "k": 8},
         {"q": 16, "n": 512, "d": 128, "k": 16}),
        _probe_mips_topk, kernel_cost_fn=mips_topk_kernel_cost,
        kernel_cost_args=lambda s, dev: (
            s["q"], s["n"], s["d"], s["k"],
            launch_plan("mips_topk", s, dev).stages[0].grid[0])),
    "bucket_match": _entry(
        "bucket_match", bucket_match, "bucket_match", _cost.packed_scan_cost,
        lambda s: (s["q"], s["b"], 32 * s["w"]), _ref.bucket_match_ref,
        lambda s, dev: ((_codes(s["q"], s["w"], dev),
                         _codes(s["b"], s["w"], dev)),
                        {"hash_bits": 32 * s["w"]}),
        ({"q": 64, "b": 1024, "w": 2},), _probe_bucket_match),
    "delta_scan": _entry(
        "delta_scan", delta_scan, "delta_scan", _cost.packed_scan_cost,
        lambda s: (s["q"], s["c"], 32 * s["w"]), _ref.delta_scan_ref,
        lambda s, dev: ((_codes(s["q"], s["w"], dev),
                         _codes(s["c"], s["w"], dev),
                         torch.arange(s["c"], device=dev) % 3 != 1),
                        {"hash_bits": 32 * s["w"]}),
        ({"q": 64, "c": 256, "w": 2},), _probe_delta_scan),
    "bucket_gather": _entry(
        "bucket_gather", bucket_gather, "bucket_gather",
        _cost.segmented_gather_cost, lambda s: (s["q"], s["p"]),
        _ref.bucket_gather_ref,
        lambda s, dev: (_runs(s["q"], s["s"], s["p"], 1 << 20, dev),
                        {"num_probe": s["p"]}),
        ({"q": 32, "s": 16, "p": 64},), _probe_bucket_gather),
    "fused_query": _entry(
        "fused_query", fused_query, "fused_query", _cost.fused_query_cost,
        lambda s: (s["q"], s["total"], s["d"], s["k"], s["kprime"]),
        _ref.fused_query_ref, _inputs_fused,
        ({"q": 16, "s": 8, "total": 256, "n": 4096, "d": 32, "k": 8,
          "kprime": 32},
         {"q": 8, "s": 16, "total": 1024, "n": 16384, "d": 32, "k": 16,
          "kprime": 64}),
        _probe_fused_query, variants=(("int8", _int8_payload),)),
}
