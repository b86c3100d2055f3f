"""Plain PyTorch reference of RANGE-LSH query serving with planned
per-range budgets: Yan et al., NeurIPS 2018, Algorithms 1 and 2, and the
recall planner that turns a target into per-range probe budgets.

It works everything out from the inputs that the benchmark draws (the
items, the hash projections, the calibration queries and the served
queries) and imports nothing of the system under test. What it fixes:

  * partition: rank items by 2-norm (ties by item id); range j holds the
    ranks in [j n/m, (j+1) n/m); U_j is the range's largest norm;
  * codes: sign([x / U_j; sqrt(1 - ||x / U_j||^2)] @ A), L = code_len -
    ceil(log2 m) bits packed LSB-first into 32-bit words; queries hash
    as [q / ||q||; 0];
  * probe order: a (range j, match count l) pair scores
    U_j cos(pi (1 - eps)(1 - l / L)) (eq. 12) and ranks in the stable
    descending order of all pairs; within one rank, items follow their
    bucket-store position: (range, code words read unsigned, item id);
  * budgets: for held-out queries, where the exact top-k items fall in
    their own range's probe order, on the probe grid {0, 1, round(1.3^i),
    n}; then greedy marginal gain per probe (ties: the cheaper step, then
    the lower range) until the mass-weighted recall meets the target. The
    curves are float32, as the planner keeps them;
  * answers: for each range j, the first min(b_j, n_j) items of range j in
    probe order are candidates; the answer is their exact top-k.
    ``admitted`` says whether given ids are among those candidates.

``mode`` is the precision of every matrix product: "f32" runs with TF32
off; "tf32" is the control one step below it (TF32 on the card; on the
CPU, where no TF32 unit exists, both operands are rounded to TF32's ten
mantissa bits first). Work over (queries, n) runs ``BLOCK`` queries at a
time.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

BLOCK = 64
GRID_FACTOR = 1.3
WORD_BITS = 32


@contextlib.contextmanager
def _tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to
    even (what the tensor cores read)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode not in ("f32", "tf32"):
        raise ValueError(f"unknown precision mode {mode!r}")
    tf32 = mode == "tf32"
    if tf32 and a.device.type != "cuda":
        a, b = round_tf32(a), round_tf32(b)
    with _tf32(tf32 and a.device.type == "cuda"):
        return a @ b


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., L) bool -> (..., ceil(L/32)) int64 words holding the unsigned
    32-bit values, bit i of word w = code bit 32 w + i."""
    n_bits = bits.shape[-1]
    words = -(-n_bits // WORD_BITS)
    b = torch.nn.functional.pad(bits.to(torch.int64),
                                (0, words * WORD_BITS - n_bits))
    b = b.reshape(bits.shape[:-1] + (words, WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return torch.sum(b << shifts, dim=-1)


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit value."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


class Index(NamedTuple):
    range_id: torch.Tensor    # (n,) int64
    counts: torch.Tensor      # (m,) int64 items per range
    upper: torch.Tensor       # (m,) f32 U_j (empty ranges: the largest)
    codes: torch.Tensor       # (n, W) int64 unsigned words
    rank: torch.Tensor        # (m * (L + 1),) int64 probe rank of (j, l)
    csr_pos: torch.Tensor     # (n,) int64 bucket-store position
    num_buckets: int
    hash_bits: int


def build(items: torch.Tensor, A: torch.Tensor, m: int, code_len: int,
          eps: float, mode: str) -> Index:
    n = items.shape[0]
    L = code_len - (math.ceil(math.log2(m)) if m > 1 else 0)
    if A.shape != (items.shape[1] + 1, L):
        raise ValueError(f"projections {tuple(A.shape)} for d="
                         f"{items.shape[1]}, L={L}")
    dev = items.device
    norms = torch.sqrt(torch.sum(items * items, dim=1))
    by_norm = torch.argsort(norms, stable=True)
    ranks = torch.empty(n, dtype=torch.int64, device=dev)
    ranks[by_norm] = torch.arange(n, device=dev)
    rid = torch.clamp_max(ranks * m // n, m - 1)
    counts = torch.bincount(rid, minlength=m)
    upper = torch.zeros(m, dtype=items.dtype, device=dev).scatter_reduce(
        0, rid, norms, "amax")
    upper = torch.where(counts > 0, upper, upper.max())
    x = items / upper[rid][:, None]
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(x * x, dim=1), 0.0))
    codes = pack(matmul(torch.cat([x, tail[:, None]], dim=1), A, mode) >= 0)
    del x, tail
    ls = torch.arange(L + 1, dtype=torch.int32, device=dev)
    frac = 1.0 - ls.to(torch.float32) / float(L)
    table = (upper[:, None] * torch.cos(math.pi * (1.0 - eps) * frac)[None, :]
             ).reshape(-1)
    rank = torch.empty_like(table, dtype=torch.int64)
    rank[torch.argsort(-table, stable=True)] = torch.arange(
        table.shape[0], device=dev)
    # bucket store: stable sorts from the last key to the first
    perm = torch.arange(n, device=dev)
    for key in [codes[:, w] for w in range(codes.shape[1] - 1, -1, -1)] + [rid]:
        perm = perm[torch.argsort(key[perm], stable=True)]
    csr_pos = torch.empty(n, dtype=torch.int64, device=dev)
    csr_pos[perm] = torch.arange(n, device=dev)
    c_s, r_s = codes[perm], rid[perm]
    new = (r_s[1:] != r_s[:-1]) | torch.any(c_s[1:] != c_s[:-1], dim=1)
    return Index(rid, counts, upper, codes, rank, csr_pos,
                 int(new.sum()) + 1, L)


def encode_queries(index: Index, queries: torch.Tensor, A: torch.Tensor,
                   mode: str) -> torch.Tensor:
    q = queries / torch.clamp_min(
        torch.sqrt(torch.sum(queries * queries, dim=1)), 1e-12)[:, None]
    return pack(matmul(q, A[:-1], mode) >= 0)


def range_positions(index: Index, q_codes: torch.Tensor) -> torch.Tensor:
    """(Q, n) position of each item in its own range's probe order."""
    n = index.range_id.shape[0]
    dist = torch.zeros((q_codes.shape[0], n), dtype=torch.int64,
                       device=q_codes.device)
    for w in range(q_codes.shape[1]):
        dist += popcount(q_codes[:, w:w + 1] ^ index.codes[None, :, w])
    pairs = index.rank.shape[0]
    r = index.rank[index.range_id * (index.hash_bits + 1)
                   + (index.hash_bits - dist)]
    del dist
    key = (index.range_id * pairs + r) * n + index.csr_pos
    del r
    order = torch.argsort(key, dim=1)
    del key
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(n, device=order.device).expand_as(
        order))
    offset = torch.cumsum(index.counts, 0) - index.counts
    return pos - offset[index.range_id]


def exact_topk(queries: torch.Tensor, items: torch.Tensor, k: int,
               mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-k MIPS, ``BLOCK`` queries at a time."""
    vals, ids = [], []
    for s in range(0, queries.shape[0], BLOCK):
        v, i = torch.topk(matmul(queries[s:s + BLOCK], items.T, mode), k,
                          dim=1)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def probe_grid(n: int) -> np.ndarray:
    vals = {0, int(n)}
    v = 1.0
    while v < n:
        vals.add(int(round(v)))
        v *= GRID_FACTOR
    return np.asarray(sorted(vals), np.int64)


def plan(index: Index, items: torch.Tensor, A: torch.Tensor,
         calibration: torch.Tensor, k: int, target: float,
         mode: str) -> Tuple[int, ...]:
    """Per-range budgets for ``target`` from the calibration queries."""
    _, truth = exact_topk(calibration, items, k, mode)
    wpos = []
    for s in range(0, calibration.shape[0], BLOCK):
        qc = encode_queries(index, calibration[s:s + BLOCK], A, mode)
        wpos.append(torch.gather(range_positions(index, qc), 1,
                                 truth[s:s + BLOCK]))
    t_wpos = torch.cat(wpos).reshape(-1).cpu().numpy()
    t_rid = index.range_id[truth.reshape(-1)].cpu().numpy()
    counts = index.counts.cpu().numpy()
    m = counts.shape[0]
    grid = probe_grid(int(counts.sum()))
    eff = np.minimum(grid[None, :], counts[:, None])
    recall = np.zeros((m, grid.size), np.float32)
    mass = np.zeros((m,), np.float32)
    for j in range(m):
        sel = t_rid == j
        mass[j] = sel.sum() / t_rid.size
        if sel.any():
            recall[j] = (t_wpos[sel][None, :] < eff[j][:, None]).mean(axis=1)
        recall[j, eff[j] >= counts[j]] = 1.0
    contrib = mass[:, None] * recall
    level = np.zeros((m,), np.int64)
    predicted = float(contrib[np.arange(m), level].sum())
    while predicted < target:
        best, best_key = -1, None
        for j in range(m):
            lv = level[j]
            if lv + 1 >= grid.size or eff[j, lv + 1] <= eff[j, lv]:
                continue
            cost = int(eff[j, lv + 1] - eff[j, lv])
            gain = float(contrib[j, lv + 1] - contrib[j, lv])
            key = (-gain / cost, cost, j)
            if best_key is None or key < best_key:
                best, best_key = j, key
        if best < 0:
            break
        level[best] += 1
        predicted = float(contrib[np.arange(m), level].sum())
    return tuple(int(eff[j, level[j]]) for j in range(m))


def candidates(index: Index, A: torch.Tensor, queries: torch.Tensor,
               budgets: Sequence[int], mode: str) -> torch.Tensor:
    """(Q, n) bool: the items that ``budgets`` admit for each query, the
    first min(b_j, n_j) of each range j in the query's probe order."""
    caps = torch.tensor(budgets, dtype=torch.int64, device=queries.device)
    return range_positions(index, encode_queries(index, queries, A, mode)) \
        < caps[index.range_id]


def admitted(index: Index, A: torch.Tensor, queries: torch.Tensor,
             budgets: Sequence[int], ids: torch.Tensor, mode: str
             ) -> torch.Tensor:
    """(Q, k) bool: whether each of ``ids`` (clamped into the catalogue)
    is among its query's candidates."""
    n = index.range_id.shape[0]
    safe = ids.to(torch.int64).clamp(0, n - 1)
    return torch.cat([
        torch.gather(candidates(index, A, queries[s:s + BLOCK], budgets,
                                mode), 1, safe[s:s + BLOCK])
        for s in range(0, queries.shape[0], BLOCK)])


def answer(index: Index, items: torch.Tensor, A: torch.Tensor,
           queries: torch.Tensor, budgets: Sequence[int], k: int,
           mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids) (Q, k): the exact top-k of each query's candidates."""
    vals, ids = [], []
    for s in range(0, queries.shape[0], BLOCK):
        qb = queries[s:s + BLOCK]
        cand = candidates(index, A, qb, budgets, mode)
        scores = matmul(qb, items.T, mode)
        scores.masked_fill_(~cand, float("-inf"))
        v, i = torch.topk(scores, k, dim=1)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)
