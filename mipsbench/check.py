"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/rangelsh.py``), which the
benchmark runs itself, on the same inputs, after the window.

Five numbers are compared, each with the limit its cell's workload file
sets (``limits``):

  * ``score_gap``: over every answer of the window, the widest gap
    between a returned value and the exact (float64) inner product of
    the returned id, as a share of the query's exact best inner product.
    An id outside the catalogue, an id repeated within one answer or a
    value that is not finite reads as ``INVALID``.
  * ``topk_miss``: over the sampled batches, the share of the reference's
    top-k ids that the answer lacks although their exact inner product
    beats the answer's worst returned one by more than twice the float32
    rounding bound of the two dot products (a tie within rounding may
    fall either way).
  * ``outside_candidates``: over the sampled batches, the share of
    returned ids that the reference's per-range budgets do not admit for
    their query (an exact comparison of sets): an answer drawn from more
    candidates than the plan allows, or from the wrong ones, shows here.
  * ``budgets_differ``: the number of norm ranges whose budget differs
    from the reference's plan (an exact comparison). In a cell that
    plans once these are the budgets every timed call was given; in one
    that plans per batch, the program's planner asked again after the
    window on the same calibration, while ``outside_candidates`` judges
    what the timed calls admitted.
  * ``code_bits_differ``: the share of the catalogue's code bits in which
    the program's index disagrees with the reference's. A wrong norm
    partition shows here too: it rescales the items it moves.

The planned width is printed beside them for the record.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import torch

from mipsbench.reference import rangelsh as ref

INVALID = 1.0e9
COMPARED = ("score_gap", "topk_miss", "outside_candidates",
            "budgets_differ", "code_bits_differ")
ROUNDING_FACTOR = 8.0     # multiple of sqrt(d) u bounding an f32 dot's error
CHUNK_ANSWERS = 65536     # answers whose rows are gathered at once


class Served(NamedTuple):
    """What one side (the program, or the control in its place) served.

    ``slots``: the pool batch of each answered batch; ``vals``/``ids``:
    (batches, batch, k) answers; ``codes``: (n, W) code words of the
    catalogue (any integer dtype holding the 32-bit patterns);
    ``budgets``: the per-range budgets the answers were planned with."""
    slots: Sequence[int]
    vals: torch.Tensor
    ids: torch.Tensor
    codes: torch.Tensor
    budgets: Sequence[int]


def exact_scores(queries: torch.Tensor, items: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) float64 inner products of each query with its ids' rows
    (ids clamped into the catalogue), in chunks of rows."""
    q, k = ids.shape
    out = torch.empty((q, k), dtype=torch.float64, device=ids.device)
    step = max(1, CHUNK_ANSWERS // k)
    safe = ids.clamp(0, items.shape[0] - 1).long()
    for s in range(0, q, step):
        rows = items[safe[s:s + step]].to(torch.float64)
        out[s:s + step] = torch.einsum(
            "qd,qkd->qk", queries[s:s + step].to(torch.float64), rows)
    return out


def abs_mass(queries: torch.Tensor, items: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) sum over d of |q_j x_ij|: the scale of a dot's rounding."""
    rows = items[ids.clamp(0, items.shape[0] - 1).long()].abs().to(torch.float64)
    return torch.einsum("qd,qkd->qk", queries.abs().to(torch.float64), rows)


def invalid_rows(vals: torch.Tensor, ids: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """(Q,) True where an answer holds an id outside [0, n), a repeated id
    or a value that is not finite."""
    bad = (ids < 0) | (ids >= n) | ~torch.isfinite(vals)
    s = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(bad)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return bad.any(dim=1) | dup.any(dim=1)


def score_gap(queries: torch.Tensor, items: torch.Tensor, vals: torch.Tensor,
              ids: torch.Tensor, best: torch.Tensor):
    """(widest relative gap, invalid answers) over one block of answers;
    ``best``: (Q,) exact best inner product of each query."""
    bad = invalid_rows(vals, ids, items.shape[0])
    gap = (vals.to(torch.float64) - exact_scores(queries, items, ids)).abs()
    rel = gap.amax(dim=1) / best.to(torch.float64).abs().clamp_min(1e-30)
    rel = torch.where(bad, INVALID, rel)
    return float(rel.max()), int(bad.sum())


def topk_misses(queries: torch.Tensor, items: torch.Tensor,
                ids: torch.Tensor, ref_ids: torch.Tensor) -> int:
    """Reference top-k ids that the answer ``ids`` lacks although they
    beat its worst returned id by more than the rounding of the two
    dots."""
    d = queries.shape[1]
    u = 2.0 ** -24
    got = exact_scores(queries, items, ids)
    want = exact_scores(queries, items, ref_ids)
    bound = ROUNDING_FACTOR * math.sqrt(d) * u
    got_err = bound * abs_mass(queries, items, ids)
    want_err = bound * abs_mass(queries, items, ref_ids)
    worst, at = got.min(dim=1)
    worst_err = torch.gather(got_err, 1, at[:, None])
    absent = ~(ref_ids[:, :, None] == ids[:, None, :]).any(dim=2)
    missed = absent & (want > worst[:, None] + worst_err + want_err)
    return int(missed.sum())


def code_bits_differ(codes: torch.Tensor, ref_codes: torch.Tensor,
                     hash_bits: int) -> float:
    a = codes.to(torch.int64) & 0xFFFFFFFF
    diff = sum(int(ref.popcount(a[:, w] ^ ref_codes[:, w]).sum())
               for w in range(ref_codes.shape[1]))
    return diff / (ref_codes.shape[0] * hash_bits)


def judge(served: Served, *, items: torch.Tensor, pool: torch.Tensor,
          batch: int, index: ref.Index, budgets: Sequence[int],
          truth_best: torch.Tensor, ref_answers: Dict[int, torch.Tensor],
          admitted: Dict[int, torch.Tensor], limits: Dict[str, float]
          ) -> dict:
    """The numbers compared, each beside its limit, and ``correct``.

    ``truth_best``: (pool batches, batch) exact best inner product of each
    pool query (only the served slots are read); ``ref_answers``: per
    sampled slot, the reference's (batch, k) ids; ``admitted``: per
    sampled slot, (batch, k) whether the reference's budgets admit each
    id that the first served answer of that slot returned."""
    k = served.ids.shape[-1]
    pool_b = pool.view(-1, batch, pool.shape[1])
    slots = torch.as_tensor(list(served.slots), dtype=torch.int64,
                            device=pool.device)
    step = max(1, CHUNK_ANSWERS // (batch * k))
    worst, invalid = 0.0, 0
    for s in range(0, slots.shape[0], step):
        sl = slots[s:s + step]
        g, bad = score_gap(pool_b[sl].reshape(-1, pool.shape[1]), items,
                           served.vals[s:s + step].reshape(-1, k),
                           served.ids[s:s + step].reshape(-1, k),
                           truth_best[sl].reshape(-1))
        worst, invalid = max(worst, g), invalid + bad
    missed = entries = outside = 0
    seen = set()
    for b, slot in enumerate(served.slots):
        if slot not in ref_answers or slot in seen:
            continue
        seen.add(slot)
        q = pool[slot * batch:(slot + 1) * batch]
        ids = served.ids[b].to(torch.int64)
        missed += topk_misses(q, items, ids.clamp(0, items.shape[0] - 1),
                              ref_answers[slot])
        entries += ref_answers[slot].numel()
        outside += int((~admitted[slot]).sum())
    m = len(budgets)
    numbers = {
        "score_gap": worst,
        "topk_miss": missed / max(entries, 1),
        "outside_candidates": outside / max(entries, 1),
        "budgets_differ": m if len(served.budgets) != m else sum(
            int(a) != int(b) for a, b in zip(served.budgets, budgets)),
        "code_bits_differ": code_bits_differ(served.codes, index.codes,
                                             index.hash_bits),
    }
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in COMPARED}
    width, ref_width = sum(served.budgets), sum(budgets)
    return {
        "correct": entries > 0 and all(c["value"] <= c["limit"]
                                       for c in checks.values()),
        "checks": checks,
        "invalid_answers": invalid,
        "compared_entries": entries,
        "planned_width": {"program": width, "reference": ref_width},
    }
