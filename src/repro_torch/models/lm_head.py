"""LSH-decode: RANGE-LSH over the unembedding matrix (port of
``repro/models/lm_head.py``).

Greedy decoding's argmax over logits IS maximum inner product search: the
database is the unembedding matrix (LM vocab rows have long-tailed
2-norms, the paper's Fig 1b setting) and the query is the final hidden
state. ``VocabIndex`` builds a RANGE-LSH index over the vocab once per
checkpoint; ``lsh_topk_tokens`` ranks vocab rows by the eq.-12 score from
one packed Hamming scan (``hash_encode`` + ``hamming_scan``) or a bucket
walk (``bucket_gather``) and exactly re-ranks the top-P.

Compatibility notes:
  * gemma2's final logit softcap is ``cap*tanh(logits/cap)`` — strictly
    monotone, so top-k by inner product == top-k by capped logit; the cap
    is applied after re-ranking.
  * every top-k here breaks ties by the lower id, as ``lax.top_k`` does
    (:func:`repro_torch.kernels.ref.stable_topk`).

Distribution: :func:`sharded_lsh_topk_tokens` splits the vocab rows over a
shard group (:mod:`repro_torch.core.distributed`); each shard ranks and
re-ranks its rows and an all-gather of (vals, ids) plus a stable merge
gives the global top-k — Algorithm 2 as one small collective.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hashing
from repro_torch.core.family import SimpleLSHFamily
from repro_torch.core.index import index_bits
from repro_torch.core.partition import effective_upper, percentile_partition
from repro_torch.core.probe import DEFAULT_EPS, item_scores
from repro_torch.core.topk import gathered_scores
from repro_torch.kernels import ops
from repro_torch.kernels.ref import full_f32, stable_topk
from repro_torch.obs.trace import span_or_null


class VocabIndex(NamedTuple):
    """RANGE-LSH index over the unembedding matrix.

    codes/range_id are in vocab order (NOT norm-sorted): token ids are the
    identity mapping, which keeps the decode path gather-free.
    ``calib`` optionally carries a planner calibration table
    (:func:`calibrate_vocab_index`) so decoding can take a
    ``recall_target`` instead of a hand-picked ``num_probe``.
    """

    codes: torch.Tensor      # (V, W) int32 (the packed uint32 bits)
    range_id: torch.Tensor   # (V,) int32
    upper: torch.Tensor      # (m,) f32
    A: torch.Tensor          # (d+1, hash_bits) f32
    code_len: int
    hash_bits: int
    eps: float
    calib: Optional[object] = None


def build_vocab_index(unembed: torch.Tensor,
                      generator: Optional[torch.Generator] = None, *,
                      code_len: int = 128, num_ranges: int = 64,
                      eps: float = DEFAULT_EPS, impl: str = "auto",
                      params: Optional[torch.Tensor] = None) -> VocabIndex:
    """unembed: (d, V) — indexed over columns (vocab rows), on its device.
    ``generator`` draws the projection unless ``params`` hands in the
    (d+1, hash_bits) matrix."""
    items = unembed.T.to(torch.float32).contiguous()       # (V, d)
    norms = hashing.l2_norm(items)
    part = percentile_partition(norms, num_ranges)
    upper = effective_upper(part)
    hash_bits = code_len - index_bits(num_ranges)
    fam = SimpleLSHFamily()
    if params is None:
        if generator is None:
            raise ValueError("pass a generator (or params) to draw the "
                             "projection")
        A = fam.make_params(generator, items.shape[-1], hash_bits,
                            device=items.device)
    else:
        A = torch.as_tensor(params, dtype=torch.float32, device=items.device)
    codes = fam.encode_items(A, items, upper[part.range_id.long()],
                             impl=impl)
    return VocabIndex(codes, part.range_id, part.upper, A, code_len,
                      hash_bits, eps)


def _query_codes(index: VocabIndex, hidden: torch.Tensor, impl: str
                 ) -> torch.Tensor:
    q = hashing.normalize(hidden.to(torch.float32))
    zeros = torch.zeros((q.shape[0],), dtype=q.dtype, device=q.device)
    return ops.hash_encode(q, index.A[:-1], zeros, index.A[-1], impl=impl)


def _dense_scores(index: VocabIndex, hidden: torch.Tensor,
                  true_vocab: Optional[int], impl: str) -> torch.Tensor:
    """(B, V) eq.-12 scores from one packed Hamming scan; padding rows
    ``-inf`` when ``true_vocab`` masks them."""
    ham = ops.hamming_scan(_query_codes(index, hidden, impl), index.codes,
                           impl=impl)                          # (B, V)
    scores = item_scores(index.upper, index.range_id, ham, index.hash_bits,
                         index.eps)
    V = index.codes.shape[0]
    if true_vocab is not None and true_vocab < V:
        scores = torch.where(torch.arange(V, device=scores.device)
                             < true_vocab, scores, -torch.inf)
    return scores


def calibrate_vocab_index(index: VocabIndex, unembed: torch.Tensor,
                          hidden: torch.Tensor, *, k: int = 10,
                          true_vocab: Optional[int] = None,
                          impl: str = "auto"):
    """Planner calibration for LSH-decode: measure where the exact top-k
    tokens of held-out hidden states land in the head's dense probe order,
    and return the fitted table — attach it with
    ``index._replace(calib=...)`` so ``lsh_topk_tokens`` can honor a
    ``recall_target``. ``hidden`` should be real decode-time hidden states
    (the serving distribution), ``(B, d)``."""
    from repro_torch.core.planner import calibrate_from_order

    scores = _dense_scores(index, hidden, true_vocab, impl)
    # ties break by lower id, matching the stable top-k of the probe path
    order = torch.argsort(-scores, dim=1, stable=True)
    _, truth = exact_topk_tokens(hidden, unembed, k, true_vocab=true_vocab)
    return calibrate_from_order(order, index.range_id, truth,
                                num_ranges=int(index.upper.shape[0]))


DEFAULT_NUM_PROBE = 1024


def lsh_topk_tokens(index: VocabIndex, hidden: torch.Tensor,
                    unembed: torch.Tensor, *, k: int = 8,
                    num_probe: Optional[int] = None,
                    final_softcap: Optional[float] = None,
                    true_vocab: Optional[int] = None,
                    impl: str = "auto",
                    buckets=None,
                    recall_target: Optional[float] = None,
                    tracker=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k tokens for hidden states (B, d).

    Returns (logit_vals (B, k) f32, token_ids (B, k)). Probes the
    ``num_probe`` best vocab rows by the eq.-12 score, then re-ranks them
    with exact inner products against the unembedding. ``true_vocab``
    excludes vocab-padding rows (configs/base.py padded_vocab).

    ``buckets`` (a :class:`repro_torch.core.bucket_index.BucketIndex` built
    over the vocab codes) switches candidate generation to the bucket
    engine — O(B log B) directory work instead of the dense (B, V) scan +
    top-k. Padding rows may then consume probe budget (they are still
    excluded from the final top-k by the ``true_vocab`` re-rank mask).

    ``recall_target`` plans ``num_probe`` from the planner's global-prefix
    budget in the index's calibration table. Exactly one of the two may be
    passed; with neither, ``DEFAULT_NUM_PROBE`` applies.

    ``tracker`` (a :class:`repro_torch.obs.Tracker`) times the candidate
    scan and re-rank stages.
    """
    if recall_target is not None:
        from repro_torch.core.planner import check_contract_k, plan_global
        if num_probe is not None:
            raise ValueError("pass one of num_probe/recall_target")
        if index.calib is not None:
            check_contract_k(index.calib, k)
        if index.calib is None:
            raise ValueError(
                "recall_target needs a calibrated VocabIndex — attach "
                "calibrate_vocab_index() via index._replace(calib=...)")
        if buckets is not None and true_vocab is not None \
                and true_vocab < index.codes.shape[0]:
            # the bucket walk spends budget on padding rows the dense
            # calibration masked out, silently under-delivering recall
            raise ValueError(
                "recall_target with engine='bucket' needs a padding-free "
                "store: build the index/buckets over the true vocab rows "
                "(as build_sharded_vocab_index does) instead of masking "
                "with true_vocab")
        num_probe = plan_global(index.calib, recall_target).num_probe
    elif num_probe is None:
        num_probe = DEFAULT_NUM_PROBE
    with span_or_null(tracker, "repro.models.lm_head.candidates") as sp:
        if buckets is not None:
            from repro_torch.core.engine import bucket_candidates
            cand = bucket_candidates(buckets,
                                     _query_codes(index, hidden, impl),
                                     num_probe, impl=impl)
        else:
            _, cand = stable_topk(
                _dense_scores(index, hidden, true_vocab, impl), num_probe)
        cand = sp.sync(cand)
    with span_or_null(tracker, "repro.models.lm_head.re_rank") as sp:
        logits = gathered_scores(hidden, unembed.T, cand)
        if true_vocab is not None:
            logits = torch.where(cand < true_vocab, logits, -torch.inf)
        vals, pos = stable_topk(logits, k)
        ids = sp.sync(torch.gather(cand.long(), 1, pos))
    if tracker is not None:
        tracker.count("repro.models.lm_head.queries", hidden.shape[0])
        tracker.observe("repro.models.lm_head.num_probe", num_probe)
    if final_softcap is not None:   # monotone: order unchanged
        vals = final_softcap * torch.tanh(vals / final_softcap)
    return vals, ids


def exact_topk_tokens(hidden: torch.Tensor, unembed: torch.Tensor, k: int,
                      final_softcap: Optional[float] = None,
                      true_vocab: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact baseline: full (B, V) f32 logits + stable top-k."""
    with full_f32():
        logits = hidden.to(torch.float32) @ unembed.to(torch.float32)
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    V = unembed.shape[1]
    if true_vocab is not None and true_vocab < V:
        logits = torch.where(torch.arange(V, device=logits.device)
                             < true_vocab, logits, -torch.inf)
    return stable_topk(logits, k)


def sharded_lsh_topk_tokens(index: VocabIndex, hidden: torch.Tensor,
                            unembed: torch.Tensor, group, *, k: int = 8,
                            num_probe_per_shard: int = 256,
                            impl: str = "auto"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocab-sharded LSH-decode (Algorithm 2 as one all-gather).

    The vocab rows split into ``group.size`` equal slices; each member
    ranks its slice by the eq.-12 score, re-ranks its top
    ``num_probe_per_shard`` exactly and keeps its top-k, and the gathered
    (vals, ids) merge into the global top-k with *global* token ids.
    ``index`` and ``unembed`` are the whole vocab's; a member of a process
    group reads only its slice.
    """
    from repro_torch.core.distributed import merge_shards

    V = unembed.shape[1]
    shards = group.size
    if V % shards:
        raise ValueError(f"vocab {V} does not split over {shards} shards")
    v_loc = V // shards
    q_codes = _query_codes(index, hidden, impl)
    local_v, local_i = [], []
    for s in group.members():
        sl = slice(s * v_loc, (s + 1) * v_loc)
        ham = ops.hamming_scan(q_codes, index.codes[sl], impl=impl)
        sc = item_scores(index.upper, index.range_id[sl], ham,
                         index.hash_bits, index.eps)
        _, cand = stable_topk(sc, num_probe_per_shard)       # local ids
        vals, pos = stable_topk(gathered_scores(hidden, unembed[:, sl].T,
                                                cand), k)
        local_v.append(vals)
        local_i.append(torch.gather(cand, 1, pos) + s * v_loc)
    # (S, B, k) gathered, merged with global ids (no -inf: logits finite)
    return merge_shards(group.all_gather(local_v),
                        group.all_gather(local_i), k)
