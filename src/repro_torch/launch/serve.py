"""Serving launcher: prefill / decode steps and a batched greedy server
(port of ``repro/launch/serve.py``).

``make_decode_step`` returns a one-token decoding function with an
optional LSH-decode head: RANGE-LSH over the unembedding
(models/lm_head.py) returning approximate top-k tokens instead of the full
(B, V) logits — the paper's technique in the serving path. Without a mesh
it runs eagerly on the params' device. With a ``DeviceMesh``
(``launch/mesh.py``) the params are DTensors placed by the stationary
serve specs (pure TP; ``fsdp_axis`` adds FSDP for models above
``FSDP_SERVE_THRESHOLD`` parameters) and the caches are sharded sequence
on ``model``: each attention layer combines its shards' partial
softmaxes (``attention.decode_attention_seq_sharded``), never gathering
a cache. The sharded LSH head runs over a shard group
(:mod:`repro_torch.core.distributed`).

``BatchedServer`` is a small request loop: prefills a batch, then
greedy-decodes it through whichever head is mounted — exact, LSH dense,
LSH bucket, fused (f32 or int8 phase 1), sharded, or streaming.

Live catalog updates: constructing the server with a ``streaming_index``
(a :class:`repro_torch.streaming.MutableIndex` over the unembedding
columns) swaps the frozen LSH head for the mutable one — the decode step
returns the hidden state and the merged base+delta top-k follows, so
``insert_tokens`` / ``delete_tokens`` take effect on the *next* decode
step. A host-side token map carries inserted rows back to embeddable token
ids (catalog upserts, token banning).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, lm_head
from repro_torch.obs.trace import span_or_null
from repro_torch.obs.tracker import resolve_tracker
from repro_torch.tree import leaves


FSDP_SERVE_THRESHOLD = 2e10  # params above this serve with FSDP+TP
MODEL_AXIS = "model"


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


def serve_fsdp_axis(params) -> Optional[str]:
    return "data" if param_count(params) > FSDP_SERVE_THRESHOLD else None


def _full(x):
    """A DTensor gathered whole (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_decode_step(cfg: ModelConfig, *, mesh=None,
                     fsdp_axis: Optional[str] = None,
                     lsh_decode: bool = False, topk: int = 8,
                     num_probe: int = 1024, vocab_meta=None,
                     engine: str = "dense",
                     return_hidden: bool = False) -> Callable:
    """Returns ``fn(params, tokens, caches, pos[, vidx_arrays])``.

    With ``return_hidden`` the step skips the logit head entirely and
    returns the final hidden state (B, d). With ``lsh_decode`` the output
    is ((vals (B, k), ids (B, k)), caches) — the RANGE-LSH head needs
    ``vocab_meta=(code_len, hash_bits, eps)`` and ``vidx_arrays`` =
    dict(codes, range_id, upper, A); ``engine="bucket"`` additionally
    expects the CSR bucket-store arrays (item_ids, bucket_start,
    bucket_rid, bucket_code, rank; see ``bucket_arrays``). Otherwise full
    (B, V) logits. The caches are written in place.

    With ``mesh`` the params are placed by the stationary serve specs
    (``fsdp_axis=None``) or FSDP + TP (``fsdp_axis="data"``), the caches
    by ``cache_specs`` (sequence on ``model``) and the tokens on the dp
    axes, each unless it is a DTensor placed so already; ``pos`` is a
    host int. The step returns plain logits (or hidden state, or the
    head's top-k, which runs on the gathered hidden state and
    unembedding) and the placed caches, which the next step takes."""

    def head(params, out, vidx_arrays):
        from repro_torch.core.bucket_index import BucketIndex

        index = lm_head.VocabIndex(
            vidx_arrays["codes"], vidx_arrays["range_id"],
            vidx_arrays["upper"], vidx_arrays["A"],
            vocab_meta[0], vocab_meta[1], vocab_meta[2])
        buckets = None
        if engine == "bucket":
            buckets = BucketIndex(
                vidx_arrays["item_ids"], vidx_arrays["bucket_start"],
                vidx_arrays["bucket_rid"], vidx_arrays["bucket_code"],
                vidx_arrays["rank"], vocab_meta[1], vocab_meta[2])
        return lm_head.lsh_topk_tokens(
            index, out, _full(lm._unembed_matrix(params, cfg)), k=topk,
            num_probe=num_probe, final_softcap=cfg.final_softcap,
            buckets=buckets)

    mode = "none" if (lsh_decode or return_hidden) else "full"

    def step(params, tokens, caches, cache_pos, vidx_arrays=None):
        out, new_caches = lm.decode_step(params, tokens, caches, cache_pos,
                                         cfg, logits_mode=mode)
        if return_hidden or not lsh_decode:
            return out, new_caches
        return head(params, out, vidx_arrays), new_caches

    if mesh is None:
        return step

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import ambient_mesh
    from repro_torch.parallel import sharding as shd
    pspecs = shd.param_specs(lm.init_params(None, cfg, device="meta"), cfg,
                             fsdp_axis=fsdp_axis,
                             serve_stationary=fsdp_axis is None)
    cspecs = shd.cache_specs(cfg, mesh)
    tspec = shd.Spec(shd.dp_axes(mesh))

    def mesh_step(params, tokens, caches, cache_pos, vidx_arrays=None):
        params = shd.to_shardings(mesh, pspecs, params)
        caches = shd.to_shardings(mesh, cspecs, caches)
        tokens = shd.distribute(tokens, mesh, tspec)
        with ambient_mesh(mesh), implicit_replication():
            out, new_caches = lm.decode_step(
                params, tokens, caches, int(cache_pos), cfg,
                seq_axis=MODEL_AXIS, logits_mode=mode)
            out = _full(out)
            if return_hidden or not lsh_decode:
                return out, new_caches
            return head(params, out, vidx_arrays), new_caches

    return mesh_step


def make_prefill(cfg: ModelConfig, *, mesh=None,
                 fsdp_axis: Optional[str] = None) -> Callable:
    """Returns ``fn(params, tokens, patches=None)`` -> (last hidden,
    caches). With ``mesh`` the params are placed by the serve param specs
    (TP, ``fsdp_axis`` for FSDP) and the tokens on the dp axes; the
    hidden state and caches come back as DTensors."""

    def fn(params, tokens, patches=None):
        return lm.prefill(params, tokens, cfg, patches)

    if mesh is None:
        return fn

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import ambient_mesh
    from repro_torch.parallel import sharding as shd
    pspecs = shd.param_specs(lm.init_params(None, cfg, device="meta"), cfg,
                             fsdp_axis=fsdp_axis)
    dp = shd.dp_axes(mesh)

    def mesh_fn(params, tokens, patches=None):
        params = shd.to_shardings(mesh, pspecs, params)
        tokens = shd.distribute(tokens, mesh, shd.Spec(dp, None))
        if patches is not None:
            patches = shd.distribute(patches, mesh, shd.Spec(dp, None, None))
        with ambient_mesh(mesh), implicit_replication():
            return lm.prefill(params, tokens, cfg, patches)

    return mesh_fn


def bucket_arrays(buckets) -> Dict[str, torch.Tensor]:
    """The CSR-store entries of the ``vidx_arrays`` dict (engine="bucket")."""
    return dict(item_ids=buckets.item_ids, bucket_start=buckets.bucket_start,
                bucket_rid=buckets.bucket_rid,
                bucket_code=buckets.bucket_code, rank=buckets.rank)


class _FusedVocabHead(NamedTuple):
    """A :class:`repro_torch.models.lm_head.VocabIndex` plus the resident
    item payload — the legacy-index surface the fused query engine needs:
    ``A`` for query encoding, ``range_id``/``upper``/``hash_bits``/``eps``
    for the bucket store, ``items`` (the unembedding columns) for the
    single-pass kernel's phase-1 scoring."""

    items: torch.Tensor
    codes: torch.Tensor
    range_id: torch.Tensor
    upper: torch.Tensor
    A: torch.Tensor
    code_len: int
    hash_bits: int
    eps: float
    calib: Optional[Any] = None


def _vocab_items(unembed: torch.Tensor,
                 true_vocab: Optional[int]) -> torch.Tensor:
    items = unembed.T.to(torch.float32)
    if true_vocab is not None:
        items = items[:true_vocab]
    return items.contiguous()


def build_sharded_vocab_index(unembed: torch.Tensor, generator=None, *,
                              num_shards: int, spec=None,
                              code_len: int = 64, num_ranges: int = 16,
                              true_vocab: Optional[int] = None,
                              align: str = "bucket",
                              calibration_queries=None,
                              calibration_k: Optional[int] = None,
                              params=None):
    """A :class:`repro_torch.core.distributed.ShardedIndex` over the
    unembedding columns, on their device. ``spec`` overrides
    ``code_len``/``num_ranges`` and picks the family/engine; hand it to
    ``BatchedServer(sharded_index=...)`` with a shard group of
    ``num_shards`` members.

    For a recall contract (``BatchedServer(recall_target=)``) pass
    ``calibration_queries`` — real decode-time hidden states — so the
    planner's curves are measured on the traffic they will govern."""
    from repro_torch.core.distributed import build_sharded
    from repro_torch.core.index import IndexSpec

    items = _vocab_items(unembed, true_vocab)
    if spec is None:
        spec = IndexSpec(family="simple", code_len=code_len, m=num_ranges,
                         engine="bucket")
    return build_sharded(spec, items, generator, num_shards, align=align,
                         strict=False,
                         calibration_queries=calibration_queries,
                         calibration_k=calibration_k, params=params,
                         device=items.device)


def build_streaming_vocab_index(unembed: torch.Tensor, generator=None, *,
                                code_len: int = 64, num_ranges: int = 16,
                                true_vocab: Optional[int] = None,
                                spec=None, params=None, **kw):
    """A :class:`repro_torch.streaming.MutableIndex` over the unembedding
    columns (global id == token id for the initial vocabulary), on their
    device.

    ``spec`` (a :class:`repro_torch.core.index.IndexSpec`) overrides
    ``code_len``/``num_ranges`` and selects the hash family."""
    from repro_torch import streaming
    from repro_torch.core import index as spec_index

    items = _vocab_items(unembed, true_vocab)
    if spec is not None:
        cidx = spec_index.build(spec, items, generator, params=params,
                                device=items.device)
        return streaming.MutableIndex.from_composed(cidx, **kw)
    return streaming.build(items, generator, code_len, num_ranges,
                           params=params, device=items.device, **kw)


class BatchedServer:
    """Minimal batched greedy-decode loop over the decode steps, on
    ``device`` (the card unless ``device="cpu"``), where ``params`` and the
    head index must live.

    ``streaming_index`` swaps the frozen LSH head for a mutable one and
    enables the :meth:`insert_tokens` / :meth:`delete_tokens` endpoints —
    catalog mutations are visible to the next decode step.

    ``sharded_index`` (a ``build_sharded_vocab_index`` result) serves the
    LSH head through the distributed engine over ``shard_group`` (an
    :class:`~repro_torch.core.distributed.InProcessShardGroup` of the
    index's shard count when None): the step returns the hidden state and
    the per-shard bucket traversal + O(k * shards) merge follow. The
    streaming delta path is not sharded (``streaming_index`` takes
    precedence).

    ``recall_target`` states the serving contract instead of a probe
    budget: the head index must carry planner calibration, and the budget
    (per-range for the sharded head, scalar for the frozen heads) is
    resolved once at construction; the streaming head re-plans per step.

    ``tracker`` (a :class:`repro_torch.obs.Tracker`; None = ambient
    default) instruments the loop — batch size, prefill / decode-step /
    topk-head spans, generated, inserted and deleted token counts — and is
    handed down to the distributed head engine and to the streaming index
    when they carry none of their own. Generated tokens are unchanged.
    The reference's ``repro.serve.decode_jit_cache`` gauge has no
    counterpart: nothing is compiled.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 max_seq: int = 256, batch: int = 8,
                 lsh_decode: bool = False,
                 vocab_index: Optional[Any] = None,
                 num_probe: int = 1024, engine: str = "dense",
                 quantized: bool = False,
                 streaming_index: Optional[Any] = None,
                 sharded_index: Optional[Any] = None,
                 shard_group=None,
                 token_map=None,
                 recall_target: Optional[float] = None,
                 tracker=None, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"the params live on {params['embed'].device}, "
                             f"the server was asked for {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self._fused_eng = None
        self.tracker = resolve_tracker(tracker)
        if streaming_index is not None and self.tracker is not None \
                and streaming_index.tracker is None:
            streaming_index.set_tracker(self.tracker)
        self.lsh_decode = lsh_decode and streaming_index is None \
            and sharded_index is None
        self.vocab_index = vocab_index
        self.num_probe = num_probe
        self.engine = engine
        self.streaming_index = streaming_index
        self.sharded_index = None
        # recall contract: resolve the serving budget from the head index's
        # planner calibration once, at construction. The streaming head
        # re-plans per step instead: its own inserts can flag the
        # calibration stale mid-session, and the contract must fail loudly
        # then, not silently serve the pre-drift budget.
        self._budgets = None
        self._recall_target = recall_target
        if recall_target is not None:
            head = (streaming_index if streaming_index is not None
                    else sharded_index if sharded_index is not None
                    else vocab_index if lsh_decode else None)
            if head is None:
                raise ValueError("recall_target needs an LSH head "
                                 "(vocab_index/streaming_index/"
                                 "sharded_index)")
            from repro_torch.core import planner
            if streaming_index is not None:
                planner.check_target(recall_target)
                if streaming_index.calib is None \
                        or streaming_index.calib_stale:
                    raise ValueError(
                        "streaming_index carries no fresh calibration — "
                        "planner.calibrate_streaming() + "
                        "set_calibration() first")
            elif sharded_index is not None:
                self._budgets = planner.resolve_budgets(
                    sharded_index.calib, recall_target).budgets
            else:
                if vocab_index is None or vocab_index.calib is None:
                    raise ValueError(
                        "recall_target needs a calibrated vocab_index "
                        "(lm_head.calibrate_vocab_index)")
                self.num_probe = planner.plan_global(
                    vocab_index.calib, recall_target).num_probe
        if sharded_index is not None and streaming_index is None:
            from repro_torch.core.distributed import (DistributedEngine,
                                                      InProcessShardGroup,
                                                      shard_index)
            if token_map is not None:
                raise ValueError(
                    "token_map applies to streaming_index; the sharded "
                    "head decodes index ids as token ids directly, so "
                    "build the index over vocab rows (id == token id)")
            group = (InProcessShardGroup(sharded_index.num_shards)
                     if shard_group is None else shard_group)
            placed = shard_index(sharded_index, group)
            self.sharded_index = placed
            self._dist = DistributedEngine(placed, group,
                                           tracker=self.tracker)
            self.decode_fn = make_decode_step(cfg, return_hidden=True)
            return
        if streaming_index is not None:
            # global index id -> embeddable token id. Identity is only
            # sound while every assigned id is a vocab row; an index that
            # already grew past the vocabulary carries ids whose tokens are
            # unknowable here, so the caller must supply the map. Inserts
            # through the server append their declared token.
            total = streaming_index.store_size + streaming_index.delta.count
            if token_map is not None:
                token_map = np.asarray(token_map, np.int64).reshape(-1)
                if token_map.shape[0] != total:
                    raise ValueError(
                        f"token_map covers {token_map.shape[0]} ids but "
                        f"the index has assigned {total}")
                self._token_map = token_map.copy()
            elif total <= cfg.padded_vocab:
                self._token_map = np.arange(total, dtype=np.int64)
            else:
                raise ValueError(
                    "streaming_index carries rows beyond the vocabulary; "
                    "pass token_map mapping every assigned id to an "
                    "embeddable token")
            self._token_map_dev = torch.as_tensor(self._token_map,
                                                  device=self.device)
            self.decode_fn = make_decode_step(cfg, return_hidden=True)
            return
        lsh_decode = self.lsh_decode
        if lsh_decode and engine == "fused":
            # single-pass LSH head: the step returns the hidden state and
            # the fused traversal+rescore kernel follows, like the
            # streaming/sharded heads. ``quantized`` scores phase 1 against
            # the int8 vocab payload.
            if vocab_index is None:
                raise ValueError("engine='fused' needs a vocab_index")
            from repro_torch.core.engine import QueryEngine
            unembed = lm._unembed_matrix(params, cfg)
            head = _FusedVocabHead(
                items=unembed.T.to(torch.float32).contiguous(),
                codes=vocab_index.codes, range_id=vocab_index.range_id,
                upper=vocab_index.upper, A=vocab_index.A,
                code_len=vocab_index.code_len,
                hash_bits=vocab_index.hash_bits, eps=vocab_index.eps,
                calib=vocab_index.calib)
            self._fused_eng = QueryEngine(head, engine="fused",
                                          quantized=quantized,
                                          tracker=self.tracker,
                                          device=self.device)
            self.decode_fn = make_decode_step(cfg, return_hidden=True)
            return
        if quantized:
            raise ValueError("quantized is a fused-head arm; pass "
                             "engine='fused'")
        meta = ((vocab_index.code_len, vocab_index.hash_bits,
                 vocab_index.eps) if lsh_decode else None)
        self._vidx_arrays = (dict(codes=vocab_index.codes,
                                  range_id=vocab_index.range_id,
                                  upper=vocab_index.upper,
                                  A=vocab_index.A) if lsh_decode else None)
        self._buckets = None
        if lsh_decode and engine == "bucket":
            from repro_torch.core.bucket_index import build_bucket_index
            self._buckets = build_bucket_index(vocab_index)
            self._vidx_arrays.update(bucket_arrays(self._buckets))
        # self.num_probe, not the ctor arg: a recall_target resolved the
        # planned budget above, and the step must honor it for every token
        self.decode_fn = make_decode_step(cfg, lsh_decode=lsh_decode,
                                          vocab_meta=meta,
                                          num_probe=self.num_probe,
                                          engine=engine)

    # -- streaming endpoints -------------------------------------------------

    def insert_tokens(self, vectors, token_ids) -> np.ndarray:
        """Register new unembedding rows (catalog upsert / vocab alias).

        ``token_ids`` (k,) declare the embeddable token each new row decodes
        to (generated ids must feed back through the embedding table).
        Returns the global index ids (pass to :meth:`delete_tokens`)."""
        if self.streaming_index is None:
            raise ValueError("server was not built with a streaming_index")
        token_ids = np.asarray(token_ids, np.int64).reshape(-1)
        vectors = torch.atleast_2d(torch.as_tensor(
            vectors, dtype=torch.float32, device=self.device))
        # validate before mutating the index
        if token_ids.shape[0] != vectors.shape[0]:
            raise ValueError(
                f"{vectors.shape[0]} vectors but {token_ids.shape[0]} "
                "token ids")
        if ((token_ids < 0) | (token_ids >= self.cfg.padded_vocab)).any():
            raise ValueError("token_ids must be embeddable (in "
                             f"[0, {self.cfg.padded_vocab}))")
        ids = self.streaming_index.insert(vectors)
        if int(ids[0]) != self._token_map.shape[0]:
            raise RuntimeError("index ids diverged from the token map "
                               "(was the index mutated directly?)")
        self._token_map = np.concatenate([self._token_map, token_ids])
        self._token_map_dev = torch.as_tensor(self._token_map,
                                              device=self.device)
        if self.tracker is not None:
            self.tracker.count("repro.serve.inserted_tokens",
                               token_ids.shape[0])
        return ids

    def delete_tokens(self, ids) -> None:
        """Tombstone catalog entries (token banning / upsert cleanup)."""
        if self.streaming_index is None:
            raise ValueError("server was not built with a streaming_index")
        self.streaming_index.delete(ids)
        if self.tracker is not None:
            self.tracker.count("repro.serve.deleted_tokens",
                               np.atleast_1d(np.asarray(ids)).size)

    def _streaming_topk(self, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy token via the mutable head (monotone final softcaps
        commute with top-1, so the cap is skipped). Under a recall contract
        the target is re-planned per step — the index raises if a
        repartition staled the calibration."""
        si = self.streaming_index
        if self._recall_target is not None:
            _, ids = si.query(hidden.to(torch.float32), 1,
                              recall_target=self._recall_target)
        else:
            _, ids = si.query(hidden.to(torch.float32), 1, self.num_probe)
        return self._token_map_dev[ids[:, 0].long()]

    def _sharded_topk(self, hidden: torch.Tensor) -> torch.Tensor:
        """Greedy token via the distributed LSH head (monotone final
        softcaps commute with top-1; index ids == vocab rows)."""
        if self._budgets is not None:
            _, ids = self._dist.query(hidden.to(torch.float32), 1,
                                      budgets=self._budgets)
        else:
            probe = min(self.num_probe, self.sharded_index.num_items)
            _, ids = self._dist.query(hidden.to(torch.float32), 1, probe)
        return ids[:, 0].long()

    # -- generation ----------------------------------------------------------

    def _head_token(self, hidden: torch.Tensor, unembed: torch.Tensor
                    ) -> torch.Tensor:
        """Greedy token via whichever LSH/exact head is mounted, timed as
        the ``repro.serve.topk_head`` stage."""
        with span_or_null(self.tracker, "repro.serve.topk_head") as sp:
            if self.streaming_index is not None:
                tok = self._streaming_topk(hidden)
            elif self.sharded_index is not None:
                tok = self._sharded_topk(hidden)
            elif self._fused_eng is not None:
                # monotone final softcaps commute with top-1, so the cap
                # is skipped (same argument as the streaming head)
                _, ids = self._fused_eng.query(
                    hidden.to(torch.float32), 1, self.num_probe)
                tok = ids[:, 0].long()
            elif self.lsh_decode:
                _, ids = lm_head.lsh_topk_tokens(
                    self.vocab_index, hidden, unembed, k=1,
                    num_probe=self.num_probe,
                    final_softcap=self.cfg.final_softcap,
                    buckets=self._buckets)
                tok = ids[:, 0]
            else:
                _, ids = lm_head.exact_topk_tokens(
                    hidden, unembed, 1, self.cfg.final_softcap)
                tok = ids[:, 0]
            return sp.sync(tok)

    def generate(self, prompts, steps: int) -> torch.Tensor:
        """prompts: (B, S0) ids -> generated ids (B, steps) int64."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, S0 = prompts.shape
        tr = self.tracker
        if tr is not None:
            tr.gauge("repro.serve.batch_size", B)
        with span_or_null(tr, "repro.serve.prefill") as sp:
            last_hidden, pf_caches = lm.prefill(self.params, prompts,
                                                self.cfg)
            sp.sync(last_hidden)
        caches = lm.extend_cache(self.cfg, pf_caches, self.max_seq)
        # first generated token comes from the prefill's last hidden state
        unembed = lm._unembed_matrix(self.params, self.cfg)
        tok = self._head_token(last_hidden, unembed)
        out = [tok]
        for t in range(steps - 1):
            args = (self.params, tok, caches, S0 + t)
            if self.streaming_index is not None \
                    or self.sharded_index is not None \
                    or self._fused_eng is not None:
                with span_or_null(tr, "repro.serve.decode_step") as sp:
                    hidden, caches = self.decode_fn(*args)
                    sp.sync(hidden)
                tok = self._head_token(hidden, unembed)
            elif self.lsh_decode:
                # head fused into the step: one span covers both
                with span_or_null(tr, "repro.serve.decode_step") as sp:
                    (vals, ids), caches = self.decode_fn(*args,
                                                         self._vidx_arrays)
                    tok = sp.sync(ids[:, 0])
            else:
                with span_or_null(tr, "repro.serve.decode_step") as sp:
                    logits, caches = self.decode_fn(*args)
                    tok = sp.sync(torch.argmax(logits, dim=-1))
            out.append(tok)
        if tr is not None:
            tr.count("repro.serve.generated_tokens", B * steps)
        return torch.stack(out, dim=1)
