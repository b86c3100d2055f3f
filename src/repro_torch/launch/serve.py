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
LSH bucket, fused (f32 or int8 phase 1), sharded, or streaming. Its two
calls are :meth:`BatchedServer.prefill` (the batch's prompts, in chunks of
at most ``PREFILL_TOKENS`` tokens, into caches of ``max_seq`` slots) and
:meth:`BatchedServer.step` (one decode step of the batch, returning the
head's top-k); ``generate`` is the one, then the other in a loop.

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
from repro_torch.kernels.ref import stable_topk
from repro_torch.models import lm, lm_head
from repro_torch.obs.trace import DeviceSpans, span_or_null
from repro_torch.obs.tracker import resolve_tracker
from repro_torch.tree import leaves


FSDP_SERVE_THRESHOLD = 2e10  # params above this serve with FSDP+TP
MODEL_AXIS = "model"
#: tokens one prefill chunk holds: a batch of longer prompts is prefilled
#: a few sequences at a time (at least one), so that activations stay
#: small beside the weights and caches (64 x 8,192 tokens of
#: DeepSeek-V2-Lite in one chunk would not fit an 80 GB card)
PREFILL_TOKENS = 1 << 15
#: tokens an LSH head that runs inside the decode step returns
#: (``make_decode_step``'s ``topk``)
STEP_TOPK = 8


class _StepGraph(NamedTuple):
    """A decode step captured as a CUDA graph over one set of caches: its
    static token and position inputs, its static hidden output and its
    layers' span sites."""
    caches: Any
    tokens: torch.Tensor
    pos: torch.Tensor
    graph: Any
    hidden: torch.Tensor
    spans: Any


class DecodeOut(NamedTuple):
    """One decode step's answer: the head's top-k logit values and token
    ids (B, k), and the step's final hidden state (B, d) where the head
    runs after the step (None where it runs inside it, or is exact)."""
    vals: torch.Tensor
    ids: torch.Tensor
    hidden: Optional[torch.Tensor]


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
                     lsh_decode: bool = False, topk: int = STEP_TOPK,
                     num_probe: int = 1024, vocab_meta=None,
                     engine: str = "dense",
                     return_hidden: bool = False) -> Callable:
    """Returns ``fn(params, tokens, caches, pos[, vidx_arrays],
    tracker=None)`` (``tracker``: the model's layer spans and counters).

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

    def step(params, tokens, caches, cache_pos, vidx_arrays=None,
             tracker=None):
        out, new_caches = lm.decode_step(params, tokens, caches, cache_pos,
                                         cfg, logits_mode=mode,
                                         tracker=tracker)
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

    def mesh_step(params, tokens, caches, cache_pos, vidx_arrays=None,
                  tracker=None):
        params = shd.to_shardings(mesh, pspecs, params)
        caches = shd.to_shardings(mesh, cspecs, caches)
        tokens = shd.distribute(tokens, mesh, tspec)
        with ambient_mesh(mesh), implicit_replication():
            out, new_caches = lm.decode_step(
                params, tokens, caches, int(cache_pos), cfg,
                seq_axis=MODEL_AXIS, logits_mode=mode, tracker=tracker)
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

    On the card, with a head that runs after the step (fused, sharded or
    streaming) and a model whose step is capturable
    (``lm.decode_capturable``: DeepSeek-V2's layout), :meth:`step` replays
    the model's step as a CUDA graph, captured at the first step on a set
    of caches (and again for new caches), so the host launches one graph
    in place of some four thousand kernels. Tracked or not, the step is
    that graph: its layers' spans are timed on the device inside it.

    ``buckets``: a bucket store already built over ``vocab_index``
    (``build_bucket_index``) for the bucket and fused heads; None builds
    one.

    ``recall_target`` states the serving contract instead of a probe
    budget: the head index must carry planner calibration, and the budget
    (per-range for the sharded head, scalar for the frozen heads) is
    resolved once at construction; the streaming head re-plans per step.

    ``tracker`` (a :class:`repro_torch.obs.Tracker`; None = ambient
    default) instruments the loop — batch size, prefill / decode-step /
    topk-head spans, generated, inserted and deleted token counts, and the
    model's layer spans and routing counters (``models/lm.py``; those of
    a replayed graph are emitted after its head) — and is handed down to
    the distributed head engine, the fused head's engine and the
    streaming index when they carry none of their own; setting
    ``server.tracker`` later hands it down the same way. Generated tokens
    are unchanged.
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
                 tracker=None, device=None, buckets=None):
        self.device = resolve_device(device)
        self._capturable = (self.device.type == "cuda"
                            and lm.decode_capturable(cfg))
        self._graph: Optional[_StepGraph] = None
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"the params live on {params['embed'].device}, "
                             f"the server was asked for {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self._fused_eng = self._dist = None
        self.streaming_index = streaming_index
        self._tracker = None
        self.tracker = resolve_tracker(tracker)
        self.lsh_decode = lsh_decode and streaming_index is None \
            and sharded_index is None
        self.vocab_index = vocab_index
        self.num_probe = num_probe
        self.engine = engine
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
                                          buckets=buckets,
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
            self._buckets = (build_bucket_index(vocab_index)
                             if buckets is None else buckets)
            self._vidx_arrays.update(bucket_arrays(self._buckets))
        # self.num_probe, not the ctor arg: a recall_target resolved the
        # planned budget above, and the step must honor it for every token
        self.decode_fn = make_decode_step(cfg, lsh_decode=lsh_decode,
                                          vocab_meta=meta,
                                          num_probe=self.num_probe,
                                          engine=engine)

    @property
    def tracker(self):
        return self._tracker

    @tracker.setter
    def tracker(self, tracker) -> None:
        """The server's tracker, handed down to each head engine that
        carries none of its own (or the one handed down before)."""
        before, self._tracker = self._tracker, tracker
        for head in (self._fused_eng, self._dist):
            if head is not None and head.tracker is before:
                head.tracker = tracker
        si = self.streaming_index
        if si is not None and si.tracker is before:
            si.set_tracker(tracker)

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

    def _streaming_topk(self, hidden: torch.Tensor, k: int):
        """Top-k via the mutable head, ids mapped to tokens. Under a recall
        contract the target is re-planned per step — the index raises if
        a repartition staled the calibration."""
        si = self.streaming_index
        if self._recall_target is not None:
            vals, ids = si.query(hidden.to(torch.float32), k,
                                 recall_target=self._recall_target)
        else:
            vals, ids = si.query(hidden.to(torch.float32), k,
                                 self.num_probe)
        return vals, self._token_map_dev[ids.long()]

    def _sharded_topk(self, hidden: torch.Tensor, k: int):
        """Top-k via the distributed LSH head (index ids == vocab rows)."""
        if self._budgets is not None:
            return self._dist.query(hidden.to(torch.float32), k,
                                    budgets=self._budgets)
        probe = min(self.num_probe, self.sharded_index.num_items)
        return self._dist.query(hidden.to(torch.float32), k, probe)

    # -- generation ----------------------------------------------------------

    def prefill(self, prompts, *, tail: int = 1):
        """Prefill the batch: prompts (B, S0) ids -> (the final hidden
        states of the prompts' last ``tail`` positions (B, tail, d), caches
        of ``max_seq`` slots holding the prompts), timed as the
        ``repro.serve.prefill`` stage. Sequences go through the model a
        chunk at a time, each chunk at most ``PREFILL_TOKENS`` tokens (at
        least one sequence), and each chunk's caches are written into the
        batch's; no sequence sees another, so the chunks change nothing
        that a sequence computes."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, S0 = prompts.shape
        tr = self.tracker
        if tr is not None:
            tr.gauge("repro.serve.batch_size", B)
        rows = max(1, PREFILL_TOKENS // S0)
        with span_or_null(tr, "repro.serve.prefill") as sp:
            caches = lm.init_cache(self.cfg, B, self.max_seq,
                                   device=self.device)
            kinds = lm.cache_kinds(self.cfg)
            tails = []
            for b0 in range(0, B, rows):
                h, part = lm.prefill_hidden(self.params,
                                            prompts[b0:b0 + rows], self.cfg,
                                            tracker=tr)
                tails.append(h[:, -tail:])
                for kind, dst, src in zip(kinds, caches, part):
                    for d, s_ in zip(dst, src):
                        if kind == "attn":   # slots 0 .. S0-1 of max_seq
                            d[:, b0:b0 + rows, :S0] = s_
                        else:
                            d[:, b0:b0 + rows] = s_
                del h, part
            hidden = sp.sync(torch.cat(tails))
        return hidden, caches

    def head_topk(self, hidden: torch.Tensor, k: int = 1):
        """(vals, ids) (B, k): the top-k tokens of final hidden states (B,
        d) through whichever LSH/exact head is mounted, timed as the
        ``repro.serve.topk_head`` stage. A final softcap, monotone, is
        applied to the values and leaves the order as it is."""
        unembed = lm._unembed_matrix(self.params, self.cfg)
        cap = self.cfg.final_softcap
        with span_or_null(self.tracker, "repro.serve.topk_head") as sp:
            if self.streaming_index is not None:
                vals, ids = self._streaming_topk(hidden, k)
            elif self.sharded_index is not None:
                vals, ids = self._sharded_topk(hidden, k)
            elif self._fused_eng is not None:
                vals, ids = self._fused_eng.query(
                    hidden.to(torch.float32), k, self.num_probe)
            elif self.lsh_decode:
                vals, ids = lm_head.lsh_topk_tokens(
                    self.vocab_index, hidden, unembed, k=k,
                    num_probe=self.num_probe, final_softcap=cap,
                    buckets=self._buckets)
                cap = None
            else:
                vals, ids = lm_head.exact_topk_tokens(hidden, unembed, k,
                                                      cap)
                cap = None
            if cap is not None:
                vals = cap * torch.tanh(vals / cap)
            sp.sync((vals, ids))
        return vals, ids.long()

    def step(self, tokens: torch.Tensor, caches, pos, k: int = 1
             ) -> DecodeOut:
        """One decode step of the batch: tokens (B,) at cache slot
        ``pos``, the caches written in place; returns the head's top-k
        (the exact head's from the step's logits, an in-step LSH head's at
        most ``STEP_TOPK``). Timed as the ``repro.serve.decode_step``
        stage; a head that runs after the model is timed after it, as the
        ``repro.serve.topk_head`` stage."""
        tr = self.tracker
        args = (self.params, tokens, caches, pos)
        after = (self.streaming_index is not None
                 or self.sharded_index is not None
                 or self._fused_eng is not None)
        launched = None if tr is None else tr.clock()
        with span_or_null(tr, "repro.serve.decode_step") as sp:
            if after and self._capturable:
                hidden = sp.sync(self._replay(tokens, caches, pos))
            elif after:
                hidden = sp.sync(self.decode_fn(*args, tracker=tr)[0])
            elif self.lsh_decode:
                # head fused into the step
                if k > STEP_TOPK:
                    raise ValueError(f"the in-step LSH head returns "
                                     f"{STEP_TOPK} tokens, not {k}")
                (vals, ids), _ = self.decode_fn(*args, self._vidx_arrays,
                                                tracker=tr)
                out = DecodeOut(vals[:, :k], ids[:, :k].long(), None)
                sp.sync((out.vals, out.ids))
            else:
                logits, _ = self.decode_fn(*args, tracker=tr)
                if k == 1:      # the first of equal maxima, as stable_topk
                    ids = torch.argmax(logits, dim=-1, keepdim=True)
                    vals = torch.gather(logits, -1, ids)
                else:
                    vals, ids = stable_topk(logits, k)
                out = DecodeOut(vals, ids.long(), None)
                sp.sync((out.vals, out.ids))
        if after:
            out = DecodeOut(*self.head_topk(hidden, k), hidden)
            if self._capturable and tr is not None:
                self._graph.spans.emit(tr, launched)
        return out

    def _replay(self, tokens: torch.Tensor, caches, pos) -> torch.Tensor:
        """The step's final hidden state from the captured graph: the
        tokens and position copied into its inputs, one replay, its output
        copied out (the next replay overwrites it). Captured first where
        the caches are new: one eager run on a side stream (lazy
        initialisations; it writes the cache slot the step writes, with
        the same values), then the capture, its layers' span sites
        recording into a ``DeviceSpans``."""
        g = self._graph
        if g is None or g.caches is not caches:
            self._graph = None      # the last graph's memory goes first
            static_tok = tokens.clone()
            static_pos = torch.full((), int(pos), dtype=torch.int64,
                                    device=self.device)

            def run(tracker=None):
                return self.decode_fn(self.params, static_tok, caches,
                                      static_pos, tracker=tracker)[0]

            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph, spans = torch.cuda.CUDAGraph(), DeviceSpans()
            with torch.cuda.graph(graph):
                hidden = run(spans)
            g = self._graph = _StepGraph(caches, static_tok, static_pos,
                                         graph, hidden, spans)
        g.tokens.copy_(tokens)
        g.pos.fill_(int(pos))
        g.graph.replay()
        return g.hidden.clone()

    def generate(self, prompts, steps: int) -> torch.Tensor:
        """prompts: (B, S0) ids -> generated ids (B, steps) int64: one
        :meth:`prefill`, the first token from the head on the prompts' last
        hidden state, then ``steps - 1`` :meth:`step` calls, each fed the
        last step's top token."""
        hidden, caches = self.prefill(prompts)
        B, S0 = hidden.shape[0], torch.as_tensor(prompts).shape[1]
        tok = self.head_topk(hidden[:, -1], 1)[1][:, 0]
        out = [tok]
        for t in range(steps - 1):
            tok = self.step(tok, caches, S0 + t).ids[:, 0]
            out.append(tok)
        if self.tracker is not None:
            self.tracker.count("repro.serve.generated_tokens", B * steps)
        return torch.stack(out, dim=1)
