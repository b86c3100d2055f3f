"""Carry an index built by the JAX package across to the port.

The caller hands over the reference ``ComposedIndex``'s fields and its
``CalibrationTable`` as numpy arrays (``np.asarray`` of each field); this
module imports nothing of the JAX package. Packed uint32 codes become
int32 tensors with the same bits. The result is a
:class:`repro_torch.core.index.ComposedIndex` whose queries run on the
same projections, partition, codes and score table as the reference's.

A legacy shim tuple (``SimpleLSHIndex``, ``RangeLSHIndex``,
``SignALSHIndex``, ``L2ALSHIndex``, ``MultiTableIndex``) crosses as its
fields: :func:`legacy_index_from_fields`.

A training state crosses as the reference's ``TrainState`` with numpy
leaves: :func:`train_state_from_tree`.

A streaming index crosses as the reference's ``streaming.index_tree``
(nested dict, each leaf as a numpy array):
:func:`mutable_index_from_tree` mounts it as a port
:class:`~repro_torch.streaming.MutableIndex`, as ``load_index`` does with
a snapshot on disk.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (l2_alsh, multi_table, range_lsh, sign_alsh,
                              simple_lsh)
from repro_torch.core.index import ComposedIndex, IndexSpec
from repro_torch.core.planner import CalibrationTable

INDEX_FIELDS = ("items", "norms", "codes", "range_id", "upper", "upper_eff",
                "lower", "params", "table")
SPEC_FIELDS = ("family", "code_len", "m", "scheme", "engine", "num_tables",
               "eps", "recall_target", "charge_index_bits", "alsh_m",
               "alsh_U", "alsh_r")
CALIB_FIELDS = ("probe_grid", "recall_range", "recall_global", "truth_mass",
                "range_counts", "k", "num_queries")


def spec_from_fields(fields: Mapping, *, impl: str = "auto") -> IndexSpec:
    """An :class:`IndexSpec` from the reference spec's fields; the
    reference's ``impl`` ("pallas") does not carry over, ``impl`` names
    the port's dispatch instead."""
    return IndexSpec(impl=impl, **{f: fields[f] for f in SPEC_FIELDS
                                   if f in fields})


def calibration_from_fields(fields: Mapping) -> CalibrationTable:
    """The port's :class:`CalibrationTable` from the reference's fields."""
    return CalibrationTable(
        np.asarray(fields["probe_grid"], np.int64),
        np.asarray(fields["recall_range"], np.float32),
        np.asarray(fields["recall_global"], np.float32),
        np.asarray(fields["truth_mass"], np.float32),
        np.asarray(fields["range_counts"], np.int64),
        int(fields["k"]), int(fields["num_queries"]))


def _host_params(params):
    """Numpy copies of a parameter pytree: one array, or a tuple of
    arrays (L2-ALSH's ``(a, b)``)."""
    if isinstance(params, (tuple, list)):
        return tuple(np.array(p, np.float32) for p in params)
    return np.array(params, np.float32)


def index_from_fields(arrays: Mapping, spec: Mapping, hash_bits: int, *,
                      calib: Optional[Mapping] = None, impl: str = "auto",
                      device=None) -> ComposedIndex:
    """The port's :class:`ComposedIndex` from the reference index's
    arrays (``INDEX_FIELDS``), spec fields and ``hash_bits``, on
    ``device`` (the card unless ``device="cpu"``). Any family crosses:
    ``params`` is one matrix for the sign families and the pair ``(a,
    b)`` for L2-ALSH; ``codes`` are packed uint32 words or int32
    hashes."""
    device = resolve_device(device)
    pspec = spec_from_fields(spec, impl=impl)

    def tensor(name, dtype):
        a = np.asarray(arrays[name])
        if name == "codes":
            # uint32 sign words keep their bits; L2-ALSH hashes are int32
            a = np.ascontiguousarray(a).view(np.int32)
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return ComposedIndex(
        spec=pspec,
        items=tensor("items", np.float32),
        norms=tensor("norms", np.float32),
        codes=tensor("codes", np.int32),
        range_id=tensor("range_id", np.int32),
        upper=tensor("upper", np.float32),
        upper_eff=tensor("upper_eff", np.float32),
        lower=tensor("lower", np.float32),
        params=pspec.resolve_family().params_on(
            _host_params(arrays["params"]), device),
        table=tensor("table", np.float32),
        hash_bits=int(hash_bits),
        calib=None if calib is None else calibration_from_fields(calib))


LEGACY = {"simple_lsh": simple_lsh.SimpleLSHIndex,
          "range_lsh": range_lsh.RangeLSHIndex,
          "sign_alsh": sign_alsh.SignALSHIndex,
          "l2_alsh": l2_alsh.L2ALSHIndex,
          "multi_table": multi_table.MultiTableIndex}


def legacy_index_from_fields(kind: str, fields: Mapping, *, device=None):
    """The port's legacy shim tuple of ``kind`` (a key of ``LEGACY``)
    from the reference tuple's fields, on ``device``
    (the card unless ``device="cpu"``). Every field of the tuple must be
    given: arrays as numpy arrays, scalars as Python numbers. Packed
    uint32 ``codes`` become int32 tensors with the same bits, ``hashes``
    and ``range_id`` int32, every other array f32; scalars stay as they
    are."""
    if kind not in LEGACY:
        raise ValueError(f"unknown legacy index {kind!r}; expected one of "
                         f"{tuple(LEGACY)}")
    cls = LEGACY[kind]
    device = resolve_device(device)

    def field(name, v):
        if not isinstance(v, np.ndarray):
            return v
        if name in ("codes", "hashes"):
            a = np.array(v).view(np.int32)
        elif name == "range_id":
            a = np.array(v, np.int32)
        else:
            a = np.array(v, np.float32)
        return torch.as_tensor(a, device=device)

    return cls(**{f: field(f, fields[f]) for f in cls._fields})


def mutable_index_from_tree(tree: Mapping, *, device=None, **kw):
    """The port's :class:`~repro_torch.streaming.MutableIndex` from an
    ``index_tree`` (the reference's or the port's; leaves as numpy
    arrays) on ``device`` (the card unless ``device="cpu"``): same
    storage, CSR store, delta buffer, bounds, projections and, when the
    tree has one, calibration. ``kw`` passes runtime knobs (engine, impl,
    repartition_policy, skew thresholds) to the index."""
    from repro_torch.streaming.delta import DeltaBuffer
    from repro_torch.streaming.index import _CSR, MutableIndex
    from repro_torch.streaming.persist import family_from_meta

    device = resolve_device(device)
    st, dl, cs, meta = tree["store"], tree["delta"], tree["csr"], tree["meta"]
    family = family_from_meta(meta)
    capacity = int(meta["capacity"])
    delta = DeltaBuffer(capacity, int(dl["items"].shape[1]),
                        int(dl["codes"].shape[1]), device=device)
    delta.count = int(dl["count"])
    delta._norms = np.array(dl["norms"], np.float32)
    delta._codes = np.array(dl["codes"], np.uint32)
    delta._rid = np.array(dl["rid"], np.int32)
    delta._ids = np.array(dl["ids"], np.int32)
    delta._live = np.array(dl["live"], bool)
    delta._perm = np.array(dl["perm"], np.int32)
    delta._ord = np.array(dl["ord"], np.int32)
    delta.items = torch.as_tensor(np.array(dl["items"], np.float32),
                                  device=device)
    delta._sync()
    csr = _CSR(**{f: np.array(cs[f], np.uint32 if "code" in f else np.int32)
                  for f in _CSR._fields})
    mindex = MutableIndex(
        family=family,
        items=np.array(st["items"], np.float32),
        norms=np.asarray(st["norms"]), codes=np.asarray(st["codes"]),
        range_id=np.asarray(st["range_id"]), live=np.asarray(st["live"]),
        upper=np.asarray(meta["upper"]), lower=np.asarray(meta["lower"]),
        edges=np.asarray(meta["edges"]),
        A=np.array(meta["A"], np.float32), code_len=int(meta["code_len"]),
        hash_bits=int(meta["hash_bits"]), eps=float(meta["eps"]),
        capacity=capacity, max_tombstones=int(meta["max_tombstones"]),
        csr=csr, delta=delta, tomb_csr=int(meta["tomb_csr"]),
        device=device, **kw)
    cal = tree.get("calib")
    if cal is not None:
        mindex.calib = calibration_from_fields(cal)
        mindex.calib_stale = bool(int(cal["stale"]))
    return mindex


def _param_tensor(a, device) -> torch.Tensor:
    """A numpy parameter as a tensor: bf16 (ml_dtypes' ``bfloat16``, as
    ``np.asarray`` of a JAX bf16 array gives it) carried bit for bit,
    anything else as f32 or its integer type."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def lm_params_from_tree(tree: Mapping, *, device=None):
    """The port's LM params (``repro_torch.models.lm``) from the
    reference's param tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``), on ``device`` (the card unless ``device="cpu"``). The
    layout is the same for every family (layers stacked per pattern
    position; MoE experts, MLA projections, the SSM's and xLSTM's f32
    leaves, an MLP-free block's empty ``ffn``, the encoder-decoder's nested
    ``encoder`` and ``layers`` stacks); bf16 and f32 leaves keep their
    bits."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _param_tensor(node, device)

    return conv(tree)


VOCAB_FIELDS = ("codes", "range_id", "upper", "A", "code_len",
                "hash_bits", "eps")


def vocab_index_from_fields(fields: Mapping, *, calib: Optional[Mapping] = None,
                            device=None):
    """The port's :class:`~repro_torch.models.lm_head.VocabIndex` from the
    reference's fields (``VOCAB_FIELDS``; arrays as numpy, packed uint32
    codes become int32 with the same bits) and, when given, its
    calibration table's fields, on ``device``."""
    from repro_torch.models.lm_head import VocabIndex
    device = resolve_device(device)
    return VocabIndex(
        codes=torch.as_tensor(np.ascontiguousarray(
            np.asarray(fields["codes"], np.uint32)).view(np.int32),
            device=device),
        range_id=torch.as_tensor(np.array(fields["range_id"], np.int32),
                                 device=device),
        upper=torch.as_tensor(np.array(fields["upper"], np.float32),
                              device=device),
        A=torch.as_tensor(np.array(fields["A"], np.float32), device=device),
        code_len=int(fields["code_len"]), hash_bits=int(fields["hash_bits"]),
        eps=float(fields["eps"]),
        calib=None if calib is None else calibration_from_fields(calib))


SHARDED_FIELDS = ("params", "rank", "dir_code", "dir_rid", "dir_size",
                  "dir_shard", "dir_local_start", "items", "codes",
                  "range_id", "bucket_of", "bucket_off", "perm", "valid",
                  "num_shards", "rows_per_shard", "num_items", "hash_bits")


def sharded_index_from_fields(fields: Mapping, spec: Mapping, *,
                              calib: Optional[Mapping] = None,
                              impl: str = "auto", device=None):
    """The port's :class:`~repro_torch.core.distributed.ShardedIndex` from
    the reference's fields (``SHARDED_FIELDS``, arrays as numpy), its
    spec's fields and, when given, its calibration table's, on
    ``device``."""
    from repro_torch.core.distributed import ShardedIndex
    device = resolve_device(device)
    pspec = spec_from_fields(spec, impl=impl)
    ints = ("num_shards", "rows_per_shard", "num_items", "hash_bits")

    def field(name):
        a = fields[name]
        if name in ints:
            return int(a)
        if name == "params":
            return pspec.resolve_family().params_on(_host_params(a), device)
        a = np.asarray(a)
        if name in ("dir_code", "codes"):
            a = np.ascontiguousarray(a).view(np.int32)
        elif name == "items":
            a = np.array(a, np.float32)
        elif name == "valid":
            a = np.array(a, bool)
        else:
            a = np.array(a, np.int32)
        return torch.as_tensor(a, device=device)

    return ShardedIndex(
        spec=pspec, **{f: field(f) for f in SHARDED_FIELDS},
        calib=None if calib is None else calibration_from_fields(calib))


def train_state_from_tree(tree, *, device=None):
    """The port's :class:`~repro_torch.launch.train.TrainState` from the
    reference's ``TrainState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``), on ``device`` (the card unless ``device="cpu"``): params as
    :func:`lm_params_from_tree` carries them, the AdamW step (int32),
    moments and EF residual bit for bit. Its tree paths are the
    reference's (``.params/...``, ``.opt/.step``, ``.opt/.mu/...``,
    ``.ef/.residual/...``), so the two checkpoint managers key it alike."""
    from repro_torch.launch.train import TrainState
    from repro_torch.optim.compression import ErrorFeedback
    from repro_torch.optim.optimizers import AdamWState

    device = resolve_device(device)
    return TrainState(
        lm_params_from_tree(tree.params, device=device),
        AdamWState(_param_tensor(tree.opt.step, device),
                   lm_params_from_tree(tree.opt.mu, device=device),
                   lm_params_from_tree(tree.opt.nu, device=device)),
        ErrorFeedback(lm_params_from_tree(tree.ef.residual, device=device)))
