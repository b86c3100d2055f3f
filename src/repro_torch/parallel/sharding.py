"""Sharding rules: logical tensor roles -> mesh placements (port of
``repro/parallel/sharding.py``).

A tensor's placement is a :class:`Spec`, the port's PartitionSpec: a
tuple with one entry per tensor dimension, each a mesh dimension's name,
a tuple of names or None. :func:`to_placements` turns it into DTensor
placements over a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``Shard(dim)`` on each mesh dimension a tensor dimension names,
``Replicate`` elsewhere) and :func:`to_shardings` distributes a tree of
tensors by a tree of specs.

Mesh dimensions (launch/mesh.py): ``data`` (+ ``pod`` when multi-pod)
carry the batch / FSDP dimension; ``model`` carries TP / EP. Rules are
keyed on leaf *names* in the param tree, as in the reference:

  * big 2D weights are sharded 2D: the contraction-adjacent dim on
    ``model`` (TP), the d_model side on the FSDP axis (``data``);
  * MoE expert stacks shard experts on ``model`` (EP) + d_model on FSDP;
  * norms / gates / small tables replicate;
  * decode KV caches shard **sequence on `model`**; the decode combines
    the shards' partial softmaxes explicitly
    (``models/attention.decode_attention_seq_sharded``);
  * recurrent (mamba/xLSTM) state shards d_inner (or d_v) on ``model``.

``fsdp`` may be None (pure-TP serving for models that fit) or "data"
(ZeRO-style, default for training and for >20B-param serving). The
optimizer state mirrors params (AdamW mu/nu get the same spec).

The functions that read a mesh read only its dimension names and sizes
(a DeviceMesh, or any object with ``axis_names`` and ``shape``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import current_mesh, shape_of
from repro_torch.tree import (flatten_with_keys, flatten_with_paths,
                              unflatten)

PyTree = Any

MODEL = "model"


class Spec(tuple):
    """A tensor's placement over a mesh: one entry per dimension, each a
    mesh dimension's name, a tuple of names or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def spec_items(spec_tree: PyTree):
    """(path key, Spec) pairs of a spec tree, in ``tree``'s order."""
    return flatten_with_paths(spec_tree, is_leaf=is_spec)


def _map_keys(fn, tree: PyTree, keys: Tuple[str, ...] = ()) -> PyTree:
    """``fn(keys, leaf)`` over a tensor tree (keys as
    :func:`repro_torch.tree.flatten_with_keys` spells them)."""
    if isinstance(tree, dict):
        return {k: _map_keys(fn, v, keys + (str(k),)) for k, v in
                tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_keys(fn, v, keys + (f".{n}",))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_keys(fn, v, keys + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(keys, tree)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch: ('pod', 'data') when present."""
    names = shape_of(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def dp_axes_for_batch(mesh, batch: Optional[int]) -> Tuple[str, ...]:
    """Largest dp-axis prefix whose size divides ``batch`` (long_500k has
    global_batch=1: the batch is replicated rather than unevenly split)."""
    if batch is None:
        return dp_axes(mesh)
    shape = shape_of(mesh)
    axes = []
    prod = 1
    for a in dp_axes(mesh):
        if batch % (prod * shape[a]) == 0:
            axes.append(a)
            prod *= shape[a]
    return tuple(axes)


# name -> base spec (without the stacked leading reps axis)
def _base_spec(name: str, ndim: int, fsdp) -> Spec:
    two_d = {
        # (in, out) layouts: contraction side / output side
        "w_q": (fsdp, MODEL), "w_k": (fsdp, MODEL), "w_v": (fsdp, MODEL),
        "w_o": (MODEL, fsdp),
        "w_gate": (fsdp, MODEL), "w_up": (fsdp, MODEL),
        "w_down": (MODEL, fsdp),
        "w_in": (fsdp, MODEL), "w_out": (MODEL, fsdp),
        "in_proj": (fsdp, MODEL), "out_proj": (MODEL, fsdp),
        "x_proj": (MODEL, None), "dt_proj": (None, MODEL),
        "w_dq": (fsdp, None), "w_uq": (None, MODEL),
        "w_dkv": (fsdp, None), "w_kr": (fsdp, None),
        "w_uk": (None, MODEL), "w_uv": (None, MODEL),
        "w_z": (fsdp, MODEL), "w_x": (fsdp, MODEL),
        "s_gate": (fsdp, MODEL), "s_up": (fsdp, MODEL),
        "s_down": (MODEL, fsdp),
        "w_if": (MODEL, None),
        "patch_proj": (fsdp, None),
        "router": (fsdp, None),
    }
    one_d = {
        "b_q": (MODEL,), "b_k": (MODEL,), "b_v": (MODEL,),
        "b_in": (MODEL,), "conv_b": (MODEL,), "dt_bias": (MODEL,),
        "D": (MODEL,), "b": (MODEL,),
    }
    if name == "embed":
        return Spec(MODEL, fsdp)
    if name == "unembed":
        return Spec(fsdp, MODEL)
    if name == "pos_table":
        return Spec(None, fsdp)
    if name in ("A_log",):
        return Spec(MODEL, None)
    if name in ("conv_w",):
        return Spec(None, MODEL)
    if name == "r_h":
        return Spec(None, None, None, None)
    if name in two_d:
        return Spec(*two_d[name])
    if name in one_d and ndim <= 2:
        return Spec(*one_d[name])
    # norms, gates, scalars, anything unmatched: replicate
    return Spec(*([None] * ndim))


_STACKED_PREFIXES = ("pos", "layers")


def _is_stacked(keys) -> bool:
    return any(str(k).startswith(_STACKED_PREFIXES) for k in keys)


def _maybe_stack(base: Spec, keys, ndim: int) -> Spec:
    if _is_stacked(keys) and len(base) == ndim - 1:
        return Spec(None, *base)
    if len(base) != ndim:   # fallback: replicate mismatched ranks
        return Spec(*([None] * ndim))
    return base


def param_specs(params: PyTree, cfg: ModelConfig, *,
                fsdp_axis: Optional[str] = "data",
                serve_stationary: bool = False) -> PyTree:
    """Spec tree matching ``params`` (the reference's rules).

    ``serve_stationary``: weights never move at decode time —
    embed/unembed shard on vocab only, ``w_o`` on its output d_model, and
    MoE expert stacks shard 2D (expert -> model, d_ff -> data)."""

    def spec(keys, leaf) -> Spec:
        name = keys[-1]
        ndim = leaf.dim()
        if serve_stationary and name in ("embed", "unembed"):
            return (Spec(MODEL, None) if name == "embed"
                    else Spec(None, MODEL))
        if serve_stationary and name == "w_o":
            return _maybe_stack(Spec(None, MODEL), keys, ndim)
        if name in ("w_k", "w_v", "b_k", "b_v") and cfg.n_kv < 16:
            # GQA with n_kv below the TP width: the tiny K/V projections
            # replicate; the 16-way q-head sharding keeps attention local
            base = Spec(*([None] * (2 if name.startswith("w") else 1)))
            return _maybe_stack(base, keys, ndim)
        # MoE expert stacks: leading expert dim -> EP on model (3D before
        # layer stacking, 4D after)
        if name in ("w_gate", "w_up", "w_down") and any(
                "ffn" in k for k in keys) and cfg.moe is not None:
            if ndim >= 3 + _is_stacked(keys):
                if serve_stationary:
                    base = (Spec(MODEL, None, "data")
                            if name in ("w_gate", "w_up")
                            else Spec(MODEL, "data", None))
                else:
                    base = (Spec(MODEL, fsdp_axis, None)
                            if name in ("w_gate", "w_up")
                            else Spec(MODEL, None, fsdp_axis))
                return _maybe_stack(base, keys, ndim)
        base = _base_spec(name, ndim - _is_stacked(keys), fsdp_axis)
        return _maybe_stack(base, keys, ndim)

    return _map_keys(spec, params)


# ---------------------------------------------------------------------------
# batch / cache / state specs
# ---------------------------------------------------------------------------


def zero_dp_specs(params: PyTree, mesh) -> PyTree:
    """Pure ZeRO data parallelism for training: each parameter shards
    over ('data', 'model') on its largest dimension that the whole mesh
    divides (trailing dims preferred on ties); the rest replicate."""
    shape = shape_of(mesh)
    shards = shape["data"] * shape["model"]
    axes = ("data", "model")

    def spec(_, leaf) -> Spec:
        best = None
        for dim in range(leaf.dim() - 1, -1, -1):   # prefer trailing dims
            n = leaf.shape[dim]
            if n % shards == 0 and n >= shards:
                if best is None or n > leaf.shape[best]:
                    best = dim
        parts = [None] * leaf.dim()
        if best is not None:
            parts[best] = axes
        return Spec(*parts)

    return _map_keys(spec, params)


#: include 'model' in the activation batch anchor (set by launchers when
#: using zero_dp_specs)
ZERO_DP_ANCHOR = False


def batch_specs(mesh, kind: str) -> PyTree:
    dp = dp_axes(mesh)
    if kind == "train":
        return {"tokens": Spec(dp, None), "labels": Spec(dp, None),
                "mask": Spec(dp, None)}
    if kind == "decode":
        return {"tokens": Spec(dp), "positions": Spec(dp)}
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, mesh, batch: Optional[int] = None) -> Any:
    """Specs mirroring ``lm.init_cache``'s tree (the encoder-decoder's:
    ``encdec.init_cache``'s). Sequence -> model axis."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xlstm_mod

    dp = dp_axes_for_batch(mesh, batch)
    if cfg.is_encoder_decoder:
        return {
            "self": attn_mod.AttnCache(Spec(None, dp, MODEL, None, None),
                                       Spec(None, dp, MODEL, None, None)),
            "cross_k": Spec(None, dp, None, None, None),
            "cross_v": Spec(None, dp, None, None, None),
        }
    out = []
    for i in range(lm_mod.combined_period(cfg)):
        kind = lm_mod.position_kind(cfg, i)
        if kind == "attn":
            if cfg.mla is not None:
                out.append(attn_mod.AttnCache(Spec(None, dp, MODEL, None),
                                              Spec(None, dp, MODEL, None)))
            else:
                out.append(attn_mod.AttnCache(
                    Spec(None, dp, MODEL, None, None),
                    Spec(None, dp, MODEL, None, None)))
        elif kind == "mamba":
            out.append(ssm_mod.SSMCache(Spec(None, dp, None, MODEL),
                                        Spec(None, dp, MODEL, None)))
        elif kind == "mlstm":
            out.append(xlstm_mod.MLSTMCache(
                Spec(None, dp, None, None, MODEL),
                Spec(None, dp, None, None),
                Spec(None, dp, None),
                Spec(None, dp, None, MODEL)))
        elif kind == "slstm":
            out.append(xlstm_mod.SLSTMCache(
                Spec(None, dp, MODEL), Spec(None, dp, MODEL),
                Spec(None, dp, MODEL), Spec(None, dp, MODEL)))
    return tuple(out)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension in mesh order, ``Shard(d)`` where tensor dimension ``d``
    names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    used = set()
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"spec {spec!r} names {a!r}, not a "
                                 f"dimension of the mesh {names}")
            if a in used:
                raise ValueError(f"spec {spec!r} names {a!r} twice")
            used.add(a)
    out = []
    for a in names:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(x, mesh, spec: Spec):
    """``x`` as a DTensor on ``mesh`` placed by ``spec`` (a DTensor
    already so placed is returned as it is)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(mesh, spec)
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def to_shardings(mesh, spec_tree: PyTree, tree: PyTree) -> PyTree:
    """``tree`` with every tensor distributed on ``mesh`` by the Spec at
    its path in ``spec_tree`` (same structure); non-tensor leaves pass."""
    import torch
    specs = dict(spec_items(spec_tree))
    values = {}
    for path, leaf in flatten_with_paths(tree):
        values[path] = (distribute(leaf, mesh, specs[path])
                        if isinstance(leaf, torch.Tensor) else leaf)
    return unflatten(tree, values)


def local_bytes(tree: PyTree) -> int:
    """Bytes of this rank's shards of a tree's tensors (a plain tensor
    counts whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for _, x in flatten_with_keys(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def settled(x):
    """A DTensor holding partial sums (a product contracted over a sharded
    dimension) reduced to whole values; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            pl.is_partial() for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in x.placements])


def constrain_batch_leading(x):
    """Pin an activation's leading (batch) dim to the dp axes, rest
    replicated — the residual-stream anchor, as a ``redistribute``.

    Without it, DTensor's propagation pushes 2D weight shardings into the
    activations. No-op without an ambient mesh
    (``launch/mesh.ambient_mesh``) or on a plain tensor, so model code
    stays usable stand-alone."""
    from torch.distributed.tensor import DTensor
    if current_mesh() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    shape = shape_of(mesh)
    axes = []
    prod = 1
    cands = ("pod", "data", "model") if ZERO_DP_ANCHOR else ("pod", "data")
    for a in cands:
        if a in shape and x.shape[0] % (prod * shape[a]) == 0:
            axes.append(a)
            prod *= shape[a]
    return distribute(x, mesh, Spec(tuple(axes), *([None] * (x.dim() - 1))))
