"""The dry run's parts that need no mesh (port of
``repro/launch/dryrun.py``): a config's abstract params and caches on the
``meta`` device, its parameter counts and the stand-ins of every input of
a cell (config x shape), shapes and dtypes only, nothing allocated.
``chip_smoke.py`` phase 11 prints every cell's counts and analytic FLOPs
and bytes (parallel/analytic.py). Lowering a cell onto a mesh (the
reference's ``build_cell``, ``run_cell``, ``run_mips_cell`` and
``main``) waits for the port's mesh.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, get_config
from repro_torch.data.tokens import train_batch_specs
from repro_torch.models import lm
from repro_torch.tree import flatten_with_keys, leaves


def _abstract_params(cfg: ModelConfig):
    return lm.init_params(None, cfg, device="meta")


def _abstract_cache(cfg: ModelConfig, batch: int, seq: int):
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        return encdec.init_cache(cfg, batch, seq, device="meta")
    return lm.init_cache(cfg, batch, seq, device="meta")


def param_counts(cfg: ModelConfig, params) -> Dict[str, float]:
    """Total, MoE-active and expert parameter counts of a param tree (the
    reference's: a leaf under an ``ffn`` key with 4 or more axes is a
    stack of experts)."""
    total = sum(x.numel() for x in leaves(params))
    expert = 0
    for keys, leaf in flatten_with_keys(params):
        if any("ffn" in k for k in keys) and leaf.dim() >= 4:
            expert += leaf.numel()
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / cfg.moe.num_experts
    return {"total": float(total), "active": float(active),
            "expert": float(expert)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str):
    """Stand-ins on ``meta`` for every input of a cell, with the
    reference's shapes and dtypes: train cells give the batch dict;
    prefill cells ``tokens`` (and ``patches``/``frames``); decode cells
    ``tokens``, ``caches`` and ``cache_pos``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B = shape.global_batch
    extra = {}
    if cfg.num_patches:
        extra["patches"] = _meta((B, cfg.num_patches, cfg.d_model),
                                 torch.float32)
    if cfg.is_encoder_decoder:
        extra["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                                torch.float32)
    if shape.kind == "train":
        return {**train_batch_specs(B, shape.seq_len), **extra}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, shape.seq_len), torch.int32), **extra}
    return {"tokens": _meta((B,), torch.int32),
            "caches": _abstract_cache(cfg, B, shape.seq_len),
            "cache_pos": _meta((), torch.int32)}
