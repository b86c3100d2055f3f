"""Training launcher: the train step and a restartable loop (port of
``repro/launch/train.py``), on one device or over a mesh.

``make_train_step`` builds ``step(state, batch, step_no)``: the autograd
of ``lm.train_loss`` (each repetition of the layer period and each loss
chunk recomputed in the backward pass) -> global-norm clip -> bf16
gradient compression with error feedback (optim/compression.py) ->
AdamW with f32 moments, which updates the params in place.

``run_training`` is the end-to-end loop: the synthetic token corpus,
async checkpoints every N steps, restart from the latest one, and the
straggler deadline monitor (launch/runtime.py).

With a ``DeviceMesh`` (``launch/mesh.py``) the state is a tree of
DTensors placed by :func:`state_specs` (params, moments and residuals
FSDP x TP by ``parallel/sharding.param_specs``, or ZeRO over every mesh
axis with ``zero_dp``) and the batch on the dp axes; each gradient is
brought to its param's placement (the reduce-scatter) before the clip.
The residual stream is anchored batch-leading
(``sharding.constrain_batch_leading``).

The state's trees have the reference's tree paths (``TrainState``,
``AdamWState`` and ``ErrorFeedback`` field names, the params' dict
keys), so a checkpoint written by either package restores into the
other. There is no donation: the step updates the state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim.compression import (ErrorFeedback, bf16_compress,
                                           ef_init)
from repro_torch.optim.optimizers import (AdamWState, adamw_init,
                                          adamw_update, clip_by_global_norm,
                                          cosine_schedule)
from repro_torch.tree import flatten_with_paths, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: ErrorFeedback


@dataclasses.dataclass
class TrainHParams:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    compress_grads: bool = True
    aux_weight: float = 0.01


def init_state(generator: torch.Generator, cfg: ModelConfig, *,
               device=None) -> TrainState:
    """Random params drawn from ``generator`` on ``device`` (the card
    unless ``device="cpu"``), zero AdamW moments and residuals."""
    params = lm.init_params(generator, cfg, device=device)
    return TrainState(params, adamw_init(params), ef_init(params))


def init_state_abstract(cfg: ModelConfig) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device, nothing
    allocated (for the dry run and for checking a checkpoint's layout)."""
    return init_state(None, cfg, device="meta")


def grad_leaves(params) -> Tuple[Any, List[torch.Tensor], Callable]:
    """(the params' tree with every leaf a fresh autograd leaf sharing its
    storage, those leaves in tree order, ``regroup``): ``regroup(xs)``
    puts one tensor per leaf (its gradient) back into the params'
    structure."""
    keyed = flatten_with_paths(params)
    leaves = [p.detach().requires_grad_() for _, p in keyed]

    def regroup(xs):
        return unflatten(params, {k: x for (k, _), x in zip(keyed, xs)})

    return regroup(leaves), leaves, regroup


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   hp: TrainHParams):
    """(loss, {"ce", "aux"}, grads): ``lm.train_loss`` and its gradient
    with respect to every param (each in its param's dtype), as a tree of
    the params' structure. A param the loss does not use (xLSTM's
    ``norm2`` with ``d_ff = 0``) gets a zero gradient, as ``jax.grad``
    gives it."""
    live, leaves, regroup = grad_leaves(params)
    loss, metrics = lm.train_loss(live, batch, cfg, aux_weight=hp.aux_weight)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            regroup(grads))


def apply_grads(state: TrainState, grads, lr, hp: TrainHParams
                ) -> Tuple[TrainState, torch.Tensor]:
    """Clip, compress (``hp.compress_grads``) and take the AdamW step at
    ``lr``: returns (new state, global norm before clipping)."""
    grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
    ef = state.ef
    if hp.compress_grads:
        grads, ef = bf16_compress(grads, ef)
    params, opt = adamw_update(grads, state.opt, state.params, lr=lr,
                               weight_decay=hp.weight_decay)
    return TrainState(params, opt, ef), gnorm


def state_specs(state: TrainState, cfg: ModelConfig,
                fsdp_axis: Optional[str] = "data", *,
                zero_dp: bool = False, mesh=None) -> TrainState:
    """The state's Spec tree: the params' (``sharding.param_specs``, or
    ``zero_dp_specs`` over ``mesh``) for the params, the AdamW moments
    and the residuals, the step count replicated."""
    from repro_torch.parallel import sharding as shd
    if zero_dp:
        pspecs = shd.zero_dp_specs(state.params, mesh)
    else:
        pspecs = shd.param_specs(state.params, cfg, fsdp_axis=fsdp_axis)
    return TrainState(params=pspecs, opt=AdamWState(shd.Spec(), pspecs,
                                                    pspecs),
                      ef=ErrorFeedback(pspecs))


def batch_specs(cfg: ModelConfig, mesh, zero_dp: bool = False
                ) -> Dict[str, Any]:
    """A train batch's Specs: the batch over the dp axes (every mesh axis
    with ``zero_dp``)."""
    from repro_torch.parallel import sharding as shd
    names = tuple(mesh.mesh_dim_names)
    dp = (tuple(a for a in ("pod", "data", "model") if a in names)
          if zero_dp else shd.dp_axes(mesh))
    specs = {k: shd.Spec(dp, None) for k in ("tokens", "labels", "mask")}
    if cfg.num_patches:
        specs["patches"] = shd.Spec(dp, None, None)
    if cfg.is_encoder_decoder:
        specs["frames"] = shd.Spec(dp, None, None)
    return specs


def shard_state(state: TrainState, cfg: ModelConfig, mesh, *,
                fsdp_axis: Optional[str] = "data",
                zero_dp: bool = False) -> TrainState:
    """``state`` as DTensors on ``mesh`` placed by :func:`state_specs`."""
    from repro_torch.parallel import sharding as shd
    return shd.to_shardings(mesh, state_specs(state, cfg, fsdp_axis,
                                              zero_dp=zero_dp, mesh=mesh),
                            state)


def unshard(tree):
    """A tree with every DTensor gathered whole (for checkpoints and
    comparisons)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def make_train_step(cfg: ModelConfig, hp: TrainHParams, *, mesh=None,
                    fsdp_axis: Optional[str] = "data",
                    zero_dp: bool = False) -> Callable:
    """``step(state, batch, step_no) -> (state, metrics)``, metrics
    ``loss``, ``ce``, ``aux``, ``gnorm`` and ``lr`` as 0-d tensors. The
    params and moments of ``state`` are updated in place.

    With ``mesh`` the state is placed by :func:`state_specs` and the batch
    by :func:`batch_specs` (each leaf unless it is a DTensor placed so
    already: place the state once with :func:`shard_state` and pass the
    returned state on); ``zero_dp`` is pure ZeRO data parallelism (the
    batch over every mesh axis, each weight over ('data', 'model')), only
    valid when the global batch divides the mesh. The metrics come back
    as plain tensors."""
    lr_fn = cosine_schedule(hp.lr, hp.warmup, hp.total_steps)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], step_no):
        loss, metrics, grads = loss_and_grads(state.params, batch, cfg, hp)
        lr = lr_fn(step_no)
        state, gnorm = apply_grads(state, grads, lr, hp)
        return state, {"loss": loss, "ce": metrics["ce"],
                       "aux": metrics["aux"], "gnorm": gnorm, "lr": lr}

    if mesh is None:
        return step

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import ambient_mesh
    from repro_torch.parallel import sharding as shd
    bspecs = batch_specs(cfg, mesh, zero_dp)

    def to_param(g, p):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g

    def mesh_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  step_no):
        shd.ZERO_DP_ANCHOR = zero_dp
        state = shard_state(state, cfg, mesh, fsdp_axis=fsdp_axis,
                            zero_dp=zero_dp)
        batch = {k: shd.distribute(v, mesh, bspecs[k])
                 for k, v in batch.items()}
        with ambient_mesh(mesh), implicit_replication():
            loss, metrics, grads = loss_and_grads(state.params, batch, cfg,
                                                  hp)
            grads = tree_map(to_param, grads, state.params)
            lr = lr_fn(step_no)
            state, gnorm = apply_grads(state, grads, lr, hp)
        return state, unshard({"loss": loss, "ce": metrics["ce"],
                               "aux": metrics["aux"], "gnorm": gnorm,
                               "lr": lr})

    return mesh_step


def stub_inputs(batch: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Dict[str, torch.Tensor]:
    """``batch`` with the reference loop's zero patch embeddings or
    encoder frames, where the config takes them."""
    B = batch["tokens"].shape[0]
    dev = batch["tokens"].device
    if cfg.num_patches:
        batch["patches"] = torch.zeros((B, cfg.num_patches, cfg.d_model),
                                       dtype=torch.float32, device=dev)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((B, cfg.encoder_frames, cfg.d_model),
                                      dtype=torch.float32, device=dev)
    return batch


def run_training(cfg: ModelConfig, hp: TrainHParams, *, global_batch: int,
                 seq_len: int, steps: int, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50,
                 step_deadline_s: Optional[float] = None,
                 log_every: int = 10, seed: int = 0,
                 on_metrics: Optional[Callable[[int, Dict], None]] = None,
                 device=None, mesh=None) -> Dict[str, float]:
    """Restartable training loop on ``device`` (the card unless
    ``device="cpu"``): resumes from the latest checkpoint in ``ckpt_dir``
    and runs steps up to ``steps``, saving every ``ckpt_every`` steps.
    With ``mesh`` the state is placed by :func:`state_specs` and each
    checkpoint holds the gathered state. Returns the last step's metrics
    as floats."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch.runtime import StragglerMonitor

    device = resolve_device(device)
    state = init_state(torch.Generator(device=device).manual_seed(seed), cfg,
                       device=device)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, state)
            start_step = latest

    train_step = make_train_step(cfg, hp, mesh=mesh)
    if mesh is not None:
        state = shard_state(state, cfg, mesh)
    corpus = SyntheticCorpus(cfg.vocab, seq_len, seed=seed, device=device)
    monitor = StragglerMonitor(deadline_s=step_deadline_s)
    metrics = {}
    for s in range(start_step, steps):
        batch = stub_inputs(dict(corpus.sample(s, 0, global_batch)._asdict()),
                            cfg)
        with monitor.step(s):
            state, metrics = train_step(state, batch, s)
            metrics = {k: float(v) for k, v in metrics.items()}
        if on_metrics and (s % log_every == 0 or s == steps - 1):
            on_metrics(s, metrics)
        if mgr and (s + 1) % ckpt_every == 0:
            mgr.save_async(s + 1, state if mesh is None else unshard(state))
    if mgr:
        mgr.wait()
    return metrics
