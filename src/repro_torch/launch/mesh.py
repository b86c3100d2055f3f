"""Mesh construction (port of ``repro/launch/mesh.py``) as
``torch.distributed``'s :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dimensions.

Defined as functions, so importing this module touches no process group.
A mesh spans the default process group, whose world must equal the
mesh's size: on the card NCCL (a rank a card), on the CPU gloo, and for
the dry run's production meshes a fake group (:func:`fake_process_group`)
whose collectives move nothing, so a 256- or 512-device mesh needs no
device at all. The caller initialises the group
(``init_process_group`` with its address, world size and rank).

``ambient_mesh`` sets the port's current mesh, which
``parallel/sharding.constrain_batch_leading`` (the residual-stream
anchor) reads, as the reference's ``jax.set_mesh`` does.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch

_AMBIENT: List = []


@contextlib.contextmanager
def ambient_mesh(mesh) -> Iterator:
    """Context manager installing ``mesh`` as the current mesh."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The innermost :func:`ambient_mesh`'s mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` fake ranks (this process
    is rank 0; collectives return at once and move nothing), torn down on
    exit. It is process-global: raises if a group is already initialised,
    so a 256-device and a 512-device world follow one another."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=int(world_size), rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_compat_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                     device_type: str = "cuda"):
    """A mesh of ``shape`` with dimensions named ``axes`` over the default
    group (its world must be the product of ``shape``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh runs on the card; pass "
                           "device_type='cpu' for a CPU mesh")
    size = 1
    for n in shape:
        size *= int(n)
    if not dist.is_initialized() or dist.get_world_size() != size:
        world = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {tuple(shape)} mesh needs a default process "
                           f"group of {size} ranks, have {world}")
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices a pod (``data``, ``model``); ``multi_pod``
    adds the 2-pod axis (512). Built on the fake group of that world
    (``with fake_process_group(256):``): no device is touched."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_compat_mesh(shape, axes, device_type="cpu")


def make_local_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """Every rank of the default group as (``data``, ``model``)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised default "
                           "process group")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by "
                         f"model_parallel={model_parallel}")
    return make_compat_mesh((n // model_parallel, model_parallel),
                            ("data", "model"), device_type=device_type)


def make_elastic_mesh(surviving_slices: int,
                      slice_shape: Tuple[int, int] = (16, 16), *,
                      device_type: str = "cuda"):
    """Re-mesh after failures from whole surviving slices
    (``launch/runtime.py``); one surviving slice degrades to a single
    (``data``, ``model``) slice."""
    if surviving_slices <= 1:
        return make_compat_mesh(tuple(slice_shape), ("data", "model"),
                                device_type=device_type)
    return make_compat_mesh((surviving_slices,) + tuple(slice_shape),
                            ("pod", "data", "model"),
                            device_type=device_type)


def mesh_shape(mesh) -> dict:
    """{dimension name: size}, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def shape_of(mesh) -> Optional[dict]:
    """{name: size} of a DeviceMesh or of any object with ``axis_names``
    and ``shape`` (a stand-in in tests); None for None."""
    if mesh is None:
        return None
    if hasattr(mesh, "mesh_dim_names"):
        return mesh_shape(mesh)
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}
