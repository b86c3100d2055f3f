"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the JAX package's (``repro.parallel.sharding``), leaf by leaf on every
config at full width: param specs (FSDP on ``data`` or none, stationary
serving or not), ZeRO specs, batch and cache specs, and the train state's
specs (``launch/train.state_specs``).

The reference's trees come from ``jax.eval_shape`` params, with no
devices; the port's from ``meta`` params. The functions that read a mesh
read only its dimension names and sizes, so a stand-in with
``axis_names`` and ``shape`` serves both packages. DTensor placements run
in a subprocess on a fake 2 x 2 world, so the fake group never reaches
this pytest process.
"""

import functools
import types

import jax
import pytest
from _torch_parity import run_script
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.parallel import sharding as jshd
from repro_torch.configs import base
from repro_torch.launch import dryrun, train
from repro_torch.parallel import sharding as shd

POD = types.SimpleNamespace(axis_names=("data", "model"),
                            shape={"data": 16, "model": 16})
MULTIPOD = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 16, "model": 16})
MESHES = {"pod": POD, "multipod": MULTIPOD}


def _entry(e):
    """A spec entry as a tuple of axis names (None and () alike)."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _norm(spec):
    return tuple(_entry(e) for e in spec)


def _ref_items(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))
    return [("/".join(str(p) for p in path), _norm(s)) for path, s in flat]


def _port_items(spec_tree):
    items = shd.spec_items(spec_tree)
    assert all(isinstance(s, shd.Spec) for _, s in items)
    return [(path, _norm(s)) for path, s in items]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(functools.partial(
        jlm.init_params, cfg=jbase.get_config(arch)), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dryrun._abstract_params(base.get_config(arch))


@pytest.mark.parametrize("stationary", [False, True])
@pytest.mark.parametrize("fsdp", ["data", None])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, fsdp, stationary):
    want = _ref_items(jshd.param_specs(
        _ref_params(arch), jbase.get_config(arch), fsdp_axis=fsdp,
        serve_stationary=stationary))
    got = _port_items(shd.param_specs(
        _port_params(arch), base.get_config(arch), fsdp_axis=fsdp,
        serve_stationary=stationary))
    assert got == want


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_zero_dp_specs_equal_the_reference(arch, mesh):
    want = _ref_items(jshd.zero_dp_specs(_ref_params(arch), MESHES[mesh]))
    got = _port_items(shd.zero_dp_specs(_port_params(arch), MESHES[mesh]))
    assert got == want


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_batch_specs_equal_the_reference(mesh, kind):
    assert _port_items(shd.batch_specs(MESHES[mesh], kind)) == \
        _ref_items(jshd.batch_specs(MESHES[mesh], kind))


def test_batch_specs_reject_an_unknown_kind():
    with pytest.raises(ValueError):
        shd.batch_specs(POD, "prefill")


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh, batch):
    want = jshd.cache_specs(jbase.get_config(arch), MESHES[mesh], batch)
    got = shd.cache_specs(base.get_config(arch), MESHES[mesh], batch)
    assert _port_items(got) == _ref_items(want)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_state_specs_equal_the_reference(arch):
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    want = _ref_items(jtrain.state_specs(jtrain.init_state_abstract(jcfg),
                                         jcfg))
    state = train.init_state_abstract(cfg)
    got = shd.spec_items(train.state_specs(state, cfg))
    assert [(p, _norm(s)) for p, s in got] == want
    zero = train.state_specs(state, cfg, zero_dp=True, mesh=POD)
    assert _port_items(zero) == _ref_items(jtrain.state_specs(
        jtrain.init_state_abstract(jcfg), jcfg, zero_dp=True, mesh=POD))


@pytest.mark.parametrize("batch", [None, 1, 2, 16, 32, 64, 128, 96])
def test_dp_axes_for_batch_equals_the_reference(batch):
    for m in (POD, MULTIPOD):
        assert shd.dp_axes_for_batch(m, batch) == \
            jshd.dp_axes_for_batch(m, batch)
        assert shd.dp_axes(m) == jshd.dp_axes(m)


class _Mesh:
    """A stand-in for ``to_placements``, which reads only the names."""
    mesh_dim_names = ("pod", "data", "model")


def test_to_placements_shards_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = _Mesh()
    assert shd.to_placements(m, shd.Spec(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert shd.to_placements(m, shd.Spec(None, ("data",))) == \
        (Replicate(), Shard(1), Replicate())
    assert shd.to_placements(m, shd.Spec()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not a dimension"):
        shd.to_placements(m, shd.Spec("expert"))
    with pytest.raises(ValueError, match="twice"):
        shd.to_placements(m, shd.Spec("model", "model"))


PLACEMENTS = r"""
import json, torch
from repro_torch.launch.mesh import (ambient_mesh, fake_process_group,
                                     make_compat_mesh)
from repro_torch.parallel import sharding as shd
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun

out = {}
with fake_process_group(4):
    mesh = make_compat_mesh((2, 2), ("data", "model"), device_type="cpu")
    x = torch.empty((8, 6, 4), device="meta")
    for name, spec in {
            "data_model": shd.Spec("data", "model", None),
            "both_on_0": shd.Spec(("data", "model"), None, None),
            "model_last": shd.Spec(None, None, "model"),
            "replicated": shd.Spec(None, None, None)}.items():
        d = shd.distribute(x, mesh, spec)
        out[name] = list(d.to_local().shape)
    cfg = get_config("qwen3_0_6b").reduced()
    params = dryrun._abstract_params(cfg)
    placed = shd.to_shardings(mesh, shd.param_specs(params, cfg), params)
    out["param_bytes"] = shd.local_bytes(placed)
    out["whole_bytes"] = shd.local_bytes(params)
    out["w_q"] = [list(placed["pos0"]["mixer"]["w_q"].shape),
                  list(placed["pos0"]["mixer"]["w_q"].to_local().shape)]
    a = shd.distribute(torch.empty((8, 4), device="meta"), mesh,
                       shd.Spec(None, "model"))
    out["no_ambient"] = list(shd.constrain_batch_leading(a).to_local().shape)
    with ambient_mesh(mesh):
        out["plain"] = list(shd.constrain_batch_leading(
            torch.empty((8, 4))).shape)
        out["anchored"] = list(shd.constrain_batch_leading(a).to_local()
                               .shape)
        shd.ZERO_DP_ANCHOR = True
        out["zero_anchored"] = list(shd.constrain_batch_leading(a)
                                    .to_local().shape)
        shd.ZERO_DP_ANCHOR = False
        odd = shd.distribute(torch.empty((3, 4), device="meta"), mesh,
                             shd.Spec(None, None))
        out["odd_batch"] = [type(p).__name__ for p in
                            shd.constrain_batch_leading(odd).placements]
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def placements():
    return run_script(PLACEMENTS, timeout=240)


def test_placements_give_each_dimension_over_its_axes():
    got = placements()
    assert got["data_model"] == [4, 3, 4]
    assert got["both_on_0"] == [2, 6, 4]
    assert got["model_last"] == [8, 6, 2]
    assert got["replicated"] == [8, 6, 4]
    # w_q (reps, d, H * hd) is FSDP x TP past the stacked reps axis
    (reps, rows, cols), (lreps, lrows, lcols) = got["w_q"]
    assert (lreps, lrows, lcols) == (reps, rows // 2, cols // 2)
    assert got["param_bytes"] < got["whole_bytes"]


def test_anchor_pins_the_batch_to_the_dp_axes():
    got = placements()
    assert got["no_ambient"] == [8, 2]      # no ambient mesh: unchanged
    assert got["plain"] == [8, 4]           # a plain tensor: unchanged
    assert got["anchored"] == [4, 4]        # batch on data, rest whole
    assert got["zero_anchored"] == [2, 4]   # ZeRO: batch on data x model
    assert got["odd_batch"] == ["Replicate", "Replicate"]
