"""The port's meshes (``repro_torch.launch.mesh``) against the JAX
package's (``repro.launch.mesh``): the same dimension names and sizes for
the production, elastic and local meshes.

The reference builds its meshes over 512 placeholder host devices, which
a JAX process must ask for before it starts; the port builds them over a
fake process group of 256 or 512 ranks, which is process-global. Both run
in one subprocess, so neither the device count nor the fake group reaches
this pytest process (the in-process cases use a gloo group of one rank).
"""

import functools

import pytest
import torch
from _torch_parity import gloo_world_of_one, run_script

from repro_torch.launch import mesh as pmesh

SCRIPT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch import mesh as jmesh
import torch.distributed as dist
from repro_torch.launch import mesh as pmesh

def ref(m):
    return {"names": list(m.axis_names),
            "shape": [int(m.shape[a]) for a in m.axis_names]}

def port(m):
    return {"names": list(m.mesh_dim_names), "shape": list(m.shape)}

out = {"ref": {}, "port": {}}
r = out["ref"]
r["pod"] = ref(jmesh.make_production_mesh())
r["multipod"] = ref(jmesh.make_production_mesh(multi_pod=True))
r["elastic1"] = ref(jmesh.make_elastic_mesh(1))
r["elastic2"] = ref(jmesh.make_elastic_mesh(2))
r["local16"] = ref(jmesh.make_local_mesh(16))
r["compat"] = ref(jmesh.make_compat_mesh((4, 2), ("data", "model")))
p = out["port"]
with pmesh.fake_process_group(256):
    p["pod"] = port(pmesh.make_production_mesh())
    p["elastic1"] = port(pmesh.make_elastic_mesh(1, device_type="cpu"))
    try:
        with pmesh.fake_process_group(512):
            pass
        p["nested"] = "no error"
    except RuntimeError as e:
        p["nested"] = str(e)
    try:
        pmesh.make_production_mesh(multi_pod=True)
        p["wrong_world"] = "no error"
    except RuntimeError as e:
        p["wrong_world"] = str(e)
p["torn_down"] = not dist.is_initialized()
with pmesh.fake_process_group(512):
    m = pmesh.make_production_mesh(multi_pod=True)
    p["multipod"] = port(m)
    p["multipod_sizes"] = pmesh.mesh_shape(m)
    p["elastic2"] = port(pmesh.make_elastic_mesh(2, device_type="cpu"))
    p["local16"] = port(pmesh.make_local_mesh(16, device_type="cpu"))
with pmesh.fake_process_group(8):
    p["compat"] = port(pmesh.make_compat_mesh((4, 2), ("data", "model"),
                                              device_type="cpu"))
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def meshes():
    return run_script(SCRIPT, timeout=240)


@pytest.mark.parametrize("kind", ["pod", "multipod", "elastic1", "elastic2",
                                  "local16", "compat"])
def test_meshes_equal_the_reference(kind):
    got = meshes()
    assert got["port"][kind] == got["ref"][kind]


def test_fake_group_is_process_global_and_torn_down():
    got = meshes()["port"]
    assert "already initialised" in got["nested"]
    assert "needs a default process group of 512 ranks" in \
        got["wrong_world"]
    assert got["torn_down"]
    assert got["multipod_sizes"] == {"pod": 2, "data": 16, "model": 16}


def test_ambient_mesh_nests():
    assert pmesh.current_mesh() is None
    with pmesh.ambient_mesh("outer"):
        assert pmesh.current_mesh() == "outer"
        with pmesh.ambient_mesh("inner") as m:
            assert m == "inner" and pmesh.current_mesh() == "inner"
        assert pmesh.current_mesh() == "outer"
    assert pmesh.current_mesh() is None


def test_local_mesh_needs_a_group_and_the_card_unless_asked_away(tmp_path):
    with pytest.raises(RuntimeError, match="initialised default process"):
        pmesh.make_local_mesh(device_type="cpu")
    with gloo_world_of_one(tmp_path):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pmesh.make_local_mesh()
        m = pmesh.make_local_mesh(device_type="cpu")
        assert pmesh.mesh_shape(m) == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.make_local_mesh(2, device_type="cpu")
        with pytest.raises(ValueError, match="differ in rank"):
            pmesh.make_compat_mesh((1,), ("data", "model"),
                                   device_type="cpu")


def test_shape_of_reads_a_stand_in():
    class StandIn:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}
    assert pmesh.shape_of(StandIn()) == {"data": 16, "model": 16}
    assert pmesh.shape_of(None) is None
