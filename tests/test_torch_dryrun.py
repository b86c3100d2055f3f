"""The dry run's abstract state and inputs (``repro_torch.launch.dryrun``,
``launch/train.init_state_abstract``, ``data/tokens.*_batch_specs``)
against the JAX package's, on every config at full width.

Nothing is allocated: every leaf lives on the ``meta`` device (the two
largest configs would take ~214 GB and ~796 GB of bf16 weights). The
abstract ``TrainState`` has the reference's leaf keys, shapes and dtypes
on all ten configs, so a checkpoint of any config crosses packages; so
do the inputs of every cell.
"""

import functools

import jax
import pytest
import torch
from _torch_parity import reference_dryrun

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.data import tokens
from repro_torch.launch import dryrun, train

CELLS = [(a, s) for a in jbase.ARCH_IDS for s in jbase.shape_cells(a)]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _layout(port_tree):
    """(keys, shape, dtype) of every leaf, each leaf checked to be meta."""
    out = []
    for keys, leaf in tree.flatten_with_keys(port_tree):
        assert leaf.is_meta, keys
        out.append((keys, tuple(leaf.shape), _dtype(leaf)))
    return out


def _reference_layout(ref_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    return [(tuple(str(getattr(p, "key", p)) for p in path),
             tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat]


@functools.lru_cache(maxsize=None)
def reference_state(arch):
    return _reference_layout(jtrain.init_state_abstract(
        jbase.get_config(arch)))


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_init_state_abstract_equals_the_reference(arch):
    state = train.init_state_abstract(base.get_config(arch))
    assert isinstance(state, train.TrainState)
    got = _layout(state)
    assert got == reference_state(arch)
    assert len(got) >= 3 * len(tree.leaves(state.params))


def test_init_state_abstract_allocates_nothing():
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    state = train.init_state_abstract(base.get_config(
        "jamba_1_5_large_398b"))
    n = sum(x.numel() for x in tree.leaves(state.params))
    assert n > 3.9e11
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got = dryrun.input_specs(arch, shape)
    want = reference_dryrun().input_specs(arch, shape)
    assert sorted(got) == sorted(want)
    assert _layout(got) == _reference_layout(want)


def test_batch_specs_equal_the_reference():
    assert _layout(tokens.train_batch_specs(8, 512)) == _reference_layout(
        jtokens.train_batch_specs(8, 512))
    assert _layout(tokens.decode_batch_specs(8)) == _reference_layout(
        jtokens.decode_batch_specs(8))


def test_abstract_caches_allocate_nothing():
    """The longest cells' caches (jamba and xlstm at 524,288 positions)
    are meta tensors of the reference's layout."""
    for arch in ("jamba_1_5_large_398b", "xlstm_1_3b"):
        caches = dryrun._abstract_cache(base.get_config(arch), 1, 524288)
        want = reference_dryrun()._abstract_cache(jbase.get_config(arch), 1,
                                                  524288)
        assert _layout(caches) == _reference_layout(want)
