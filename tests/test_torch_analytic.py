"""The port's analytic FLOP/byte model (``repro_torch.parallel.analytic``),
the dry run's parameter counts (``repro_torch.launch.dryrun``) and the
roofline (``repro_torch.parallel.roofline``) against the JAX package.

Every config of ``configs/`` at full width, its params abstract on both
sides (``jax.eval_shape`` of the reference's init, the port's on the
``meta`` device): ``matmul_param_counts``, ``param_counts`` and every
value of ``estimate`` at every cell of ``shape_cells`` for 1 and 256
chips equal the reference's exactly (the same float arithmetic on the
same leaf sizes). The key paths the port walks spell the reference's.
"""

import functools

import jax
import pytest
from _torch_parity import reference_dryrun

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.parallel import analytic as janalytic
from repro.parallel import hlo_analysis as jhlo
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.parallel import analytic, roofline

H100 = "NVIDIA H100 80GB HBM3"
CELLS = [(a, s) for a in jbase.ARCH_IDS for s in jbase.shape_cells(a)]


@functools.lru_cache(maxsize=None)
def abstract(arch):
    """(reference cfg, its abstract params, port cfg, meta params)."""
    jcfg = jbase.get_config(arch)
    jp = jax.eval_shape(functools.partial(jlm.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    cfg = base.get_config(arch)
    return jcfg, jp, cfg, dryrun._abstract_params(cfg)


def test_cells_are_the_reference_cells():
    assert len(CELLS) == 32
    assert [(a, s) for a in base.ARCH_IDS for s in base.shape_cells(a)] \
        == CELLS


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_meta_params_allocate_nothing(arch):
    _, jp, _, pp = abstract(arch)
    leaves = tree.leaves(pp)
    assert leaves and all(x.is_meta for x in leaves)
    assert [tuple(x.shape) for x in leaves] == [
        tuple(x.shape) for x in jax.tree.leaves(jp)]


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_key_paths_spell_the_references(arch):
    _, jp, _, pp = abstract(arch)
    want = [tuple(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [k for k, _ in tree.flatten_with_keys(pp)] == want


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_matmul_param_counts_equal_the_reference(arch):
    jcfg, jp, cfg, pp = abstract(arch)
    assert analytic.matmul_param_counts(cfg, pp) == \
        janalytic.matmul_param_counts(jcfg, jp)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    jcfg, jp, cfg, pp = abstract(arch)
    got = dryrun.param_counts(cfg, pp)
    assert got == reference_dryrun().param_counts(jcfg, jp)
    if cfg.moe is not None:
        assert 0 < got["expert"] and got["active"] < got["total"]


@pytest.mark.parametrize("chips", [1, 256])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_estimate_equals_the_reference(arch, shape, chips):
    jcfg, jp, cfg, pp = abstract(arch)
    got = analytic.estimate(cfg, base.SHAPES[shape], pp, chips)
    want = janalytic.estimate(jcfg, jbase.SHAPES[shape], jp, chips)
    assert got == want


def test_causal_block_skip_matches_the_references_default():
    from repro.models import attention as jattn
    from repro_torch.models import attention
    assert attention.CAUSAL_BLOCK_SKIP is True
    assert jattn.CAUSAL_BLOCK_SKIP is True   # REPRO_CAUSAL_SKIP unset: "1"


@pytest.mark.parametrize("wire", [0.0, 3e9])
def test_roofline_equals_the_references_at_the_cards_peaks(monkeypatch,
                                                           wire):
    """The reference's roofline with the H100's peaks in place of the
    TPU's gives the port's numbers."""
    pk = roofline.card_peaks(H100)
    monkeypatch.setattr(jhlo, "PEAK_FLOPS", pk.bf16_flops)
    monkeypatch.setattr(jhlo, "HBM_BW", pk.hbm_bytes)
    monkeypatch.setattr(jhlo, "ICI_BW", pk.link_bytes)
    _, _, cfg, pp = abstract("qwen3_0_6b")
    est = analytic.estimate(cfg, base.SHAPES["train_4k"], pp, 1)
    args = (est["flops"], est["hbm_bytes_per_device"], wire, 1,
            est["model_flops"])
    assert roofline.roofline(*args, card=H100) == jhlo.roofline(*args)


def test_h100_peaks_and_unknown_card():
    pk = roofline.card_peaks(H100)
    assert (pk.bf16_flops, pk.f32_flops, pk.hbm_bytes, pk.l2_bytes,
            pk.power_w) == (989e12, 67e12, 3.35e12, 50 * 2 ** 20, 700.0)
    with pytest.raises(ValueError, match="no peaks"):
        roofline.card_peaks("NVIDIA A100-SXM4-80GB")
    assert roofline.measured_fraction(989e12, 2.0, card=H100) == 0.5
