"""The plain reference against the port at a tiny size on the CPU: the
catalogue's codes, the planner's budgets and the served ids, for both
configurations' specs and norm profiles; and the reference's own parts
against hand-worked values."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mipsbench import check, harness, traffic
from mipsbench.kinds import rangelsh
from mipsbench.reference import rangelsh as ref
from repro_torch.core import planner
from repro_torch.core.hashing import pack_bits

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]
         if harness.resolve_cell(MANIFEST, w["name"]).config["kind"]
         == "rangelsh"]
TINY = {"config": {"n": 6000, "d": 24}, "mix": {"pool_batches": 6,
                                                 "batch": 16}}
PLANS = ("once", "per_batch")     # the mixes' two ways to plan a batch


@pytest.fixture(scope="module",
                params=[(c, plan) for c in CELLS for plan in PLANS],
                ids=lambda p: "-".join(p))
def both_sides(request):
    name, plan = request.param
    cell = harness.resolve_cell(MANIFEST, name,
                                {**TINY, "mix": {**TINY["mix"], "plan": plan}})
    cpu = torch.device("cpu")
    inputs = traffic.make_inputs(cell.config, cell.mix, 20260118, cpu)
    prog = rangelsh.set_up(cell.config, inputs, cpu, lambda: None)
    call, slots = rangelsh.caller(prog, cell.config, cell.mix, inputs)
    answers = [call(s) for s in range(slots)]
    budgets = rangelsh.served(prog, harness.Window(
        list(range(slots)), torch.stack([a[0] for a in answers]),
        torch.stack([a[1] for a in answers]), [], 0.0)).budgets
    index, ref_budgets = rangelsh.reference_side(inputs, cell.config, "f32")
    return cell, inputs, prog, answers, budgets, index, ref_budgets


def test_codes_agree(both_sides):
    _, _, prog, _, _, index, _ = both_sides
    assert check.code_bits_differ(prog.index.codes, index.codes,
                                  index.hash_bits) <= 1e-4
    assert index.hash_bits == prog.index.hash_bits


def test_partition_and_buckets_agree(both_sides):
    _, _, prog, _, _, index, _ = both_sides
    assert torch.equal(prog.index.range_id.long(), index.range_id)
    assert index.num_buckets == prog.buckets.num_buckets
    csr = torch.empty_like(index.csr_pos)
    csr[index.csr_pos] = torch.arange(csr.shape[0])
    assert torch.equal(prog.buckets.item_ids.long(), csr)


def test_budgets_agree(both_sides):
    *_, budgets, _, ref_budgets = both_sides
    assert tuple(budgets) == tuple(ref_budgets)


def test_served_ids_agree(both_sides):
    cell, inputs, _, answers, _, index, ref_budgets = both_sides
    batch, k = cell.mix["batch"], cell.config["k"]
    for slot, (vals, ids) in enumerate(answers):
        q = inputs.pool[slot * batch:(slot + 1) * batch]
        want_vals, want = ref.answer(index, inputs.items, inputs.projections,
                                     q, ref_budgets, k, "f32")
        assert check.topk_misses(q, inputs.items, ids.long(), want) == 0
        torch.testing.assert_close(vals, want_vals, rtol=1e-5, atol=1e-5)
        assert ref.admitted(index, inputs.projections, q, ref_budgets, ids,
                            "f32").all()


def test_pack_matches_the_ports_bit_order():
    bits = torch.rand((50, 27), generator=torch.Generator().manual_seed(3)) \
        < 0.5
    ours = ref.pack(bits)
    theirs = pack_bits(bits).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(ours, theirs)


def test_probe_grid_matches_the_planners():
    for n in (1, 7, 6000, 136736):
        assert np.array_equal(ref.probe_grid(n), planner.default_grid(n))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -11 - 2 ** -20, 3.0e-3], dtype=torch.float32)
    got = ref.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                         -1.0 - 2 ** -10], dtype=torch.float32)
    assert torch.equal(got[:5], want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[5]) / 3.0e-3 - 1.0) <= 2 ** -11


def test_popcount_and_matmul_modes():
    v = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001], dtype=torch.int64)
    assert ref.popcount(v).tolist() == [0, 1, 32, 2]
    a = torch.randn((4, 8), generator=torch.Generator().manual_seed(1))
    b = torch.randn((8, 3), generator=torch.Generator().manual_seed(2))
    exact = (a.double() @ b.double()).float()
    assert (ref.matmul(a, b, "f32") - exact).abs().max() < 1e-5
    assert (ref.matmul(a, b, "tf32") - exact).abs().max() > 1e-5
    with pytest.raises(ValueError):
        ref.matmul(a, b, "bf16")


def test_build_refuses_projections_of_the_wrong_shape():
    items = torch.randn((64, 8), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        ref.build(items, torch.zeros((9, 31)), 32, 32, 0.06, "f32")


def test_spec_without_a_target_builds_the_same_index():
    spec = harness.resolve_cell(MANIFEST, CELLS[0]).config["spec"]
    from repro_torch.core.index import IndexSpec

    a = IndexSpec(**spec)
    b = dataclasses.replace(a, recall_target=None)
    assert (a.hash_bits, a.m, a.eps) == (b.hash_bits, b.m, b.eps)


def test_admitted_is_the_answers_candidate_set():
    cell = harness.resolve_cell(MANIFEST, CELLS[0], TINY)
    inputs = traffic.make_inputs(cell.config, cell.mix, 20260119,
                                 torch.device("cpu"))
    index, budgets = rangelsh.reference_side(inputs, cell.config, "f32")
    q = inputs.pool[:16]
    cand = ref.candidates(index, inputs.projections, q, budgets, "f32")
    assert (cand.sum(dim=1) == sum(budgets)).all()
    outside = torch.argmin(cand.to(torch.int8), dim=1, keepdim=True)
    inside = torch.argmax(cand.to(torch.int8), dim=1, keepdim=True)
    got = ref.admitted(index, inputs.projections, q, budgets,
                       torch.cat([inside, outside], dim=1), "f32")
    assert got[:, 0].all() and not got[:, 1].any()
