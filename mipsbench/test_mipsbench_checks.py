"""The comparison that decides ``correct`` fails what it must: the control
(the plain reference in the program's place, its products one precision
step below float32) and a run whose timed path is broken underneath, once
for each fault a served cell can have: an answer left as the last batch's,
half of the batch left out, one answer altered where it is produced, and
answers drawn from more candidates or another plan than the reference's
budgets. The cells' own limits are used, at a tiny size on the CPU; a
sound run of the same size comes out correct, whichever way its mix plans.
(One card: no exchange between chips.)"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mipsbench import check, devtrace, harness, traffic
from mipsbench.kinds import rangelsh
from mipsbench.reference import rangelsh as ref
from repro_torch.core.engine import QueryEngine

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]
         if harness.resolve_cell(MANIFEST, w["name"]).config["kind"]
         == "rangelsh"]
TINY = {"config": {"n": 6000, "d": 24},
        "mix": {"pool_batches": 8, "batch": 16},
        "workload": {"sample_batches": 4, "build_repeats": 2}}
SEED = 2 ** 31 + 77


def _run(cell, plan=None):
    overrides = TINY if plan is None else {
        **TINY, "mix": {**TINY["mix"], "plan": plan}}
    return harness.run_cell(MANIFEST, cell, SEED, 0.3, False, device="cpu",
                            overrides=overrides)[0]


@pytest.mark.parametrize("plan", ["once", "per_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, plan):
    result = _run(cell, plan)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert list(result["checks"]) == list(check.COMPARED)
    assert result["checks"]["outside_candidates"]["value"] == 0
    assert result["checks"]["budgets_differ"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(cell):
    c = harness.resolve_cell(MANIFEST, cell, TINY)
    inputs = traffic.make_inputs(c.config, c.mix, SEED, torch.device("cpu"))
    index, budgets = rangelsh.reference_side(inputs, c.config, "tf32")
    batch, k = c.mix["batch"], c.config["k"]
    slots = list(range(4))
    vals, ids = ref.answer(index, inputs.items, inputs.projections,
                           inputs.pool[:4 * batch], budgets, k, "tf32")
    served = check.Served(slots, vals.view(4, batch, k),
                          ids.view(4, batch, k), index.codes, budgets)
    verdict = rangelsh.judge(served, inputs, c, SEED).judged
    assert not verdict["correct"]
    assert verdict["checks"]["score_gap"]["value"] \
        > verdict["checks"]["score_gap"]["limit"]


def _stale(query):
    last = {}

    def broken(self, q, k, *a, **kw):
        out = query(self, q, k, *a, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return broken


def _half(query):
    def broken(self, q, k, *a, **kw):
        h = q.shape[0] // 2
        vals, ids = query(self, q[:h], k, *a, **kw)
        return torch.cat([vals, vals]), torch.cat([ids, ids])
    return broken


def _altered(query):
    def broken(self, q, k, *a, **kw):
        vals, ids = query(self, q, k, *a, **kw)
        ids = ids.clone()
        taken = set(ids[0].tolist())
        ids[0, -1] = next(i for i in range(self.index.items.shape[0])
                          if i not in taken)
        return vals, ids
    return broken


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["answer_left_as_last_batch", "half_batch_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(QueryEngine, "query", fault(QueryEngine.query))
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["score_gap"]["value"] \
        > result["checks"]["score_gap"]["limit"]


def _wider(query):
    def broken(self, q, k, *a, budgets=None, **kw):
        if budgets is not None:
            budgets = [2 * b + 8 for b in budgets]
        return query(self, q, k, *a, budgets=budgets, **kw)
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_answers_beyond_the_plan_are_not_correct(monkeypatch, cell):
    monkeypatch.setattr(QueryEngine, "query", _wider(QueryEngine.query))
    result = _run(cell, "once")
    assert not result["correct"]
    assert result["checks"]["outside_candidates"]["value"] \
        > result["checks"]["outside_candidates"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_another_plan_is_not_correct(monkeypatch, cell):
    from repro_torch.core import planner

    resolve = planner.resolve_budgets

    def moved(*a, **kw):
        plan = resolve(*a, **kw)
        b = list(plan.budgets)
        j = max(range(len(b)), key=b.__getitem__)
        b[j] -= 1
        return plan._replace(budgets=tuple(b))

    monkeypatch.setattr(planner, "resolve_budgets", moved)
    result = _run(cell, "once")
    assert not result["correct"]
    assert result["checks"]["budgets_differ"]["value"] == 1


def test_build_is_timed_as_the_mean_of_its_repeats():
    c = harness.resolve_cell(MANIFEST, CELLS[0], TINY)
    cpu = torch.device("cpu")
    inputs = traffic.make_inputs(c.config, c.mix, SEED, cpu)
    prog = rangelsh.set_up(c.config, inputs, cpu, lambda: None, repeats=3)
    t = prog.timings
    steps = t["index_s"] + t["bucket_store_s"] + t["calibrate_s"]
    assert 0 < steps <= t["build_s"] * (1 + 1e-9)


def test_each_batch_is_timed_to_its_synchronise():
    synced = []

    def call(slot):
        time.sleep(0.002)
        return torch.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.int32)

    w = harness.serve(call, 5, 0.05, lambda: synced.append(1), first=1)
    assert len(w.latency_ms) == len(w.slots) == len(synced)
    assert w.slots[:5] == [1, 2, 3, 4, 0]
    assert min(w.latency_ms) >= 2.0 and w.vals.shape == (len(w.slots), 2, 3)


def test_invalid_answers_read_as_invalid():
    items = torch.randn((32, 4), generator=torch.Generator().manual_seed(0))
    q = torch.randn((2, 4), generator=torch.Generator().manual_seed(1))
    ids = torch.tensor([[0, 1, 2], [3, 3, 4]])
    vals = check.exact_scores(q, items, ids).float()
    best = torch.ones(2)
    gap, bad = check.score_gap(q, items, vals, ids, best)
    assert gap == check.INVALID and bad == 1
    ids[1] = torch.tensor([3, 40, 4])
    assert check.score_gap(q, items, vals, ids, best)[1] == 1


def test_ties_within_rounding_are_no_miss():
    items = torch.tensor([[1.0, 0.0], [1.0, 1e-9], [0.5, 0.0]])
    q = torch.tensor([[1.0, 1.0]])
    assert check.topk_misses(q, items, torch.tensor([[0]]),
                             torch.tensor([[1]])) == 0
    assert check.topk_misses(q, items, torch.tensor([[2]]),
                             torch.tensor([[0]])) == 1


def test_merge_of_device_intervals():
    iv = np.array([[5, 9], [0, 2], [1, 3], [8, 12], [20, 21]], np.int64)
    assert devtrace._merge(iv).tolist() == [[0, 3], [5, 12], [20, 21]]


def test_sample_is_drawn_from_the_seed():
    slots = list(range(40)) + list(range(10))
    a = rangelsh.sample_slots(SEED, slots, 8)
    assert a == rangelsh.sample_slots(SEED, slots, 8) and len(set(a)) == 8
    assert rangelsh.sample_slots(SEED, [3, 3], 8) == [3]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_the_card(cuda_device, cell):
    result, lines = harness.run_cell(MANIFEST, cell, SEED, 1.0, True,
                                     device=cuda_device,
                                     overrides={"config": {"n": 200000}})
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert [ln.split(":")[0] for ln in lines[-len(check.COMPARED):]] \
        == list(check.COMPARED)
