"""The port's contracts (``repro_torch.analysis.contracts``) on the tiny
index (N = 256), restated from ``tests/test_analysis_contracts.py``: the
distributed engine's plan memo fills once per (num_probe, k, budgets)
class and hits on repeat traffic (C1, the counterpart of the reference's
trace budget), an unhashable key and a defeated memo are reported, and
every entry point returns f32 values and int32 ids (C2). The measured
memo counts equal the reference's trace counts for the same traffic.
"""

import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro_torch.analysis import contracts
from repro_torch.analysis.contracts import ContractReport
from repro_torch.core import distributed
from repro_torch.core.engine import QueryEngine


@pytest.fixture(scope="module")
def tiny():
    return contracts._tiny_setup()


def test_plan_budget_two_classes_exactly_two_plans(tiny):
    cidx, items, queries = tiny
    report = ContractReport()
    contracts.check_distributed(report, cidx.spec, items, queries,
                                classes=((60, 5), (90, 5)),
                                planned_budget=None)
    assert report.findings == []
    assert report.stats["distributed_classes"] == 2
    assert report.stats["distributed_plans"] == 2
    assert report.stats["distributed_memo_hits"] == 2
    assert report.stats["distributed_memo_size"] == 2


def test_plan_budget_planned_class_adds_one_plan(tiny):
    cidx, items, queries = tiny
    report = ContractReport()
    contracts.check_distributed(report, cidx.spec, items, queries,
                                classes=((60, 5),), planned_budget=20)
    assert report.findings == []
    assert report.stats["distributed_plans"] == 2
    assert report.stats["distributed_memo_hits"] == 2


def test_memo_counts_equal_the_references_trace_counts(tiny):
    cidx, items, queries = tiny
    report = ContractReport()
    contracts.check_distributed(report, cidx.spec, items, queries)
    jcidx, jitems, jqueries = jcontracts._tiny_setup()
    jreport = jcontracts.ContractReport()
    jcontracts.check_distributed(jreport, jcidx.spec, jitems, jqueries)
    assert jreport.findings == [] and report.findings == []
    s, js = report.stats, jreport.stats
    assert (s["distributed_classes"], s["distributed_planned_classes"],
            s["distributed_plans"], s["distributed_memo_hits"]) == (
        js["distributed_classes"], js["distributed_planned_classes"],
        js["distributed_traces"], js["distributed_cache_hits"])


def test_unhashable_key_is_a_c1_finding(tiny, monkeypatch):
    cidx, items, queries = tiny
    orig = distributed.DistributedEngine._plan

    def bad_plan(self, num_probe, k, budgets=None):
        # a list reaches the memo's key: the dict lookup raises TypeError
        return orig(self, num_probe, k,
                    list(budgets) if budgets is not None else [num_probe])

    monkeypatch.setattr(distributed.DistributedEngine, "_plan", bad_plan)
    report = ContractReport()
    contracts.check_distributed(report, cidx.spec, items, queries,
                                classes=((60, 5),), planned_budget=None)
    f = next(f for f in report.findings if f.rule == "C1")
    assert "unhashable" in f.message
    assert f.path.endswith("core/distributed.py") and f.line > 1


def test_defeated_memo_is_a_c1_finding(tiny, monkeypatch):
    cidx, items, queries = tiny
    orig = distributed.DistributedEngine._plan

    def never_memoized(self, num_probe, k, budgets=None):
        plan = orig(self, num_probe, k, budgets)
        self._plans.clear()          # the next call misses
        return plan

    monkeypatch.setattr(distributed.DistributedEngine, "_plan",
                        never_memoized)
    report = ContractReport()
    contracts.check_distributed(report, cidx.spec, items, queries,
                                classes=((60, 5),), planned_budget=None)
    assert any(f.rule == "C1" and "budget" in f.message
               for f in report.findings)


def test_wrong_dtype_is_a_c2_finding(tiny, monkeypatch):
    cidx, _, queries = tiny
    orig = QueryEngine.query

    def widened(self, *a, **kw):
        vals, ids = orig(self, *a, **kw)
        return vals.to(torch.bfloat16), ids.long()

    monkeypatch.setattr(QueryEngine, "query", widened)
    report = ContractReport()
    contracts.check_single_device(report, cidx, queries)
    msgs = [f.message for f in report.findings if f.rule == "C2"]
    assert any("values dtype torch.bfloat16" in m for m in msgs)
    assert any("ids dtype torch.int64" in m for m in msgs)


def test_run_contracts_clean_on_repo():
    report = contracts.run_contracts()
    assert [f.format() for f in report.findings] == []
    # the card when there is one, else the CPU; the card's run is
    # tests/test_torch_cuda.py::test_contracts_hold_on_the_card
    assert report.stats["device"] == ("cuda" if torch.cuda.is_available()
                                      else "cpu")
    assert report.stats["distributed_plans"] == (
        report.stats["distributed_classes"]
        + report.stats["distributed_planned_classes"])


def test_lint_contracts_exits_0(capsys):
    from repro_torch.analysis import lint
    assert lint.run(["--contracts"]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
