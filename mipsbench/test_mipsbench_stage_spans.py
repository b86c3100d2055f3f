"""The readers of the served path's stage spans (``runs_ms``,
``fused_score_ms``, ``directory_scan_ms``, ``rank_sort_ms``): each turns
its span's sum over the span phase into milliseconds a batch and reads
None when the program has no such span; on the card, a small traced run
reports all four, splits ``probe_score_ms`` between the first two, and
keeps the stage ranges out of the device's operations."""

import json
from pathlib import Path

import pytest
import torch

from mipsbench import harness

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]
         if harness.resolve_cell(MANIFEST, w["name"]).config["kind"]
         == "rangelsh"]
SEED = 2 ** 31 + 91
STAGE_SPANS = {"runs_ms": "repro.engine.runs",
               "fused_score_ms": "repro.engine.fused_score",
               "directory_scan_ms": "repro.engine.directory_scan",
               "rank_sort_ms": "repro.engine.rank_sort"}


def _readings(spans, batches=40):
    return harness.Readings(spans, batches, None, {}, {}, None)


@pytest.mark.parametrize("metric", sorted(STAGE_SPANS))
def test_reader_gives_ms_a_batch_or_none(metric):
    read = harness.load_reader(metric)
    span = STAGE_SPANS[metric]
    assert read(_readings({span: (0.5, 40)})) == pytest.approx(12.5)
    other = {s: (1.0, 40) for s in STAGE_SPANS.values() if s != span}
    assert read(_readings({"repro.engine.fused_query": (1.0, 40),
                           "repro.engine.directory_match": (1.0, 40),
                           **other})) is None
    assert read(_readings({span: (0.5, 40)}, batches=0)) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_stage_spans_in_a_small_traced_run(cuda_device, cell):
    result, _ = harness.run_cell(MANIFEST, cell, SEED, 1.0, True,
                                 device=cuda_device,
                                 overrides={"config": {"n": 200000}})
    assert result["correct"]
    ops = [name for name, _ in result["breakdown"]["device_ops"]]
    assert not any(name.startswith("repro.") for name in ops), ops
    m = {n: v["value"] for n, v in result["metrics"].items()}
    assert set(STAGE_SPANS) <= set(m)
    assert m["runs_ms"] + m["fused_score_ms"] == pytest.approx(
        m["probe_score_ms"], rel=0.1)
