"""A configuration of another kind runs through the harness from new files
alone: a toy kind (exact top-k by brute force over a seeded catalogue,
judged by one number of its own) with its configuration, mix, workload
and per-layer reader, all written to a folder of their own, comes out
correct from ``run_cell`` on the CPU with the keys and end-to-end metrics
of a RANGE-LSH run; a kind that no file holds is refused by name."""

import json
import shutil
import sys
from pathlib import Path

import pytest

from mipsbench import harness, kinds

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 113
TOY = "toy_exact"
CELL = "toy-exact-b8"

TOY_KIND = '''
"""Exact top-k by brute force: the whole catalogue scored per batch."""
import time

import torch

COMPARED = ("value_gap",)


class Program:
    def __init__(self, items, timings):
        self.items, self.timings = items, timings
        self.tracker = None
        self.traced = self


def make_inputs(config, mix, seed, device):
    gen = torch.Generator(device=device).manual_seed(config["data_seed"])
    items = torch.randn((config["n"], config["d"]), generator=gen,
                        device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn((mix["pool_batches"] * mix["batch"], config["d"]),
                       generator=gen, device=device)
    return items, pool


def set_up(config, inputs, device, sync, repeats):
    t = time.perf_counter()
    for _ in range(repeats):
        items = inputs[0].clone()
    sync()
    return Program(items, {"build_s": (time.perf_counter() - t) / repeats})


def caller(program, config, mix, inputs):
    pool, batch, k = inputs[1], mix["batch"], config["k"]

    def call(slot):
        q = pool[slot * batch:(slot + 1) * batch]
        if program.tracker is None:
            return tuple(torch.topk(q @ program.items.T, k))
        with program.tracker.span("toy.score"):
            return tuple(torch.topk(q @ program.items.T, k))

    return call, pool.shape[0] // batch


def served(program, window):
    return window


def judge(served, inputs, cell, seed):
    items, pool = inputs
    batch, k = cell.mix["batch"], cell.config["k"]
    q = pool.view(-1, batch, pool.shape[1])[served.slots].double()
    want_vals, want_ids = torch.topk(q @ items.double().T, k)
    gap = float((served.vals.double() - want_vals).abs().max())
    limit = cell.workload["limits"]["value_gap"]
    hits = (served.ids[..., :, None] == want_ids[..., None, :]).any(dim=-1)
    judged = {"correct": gap <= limit, "invalid_answers": 0,
              "checks": {"value_gap": {"value": gap, "limit": limit}}}
    return judged, float(hits.float().mean()), [f"toy: {gap!r} widest gap"]
'''

TOY_READER = '''
def read(r):
    s, n = r.spans.get("toy.score", (0.0, 0))
    return 1e3 * s / r.batches if n and r.batches else None
'''


def _toy_manifest():
    e2e = [{**m, "workloads": m["workloads"] + [CELL]} if "workloads" in m
           else m for m in MANIFEST["end_to_end"]]
    return {
        "configs": [{"name": "toy", "source": "https://example.org/toy",
                     "file": "mipsbench/configs/toy.json", "reduced": [],
                     "why": "a kind with no index"}],
        "workloads": [{"name": CELL, "config": "toy", "traffic": "toy-b8",
                       "chips": 1, "why": "8-query batches"}],
        "end_to_end": e2e,
        "per_layer": [{"name": "toy_score_ms", "unit": "ms",
                       "better": "lower", "source": "program_span",
                       "layer": "toy scoring", "moves": "queries_per_s",
                       "workloads": [CELL]}],
    }


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files under ``tmp_path``, and the harness looking there."""
    bench = tmp_path / "mipsbench"
    for sub in ("configs", "mixes", "workloads", "metrics", "kinds"):
        (bench / sub).mkdir(parents=True)
    (bench / "kinds" / f"{TOY}.py").write_text(TOY_KIND)
    (bench / "metrics" / "toy_score_ms.py").write_text(TOY_READER)
    files = {
        "configs/toy.json": {"name": "toy", "kind": TOY, "n": 512, "d": 16,
                             "k": 10, "data_seed": 5, "reduced": [],
                             "assumed": ["a toy"]},
        "mixes/toy-b8.json": {"name": "toy-b8", "batch": 8,
                              "pool_batches": 6},
        f"workloads/{CELL}.json": {"config": "toy", "traffic": "toy-b8",
                                   "chips": 1, "build_repeats": 2,
                                   "profile_seconds": 0.1,
                                   "limits": {"value_gap": 1e-4}},
    }
    for rel, body in files.items():
        (bench / rel).write_text(json.dumps(body))
    shutil.copy(harness.BENCH / "peaks.json", bench / "peaks.json")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(kinds, "__path__",
                        [str(bench / "kinds"), *kinds.__path__])
    yield bench
    sys.modules.pop(f"mipsbench.kinds.{TOY}", None)
    if hasattr(kinds, TOY):
        delattr(kinds, TOY)


@pytest.fixture(scope="module")
def rangelsh_result():
    """A tiny run of a RANGE-LSH cell, before the harness looks elsewhere."""
    cell = next(w["name"] for w in MANIFEST["workloads"]
                if harness.resolve_cell(MANIFEST, w["name"]).config["kind"]
                == "rangelsh")
    tiny = {"config": {"n": 6000, "d": 24},
            "mix": {"pool_batches": 8, "batch": 16},
            "workload": {"sample_batches": 4, "build_repeats": 2}}
    return harness.run_cell(MANIFEST, cell, SEED, 0.3, False, device="cpu",
                            overrides=tiny)[0]


def test_second_kind_runs_from_new_files_alone(rangelsh_result, toy):
    result, lines = harness.run_cell(_toy_manifest(), CELL, SEED, 0.3, False,
                                     device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert list(result) == list(rangelsh_result)
    assert set(result["metrics"]) == {m["name"] for m in MANIFEST["end_to_end"]}
    assert result["attempted"] > 0 and result["attempted"] % 8 == 0
    assert lines[1].startswith("toy: ") and lines[-1].startswith("value_gap: ")


def test_second_kind_hands_its_traced_object_the_tracker(toy):
    result, _ = harness.run_cell(_toy_manifest(), CELL, SEED, 0.3, True,
                                 device="cpu")
    assert result["correct"]
    assert result["metrics"]["toy_score_ms"]["value"] > 0


def test_unknown_kind_is_refused_naming_the_file(toy):
    cfg = toy / "configs" / "toy.json"
    cfg.write_text(json.dumps({**json.loads(cfg.read_text()),
                               "kind": "no_such_kind"}))
    with pytest.raises(ValueError, match="no_such_kind.py") as err:
        harness.run_cell(_toy_manifest(), CELL, SEED, 0.3, False,
                         device="cpu")
    assert str(toy / "kinds" / "no_such_kind.py") in str(err.value)
