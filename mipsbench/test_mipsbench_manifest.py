"""BENCHMARK.json and the files the harness finds by name: every
configuration, its kind, cell, mix and per-layer reader loads, and every
name, unit and number keeps to the rules of the manifest's format. What
holds of every configuration is checked of each; what holds of one kind
only, of the configurations of that kind."""

import json
import math
import re
from pathlib import Path

import pytest

from mipsbench import harness, traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "mipsbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
CONFIGS = [c["name"] for c in MANIFEST["configs"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]
END_TO_END = [m["name"] for m in MANIFEST["end_to_end"]]
# a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
# 180 s a cell to compile and 1200 s spare fit in 43200 s
CHECK_SECONDS = 43200


def _line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_manifest_keys_and_size():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "mipsbench/run.py"]
    assert MANIFEST["paths"] == ["mipsbench"]
    for word in MANIFEST["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    run = MANIFEST["run_seconds"]
    assert isinstance(run, int) and 1 <= run <= 51
    assert 2 + 14 * 24 * (run + 60) + 24 * 180 + 1200 <= CHECK_SECONDS


def test_paths_hold_only_the_benchmark():
    for p in MANIFEST["paths"]:
        assert PATH.fullmatch(p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.fullmatch(n), n
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert set(END_TO_END).isdisjoint(PER_LAYER)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_file_loads_by_name(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"mipsbench/configs/{config}.json"
    assert _line(entry["source"]) and _line(entry["why"])
    assert entry["source"].startswith("https://")
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["name"] == config and body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"] and body["assumed"]
    assert callable(harness.load_kind(body).judge)
    assert any(config == w["config"] for w in MANIFEST["workloads"])
    if body["kind"] == "rangelsh":
        assert body["reduced"] == [] and body["precision"] == "float32"
        spec = body["spec"]
        assert traffic.hash_bits(spec) == spec["code_len"] - math.ceil(
            math.log2(spec["m"]))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and _line(entry["why"])
    loaded = harness.resolve_cell(MANIFEST, cell)
    kind = harness.load_kind(loaded.config)
    assert loaded.mix["name"] == entry["traffic"]
    assert loaded.workload["build_repeats"] >= 1
    limits = loaded.workload["limits"]
    assert set(limits) == set(kind.COMPARED)
    if loaded.config["kind"] == "rangelsh":
        assert loaded.mix["plan"] in ("per_batch", "once")
        assert loaded.workload["sample_batches"] >= 1
        exact = ("outside_candidates", "budgets_differ")
        assert all(limits[n] == 0 for n in exact)
        assert all(v > 0 for n, v in limits.items() if n not in exact)
    reported = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert loaded.per_layer


@pytest.mark.parametrize("metric", END_TO_END)
def test_end_to_end_metric(metric):
    m = next(e for e in MANIFEST["end_to_end"] if e["name"] == metric)
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES_E2E
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", PER_LAYER)
def test_per_layer_metric_has_a_reader(metric):
    m = next(e for e in MANIFEST["per_layer"] if e["name"] == metric)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and _line(m["layer"])
    moved = next(e for e in MANIFEST["end_to_end"]
                 if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", CELLS)
    assert callable(harness.load_reader(metric))
    if metric.endswith("_roofline"):
        assert m["unit"] == "%" and m["source"] == "device_trace"


def test_one_layer_name_per_layer():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 or k == "engine:" for k, v in layers.items())


def test_every_reader_file_is_a_listed_metric():
    files = {f.stem for f in (BENCH / "metrics").glob("*.py")}
    assert files == set(PER_LAYER)
