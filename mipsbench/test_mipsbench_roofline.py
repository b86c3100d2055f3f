"""The frozen work counts of the roofline readers against hand-worked
values, and what each per-layer reader returns from given readings."""

import json
from pathlib import Path

import pytest

from mipsbench import devtrace, harness

ROOT = Path(__file__).resolve().parents[1]
PEAKS = json.loads((ROOT / "mipsbench" / "peaks.json").read_text())
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def _module(name):
    return harness.load_reader(name).__globals__


def test_fused_query_count_at_the_imagenet_width():
    fused = _module("fused_query_roofline")
    w = fused["work"](64, 73136, 150, 40)
    assert w["flops"] == 1_404_211_200          # 1.404 GFLOP
    ms = 1e3 * fused["least_seconds"](64, 73136, 150, 40, H100)
    assert ms == pytest.approx(0.02096, abs=5e-6)      # at 67 TFLOP/s
    assert w["bytes"] / H100["hbm_byte_per_s"] < w["flops"] / H100[
        "f32_flop_per_s"]                              # bound by operations


def test_directory_match_count_at_the_imagenet_directory():
    match = _module("bucket_match_roofline")
    w = match["work"](64, 2_249_784, 1)
    assert w["bytes"] == 584_944_096                   # 585 MB
    ms = 1e3 * match["least_seconds"](64, 2_249_784, 1, H100)
    assert ms == pytest.approx(0.1746, abs=1e-4)       # at 3.35 TB/s


def _readings(device_s, shapes, spans=None, busy=2.0, window=2.5):
    trace = devtrace.Trace(window, busy, device_s, [])
    return harness.Readings(spans or {}, 10, trace, shapes,
                            {"calibrate_s": 1.5, "bucket_store_s": 1.25},
                            H100)


def test_roofline_readers_divide_least_time_by_device_time():
    shapes = {("fused_query", (64, 2249647, 150, 73136, 40)): 3,
              ("hamming_scan", (64, 2249784, 1)): 3}
    dev = {"void (anonymous namespace)::fq_span_kernel<float>": 3e-3,
           "void (anonymous namespace)::fq_merge_kernel<2>": 3e-4,
           "void (anonymous namespace)::wide_scan_kernel<0, 1>": 6e-4,
           "aten::cumsum": 0.5}
    r = _readings(dev, shapes)
    fused = harness.load_reader("fused_query_roofline")(r)
    assert fused == pytest.approx(100 * 3 * 2.0958e-5 / 3.3e-3, rel=1e-3)
    match = harness.load_reader("bucket_match_roofline")(r)
    assert match == pytest.approx(100 * 3 * 1.7461e-4 / 6e-4, rel=1e-3)


@pytest.mark.parametrize("name", ["fused_query_roofline",
                                  "bucket_match_roofline"])
def test_roofline_reader_without_launches_reads_nothing(name):
    assert harness.load_reader(name)(_readings({"x": 1.0}, {})) is None


def test_span_and_set_up_readers():
    spans = {"repro.engine.hash_encode": (0.01, 10),
             "repro.engine.directory_match": (0.12, 10),
             "repro.engine.fused_query": (1.9, 10)}
    r = _readings({}, {}, spans)
    assert harness.load_reader("encode_ms")(r) == pytest.approx(1.0)
    assert harness.load_reader("directory_ms")(r) == pytest.approx(12.0)
    assert harness.load_reader("probe_score_ms")(r) == pytest.approx(190.0)
    assert harness.load_reader("device_idle_share")(r) == pytest.approx(20.0)
    assert harness.load_reader("calibrate_s")(r) == 1.5
    assert harness.load_reader("bucket_store_s")(r) == 1.25
    assert harness.load_reader("encode_ms")(_readings({}, {})) is None
