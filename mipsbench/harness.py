"""One run of one cell: set-up, the measured window, in a traced run the
span phase and the profiled phase, then the comparison with the plain
reference and the result line.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json``, ``workloads/<cell>.json`` (its limits and sampling),
its configuration's file, ``mixes/<traffic>.json``, one reader
``metrics/<metric>.py`` per per-layer metric, and ``kinds/<kind>.py`` for
the ``kind`` that the configuration's file names: how that kind of
configuration is drawn, set up, called, packed and judged. From the
program the run takes the system under test, its spans and its launch
counters.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mipsbench import devtrace, kinds

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell(NamedTuple):
    name: str
    config: dict
    mix: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


class Window(NamedTuple):
    slots: List[int]
    vals: torch.Tensor        # (batches, batch, k)
    ids: torch.Tensor         # (batches, batch, k)
    latency_ms: List[float]
    seconds: float


class Readings(NamedTuple):
    """What a per-layer reader reads."""
    spans: Dict[str, Tuple[float, int]]   # span name -> (seconds, count)
    batches: int                          # batches of the span phase
    trace: Optional[devtrace.Trace]       # the profiled phase
    launch_shapes: Dict[tuple, int]       # (op, shape) -> launches, profiled
    setup: Dict[str, float]
    peaks: Optional[Dict[str, float]]


class SpanSums:
    """Tracker sink that adds up span durations by name."""

    def __init__(self):
        self.sums: Dict[str, Tuple[float, int]] = {}

    def emit(self, record: dict) -> None:
        if record.get("type") == "span":
            s, n = self.sums.get(record["name"], (0.0, 0))
            self.sums[record["name"]] = (s + record["dur_s"], n + 1)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_reader(metric: str) -> Callable:
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"mipsbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_kind(config: dict):
    """The module ``mipsbench.kinds.<kind>`` that the configuration's
    ``kind`` names."""
    kind = config.get("kind")
    name = f"mipsbench.kinds.{kind}"
    if not (isinstance(kind, str) and kind.isidentifier()) \
            or importlib.util.find_spec(name) is None:
        looked = " or ".join(str(Path(p) / f"{kind}.py")
                             for p in kinds.__path__)
        raise ValueError(f"configuration {config.get('name')!r} names kind "
                         f"{kind!r}: found no {looked}")
    return importlib.import_module(name)


def resolve_cell(manifest: dict, name: str,
                 overrides: Optional[Dict[str, dict]] = None) -> Cell:
    """The cell ``name`` with its files; ``overrides`` updates the loaded
    ``config``, ``mix`` or ``workload`` (tests shrink them)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise ValueError(f"no cell {name!r} in BENCHMARK.json")
    config_entry = next(c for c in manifest["configs"]
                        if c["name"] == entry["config"])
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key}="
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    parts = {"config": load_json(ROOT / config_entry["file"]),
             "mix": load_json(BENCH / "mixes" / f"{entry['traffic']}.json"),
             "workload": workload}
    for key, update in (overrides or {}).items():
        parts[key] = {**parts[key], **update}

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, parts["config"], parts["mix"], parts["workload"],
                [m for m in manifest["end_to_end"] if applies(m)],
                [m for m in manifest["per_layer"] if applies(m)])


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: the loaded modules) that
    the run may not hold, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def serve(call: Callable, slots: int, seconds: float, sync: Callable,
          first: int = 0) -> Window:
    """Closed loop: each batch starts when the last has synchronised,
    pool batches in order from ``first``, until ``seconds`` have passed.
    Each batch's latency is the host clock from the call to the end of
    its synchronise, as its caller sees it. Answers go into buffers that
    grow by doubling, so the loop holds no object per batch."""
    out_slots, lat = [], []
    vals = ids = None
    i = first
    t0 = time.perf_counter()
    while not out_slots or time.perf_counter() - t0 < seconds:
        slot = i % slots
        h = time.perf_counter()
        v, d = call(slot)
        sync()
        lat.append(1e3 * (time.perf_counter() - h))
        n = len(out_slots)
        if vals is None or n == vals.shape[0]:
            vals = _grown(vals, v, n)
            ids = _grown(ids, d, n)
        vals[n].copy_(v)
        ids[n].copy_(d)
        out_slots.append(slot)
        i += 1
    t1 = time.perf_counter()
    n = len(out_slots)
    return Window(out_slots, vals[:n], ids[:n], lat, t1 - t0)


def _grown(buf: Optional[torch.Tensor], like: torch.Tensor, n: int
           ) -> torch.Tensor:
    new = like.new_empty((max(64, 2 * n),) + tuple(like.shape))
    if buf is not None:
        new[:n] = buf[:n]
    return new


def join(a: Window, b: Window) -> Window:
    return Window(a.slots + b.slots, torch.cat([a.vals, b.vals]),
                  torch.cat([a.ids, b.ids]), a.latency_ms + b.latency_ms,
                  a.seconds + b.seconds)


def device_info(cuda: bool, peak: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    return load_json(BENCH / "peaks.json").get(kind)


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, *, t0: Optional[float] = None, device=None,
             overrides: Optional[Dict[str, dict]] = None
             ) -> Tuple[dict, List[str]]:
    """One run. Returns (the result object, the lines that name each
    number compared beside its limit)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracker

    entered = time.perf_counter()
    t0 = entered if t0 is None else t0
    cell = resolve_cell(manifest, name, overrides)
    cfg, mix, wl = cell.config, cell.mix, cell.workload
    kind = load_kind(cfg)
    device = torch.device("cuda" if device is None else device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    batch = int(mix["batch"])

    inputs = kind.make_inputs(cfg, mix, seed, device)
    sync()
    drawn = time.perf_counter()
    prog = kind.set_up(cfg, inputs, device, sync, int(wl["build_repeats"]))
    built = time.perf_counter()
    call, slots = kind.caller(prog, cfg, mix, inputs)
    call(0)
    sync()
    setup_s = time.perf_counter() - t0
    steps = {"start": entered - t0, "inputs": drawn - entered,
             **prog.timings, "first_batch": t0 + setup_s - built}
    # what set-up made lives to the end: the collector need not walk it
    gc.collect()
    gc.freeze()

    sink = SpanSums()
    if trace:
        prog.traced.tracker = Tracker([sink])
    window = serve(call, slots, seconds, sync, first=1)
    readings = None
    if trace:
        prog.traced.tracker = None
        card = torch.cuda.get_device_name(0) if cuda else "cpu"
        tr, shapes, box = None, {}, []
    if trace and cuda:
        ops.reset_launch_counts()

        def one_batch():
            slot = (1 + len(window.slots) + len(box)) % slots
            box.append((slot, *call(slot)))
            sync()

        prof = devtrace.profile_batches(one_batch,
                                        float(wl["profile_seconds"]))
        shapes = dict(ops.launch_shapes)
        tr = devtrace.read(prof)
        del prof
        window = join(window, Window(
            [b[0] for b in box], torch.stack([b[1] for b in box]),
            torch.stack([b[2] for b in box]), [], 0.0))
    if trace:
        readings = Readings(dict(sink.sums), len(window.slots) - len(box),
                            tr, shapes, prog.timings, peaks_for(card))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    served = kind.served(prog, window)
    timings = prog.timings
    del prog, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    gc.unfreeze()
    judged, recall, kind_lines = kind.judge(served, inputs, cell, seed)
    if trace:
        wanted = cell.per_layer
        values = {m["name"]: load_reader(m["name"])(readings) for m in wanted}
    else:
        wanted = cell.end_to_end
        values = {
            "queries_per_s": len(window.slots) * batch / window.seconds,
            "batch_ms_p95": float(np.percentile(window.latency_ms, 95)),
            "recall_at_10": recall,
            "build_s": timings["build_s"],
            "setup_s": setup_s,
        }
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    dev = device_info(cuda, peak)
    result = {"correct": judged["correct"],
              "attempted": len(window.slots) * batch,
              "failed": judged["invalid_answers"],
              "metrics": metrics, "device": dev}
    if trace and readings.trace is not None:
        dev["busy_s"] = readings.trace.busy_s
        dev["window_s"] = readings.trace.window_s
        result["breakdown"] = devtrace.breakdown(readings.trace)
    result["checks"] = judged["checks"]
    lines = ["set-up seconds: " + ", ".join(
        f"{n} {v:.3f}" for n, v in steps.items() if n != "build_s")]
    lines += kind_lines
    lines += [f"{n}: {c['value']!r} limit {c['limit']!r}"
              for n, c in judged["checks"].items()]
    return result, lines
