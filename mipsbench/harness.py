"""One run of one cell: set-up, the measured window, in a traced run the
span phase and the profiled phase, then the comparison with the plain
reference and the result line.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json``, ``workloads/<cell>.json`` (its limits and sampling),
its configuration's file, ``mixes/<traffic>.json`` and one reader
``metrics/<metric>.py`` per per-layer metric. From the program the run
takes the system under test, its spans and its launch counters.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mipsbench import check, devtrace, traffic
from mipsbench.reference import rangelsh as ref

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_ITEMS = 65536


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


class Program(NamedTuple):
    index: object
    buckets: object
    engine: object
    timings: Dict[str, float]


def set_up(cfg: dict, inputs: traffic.Inputs, device: torch.device,
           sync: Callable, repeats: int = 1) -> Program:
    """Build the program's index, bucket store, calibration and engine
    from the benchmark's inputs, ``repeats`` times over, and serve the
    last build. The host clock reads all builds at once (``build_s`` is
    their mean) and each step of each build (the means of the steps)."""
    from repro_torch.core import bucket_index, planner
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.index import IndexSpec, build

    spec = IndexSpec(**cfg["spec"])
    if spec.hash_bits != inputs.projections.shape[1]:
        raise ValueError(f"the program hashes {spec.hash_bits} bits, the "
                         f"projections hold {inputs.projections.shape[1]}")
    # the build path once on a slice of the catalogue before the clock
    # starts: the kernel libraries, the device's lazily loaded modules and
    # the BLAS handles are ready, as in a server that refreshes its index
    t_warm = time.perf_counter()
    few = min(WARM_ITEMS, inputs.items.shape[0])
    warm = build(dataclasses.replace(spec, recall_target=None),
                 inputs.items[:few], params=inputs.projections, device=device)
    planner.calibrate(warm, inputs.calibration[:8], k=int(cfg["k"]),
                      buckets=bucket_index.build_bucket_index(warm))
    del warm
    sync()
    steps = dict.fromkeys(("index_s", "bucket_store_s", "calibrate_s"), 0.0)
    t0 = time.perf_counter()
    for _ in range(repeats):
        index = buckets = calib = None    # the last build's memory goes first
        t = time.perf_counter()
        index = build(dataclasses.replace(spec, recall_target=None),
                      inputs.items, params=inputs.projections, device=device)
        sync()
        t1 = time.perf_counter()
        buckets = bucket_index.build_bucket_index(index)
        sync()
        t2 = time.perf_counter()
        calib = planner.calibrate(index, inputs.calibration,
                                  k=int(cfg["k"]), buckets=buckets)
        sync()
        t3 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t, t2 - t1, t3 - t2)):
            steps[name] += dt
    build_s = (time.perf_counter() - t0) / repeats
    index = index._replace(spec=spec, calib=calib)
    engine = QueryEngine(index, engine=spec.engine, buckets=buckets,
                         device=device)
    return Program(index, buckets, engine,
                   {"warm_s": t0 - t_warm,
                    **{n: v / repeats for n, v in steps.items()},
                    "build_s": build_s})


def batch_caller(prog: Program, cfg: dict, mix: dict, pool: torch.Tensor):
    """(call(slot) -> (vals, ids), pool batches, budgets or None): one
    served batch as the mix asks. ``plan: per_batch`` names the recall
    target in every call, so the program plans each batch; ``plan: once``
    resolves it through the program's planner here, once, and serves each
    batch with those budgets."""
    from repro_torch.core import planner

    batch, k = int(mix["batch"]), int(cfg["k"])
    target = float(cfg["spec"]["recall_target"])
    slots = pool.shape[0] // batch
    budgets = None
    if mix["plan"] == "once":
        budgets = planner.resolve_budgets(prog.index.calib, target,
                                          k=k).budgets
    elif mix["plan"] != "per_batch":
        raise ValueError(f"unknown plan {mix['plan']!r} in the mix")

    def call(slot: int):
        q = pool[slot * batch:(slot + 1) * batch]
        if budgets is None:
            return prog.engine.query(q, k, recall_target=target)
        return prog.engine.query(q, k, budgets=budgets)

    return call, slots, budgets


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


class Verdict(NamedTuple):
    judged: dict
    recall: float


def reference_side(inputs: traffic.Inputs, cfg: dict, mode: str):
    spec = cfg["spec"]
    index = ref.build(inputs.items, inputs.projections, int(spec["m"]),
                      int(spec["code_len"]), float(spec["eps"]), mode)
    budgets = ref.plan(index, inputs.items, inputs.projections,
                       inputs.calibration, int(cfg["k"]),
                       float(spec["recall_target"]), mode)
    return index, budgets


def sample_slots(seed: int, slots: List[int], count: int) -> List[int]:
    used = sorted(set(slots))
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(used), size=min(count, len(used)), replace=False)
    return sorted(used[i] for i in pick)


def judge(served: check.Served, inputs: traffic.Inputs, cell: Cell,
          seed: int) -> Verdict:
    """The reference's verdict on ``served`` and the recall of its answers
    against exact MIPS. Runs ``BLOCK`` queries at a time."""
    cfg, batch = cell.config, int(cell.mix["batch"])
    k = int(cfg["k"])
    index, budgets = reference_side(inputs, cfg, "f32")
    pool_b = inputs.pool.view(-1, batch, inputs.pool.shape[1])
    used = sorted(set(served.slots))
    _, truth = ref.exact_topk(pool_b[used].reshape(-1, pool_b.shape[2]),
                              inputs.items, k, "f32")
    truth = truth.view(len(used), batch, k)
    truth_ids = torch.zeros((pool_b.shape[0], batch, k), dtype=torch.int64,
                            device=truth.device)
    truth_ids[used] = truth
    best = check.exact_scores(
        pool_b[used].reshape(-1, pool_b.shape[2]), inputs.items,
        truth[:, :, :1].reshape(-1, 1)).view(len(used), batch)
    truth_best = torch.zeros((pool_b.shape[0], batch), dtype=torch.float64,
                             device=truth.device)
    truth_best[used] = best
    first = {}
    for b, s in enumerate(served.slots):
        first.setdefault(s, b)
    ref_answers, admitted = {}, {}
    for s in sample_slots(seed, served.slots,
                          int(cell.workload["sample_batches"])):
        ref_answers[s] = ref.answer(index, inputs.items, inputs.projections,
                                    pool_b[s], budgets, k, "f32")[1]
        admitted[s] = ref.admitted(index, inputs.projections, pool_b[s],
                                   budgets, served.ids[first[s]], "f32")
    judged = check.judge(served, items=inputs.items, pool=inputs.pool,
                         batch=batch, index=index, budgets=budgets,
                         truth_best=truth_best, ref_answers=ref_answers,
                         admitted=admitted, limits=cell.workload["limits"])
    slots = torch.as_tensor(served.slots, device=served.ids.device)
    hits = (served.ids.to(torch.int64)[..., :, None]
            == truth_ids[slots][..., None, :]).any(dim=-1)
    return Verdict(judged, float(hits.float().mean()))


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
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracker

    entered = time.perf_counter()
    t0 = entered if t0 is None else t0
    cell = resolve_cell(manifest, name, overrides)
    cfg, mix, wl = cell.config, cell.mix, cell.workload
    device = torch.device("cuda" if device is None else device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    batch, k = int(mix["batch"]), int(cfg["k"])
    target = float(cfg["spec"]["recall_target"])

    inputs = traffic.make_inputs(cfg, mix, seed, device)
    sync()
    drawn = time.perf_counter()
    prog = set_up(cfg, inputs, device, sync, int(wl["build_repeats"]))
    built = time.perf_counter()
    call, slots, planned = batch_caller(prog, cfg, mix, inputs.pool)
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
        prog.engine.tracker = Tracker([sink])
    window = serve(call, slots, seconds, sync, first=1)
    readings = None
    if trace:
        prog.engine.tracker = None
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
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
                            tr, shapes, prog.timings, peaks_for(kind))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    budgets = planned or planner.resolve_budgets(prog.index.calib, target,
                                                 k=k).budgets
    served = check.Served(window.slots, window.vals, window.ids,
                          prog.index.codes, budgets)
    timings = prog.timings
    del prog, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    gc.unfreeze()
    verdict = judge(served, inputs, cell, seed)
    if trace:
        wanted = cell.per_layer
        values = {m["name"]: load_reader(m["name"])(readings) for m in wanted}
    else:
        wanted = cell.end_to_end
        values = {
            "queries_per_s": len(window.slots) * batch / window.seconds,
            "batch_ms_p95": float(np.percentile(window.latency_ms, 95)),
            "recall_at_10": verdict.recall,
            "build_s": timings["build_s"],
            "setup_s": setup_s,
        }
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    dev = device_info(cuda, peak)
    result = {"correct": verdict.judged["correct"],
              "attempted": len(window.slots) * batch,
              "failed": verdict.judged["invalid_answers"],
              "metrics": metrics, "device": dev}
    if trace and readings.trace is not None:
        dev["busy_s"] = readings.trace.busy_s
        dev["window_s"] = readings.trace.window_s
        result["breakdown"] = devtrace.breakdown(readings.trace)
    result["checks"] = verdict.judged["checks"]
    j = verdict.judged
    lines = ["set-up seconds: " + ", ".join(
        f"{n} {v:.3f}" for n, v in steps.items() if n != "build_s")]
    lines += [f"planned width: program {j['planned_width']['program']}, "
             f"reference {j['planned_width']['reference']}; budgets by "
             f"range {list(served.budgets)}; answers compared with the "
             f"reference {j['compared_entries']}; invalid answers "
             f"{j['invalid_answers']} (not compared: shown for the record)"]
    lines += [f"{n}: {c['value']!r} limit {c['limit']!r}"
              for n, c in j["checks"].items()]
    return result, lines
