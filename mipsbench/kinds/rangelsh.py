"""RANGE-LSH query serving: a catalogue indexed by the program's
``IndexSpec``, served in batches by its ``QueryEngine`` at the budgets its
planner gives for the configuration's recall target, and judged against
the plain reference (``reference/rangelsh.py``) by ``check.py``.

The harness drives a kind through ``make_inputs``, ``set_up``, ``caller``,
``served`` and ``judge``, and checks each cell's limits against
``COMPARED``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from mipsbench import check, traffic
from mipsbench.reference import rangelsh as ref

COMPARED = check.COMPARED
WARM_ITEMS = 65536
make_inputs = traffic.make_inputs


class Program(NamedTuple):
    index: object
    buckets: object
    engine: object
    timings: Dict[str, float]
    k: int
    target: float

    @property
    def traced(self):
        """What the harness hands a ``Tracker`` for the span phase."""
        return self.engine


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
                    "build_s": build_s},
                   int(cfg["k"]), float(spec.recall_target))


def caller(prog: Program, cfg: dict, mix: dict, inputs: traffic.Inputs):
    """(call(slot) -> (vals, ids), pool batches): one served batch as the
    mix asks. ``plan: per_batch`` names the recall target in every call,
    so the program plans each batch; ``plan: once`` resolves it through
    the program's planner here, once, and serves each batch with those
    budgets."""
    from repro_torch.core import planner

    pool = inputs.pool
    batch, k, target = int(mix["batch"]), prog.k, prog.target
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

    return call, slots


def served(prog: Program, window) -> check.Served:
    """The window's answers with the codes and the budgets they were
    planned with: the program's planner asked again after the window on
    the same calibration and target. Its plan is a deterministic function
    of those two, so this is the plan that ``caller`` served a ``plan:
    once`` mix with, and the one each batch of a ``per_batch`` mix made."""
    from repro_torch.core import planner

    budgets = planner.resolve_budgets(prog.index.calib, prog.target,
                                      k=prog.k).budgets
    return check.Served(window.slots, window.vals, window.ids,
                        prog.index.codes, budgets)


class Verdict(NamedTuple):
    judged: dict
    recall: float
    lines: List[str]


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


def judge(served: check.Served, inputs: traffic.Inputs, cell,
          seed: int) -> Verdict:
    """The reference's verdict on ``served``, the recall of its answers
    against exact MIPS, and the line that shows the planned width beside
    the reference's."""
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
    j = check.judge(served, items=inputs.items, pool=inputs.pool,
                    batch=batch, index=index, budgets=budgets,
                    truth_best=truth_best, ref_answers=ref_answers,
                    admitted=admitted, limits=cell.workload["limits"])
    slots = torch.as_tensor(served.slots, device=served.ids.device)
    hits = (served.ids.to(torch.int64)[..., :, None]
            == truth_ids[slots][..., None, :]).any(dim=-1)
    lines = [f"planned width: program {j['planned_width']['program']}, "
             f"reference {j['planned_width']['reference']}; budgets by "
             f"range {list(served.budgets)}; answers compared with the "
             f"reference {j['compared_entries']}; invalid answers "
             f"{j['invalid_answers']} (not compared: shown for the record)"]
    return Verdict(j, float(hits.float().mean()), lines)
