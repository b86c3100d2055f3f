"""Readings that the limits of ``workloads/<cell>.json`` are set from, at
the cell's own size, several seeds in one process:

    python3 mipsbench/controls.py --workload <cell> \\
        --program-seeds 11,12,... --control-seeds 21,22,23 [--batches 32]

Program seeds: the program is set up as a run sets it up, serves
``--batches`` batches of the cell's traffic, and is judged as a run is
(its lower readings). Control seeds: the plain reference in the
program's place, its matrix products one precision step below the
configuration's float32 (TF32), judged the same way against the float32
reference (its upper readings). One JSON line per seed on standard
output. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--batches", type=int, default=32)
    args = ap.parse_args(argv)

    import torch

    from mipsbench import check, harness
    from mipsbench.kinds import rangelsh
    from mipsbench.reference import rangelsh as ref

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, args.workload)
    cfg, mix = cell.config, cell.mix
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    batch, k = int(mix["batch"]), int(cfg["k"])
    slots = list(range(args.batches))

    def report(side, seed, verdict, t):
        j = verdict.judged
        print(json.dumps({
            "side": side, "seed": seed, "correct": j["correct"],
            **{n: c["value"] for n, c in j["checks"].items()},
            "width": j["planned_width"],
            "recall": verdict.recall, "seconds": time.perf_counter() - t}),
            flush=True)

    for seed in args.program_seeds:
        t = time.perf_counter()
        inputs = rangelsh.make_inputs(cfg, mix, seed, device)
        prog = rangelsh.set_up(cfg, inputs, device, sync)
        call, _ = rangelsh.caller(prog, cfg, mix, inputs)
        answers = []
        for s in slots:
            answers.append(call(s))
            sync()
        served = rangelsh.served(prog, harness.Window(
            slots, torch.stack([a[0] for a in answers]),
            torch.stack([a[1] for a in answers]), [], 0.0))
        del prog, call, answers
        gc.collect()
        report("program", seed, rangelsh.judge(served, inputs, cell, seed), t)

    for seed in args.control_seeds:
        t = time.perf_counter()
        inputs = rangelsh.make_inputs(cfg, mix, seed, device)
        index, budgets = rangelsh.reference_side(inputs, cfg, "tf32")
        pool_b = inputs.pool.view(-1, batch, inputs.pool.shape[1])
        vals, ids = ref.answer(index, inputs.items, inputs.projections,
                               pool_b[slots].reshape(-1, pool_b.shape[2]),
                               budgets, k, "tf32")
        served = check.Served(slots, vals.view(len(slots), batch, k),
                              ids.view(len(slots), batch, k), index.codes,
                              budgets)
        del index
        report("control", seed, rangelsh.judge(served, inputs, cell, seed), t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
