"""The readings that an LM decode cell's limits are set from:

    python3 mipsbench/controls_lmdecode.py --workload dsv2lite-decode-b64-ctx8k \\
        --program-seeds 1,2,3,4,5,6 --control-seeds 11,12,13 --steps 256

For each program seed it sets the program up as a run does, serves
``--steps`` decode steps (slots 0 onwards) and judges them as a run does,
printing each compared number. For each control seed it does the same
with every weight rounded through ``float8_e4m3fn`` before set-up (the
nearest precision below the configuration's bf16), and judges what that
program served against the reference on the weights as drawn, which are
drawn again from the seed once the rounded ones are freed. A limit lies
between the program's largest reading and the control's smallest, and
the control has to fail at least one limit on every seed. The
benchmark's runs never run it; it needs the cell's card.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rounded(tree, dtype):
    """Every floating leaf of ``tree`` rounded through ``dtype`` in place."""
    for value in tree.values():
        if isinstance(value, dict):
            rounded(value, dtype)
        elif value.is_floating_point():
            value.copy_(value.to(dtype).to(value.dtype))


def free(device) -> None:
    """Collect what a freed program left (it holds itself through its
    ``traced`` adapter) and hand its memory back to the card."""
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def read(cell, seed: int, steps: int, device, control: bool) -> dict:
    """Set up, serve ``steps`` slots and judge; the checks and recall."""
    import torch

    from mipsbench import harness
    from mipsbench.kinds import lmdecode as kind

    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    inputs = kind.make_inputs(cell.config, cell.mix, seed, device)
    if control:
        rounded(inputs.params, torch.float8_e4m3fn)
    prog = kind.set_up(cell.config, inputs, device, sync, 1)
    call, slots = kind.caller(prog, cell.config, cell.mix, inputs)
    got, lat = [], []
    for slot in range(min(steps, slots)):
        t = time.perf_counter()
        got.append(call(slot))
        sync()
        lat.append(1e3 * (time.perf_counter() - t))
    window = harness.Window(list(range(len(got))),
                            torch.stack([v for v, _ in got]),
                            torch.stack([i for _, i in got]), lat, 0.0)
    served = kind.served(prog, window)
    del prog, call, got
    if control:     # the weights as drawn, for the reference
        del inputs
        free(device)
        inputs = kind.make_inputs(cell.config, cell.mix, seed, device)
    free(device)
    judged, recall, lines = kind.judge(served, inputs, cell, seed)
    del inputs, served
    free(device)
    for line in lines:
        print(f"  {line}", file=sys.stderr)
    return {"seed": seed, "control": control, "correct": judged["correct"],
            "recall_at_10": recall,
            "step_ms_median": sorted(lat)[len(lat) // 2],
            **{n: c["value"] for n, c in judged["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="1,2,3,4,5,6")
    ap.add_argument("--control-seeds", default="11,12,13")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from mipsbench import harness
    from mipsbench.kinds import lmdecode as kind

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, args.workload)
    device = torch.device(args.device)
    rows = []
    for control, seeds in ((False, args.program_seeds),
                           (True, args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            row = read(cell, seed, args.steps, device, control)
            print(json.dumps(row), flush=True)
            rows.append(row)
    for name in kind.COMPARED:
        prog = [r[name] for r in rows if not r["control"]]
        ctrl = [r[name] for r in rows if r["control"]]
        print(f"{name}: program largest {max(prog, default=None)!r}, "
              f"control smallest {min(ctrl, default=None)!r}, limit "
              f"{cell.workload['limits'][name]!r}")
    return 0


if __name__ == "__main__":
    # the checkout's root replaces this script's folder at the head of
    # the path, so that the harness's modules import as ``mipsbench.*``
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
