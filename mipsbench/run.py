"""Run one cell of the benchmark of the PyTorch and CUDA port:

    python3 mipsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result object; the last lines of standard
error name each number compared with the reference beside its limit. It
exits with 2, printing no result, when the cell's cards are not there,
and with 3 when JAX or the JAX package is loaded once the window has
closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root replaces this script's folder at the head of the
# path, so that the harness's modules import as ``mipsbench.*``
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from mipsbench import harness

    result, lines = harness.run_cell(manifest, args.workload, args.seed,
                                     args.seconds, bool(args.trace), t0=_T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
