"""The port's lint CLI: ``python -m repro_torch.analysis.lint`` (port of
``repro/analysis/lint.py``).

Runs the AST rules (R1-R7, analysis/rules.py) over ``src/repro_torch``,
and R7 alone over ``chip_smoke.py``, subtracts the committed baseline,
and exits 1 on any *new* finding. ``--kernels`` adds the kernel checks
(K1-K5, analysis/kernelcheck.py): on a host without a CUDA device the
probes and timings are skipped and the skip is printed; on the card they
run through the CUDA kernels. ``--contracts`` adds the dtype and
plan-memo contracts (analysis/contracts.py) on a tiny index, on the same
device as the kernel checks: the card when there is one (the entry
points launch the CUDA kernels), else the CPU.

    python -m repro_torch.analysis.lint                  # AST rules
    python -m repro_torch.analysis.lint --kernels        # + K1-K5
    python -m repro_torch.analysis.lint --contracts      # + contracts
    python -m repro_torch.analysis.lint --fix-baseline   # re-record
    python -m repro_torch.analysis.lint path/to/tree ... # other roots

Exit codes: 0 clean, 1 new findings, 2 usage or setup error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis import findings as fnd
from repro_torch.analysis import rules

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parents[2]
DEFAULT_BASELINE = PACKAGE_DIR / "baseline.json"
DEFAULT_ROOTS = ("src/repro_torch",)
IMPORT_ONLY = ("chip_smoke.py",)


def run(argv: Optional[Sequence[str]] = None, *, stdout=None) -> int:
    """Entry point; returns the process exit code (0 clean, 1 findings,
    2 usage/setup error)."""
    out = stdout or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="invariant checker of the PyTorch port (rules R1-R7, "
                    "kernel checks K1-K5, contracts C1-C2)")
    ap.add_argument("roots", nargs="*",
                    help=f"directories to lint (default: {DEFAULT_ROOTS} "
                         f"and R7 over {IMPORT_ONLY}, under the repo root)")
    ap.add_argument("--repo-root", default=None,
                    help="path findings are reported relative to "
                         "(default: the repo root)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE})")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="rewrite the baseline from current findings and "
                         "exit 0")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the dtype and plan-memo contracts on a "
                         "tiny index (seconds)")
    ap.add_argument("--kernels", action="store_true",
                    help="also run the kernel checks K1-K5 (probes and "
                         "timings only on a CUDA device)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-finding hints")
    args = ap.parse_args(argv)

    repo_root = Path(args.repo_root) if args.repo_root else REPO_ROOT
    if args.roots:
        roots, import_only = [Path(r) for r in args.roots], []
    else:
        roots = [repo_root / r for r in DEFAULT_ROOTS]
        import_only = [repo_root / f for f in IMPORT_ONLY
                       if (repo_root / f).exists()]
    for r in roots:
        if not r.exists():
            print(f"error: lint root {r} does not exist", file=out)
            return 2

    found: List[fnd.Finding] = rules.lint_tree(roots, repo_root,
                                               import_only)
    device = None
    if args.contracts or args.kernels:
        import torch
        device = torch.device("cuda" if torch.cuda.is_available()
                              else "cpu")
    if args.contracts:
        from repro_torch.analysis import contracts
        creport = contracts.run_contracts(device=device)
        print(f"contracts: {len(creport.findings)} finding(s) on "
              f"{device.type}", file=out)
        found.extend(creport.findings)
    if args.kernels:
        from repro_torch.analysis import kernelcheck
        kfound, report = kernelcheck.run_kernelcheck(probes=True,
                                                     device=device)
        for line in kernelcheck.report_lines(report):
            print(line, file=out)
        found.extend(kfound)
    found = sorted(set(found))

    baseline_path = Path(args.baseline) if args.baseline \
        else DEFAULT_BASELINE
    if args.fix_baseline:
        fnd.save_baseline(baseline_path, found)
        print(f"baseline rewritten: {len(found)} finding(s) -> "
              f"{baseline_path}", file=out)
        return 0

    baseline = fnd.load_baseline(baseline_path)
    new, suppressed = fnd.split_by_baseline(found, baseline)
    for f in new:
        print(f.format() if not args.quiet
              else f"{f.path}:{f.line}: {f.rule} {f.message}", file=out)
    print(f"{len(new)} new finding(s), {len(suppressed)} baselined "
          f"({baseline_path.name}: {len(baseline)} entr"
          f"{'y' if len(baseline) == 1 else 'ies'})", file=out)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(run())
