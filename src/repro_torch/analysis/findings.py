"""Typed findings and the suppression baseline (port of
``repro/analysis/findings.py``).

A :class:`Finding` is one invariant violation: rule id, repo-relative
``path:line``, a one-line message and a fix hint. Findings are *keyed* by
``(rule, path, message)`` — deliberately excluding the line number, so a
pre-existing finding keeps matching its baseline entry when unrelated
edits shift the file.

The baseline (``src/repro_torch/analysis/baseline.json``) is the committed
set of pre-existing findings the lint tolerates:
``python -m repro_torch.analysis.lint``
fails only on findings *not* in the baseline, and ``--fix-baseline``
regenerates it from the current tree. An empty baseline is the goal
state; every retained entry should carry a ``justification``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One invariant violation at ``path:line``.

    ``rule`` is ``R1``–``R7`` (AST rules, analysis/rules.py), ``K1``–``K5``
    (kernel checks, analysis/kernelcheck.py) or ``C1``–``C2`` (contracts,
    analysis/contracts.py); ``R0`` marks a malformed suppression pragma.
    """

    rule: str
    path: str        # repo-relative, posix separators
    line: int
    message: str
    hint: str = ""

    @property
    def key(self) -> str:
        """Baseline identity — line-number free (see module docstring)."""
        return f"{self.rule}|{self.path}|{self.message}"

    def format(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def load_baseline(path: Path) -> Dict[str, dict]:
    """Baseline entries keyed like :attr:`Finding.key`; a missing file is
    an empty baseline (nothing suppressed)."""
    path = Path(path)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} in "
            f"{path} (expected {BASELINE_VERSION})")
    out: Dict[str, dict] = {}
    for ent in data.get("findings", []):
        key = f"{ent['rule']}|{ent['path']}|{ent['message']}"
        out[key] = ent
    return out


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    """Write the current findings as the new baseline (``--fix-baseline``).
    Entries are sorted for a stable diff; hand-add a ``justification``
    field to any entry that is kept on purpose."""
    ents = [{"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message} for f in sorted(set(findings))]
    payload = {"version": BASELINE_VERSION, "findings": ents}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def split_by_baseline(findings: Iterable[Finding],
                      baseline: Dict[str, dict]
                      ) -> Tuple[List[Finding], List[Finding]]:
    """(new, suppressed): findings missing from / present in the
    baseline. Stale baseline entries (no longer found) are ignored —
    ``--fix-baseline`` prunes them."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        (suppressed if f.key in baseline else new).append(f)
    return new, suppressed
