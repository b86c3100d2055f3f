"""Tracker sinks (port of ``repro/obs/sinks.py``).

A sink receives every metric update as one flat dict record (``type`` in
{counter, gauge, observe, event, span}, ``name``, ``t`` seconds since
tracker start, plus type-specific fields). Three implementations:

  * :class:`RingBufferSink` — bounded in-memory time series; overflow
    drops the *oldest* records and counts them (``dropped``), so a
    long-running server holds a sliding window, never unbounded memory.
  * :class:`JsonlSink` — one JSON object per line, append mode, with
    optional size-capped rotation; :func:`read_jsonl` reads it back.
  * :class:`StdoutTableSink` — human-readable rollup on demand
    (``dump(snapshot)``), plus optional passthrough of event records.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, Iterable, List, Optional


class RingBufferSink:
    """Keep the last ``capacity`` records; count what overflowed."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self.total = 0

    def emit(self, record: dict) -> None:
        self._buf.append(record)      # deque drops the oldest on overflow
        self.total += 1

    @property
    def dropped(self) -> int:
        return self.total - len(self._buf)

    @property
    def records(self) -> List[dict]:
        """Oldest-to-newest window contents (a copy)."""
        return list(self._buf)

    def query(self, *, type: Optional[str] = None,
              name: Optional[str] = None) -> List[dict]:
        """Window records filtered by type and/or exact name."""
        return [r for r in self._buf
                if (type is None or r.get("type") == type)
                and (name is None or r.get("name") == name)]


class JsonlSink:
    """Append records to ``path`` as JSON lines (flushed per record by
    default so a crashed process loses nothing).

    ``max_bytes`` bounds disk growth under sustained traffic (the
    open-loop load harness): when the live file would exceed it, the file
    rotates to ``path + ".1"`` (replacing any previous rotation — exactly
    one trailing file is kept) and a fresh ``path`` is opened, so a
    long-running server holds at most ~``2 * max_bytes`` on disk.
    ``rotations`` counts how often that happened; ``total`` counts every
    record ever emitted (both surface in ``Tracker.snapshot()``)."""

    def __init__(self, path: str, *, autoflush: bool = True,
                 max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.path = path
        self.autoflush = autoflush
        self.max_bytes = max_bytes
        self.total = 0
        self.rotations = 0
        self._bytes = os.path.getsize(path) if os.path.exists(path) else 0
        self._fh = open(path, "a")

    def _rotate(self) -> None:
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a")
        self._bytes = 0
        self.rotations += 1

    def emit(self, record: dict) -> None:
        line = json.dumps(record, default=_jsonable) + "\n"
        if self.max_bytes is not None and self._bytes \
                and self._bytes + len(line) > self.max_bytes:
            self._rotate()
        self._fh.write(line)
        self._bytes += len(line)
        self.total += 1
        if self.autoflush:
            self._fh.flush()

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _jsonable(x):
    """Fallback encoder: numpy scalars/arrays degrade to python types."""
    if hasattr(x, "item") and getattr(x, "ndim", None) in (0, None):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


def read_jsonl(path: str) -> List[dict]:
    """Load a :class:`JsonlSink` export back into record dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class StdoutTableSink:
    """Print typed events as they happen (``live=True``) and render
    aggregate tables from a tracker snapshot on ``dump()``."""

    def __init__(self, *, live: bool = False):
        self.live = live

    def emit(self, record: dict) -> None:
        if self.live and record.get("type") == "event":
            fields = record.get("fields") or {}
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[obs +{record.get('t', 0.0):9.3f}s] "
                  f"{record['name']} {kv}".rstrip(), flush=True)

    def dump(self, snapshot: Dict) -> None:
        print(format_table(snapshot), flush=True)


def format_table(snapshot: Dict) -> str:
    """Aligned text rollup of ``Tracker.snapshot()``."""
    lines: List[str] = []

    def section(title: str, rows: Iterable[List[str]], header: List[str]):
        rows = list(rows)
        if not rows:
            return
        widths = [max(len(h), *(len(r[i]) for r in rows))
                  for i, h in enumerate(header)]
        lines.append(title)
        lines.append("  " + "  ".join(h.ljust(w)
                                      for h, w in zip(header, widths)))
        for r in rows:
            lines.append("  " + "  ".join(c.ljust(w)
                                          for c, w in zip(r, widths)))

    section("counters",
            ([k, f"{v:g}"] for k, v in sorted(
                snapshot.get("counters", {}).items())),
            ["name", "total"])
    section("gauges",
            ([k, f"{v:g}"] for k, v in sorted(
                snapshot.get("gauges", {}).items())),
            ["name", "value"])
    section("histograms",
            ([k, str(int(s["count"])), f"{s['mean']:.3g}",
              f"{s['p50']:.3g}", f"{s['p90']:.3g}", f"{s['p99']:.3g}",
              f"{s['max']:.3g}"]
             for k, s in sorted(snapshot.get("hists", {}).items())),
            ["name", "n", "mean", "p50", "p90", "p99", "max"])
    # sink totals make silent overflow visible: a RingBufferSink that
    # wrapped shows dropped > 0 right in the rollup instead of silently
    # serving a truncated window
    section("sinks",
            ([s["sink"], str(s["records"]), str(s["dropped"])]
             for s in snapshot.get("sinks", [])),
            ["sink", "records", "dropped"])
    return "\n".join(lines) if lines else "(no metrics recorded)"
