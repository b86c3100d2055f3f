"""The device trace of a traced run: ``torch.profiler`` over a steady
stretch of served batches, reduced to what the per-layer readers and the
result line need.

The profiler drops the first few kernels of a window, so one batch runs
as a discarded warm-up step before the active step. The active step's
``ProfilerStep#`` range is the traced window; device events are kernels,
copies and fills, on the same clock.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

GAP_LABELS = 500      # longest idle gaps named by the host's activity
TOP = 10
NAME_CHARS = 120


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device_s: Dict[str, float]            # device seconds by event name
    idle_by_host: List[Tuple[str, float]]  # idle seconds by host activity


def profile_batches(run_batch: Callable[[], None], seconds: float):
    """Run ``run_batch`` (one served batch, ending in a synchronise) once
    as the profiler's warm-up step, then for ``seconds`` as its active
    step. Returns the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run_batch()
        prof.step()
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            run_batch()
            n += 1
        prof.step()
    return prof


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of (start, end) rows as disjoint sorted rows."""
    if intervals.shape[0] == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(iv.shape[0], bool)
    new[1:] = iv[1:, 0] > run_end[:-1]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, iv.shape[0] - 1]
    return np.stack([starts, run_end[last]], axis=1)


def _is_annotation(e) -> bool:
    """A range a ``record_function`` marks on the device's timeline (the
    profiler's ``ProfilerStep#`` among them), which is no device work."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith("ProfilerStep#")


def _host_label(mid: int, cpu_iv: np.ndarray, names: List[str],
                by_end: np.ndarray, by_start: np.ndarray) -> str:
    """What the host was doing at ``mid``: the innermost host event that
    holds it, else the host events on either side of it."""
    inside = np.flatnonzero((cpu_iv[:, 0] <= mid) & (cpu_iv[:, 1] >= mid))
    if inside.size:
        return names[inside[np.argmin(cpu_iv[inside, 1] - cpu_iv[inside, 0])]]
    i = np.searchsorted(cpu_iv[by_end, 1], mid) - 1
    j = np.searchsorted(cpu_iv[by_start, 0], mid)
    before = names[by_end[i]] if i >= 0 else "start"
    after = names[by_start[j]] if j < by_start.size else "end"
    return f"host between {before} and {after}"


def read(prof) -> Trace:
    """Busy time, device time by name and idle time by host activity in
    the active step of ``prof``."""
    from torch.autograd import DeviceType

    dev, cpu, cpu_names = [], [], []
    window = None
    device_s: Dict[str, float] = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e):
                dev.append((start, end))
                device_s[name] += (end - start) * 1e-9
        elif name.startswith("ProfilerStep#"):
            if window is None or end - start > window[1] - window[0]:
                window = (start, end)
        else:
            cpu.append((start, end))
            cpu_names.append(name)
    if window is None or not dev:
        raise RuntimeError("the profiler recorded no traced step or no "
                           "device event")
    w0, w1 = window
    busy = np.clip(_merge(np.asarray(dev, np.int64)), w0, w1)
    busy_ns = int(np.sum(busy[:, 1] - busy[:, 0]))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:GAP_LABELS]
    cpu_iv = np.asarray(cpu, np.int64).reshape(-1, 2)
    by_end = np.argsort(cpu_iv[:, 1])
    by_start = np.argsort(cpu_iv[:, 0])
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        label = _host_label((g0 + g1) // 2, cpu_iv, cpu_names, by_end,
                            by_start)
        idle[label[:NAME_CHARS]] += (g1 - g0) * 1e-9
    return Trace((w1 - w0) * 1e-9, busy_ns * 1e-9, dict(device_s),
                 sorted(idle.items(), key=lambda kv: -kv[1]))


def breakdown(trace: Trace) -> dict:
    ops = sorted(trace.device_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace.idle_by_host[:TOP]]}
