"""Runtime fault tolerance: failure detection, stragglers, elastic
re-mesh (port of ``repro/launch/runtime.py``).

The policies are pure Python, tested against an injected clock:

  * ``HeartbeatTracker`` — per-worker last-seen timestamps; a worker has
    failed after ``timeout_s``. A training loop polls ``failed()`` each
    step and raises ``WorkerFailure`` to trigger recovery.
  * ``StragglerMonitor`` — per-step deadline tracking; a step exceeding
    ``deadline_s`` is recorded and, past ``max_consecutive`` in a row,
    escalated as a ``StragglerEvent``.
  * ``elastic_recover`` — the recovery policy: rebuild a mesh from the
    surviving whole slices (``launch/mesh.make_elastic_mesh``, over the
    default process group the survivors re-initialised) and restore the
    latest complete checkpoint into a state template; the caller places
    it on the new mesh (``train.shard_state``: shardings follow logical
    rules, not device ids). The data pipeline is counter-based
    (``data/tokens.py``), so the resumed stream is exact.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    def __init__(self, workers: List[str]):
        super().__init__(f"workers failed: {workers}")
        self.workers = workers


class HeartbeatTracker:
    """Last-seen tracking with an injectable clock (tests simulate
    time)."""

    def __init__(self, workers: List[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {w: now for w in workers}

    def beat(self, worker: str) -> None:
        self.last_seen[worker] = self.clock()

    def failed(self) -> List[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def check(self) -> None:
        bad = self.failed()
        if bad:
            raise WorkerFailure(bad)


class StragglerEvent(RuntimeError):
    def __init__(self, step: int, elapsed: float):
        super().__init__(f"step {step} exceeded deadline ({elapsed:.2f}s)")
        self.step = step
        self.elapsed = elapsed


class StragglerMonitor:
    """Per-step deadline accounting. ``deadline_s=None`` disables."""

    def __init__(self, deadline_s: Optional[float] = None,
                 max_consecutive: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self.max_consecutive = max_consecutive
        self.clock = clock
        self.slow_steps: List[int] = []
        self._consecutive = 0

    @contextlib.contextmanager
    def step(self, step_no: int):
        t0 = self.clock()
        yield
        elapsed = self.clock() - t0
        if self.deadline_s is not None and elapsed > self.deadline_s:
            self.slow_steps.append(step_no)
            self._consecutive += 1
            if self._consecutive >= self.max_consecutive:
                self._consecutive = 0
                raise StragglerEvent(step_no, elapsed)
        else:
            self._consecutive = 0


def elastic_recover(ckpt_manager, state_template, *, surviving_slices: int,
                    slice_shape=(16, 16), device_type: str = "cuda"):
    """Rebuild the mesh from surviving slices and restore the latest
    checkpoint. Returns (mesh', step, state'), state' restored into
    ``state_template``'s structure, dtypes and devices."""
    from repro_torch.launch.mesh import make_elastic_mesh

    mesh = make_elastic_mesh(surviving_slices, slice_shape,
                             device_type=device_type)
    step = ckpt_manager.latest_step()
    if step is None:
        raise RuntimeError("no checkpoint to recover from")
    return mesh, step, ckpt_manager.restore(step, state_template)
