"""Streaming index service: mutable norm-range indexes (port of
``repro/streaming``).

Layers insert/delete/compact/repartition on top of the immutable RANGE-LSH
structures while keeping queries identical to a from-scratch rebuild:

  * :class:`~repro_torch.streaming.delta.DeltaBuffer` — fixed-capacity
    append log of recent inserts with tombstones.
  * :class:`~repro_torch.streaming.index.MutableIndex` — the service core:
    storage + CSR base + delta + drift-triggered localized repartition.
  * :class:`~repro_torch.streaming.drift.DriftMonitor` — per-range
    occupancy and norm-tail tracking; overflow/skew triggers.
  * :mod:`~repro_torch.streaming.persist` — mount/save in the checkpoint
    manager's format, shared with the JAX package.
"""

from repro_torch.streaming.delta import DeltaBuffer
from repro_torch.streaming.drift import DriftMonitor
from repro_torch.streaming.index import MutableIndex, build, partition_edges
from repro_torch.streaming.persist import index_tree, load_index, save_index

__all__ = [
    "DeltaBuffer", "DriftMonitor", "MutableIndex", "build",
    "partition_edges", "index_tree", "load_index", "save_index",
]
