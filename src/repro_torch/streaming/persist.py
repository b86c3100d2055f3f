"""Streaming-index persistence through the checkpoint manager (port of
``repro/streaming/persist.py``).

The snapshot format is the reference's, leaf for leaf (names, shapes,
dtypes: codes as uint32), so the two packages mount each other's
snapshots. The manifest supplies the restore template, so
:func:`load_index` needs nothing but the directory.

Layout (one ``step_*`` dir per snapshot)::

    store/  items norms codes range_id live
    delta/  items norms codes rid ids live perm ord count
    csr/    item_ids bucket_start bucket_rid bucket_code csr_bucket
            csr_codes csr_rid
    meta/   upper lower edges A + 0-d scalars (code_len, hash_bits, eps,
            capacity, max_tombstones, tomb_csr, family_id, fam_m, fam_U)
    calib/  planner calibration table, only when one is attached:
            probe_grid recall_range recall_global truth_mass range_counts
            + 0-d scalars (k, num_queries, stale)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.family import (HashFamily, SignALSHFamily,
                                     SimpleLSHFamily)
from repro_torch.streaming.index import MutableIndex, _host

# family registry for snapshots (manifest leaves are arrays, so the family
# rides as a small integer; absent in pre-family snapshots => simple)
FAMILY_IDS = {"simple": 0, "sign_alsh": 1}


def family_from_meta(meta) -> HashFamily:
    """The snapshot's hash family from its ``meta`` leaves: SIGN-ALSH
    (``family_id`` 1) with its ``fam_m`` and ``fam_U``, else SIMPLE-LSH."""
    fid = int(meta.get("family_id", 0))
    if fid == FAMILY_IDS["sign_alsh"]:
        return SignALSHFamily(m=int(meta["fam_m"]), U=float(meta["fam_U"]))
    if fid != FAMILY_IDS["simple"]:
        raise ValueError(f"unknown snapshot family_id {fid}; expected one "
                         f"of {sorted(FAMILY_IDS.values())}")
    return SimpleLSHFamily()


def index_tree(mindex: MutableIndex) -> Dict[str, Any]:
    """The index as a nested dict of host numpy arrays (0-d arrays for
    scalars), keyed as the reference's ``index_tree``."""
    d = mindex.delta
    tree = {
        "store": {
            "items": _host(mindex.items),
            "norms": mindex._norms,
            "codes": mindex._codes,
            "range_id": mindex._rid,
            "live": mindex._live,
        },
        "delta": {
            "items": _host(d.items),
            "norms": d._norms,
            "codes": d._codes,
            "rid": d._rid,
            "ids": d._ids,
            "live": d._live,
            "perm": d._perm,
            "ord": d._ord,
            "count": np.asarray(d.count, np.int32),
        },
        "csr": dict(mindex._csr._asdict()),
        "meta": {
            "upper": mindex.upper,
            "lower": mindex.lower,
            "edges": mindex.edges,
            "A": _host(mindex.A),
            "code_len": np.asarray(mindex.code_len, np.int32),
            "hash_bits": np.asarray(mindex.hash_bits, np.int32),
            "eps": np.asarray(mindex.eps, np.float32),
            "capacity": np.asarray(mindex.capacity, np.int32),
            "max_tombstones": np.asarray(mindex.max_tombstones, np.int32),
            "tomb_csr": np.asarray(mindex.tomb_csr, np.int32),
            "family_id": np.asarray(FAMILY_IDS[mindex.family.name],
                                    np.int32),
            "fam_m": np.asarray(getattr(mindex.family, "m", 0), np.int32),
            "fam_U": np.asarray(getattr(mindex.family, "U", 0.0),
                                np.float32),
        },
    }
    if mindex.calib is not None:
        cal = mindex.calib
        tree["calib"] = {
            "probe_grid": np.asarray(cal.probe_grid, np.int32),
            "recall_range": np.asarray(cal.recall_range, np.float32),
            "recall_global": np.asarray(cal.recall_global, np.float32),
            "truth_mass": np.asarray(cal.truth_mass, np.float32),
            "range_counts": np.asarray(cal.range_counts, np.int32),
            "k": np.asarray(cal.k, np.int32),
            "num_queries": np.asarray(cal.num_queries, np.int32),
            "stale": np.asarray(int(mindex.calib_stale), np.int32),
        }
    return tree


def save_index(manager: CheckpointManager, step: int,
               mindex: MutableIndex) -> str:
    """Snapshot the full mutable state as checkpoint ``step``."""
    return manager.save(step, index_tree(mindex))


def _template_from_manifest(manager: CheckpointManager, step: int
                            ) -> Dict[str, Any]:
    """The restore template (nested dict of zero-size-backed arrays of
    the snapshot's shapes and dtypes) from the manifest."""
    tree: Dict[str, Any] = {}
    for key, meta in manager.manifest(step)["leaves"].items():
        parts = [p[2:-2] for p in key.split("/")]
        if not all(p.startswith("['") and p.endswith("']")
                   for p in key.split("/")):
            raise ValueError(f"unparseable manifest key {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.broadcast_to(
            np.zeros((), np.dtype(meta["logical_dtype"])),
            tuple(meta["shape"]))
    return tree


def load_index(directory: str, step: Optional[int] = None, *,
               device=None, **kw) -> MutableIndex:
    """Mount an index from a checkpoint directory (crc-verified restore;
    no CSR rebuild) on ``device`` (the card unless ``device="cpu"``).
    ``kw`` passes runtime knobs (engine, impl, repartition_policy, skew
    thresholds) through to :class:`MutableIndex`."""
    from repro_torch.convert import mutable_index_from_tree

    manager = CheckpointManager(directory)
    if step is None:
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    tree = manager.restore(step, _template_from_manifest(manager, step))
    return mutable_index_from_tree(tree, device=device, **kw)
