"""Checkpoints of nested array trees with async write and restart support
(port of ``repro/checkpoint/manager.py``; numpy, no JAX).

Layout per step, the reference's, so either package mounts the other's
snapshots::

    <dir>/step_000042/
        arrays.npz          # flattened leaves, key = escaped tree path
        manifest.json       # step, leaf paths, shapes, dtypes, crc32s
    <dir>/LATEST            # text file holding the newest complete step

A tree is nested dicts (keys in sorted order), lists, tuples and
NamedTuples; a leaf is a numpy array, a torch tensor or a scalar. Leaf
keys are the reference's tree paths (:mod:`repro_torch.tree`):
``['store']/['items']`` for ``tree["store"]["items"]``, ``[0]`` for a
sequence position, and ``.name`` for a NamedTuple field, as
``jax.tree_util`` spells a ``GetAttrKey`` (``.opt/.mu/['embed']`` in a
``TrainState``).

  * writes go to a temp dir and are renamed into place — a crash mid-write
    never corrupts LATEST (restart reads the previous complete step);
  * ``save_async`` snapshots to host memory synchronously and writes the
    files on a thread; ``wait`` joins it and raises what the write raised;
  * ``restore`` gives each leaf the type of the template's leaf: a torch
    tensor on the template tensor's device, else a numpy array;
  * crc32 digests catch torn/corrupt files at restore time.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

Tree = Any

_NATIVE_DTYPES = {
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128",
}
_UINT_FOR_WIDTH = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# logical dtypes numpy cannot hold, stored as same-width uint views
_TORCH_ONLY = {"bfloat16": torch.bfloat16}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(storable numpy array, logical dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if arr.dtype.kind == "V" or arr.dtype.name not in _NATIVE_DTYPES:
        arr = arr.view(_UINT_FOR_WIDTH[arr.dtype.itemsize])
    return arr, logical


def _from_host(arr: np.ndarray, logical: str, tmpl):
    """A stored array as the template leaf's type and logical dtype."""
    if isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if logical in _TORCH_ONLY:
            t = t.view(_TORCH_ONLY[logical])
        return t.to(tmpl.device)
    if logical != str(arr.dtype):
        try:
            arr = arr.view(np.dtype(logical))
        except TypeError as e:
            raise ValueError(f"dtype {logical!r} needs a torch template "
                             f"leaf (numpy has no such dtype)") from e
    return arr


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Tree) -> str:
        return self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Tree) -> None:
        """Snapshot now (blocks on the device->host copy only), write
        later; ``wait`` reports a failed write."""
        self.wait()
        host = self._snapshot(tree)

        def write():
            try:
                self._write(step, host)
            except Exception as e:       # handed to wait(), which re-raises
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    @staticmethod
    def _snapshot(tree: Tree) -> Dict[str, Tuple[np.ndarray, str]]:
        return {k: _to_host(v) for k, v in flatten_with_paths(tree)}

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]]
               ) -> str:
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in host.items()})
        manifest = {
            "step": step,
            "leaves": {
                k: {"shape": list(a.shape), "dtype": str(a.dtype),
                    "logical_dtype": logical,
                    "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes())}
                for k, (a, logical) in host.items()
            },
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.directory, "LATEST.tmp"),
                   os.path.join(self.directory, "LATEST"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(path) as f:
            return int(f.read().strip())

    def manifest(self, step: int) -> dict:
        path = os.path.join(self.directory, f"step_{step:09d}",
                            "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: int, template: Tree) -> Tree:
        """Load ``step`` in the template's structure. Each leaf is checked
        against its crc32 (``IOError``) and the template leaf's shape
        (``ValueError``)."""
        path = os.path.join(self.directory, f"step_{step:09d}")
        manifest = self.manifest(step)
        values = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, tmpl in flatten_with_paths(template):
                arr = data[key]
                meta = manifest["leaves"][key]
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc32"]:
                    raise IOError(
                        f"checkpoint leaf {key!r} failed crc32 check")
                if list(arr.shape) != list(np.shape(tmpl)):
                    raise ValueError(f"leaf {key!r} shape {arr.shape} != "
                                     f"template {tuple(np.shape(tmpl))}")
                values[key] = _from_host(
                    arr, meta.get("logical_dtype", meta["dtype"]), tmpl)
        return unflatten(template, values)

    def restore_latest(self, template: Tree) -> Tuple[Optional[int], Tree]:
        step = self.latest_step()
        if step is None:
            return None, template
        return step, self.restore(step, template)
