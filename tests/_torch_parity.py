"""Shared comparisons of the PyTorch port against the JAX reference.

Inputs are numpy arrays made from a seed; each side gets its own copy.
Packed codes cross as the int32 view of the reference's uint32 words.
"""

from __future__ import annotations

import ast
import contextlib
from pathlib import Path

import numpy as np
import torch

# f32 dots of up to a few hundred terms, summed in another order by XLA
# and by torch: a few ulps of the largest partial sum
ATOL, RTOL = 1e-4, 1e-5

# a code bit may differ only where the reference projection is this close
# to zero relative to the projected row's norm (summation-order noise)
FLIP_REL = 1e-5


def u32_to_i32(codes) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(codes, np.uint32)).view(np.int32)


def t(a, dtype=None) -> torch.Tensor:
    """A CPU tensor holding a copy of numpy/JAX array ``a``."""
    return torch.as_tensor(np.array(np.asarray(a), dtype=dtype))


def assert_codes_match(port_codes, ref_codes, proj, row_norm) -> int:
    """Packed codes equal bit for bit, except bits whose reference
    projection lies within FLIP_REL * ||row|| of zero. Returns the number
    of such flipped bits."""
    got = np.asarray(port_codes).view(np.uint32)
    want = np.asarray(ref_codes, np.uint32)
    assert got.shape == want.shape
    L = proj.shape[1]
    shifts = np.arange(32, dtype=np.uint32)
    diff = ((got ^ want)[..., None] >> shifts) & 1
    diff = diff.reshape(got.shape[0], -1)[:, :L].astype(bool)
    near = np.abs(proj) < FLIP_REL * np.asarray(row_norm)[:, None]
    assert not (diff & ~near).any(), (
        f"{int((diff & ~near).sum())} code bits differ away from zero")
    return int(diff.sum())


def assert_topk_tie_aware(ids, vals, ref_ids, ref_vals, *, atol=ATOL,
                          rtol=RTOL) -> None:
    """Top-k results agree: values within tolerance slot by slot, and an
    id may differ from the reference's only where the reference holds the
    same id at a value within tolerance (a reordered tie) or the id's
    value ties the reference's last value (a swap at the cut)."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    vals, ref_vals = np.asarray(vals), np.asarray(ref_vals)
    assert ids.shape == ref_ids.shape
    np.testing.assert_allclose(vals, ref_vals, atol=atol, rtol=rtol)
    for r, c in zip(*np.nonzero(ids != ref_ids)):
        tol = atol + rtol * abs(ref_vals[r, c])
        at = np.flatnonzero(ref_ids[r] == ids[r, c])
        if at.size:
            assert abs(ref_vals[r, at[0]] - vals[r, c]) <= tol, (r, c)
        else:
            assert abs(vals[r, c] - ref_vals[r, -1]) <= tol, (r, c)


def make_runs(rng, q, s, n):
    """Random probe-ordered CSR runs: (cum (q, s+1), starts (q, s)) int32
    with starts inside [0, n), and ``total``, the smallest per-query take,
    so every slot below it is a real candidate."""
    sizes = rng.integers(0, 9, size=(q, s)).astype(np.int32)
    starts = rng.integers(0, n - 8, size=(q, s)).astype(np.int32)
    cum = np.concatenate([np.zeros((q, 1), np.int32),
                          np.cumsum(sizes, 1, dtype=np.int32)], 1)
    return cum, starts, int(cum[:, -1].min())


def imports_of(path: Path) -> set:
    """Top-level module names a Python file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def make_directory(rng, q, b, r, caps_mode, probe_like=False):
    """A seeded directory of ``b`` buckets over ``r`` ranges (bucket
    sizes 1-6, ranges ascending as in the CSR store), ``q`` probe orders
    and per-range caps: "half" of each range's count, "zero" for range 0
    and half elsewhere, "above" the counts, "count" exactly them."""
    sizes = rng.integers(1, 7, size=b)
    start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    rid = np.sort(rng.integers(0, r, size=b)).astype(np.int32)
    if probe_like:          # rank by (range, level) groups, as a probe does
        level = rng.integers(0, 8, size=(q, b))
        key = rng.permutation(r * 8)[rid[None, :] * 8 + level]
        order = np.argsort(key, axis=1, kind="stable")
    else:
        order = np.stack([rng.permutation(b) for _ in range(q)])
    count = np.bincount(rid, weights=sizes, minlength=r).astype(np.int64)
    caps = {"half": count // 2, "zero": np.r_[0, count[1:] // 2],
            "above": count + 3, "count": count}[caps_mode]
    return order.astype(np.int64), start, rid, caps.astype(np.int32)


def mismatched_shape_calls(device):
    """Calls of the wrappers whose arguments' shapes disagree (the cases
    the CUDA kernels would read out of bounds on): name -> fn(impl)."""
    from repro_torch.kernels import ops

    def f(*shape):
        return torch.ones(shape, device=device)

    def i(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    cum = torch.tensor([[0, 2, 4]] * 2, dtype=torch.int32, device=device)
    return {
        "hash_encode_A_rows": lambda impl: ops.hash_encode(
            f(6, 8), f(12, 32), impl=impl),
        "hash_encode_tail": lambda impl: ops.hash_encode(
            f(6, 8), f(8, 32), f(5), f(32), impl=impl),
        "hash_encode_a_tail": lambda impl: ops.hash_encode(
            f(6, 8), f(8, 32), f(6), f(31), impl=impl),
        "fused_query_items_d": lambda impl: ops.fused_query(
            f(2, 4), cum, i(2, 2), f(8, 5), 4, 2, impl=impl),
        "fused_query_cum_rows": lambda impl: ops.fused_query(
            f(2, 4), torch.cat([cum, cum[:1]]), i(2, 2), f(8, 4), 4, 2,
            impl=impl),
        "fused_query_starts": lambda impl: ops.fused_query(
            f(2, 4), cum, i(3, 2), f(8, 4), 4, 2, impl=impl),
        "planned_runs_bucket_start": lambda impl: ops.planned_runs(
            i(2, 5).long(), i(5), i(5), i(3), impl=impl),
        "planned_runs_bucket_rid": lambda impl: ops.planned_runs(
            i(2, 5).long(), i(6), i(4), i(3), impl=impl),
    }


MISMATCHED = ("hash_encode_A_rows", "hash_encode_tail", "hash_encode_a_tail",
              "fused_query_items_d", "fused_query_cum_rows",
              "fused_query_starts", "planned_runs_bucket_start",
              "planned_runs_bucket_rid")


def reference_dryrun():
    """``repro.launch.dryrun``, imported without keeping the 512 host
    devices its first lines ask XLA for (this process's jax keeps its one
    CPU device: the flag is read when the backend starts, after this)."""
    import os
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


@contextlib.contextmanager
def gloo_world_of_one(where):
    """A default gloo process group of one rank over a file rendezvous in
    the directory ``where`` (no network), destroyed on exit: a 1 x 1 CPU
    mesh's world."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("gloo", init_method=f"file://{where}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_script(code: str, timeout: float):
    """Runs ``code`` in a fresh Python with this process's import path;
    returns the JSON its last stdout line prints (fails the test on a
    non-zero exit, with the output)."""
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
