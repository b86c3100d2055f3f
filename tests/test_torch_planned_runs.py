"""``ops.planned_runs``, the per-range take as one op: its plain version
against the reference's ``_planned_runs`` (the JAX package's per-range
loop) and against the take computed another way (a stable sort of each
row by range, one cumsum, a scatter back), and the wrapper's input
checks. The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_directory
from repro.core import engine as jengine
from repro_torch.core.engine import _planned_runs
from repro_torch.kernels import ops


def _take_by_sort(order, start, rid, caps):
    """(cum, starts) with each row's same-range sizes summed after a
    stable sort by range."""
    sz = np.diff(start).astype(np.int64)[order]
    r = rid[order]
    crb = np.empty_like(sz)
    for i in range(order.shape[0]):
        o = np.argsort(r[i], kind="stable")
        before = np.cumsum(sz[i, o]) - sz[i, o]
        first = np.r_[True, r[i, o][1:] != r[i, o][:-1]]
        crb[i, o] = before - np.maximum.accumulate(np.where(first, before, 0))
    take = np.minimum(np.maximum(caps[r].astype(np.int64) - crb, 0), sz)
    cum = np.concatenate([np.zeros((order.shape[0], 1), np.int64),
                          np.cumsum(take, axis=1)], axis=1)
    return cum, start[:-1][order]


# (Q, B, R, caps, probe-like order); the reference's loop compiles each
# op per shape under JAX, so the cases marked JAX (a second) check it too
CASES = {
    "r1": (3, 50, 1, "half", False),
    "r3_zero_budget": (4, 257, 3, "zero", False),
    "r32": (5, 4097, 32, "half", False),
    "r32_probe_order": (3, 4095, 32, "half", True),
    "r64_above_counts": (2, 1000, 64, "above", False),
    "r64_at_counts": (2, 1031, 64, "count", True),
    "one_bucket": (3, 1, 1, "half", False),
    "one_bucket_zero": (2, 1, 1, "zero", False),
}
JAX = ("r3_zero_budget", "r32_probe_order")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_planned_runs_equal_reference_and_a_sort(case):
    q, b, r, caps_mode, probe_like = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    order, start, rid, caps = make_directory(rng, q, b, r, caps_mode,
                                             probe_like)
    cum, starts = ops.planned_runs(torch.as_tensor(order),
                                   torch.as_tensor(start),
                                   torch.as_tensor(rid),
                                   torch.as_tensor(caps), impl="ref")
    assert cum.dtype == starts.dtype == torch.int32
    assert cum.shape == (q, b + 1) and starts.shape == (q, b)
    want_cum, want_starts = _take_by_sort(order, start, rid, caps)
    np.testing.assert_array_equal(cum.numpy(), want_cum)
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    if case in JAX:
        jb = SimpleNamespace(bucket_start=jnp.asarray(start),
                             bucket_rid=jnp.asarray(rid))
        jcum, jstarts = jengine._planned_runs(jb, jnp.asarray(order),
                                              tuple(int(c) for c in caps))
        np.testing.assert_array_equal(cum.numpy(), np.asarray(jcum))
        np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    # the engine's step is this op, its caps made from the budgets
    bk = SimpleNamespace(bucket_start=torch.as_tensor(start),
                         bucket_rid=torch.as_tensor(rid))
    ecum, estarts = _planned_runs(bk, torch.as_tensor(order),
                                  [int(c) for c in caps])
    assert torch.equal(ecum, cum) and torch.equal(estarts, starts)


def _args(q=2, b=5, r=3):
    return (torch.zeros((q, b), dtype=torch.int64),
            torch.arange(b + 1, dtype=torch.int32),
            torch.zeros((b,), dtype=torch.int32),
            torch.ones((r,), dtype=torch.int32))


def _with(i, value):
    args = list(_args())
    args[i] = value
    return args


BAD = {
    "order_int32": (_with(0, torch.zeros((2, 5), dtype=torch.int32)),
                    "order must be torch.int64"),
    "bucket_start_int64": (_with(1, torch.arange(6)),
                           "bucket_start must be torch.int32"),
    "bucket_rid_float": (_with(2, torch.zeros(5)),
                         "bucket_rid must be torch.int32"),
    "caps_int64": (_with(3, torch.ones(3, dtype=torch.int64)),
                   "caps must be torch.int32"),
    "bucket_start_short": (_with(1, torch.arange(5, dtype=torch.int32)),
                           "must be"),
    "bucket_rid_long": (_with(2, torch.zeros(6, dtype=torch.int32)),
                        "must be"),
    "order_1d": (_with(0, torch.zeros(5, dtype=torch.int64)), "must be"),
    "caps_2d": (_with(3, torch.ones((3, 1), dtype=torch.int32)), "must be"),
    "no_ranges": (_with(3, torch.ones(0, dtype=torch.int32)), "zero-size"),
    "no_queries": (list(_args(q=0)), "zero-size"),
    "no_buckets": ([torch.zeros((2, 0), dtype=torch.int64),
                    torch.zeros(1, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32),
                    torch.ones(3, dtype=torch.int32)], "zero-size"),
}


@pytest.mark.parametrize("impl", ["auto", "ref", "cuda"])
@pytest.mark.parametrize("case", list(BAD))
def test_planned_runs_rejects_bad_inputs_before_any_dispatch(case, impl):
    args, match = BAD[case]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        ops.planned_runs(*args, impl=impl)
    assert not any(ops.launch_counts.values())


def test_planned_runs_impl_cuda_on_cpu_tensors_raises():
    with pytest.raises(ValueError, match="impl='cuda' needs"):
        ops.planned_runs(*_args(), impl="cuda")


def test_kernelcheck_passes_over_the_port_kernels_launch_shapes():
    """A path's launch shapes hold planned_runs's, which no registry op
    owns: kernelcheck takes them and checks the registry's ops alone."""
    from repro_torch.analysis import kernelcheck
    assert ops.launch_shape_class("planned_runs", (64, 136736, 32)) == (
        "planned_runs", {"q": 64, "b": 136736, "r": 32})
    findings, report = kernelcheck.run_kernelcheck(
        device="cpu", probes=False,
        launched=[("planned_runs", (64, 136736, 32)),
                  ("bucket_gather", (64, 136736, 30641))])
    assert findings == [] and report["launch_shapes"] == 1
