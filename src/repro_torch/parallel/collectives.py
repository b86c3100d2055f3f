"""Collective traffic of a step: every collective with its bytes, group
size and per-device wire bytes (the counterpart of
``repro/parallel/hlo_analysis.py``'s ``parse_collectives``,
``_wire_bytes`` and ``summarize_collectives``).

The reference parses XLA's optimized HLO. The port has two sources:

  * :class:`CollectiveRecorder`, a dispatch mode that sees every
    collective a step issues in this process: DTensor's functional
    collectives (``_c10d_functional.*``) and ``torch.distributed``'s own
    (``c10d.*``, the shard groups' reductions and gathers), with their
    local input and output bytes. Under the dry run's fake process group
    these are the collectives one device of a 256- or 512-device mesh
    would issue;
  * :func:`from_profiler`, the ``nccl:*`` (on the CPU ``gloo:*``) events
    of a ``torch.profiler`` run with ``record_shapes=True``, for a run on
    the card.

Per-device wire bytes use the reference's ring-algorithm factors:

    all-gather:          (g-1)/g * out_bytes     (received)
    reduce-scatter:      (g-1)/g * in_bytes
    all-reduce:          2 (g-1)/g * in_bytes    (RS + AG)
    all-to-all:          (g-1)/g * in_bytes
    collective-permute:  out_bytes

DTensor and XLA's SPMD partitioner place collectives differently, so the
counts are not the reference's.

A loop body traced once for many trips (``models/common.scan`` on
``meta`` tensors, as the reference's ``lax.scan`` lowers one while body)
runs inside :func:`repeat`, and its autograd nodes are marked by
:func:`repeat_backward`: each collective the body or its backward issues
is noted with the trip count as its ``multiplier`` (nested loops
multiply, as ``hlo_analysis._multipliers`` multiplies nested whiles), and
its wire bytes are the multiplied ones, as the reference's are. Counts
are the sum of the multipliers: an eager loop's collectives, one entry a
trip, and the traced body's add up alike.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the trip counts of the enclosing trace-once loop bodies, outermost first
_TRIPS: List[int] = []


def wire_bytes(op: str, in_bytes: int, out_bytes: int, g: int) -> float:
    """Per-device ring wire bytes of one collective over ``g`` members."""
    g = max(g, 1)
    f = (g - 1) / g
    if op == "all-gather":
        return f * out_bytes
    if op == "reduce-scatter":
        return f * in_bytes
    if op == "all-reduce":
        return 2.0 * f * in_bytes
    if op == "all-to-all":
        return f * in_bytes
    if op == "collective-permute":
        return float(out_bytes)
    return float(out_bytes)


def record(op: str, in_bytes: int, out_bytes: int, g: int,
           multiplier: int = 1) -> Dict[str, float]:
    """One collective's entry, the reference's keys: issued
    ``multiplier`` times (a trace-once loop body's trip count; 1 for a
    collective an eager run issues once), its wire bytes multiplied."""
    return {"op": op, "out_bytes": out_bytes, "in_bytes": in_bytes,
            "group": g, "multiplier": multiplier,
            "wire_bytes": wire_bytes(op, in_bytes or out_bytes, out_bytes,
                                     g) * multiplier}


def summarize_collectives(colls: List[Dict]) -> Dict[str, float]:
    """Wire bytes by op, their total and the count of collectives (each
    entry counted its multiplier's times)."""
    by_op: Dict[str, float] = {}
    for c in colls:
        by_op[c["op"]] = by_op.get(c["op"], 0.0) + c["wire_bytes"]
    total = sum(by_op.values())
    by_op["total_wire_bytes"] = total
    by_op["count"] = float(sum(c.get("multiplier", 1) for c in colls))
    return by_op


def counts_by_op(colls: List[Dict]) -> Dict[str, int]:
    """The number of collectives of each op (each entry counted its
    multiplier's times)."""
    out: Dict[str, int] = {}
    for c in colls:
        out[c["op"]] = out.get(c["op"], 0) + int(c.get("multiplier", 1))
    return out


def trips() -> int:
    """The product of the enclosing :func:`repeat` contexts' trip counts
    (1 outside any)."""
    n = 1
    for k in _TRIPS:
        n *= k
    return n


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """While active, every collective is noted ``n`` times (a loop body
    traced once for ``n`` trips); nested contexts multiply."""
    _TRIPS.append(int(n))
    try:
        yield
    finally:
        _TRIPS.pop()


def autograd_mark() -> int:
    """The sequence number the next autograd node of this thread will
    take: nodes are numbered in creation order, so those a body creates
    lie between the marks taken before and after it."""
    with torch.enable_grad():
        probe = torch.empty(0, requires_grad=True).view(0)
    return probe.grad_fn._sequence_nr() + 1


#: an autograd node's ``metadata`` key holding its trip count
TRIPS_KEY = "repro.collectives.trips"


def repeat_backward(n: int, roots, since: int, until: int) -> int:
    """Marks the backward of a loop body traced once for ``n`` trips:
    every autograd node that ``roots`` (the body's output tensors) reach
    and whose sequence number lies in ``[since, until)``
    (:func:`autograd_mark` before and after the body) gets ``n`` in its
    ``metadata`` (multiplied into a mark already there: nested bodies).
    While a marked node runs (its function and the accumulation of its
    outputs into the gradients of the nodes before it), the recorder notes
    each collective ``n`` times. Nodes of the graph before the body (its
    inputs' and the leaves') are left alone. Returns the number of nodes
    marked."""
    stack = [t.grad_fn for t in roots
             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        if not since <= node._sequence_nr() < until:
            continue
        seen.add(id(node))
        node.metadata[TRIPS_KEY] = node.metadata.get(TRIPS_KEY, 1) * int(n)
        stack.extend(f for f, _ in node.next_functions)
    return len(seen)


def _backward_trips() -> int:
    """The trip count marked on the autograd node running now (1 outside
    a backward or on an unmarked node)."""
    node = torch._C._current_autograd_node()
    return 1 if node is None else node.metadata.get(TRIPS_KEY, 1)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _pg_size(pg) -> int:
    """The size of a dispatched ``c10d`` op's process group argument (a
    TorchScript object wrapping the group)."""
    from torch.distributed import ProcessGroup
    if not isinstance(pg, ProcessGroup):
        pg = ProcessGroup.unbox(pg)
    return pg.size()


# _c10d_functional op -> (reference op, its group argument's position)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "all_reduce": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
}
# c10d op -> (reference op, its process group argument's position)
_C10D = {
    "allreduce_": ("all-reduce", 1),
    "allreduce_coalesced_": ("all-reduce", 1),
    "allgather_": ("all-gather", 2),
    "_allgather_base_": ("all-gather", 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 2),
    "reduce_scatter_": ("reduce-scatter", 2),
    "_reduce_scatter_base_": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 2),
    "alltoall_": ("all-to-all", 2),
    "alltoall_base_": ("all-to-all", 2),
    "send": ("collective-permute", 1),
}


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched while active in
    :attr:`collectives` (the reference's entry keys), with the trip count
    of the trace-once loop bodies it was issued in as its multiplier."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Dict[str, float]] = []

    def _note(self, func, args, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            op, at = _FUNCTIONAL[name]
            g = _group_size(args[at])
            in_b = _nbytes(args[0])
        elif ns == "c10d" and name in _C10D:
            op, at = _C10D[name]
            g = _pg_size(args[at])
            # the input is the last tensor argument before the group
            in_b = _nbytes(args[at - 1] if at > 1 else args[0])
        else:
            return
        out_b = _nbytes(out if ns == "_c10d_functional" else args[0])
        if op == "all-gather" and ns == "_c10d_functional":
            out_b = in_b * g
        self.collectives.append(record(op, in_b, out_b, g,
                                       trips() * _backward_trips()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            # let DTensor desugar the op into local ops and collectives,
            # which then come through here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._note(func, args, out)
        return out


_PROFILER_OPS = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather": "all-gather", "_all_gather_base": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all": "all-to-all", "alltoall_base": "all-to-all",
    "send": "collective-permute",
}
_ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "int": 4,
             "long int": 8, "double": 8, "bool": 1, "signed char": 1,
             "unsigned char": 1}


def from_profiler(events, group_size: int,
                  backends=("nccl", "gloo")) -> List[Dict[str, float]]:
    """The collectives among ``events`` (a ``torch.profiler`` run's
    ``prof.events()``, recorded with ``record_shapes=True``): the
    process group's own ``nccl:<op>`` (``gloo:<op>``) events, their bytes
    from the input shapes and dtypes, over a group of ``group_size``."""
    out = []
    for e in events:
        back, _, name = e.name.partition(":")
        if back not in backends or name not in _PROFILER_OPS:
            continue
        op = _PROFILER_OPS[name]
        shapes = [s for s in (e.input_shapes or []) if s]
        dtypes = list(getattr(e, "input_dtypes", None) or [])
        in_b = 0
        for i, s in enumerate(shapes):
            n = 1
            for d in s:
                n *= int(d)
            in_b += n * _ITEMSIZE.get(dtypes[i] if i < len(dtypes) else "",
                                      4)
        out_b = (in_b * group_size if op == "all-gather" else
                 in_b // max(group_size, 1) if op == "reduce-scatter"
                 else in_b)
        out.append(record(op, in_b, out_b, group_size))
    return out


class RecordingShardGroup:
    """A shard group (``core/distributed.py``) that records each gather
    and reduction as the collective one member would issue: an
    all-gather of one member's tensor, an all-reduce of it. Everything
    else is the wrapped group's."""

    def __init__(self, group):
        self.group = group
        self.collectives: List[Dict[str, float]] = []

    def __getattr__(self, name):
        return getattr(self.group, name)

    def all_gather(self, local):
        out = self.group.all_gather(local)
        g = self.group.size
        one = _nbytes(local[0])
        self.collectives.append(record("all-gather", one, one * g, g))
        return out

    def all_reduce(self, local, op: str = "sum"):
        out = self.group.all_reduce(local, op)
        g = self.group.size
        one = _nbytes(local[0])
        self.collectives.append(record("all-reduce", one, one, g))
        return out
