"""Claim sheets of the hand-written CUDA kernels, read by kernelcheck
(port of ``repro/kernels/annotations.py``).

Each op of :mod:`repro_torch.kernels.ops` has a :class:`KernelAnnotation`
in :data:`ANNOTATIONS`: the kernel author's claims, which
:mod:`repro_torch.analysis.kernelcheck` holds against the launch plans
and the ``.cu`` sources.

* ``grid_names`` label the first stage's grid axes (x, y, z) in findings.
* ``revisit_dims`` are the first stage's grid axes along which several
  blocks feed the same rows of the op's result (a later stage of the
  same launch merges them: ``mips_topk.cu``'s item chunks,
  ``fused_query.cu``'s span blocks). Any other grid axis that does not
  index the result is a K3 finding.
* ``static_smem`` claims, for each CUDA ``__global__`` function the op
  launches, the most static shared memory (bytes) any of its template
  instances declares, and ``max_threads`` the most threads a block of it
  is launched with. Together with the dynamic shared memory of the plan
  they stand where the reference's VMEM estimator stood; on the card
  kernelcheck holds them against ``ptxas -v``'s report of each function.
* ``pad_contained`` claims no padded or out-of-range lane reaches the
  caller; a wrapper whose result may carry a filler value instead
  declares a :class:`SentinelSpec` (``spelling``: how the constant is
  written in the source, where ``repr`` of the value is not).

This module imports neither torch nor numpy, so that the AST lint can
load it without the runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SentinelSpec:
    """The filler one kernel's wrapper writes in lanes with no real
    value: ``kind`` names what carries it ("ids", "vals", "match" or
    "bits"), ``value`` the constant."""

    kind: str
    value: float
    note: str = ""
    spelling: str = ""


@dataclasses.dataclass(frozen=True)
class KernelAnnotation:
    """Machine-checkable claims for one CUDA op (see the module
    docstring)."""

    name: str
    grid_names: Tuple[str, ...]
    static_smem: Dict[str, int]
    max_threads: Dict[str, int]
    revisit_dims: Tuple[int, ...] = ()
    sentinel: Optional[SentinelSpec] = None
    pad_contained: bool = False
    note: str = ""

    def describe_dim(self, dim: int) -> str:
        if 0 <= dim < len(self.grid_names):
            return f"{dim} ({self.grid_names[dim]})"
        return str(dim)


def _pad16(nbytes: int) -> int:
    """Static shared memory rounded up to 16 bytes."""
    return -(-nbytes // 16) * 16


# hamming.cu's wide block stages its 64 query codes plus the next row's,
# and the halo of 7 item codes, for up to W = 8 words
_WIDE_SCAN_SMEM = 4 * (64 + 1 + 7) * 8

_PACKED_SCAN_SMEM = {"wide_scan_kernel": _WIDE_SCAN_SMEM,
                     "narrow_scan_kernel": 0}
_PACKED_SCAN_THREADS = {"wide_scan_kernel": 256, "narrow_scan_kernel": 128}

ANNOTATIONS: Dict[str, KernelAnnotation] = {
    "hash_encode": KernelAnnotation(
        name="hash_encode",
        grid_names=("row blocks", "word groups"),
        # the resident design holds A and the slabs in dynamic shared
        # memory; the tiled design's double-buffered tiles are static
        # (35,840 bytes for its widest layout, ops.hash_tile_smem)
        static_smem={"hash_encode_kernel": 0,
                     "hash_encode_tiled_kernel": 35840},
        max_threads={"hash_encode_kernel": 512,
                     "hash_encode_tiled_kernel": 256},
        sentinel=SentinelSpec(
            kind="bits", value=0,
            note="padding bits of the final packed word are 0: A's pad "
                 "columns are staged as zeros and bits >= L vote 0"),
        pad_contained=True),
    "hamming_scan": KernelAnnotation(
        name="hamming_scan", grid_names=("item tiles", "query blocks"),
        static_smem=_PACKED_SCAN_SMEM, max_threads=_PACKED_SCAN_THREADS,
        pad_contained=True,
        note="no padding: every load and store is bounds-guarded"),
    "bucket_match": KernelAnnotation(
        name="bucket_match", grid_names=("bucket tiles", "query blocks"),
        static_smem=_PACKED_SCAN_SMEM, max_threads=_PACKED_SCAN_THREADS,
        pad_contained=True,
        note="no padding: every load and store is bounds-guarded"),
    "delta_scan": KernelAnnotation(
        name="delta_scan", grid_names=("output quads",),
        static_smem=_PACKED_SCAN_SMEM, max_threads=_PACKED_SCAN_THREADS,
        sentinel=SentinelSpec(
            kind="match", value=-1,
            note="dead slots fuse to -1 so the streaming merge ranks them "
                 "last without a second masking pass")),
    "bucket_gather": KernelAnnotation(
        name="bucket_gather", grid_names=("slot spans", "queries"),
        # the library also holds the port's planned_runs kernel (ops.
        # planned_runs, no op of the registry): one 1,024-thread block a
        # row, its per-range sums in dynamic shared memory, statically the
        # warps' take sums and the take carry. A library that declares
        # dynamic shared memory has each kernel's static part padded to
        # 16 bytes (ptxas: 8,456 -> 8,464 and 132 -> 144)
        static_smem={"bucket_gather_kernel":
                     _pad16(4 * (2048 + 2048 // 32 + 2)),
                     "planned_runs_kernel": _pad16(4 * (32 + 1))},
        max_threads={"bucket_gather_kernel": 256,
                     "planned_runs_kernel": 1024},
        pad_contained=True,
        note="a block covers 2,048 slots of one query at a time and walks "
             "the queries past the grid's 65,535 rows"),
    "fused_query": KernelAnnotation(
        name="fused_query", grid_names=("spans", "queries"),
        revisit_dims=(0,),
        static_smem={"fq_span_kernel": 4 * (256 + 8 + 4),
                     "fq_merge_kernel": 0},
        max_threads={"fq_span_kernel": 256, "fq_merge_kernel": 256},
        sentinel=SentinelSpec(
            kind="vals", value=-3e38,
            note="survivor slots past a query's take total carry NEG at "
                 "position -1; the merge ranks them behind every real "
                 "candidate"),
        note="span blocks of one query write their own survivor lists; "
             "the merge kernel reduces them into the query's row"),
    "mips_topk": KernelAnnotation(
        name="mips_topk", grid_names=("item chunks", "query tiles"),
        revisit_dims=(0,),
        static_smem={"mips_partial_kernel": 0, "mips_merge_kernel": 80},
        max_threads={"mips_partial_kernel": 128, "mips_merge_kernel": 256},
        sentinel=SentinelSpec(
            kind="vals", value=float("-inf"), spelling="-INFINITY",
            note="a chunk's unfilled list entries carry -inf at id -1; "
                 "k <= N keeps them out of the merged result"),
        pad_contained=True,
        note="chunk blocks write their own partial lists; the merge "
             "kernel reduces them into the query's row"),
    # the port's own op (ops.latent_attend, no op of the registry): all of
    # its shared memory is dynamic (~190-200 KB a block, latent_attn.cu)
    "latent_attend": KernelAnnotation(
        name="latent_attend", grid_names=("splits", "sequences"),
        revisit_dims=(0,),
        static_smem={"latent_attn_kernel": 0, "latent_merge_kernel": 0},
        max_threads={"latent_attn_kernel": 256, "latent_merge_kernel": 128},
        pad_contained=True,
        note="slots past the live position are zero-filled in shared "
             "memory and scored -inf; the split blocks of one sequence "
             "write their own (o, max, sum), merged by the second kernel"),
}
