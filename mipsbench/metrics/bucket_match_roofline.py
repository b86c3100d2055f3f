"""bucket_match_roofline: the directory match kernel's share of its
roofline, in percent.

The served path matches the query codes against the bucket directory
with ``hamming.cu``'s packed scan (``ops.hamming_scan`` on the bucket
codes for a spec-built index, ``ops.bucket_match`` for a legacy one).
Least time of one launch of shape (Q, B, W): its bytes, each once, at the
card's memory bandwidth: the (B, W) directory codes and (Q, W) query
codes read and the (Q, B) int32 counts written; a popcount per word is
no bound. The launches are the program's counters of the profiled
batches; the time is the device time of the scan kernels in the trace
of the same batches.
"""

OPS = ("hamming_scan", "bucket_match")
KERNELS = ("wide_scan_kernel", "narrow_scan_kernel")


def work(q, b, w):
    """Least bytes of one launch."""
    return {"bytes": 4.0 * (b * w + q * b + q * w)}


def least_seconds(q, b, w, peaks):
    return work(q, b, w)["bytes"] / peaks["hbm_byte_per_s"]


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    least = sum(n * least_seconds(shape[0], shape[1], shape[2], r.peaks)
                for (op, shape), n in r.launch_shapes.items() if op in OPS)
    device = sum(s for name, s in r.trace.device_s.items()
                 if any(k in name for k in KERNELS))
    return 100.0 * least / device if least > 0 and device > 0 else None
