"""fused_query_roofline: the fused query kernel's share of its roofline,
in percent.

Least time of one launch of shape (Q, S, d, P, k'): the larger of its
operations, 2 Q P d (each query scored against its P planned rows), at
the card's float32 rate, and its bytes, each input byte once, at the
card's memory bandwidth: the (Q, d) query block, P rows of d floats (at
least P distinct rows feed a query) and the (Q, k') survivor values and
positions written. The launches are the program's counters of the
profiled batches; the time is the device time of the launch's two
kernels in the trace of the same batches.
"""

OP = "fused_query"
KERNELS = ("fq_span_kernel", "fq_merge_kernel")


def work(q, p, d, kprime):
    """Least operations and bytes of one launch."""
    return {"flops": 2.0 * q * p * d,
            "bytes": 4.0 * (q * d + p * d) + 8.0 * q * kprime}


def least_seconds(q, p, d, kprime, peaks):
    w = work(q, p, d, kprime)
    return max(w["flops"] / peaks["f32_flop_per_s"],
               w["bytes"] / peaks["hbm_byte_per_s"])


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    least = sum(n * least_seconds(shape[0], shape[3], shape[2], shape[4],
                                  r.peaks)
                for (op, shape), n in r.launch_shapes.items() if op == OP)
    device = sum(s for name, s in r.trace.device_s.items()
                 if any(k in name for k in KERNELS))
    return 100.0 * least / device if least > 0 and device > 0 else None
