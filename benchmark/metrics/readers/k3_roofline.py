"""Paged decode attention (K3, ``paged_decode_mma_kernel``) against its
bound, in %: the least time of the bytes the traced steps' decode rows need (each
row's live K/V over its own context, Q and the output once, every layer) at
the memory rate, over the kernel's device time in the trace."""

from benchmark.metrics.yardstick import least_seconds, paged_decode_bytes

KERNEL = "paged_decode_mma_kernel"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    t = run.trace.kernel_seconds(KERNEL)
    if t <= 0:
        return None
    nbytes = sum(paged_decode_bytes(run.model, c) for s in run.rec.traced_steps()
                 for c in s.decoded)
    if nbytes == 0:
        return None
    return least_seconds(nbytes, 0.0, run.peaks) / t * 100.0
