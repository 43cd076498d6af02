"""Fused low-rank projection (K2, ``lowrank_fused_mma_kernel``) against its
bound, in %: for every prompt admitted in the window and every GRASP pair,
the larger of its bytes (x, A, B, y once, bf16) at the memory rate and its
operations (2 rows r (in + out), the prompt's real rows) at the bf16 rate,
over the kernel's device time in the trace: the prompts admitted in the
traced steps."""

from benchmark.metrics.yardstick import least_seconds, lowrank_cost

KERNEL = "lowrank_fused_mma_kernel"


def read(run):
    if run.trace is None or run.peaks is None or not run.lowrank:
        return None
    t = run.trace.kernel_seconds(KERNEL)
    if t <= 0:
        return None
    least = 0.0
    for s in run.rec.traced_steps():
        for rows in s.admitted:
            for k, r, n in run.lowrank:
                least += least_seconds(*lowrank_cost(rows, k, r, n), run.peaks)
    return least / t * 100.0 if least > 0 else None
