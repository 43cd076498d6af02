"""Model FLOPs of the traced steps' tokens over the trace's length, as a
share of the bf16 peak, in %: each admitted prompt's real tokens (causal),
each decoded token over its own context, the lm head once per emitted
token."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    m = run.model
    flops = 0.0
    for s in run.rec.traced_steps():
        flops += sum(m.prefill_flops(p) for p in s.admitted)
        flops += sum(m.decode_flops(c) for c in s.useful)
    if flops == 0:
        return None
    return flops / run.trace.window_s / run.peaks["bf16_flops_per_s"] * 100.0
