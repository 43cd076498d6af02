"""Every token emitted in the window over the window's seconds (host clock)."""

from benchmark.metrics.yardstick import rate


def read(run):
    rec = run.rec
    n = sum(1 for r in rec.requests for t in r.times if rec.t_start < t <= rec.t_end)
    return rate(n, run.seconds)
