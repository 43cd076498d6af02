"""95th percentile over every gap between successive tokens of a request,
both emitted in the window (host clock), steps that also admit included; in
a traced run, both emitted before the trace starts."""

from benchmark.metrics.yardstick import percentile


def read(run):
    rec = run.rec
    gaps = []
    for r in rec.requests:
        ts = [t for t in r.times if rec.t_start <= t <= rec.host_end()]
        gaps += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
    return percentile(gaps, 95) if gaps else None
