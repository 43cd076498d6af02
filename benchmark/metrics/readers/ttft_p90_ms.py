"""90th percentile over every request sent in the window of the time from
its scheduled send to its first emitted token (host clock); a request that
never answered counts as infinite."""

import math

from benchmark.metrics.yardstick import percentile


def read(run):
    sent = [r for r in run.rec.requests if r.in_window]
    if not sent:
        return None
    return percentile([(r.times[0] - r.due) * 1e3 if r.times else math.inf for r in sent], 90)
