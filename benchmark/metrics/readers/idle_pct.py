"""Share of the traced window in which no device operation runs, in %: the
window less the union of the trace's device intervals."""


def read(run):
    if run.trace is None:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
