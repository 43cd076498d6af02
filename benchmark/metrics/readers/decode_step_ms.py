"""Mean host ms of the engine's batched decode steps in the window before a
traced run's trace starts, from its own counters (``decode_seconds /
decode_steps``: each step timed up to its sampled tokens on the host)."""


def read(run):
    a, b = run.rec.counters_start, run.rec.counters_trace
    steps = b["decode_steps"] - a["decode_steps"]
    if steps <= 0:
        return None
    return (b["decode_seconds"] - a["decode_seconds"]) / steps * 1e3
