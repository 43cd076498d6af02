"""Mean host ms of the window's step() calls that admitted at least one
request (the harness's clock; each step ends on the host's read of tokens),
before a traced run's trace starts."""


def read(run):
    steps = [s for s in run.rec.untraced_steps() if s.admitted]
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
