"""Process start to the window's start: imports, the kernel library (built on
a checkout's first run), weights, the engine, warming the cell's shapes and
the traffic's ramp."""


def read(run):
    return run.setup_s
