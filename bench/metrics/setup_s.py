"""Process start to the first timed request: data, the fit, kernel loading
(or building, in a checkout's first run) and the warm-up of the cell's own
dispatch shapes (host clock)."""


def read(run):
    return run.setup_s
