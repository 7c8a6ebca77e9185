"""Seconds of ``VariationalDualTree.fit``, the harness's own span around
it, the device synchronised on both sides (host clock)."""


def read(run):
    return run.fit_s
