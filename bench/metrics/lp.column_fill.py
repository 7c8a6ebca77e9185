"""Share, in %, of the label columns the window's walks computed that carry
a request: the requests' widths over batch bucket x width bucket of each
dispatch (``MetricsSnapshot.columns_real / columns_walked``, as deltas over
the window); the rest is padding.  ``None`` where the program does not
count columns."""


def read(run):
    if not hasattr(run.after, "columns_walked"):
        return None
    walked = run.after.columns_walked - run.before.columns_walked
    if walked <= 0:
        return None
    return 100.0 * (run.after.columns_real - run.before.columns_real) / walked
