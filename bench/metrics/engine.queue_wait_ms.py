"""Mean ms a dispatched request waited, from its ``t_submit`` to the start
of its dispatch: the engine's ``MetricsSnapshot.queued_s`` over
``batched_requests``, as deltas over the window (a ``submit`` blocked on a
full queue waits inside it too).  ``None`` where the program does not count
``queued_s``."""


def read(run):
    if not hasattr(run.after, "queued_s"):
        return None
    requests = run.after.batched_requests - run.before.batched_requests
    if requests <= 0:
        return None
    return 1e3 * (run.after.queued_s - run.before.queued_s) / requests
