"""Real requests per device dispatch over the window: the engine's own
counters (``MetricsSnapshot.batched_requests`` / ``dispatches``) as deltas."""


def read(run):
    dispatches = run.after.dispatches - run.before.dispatches
    if dispatches <= 0:
        return None
    return (run.after.batched_requests - run.before.batched_requests) \
        / dispatches
