"""Host ms a dispatch spends on the engine's scheduler thread around its
walk: staging (grouping, the host stack, its copy to the device), the
result slab's copy back and resolving the futures
(``MetricsSnapshot.stage_s + copy_out_s + resolve_s`` over ``dispatches``,
as deltas over the window).  ``None`` where the program does not time
those phases."""

PHASES = ("stage_s", "copy_out_s", "resolve_s")


def read(run):
    if not all(hasattr(run.after, f) for f in PHASES):
        return None
    dispatches = run.after.dispatches - run.before.dispatches
    if dispatches <= 0:
        return None
    seconds = sum(getattr(run.after, f) - getattr(run.before, f)
                  for f in PHASES)
    return 1e3 * seconds / dispatches
