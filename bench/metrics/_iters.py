"""LP iterations the window's dispatches ran: dispatches x the mix's one
``n_iters`` (a dispatch groups requests of one iteration count)."""


def dispatched_iters(run):
    dispatches = run.after.dispatches - run.before.dispatches
    n_iters = run.cell.mix.get("n_iters")
    if dispatches <= 0 or not isinstance(n_iters, int):
        return None
    return dispatches * n_iters
