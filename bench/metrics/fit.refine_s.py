"""Seconds of the fit's greedy refinement, as the program's ``VdtStats``
reports it (host clock after a device synchronisation)."""


def read(run):
    return run.fit_stats.refine_s
