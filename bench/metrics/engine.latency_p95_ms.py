"""95th percentile of the latency of every request sent in the window (all
are awaited), each timed from when it fell due to its answer in hand as a
host array (host clock), so a stall counts against the requests behind it.
A per-layer reading: the walk is bound by the host, and the whole latency
distribution follows the host's speed from run to run, too far for a bound."""
import numpy as np


def read(run):
    lat = [r.t_done - r.t_due for r in run.records if r.ok]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
