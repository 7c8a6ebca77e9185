"""Requests answered per second of the window (host clock): the requests
answered from the window's start up to the last answer at or before its
close, over the seconds from the start to that answer.  Answers come in
lumps, a dispatch's at once, so the window's close would otherwise cut a
lump in or out at random.  A failed request is not answered."""


def read(run):
    t_start = run.t_end - run.seconds
    done = [r.t_done for r in run.records if r.ok and r.t_done <= run.t_end]
    if not done or max(done) <= t_start:
        return None
    return len(done) / (max(done) - t_start)
