"""replay_rate (Mcellreq/s, host clock): the cell-requests of every job
completed in the window (requests x cells a grid), over the window's
seconds, in millions. The window runs from its opening to the end of its
last job, so it holds all the work and all the time."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j.work for j in run.jobs) / run.window_s / 1e6
