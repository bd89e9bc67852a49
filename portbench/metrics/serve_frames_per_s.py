"""Frames whose predictions reached host memory in the window, over the
whole window, which ends when the last batch dispatched in it is read
back (host clock)."""


def read(run):
    return run.work["frames"] / run.window_s
