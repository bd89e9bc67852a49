"""The train step's rate: samples of every step completed in the window over the whole window,
which ends once the last step dispatched in it has finished (host clock)."""


def read(run):
    return run.work["samples"] / run.window_s
