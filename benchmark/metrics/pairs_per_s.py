"""Pairs completed over the time from the window's start to the end of the
last completed pair: all the work of the window over all of its time."""


def read(run):
    return run.pairs / (run.pair_ends[-1] - run.window_start)
