"""Seconds from the process's start to the window's start: imports, the
objects made from the seed, the card's set-up, the kernels' build on a
checkout's first run, and one warm call."""


def value(run):
    return run.setup_s
