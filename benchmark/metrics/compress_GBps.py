"""Input bytes of every compress call in the window over the window's
seconds (first call's start to last call's end), in 10^9 B/s."""


def value(run):
    return run.bytes("compress") / run.window_s / 1e9
