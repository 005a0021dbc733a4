"""100 x (1 - the union of the device's kernel, copy and memset intervals
over the traced window), in the round-trip cell."""

from harness import idle_pct


def value(run):
    return idle_pct(run)
