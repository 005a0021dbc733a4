"""Container bytes over input bytes, summed over the window's compress
calls: what the user pays in storage."""


def value(run):
    calls = run.of("compress")
    return sum(c.out_bytes for c in calls) / sum(c.in_bytes for c in calls)
