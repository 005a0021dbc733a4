"""The compress calls' wall less the own time of every span of the run (what
no span names: tree build, headers, tables, control flow), in ms per GiB
of the calls' data."""

from harness import GIB


def value(run):
    return (run.wall("compress") - run.spans.total("compress")) * 1e3 / (
        run.bytes("compress") / GIB)
