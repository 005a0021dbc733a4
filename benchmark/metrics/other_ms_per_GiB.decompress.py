"""The decompress calls' wall less the own time of every span of the run (what
no span names: tree build, headers, tables, control flow), in ms per GiB
of the calls' data."""

from harness import GIB


def value(run):
    return (run.wall("decompress") - run.spans.total("decompress")) * 1e3 / (
        run.bytes("decompress") / GIB)
