"""Own time of the output file's writes, in ms per GiB of output."""

from harness import ms_per_gib

SPANS = {"write": ["tpuhuff_torch.io.stream:open().write"]}


def value(run):
    return ms_per_gib(run, "decompress", "write")
