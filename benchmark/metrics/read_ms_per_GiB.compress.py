"""Own time of the reads of the files that the file pipeline opens, in ms
per GiB of the compress calls' data."""

from harness import ms_per_gib

SPANS = {"read": ["tpuhuff_torch.io.stream:open().read", "tpuhuff_torch.io.stream:open().readinto"]}


def value(run):
    return ms_per_gib(run, "compress", "read")
