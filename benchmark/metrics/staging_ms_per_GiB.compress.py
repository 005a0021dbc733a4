"""Own time of ``_Staging``'s methods that fill pinned buffers and start
copies (reads and waits inside them are spans of their own), in ms per
GiB of the compress calls' data."""

from harness import ms_per_gib

SPANS = {"staging": ["tpuhuff_torch.io.stream:_Staging.h2d", "tpuhuff_torch.io.stream:_Staging.read_into",
                     "tpuhuff_torch.io.stream:_Staging.to_device", "tpuhuff_torch.io.stream:_Staging.d2h",
                     "tpuhuff_torch.io.stream:_Staging.fetch"]}


def value(run):
    return ms_per_gib(run, "compress", "staging")
