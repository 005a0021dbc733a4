"""Own time of the container's sink (``_Hf2Sink.write_aligned``: table and
CRC patches) and of the file writes, in ms per GiB of input."""

from harness import ms_per_gib

SPANS = {"write": ["tpuhuff_torch.io.stream:open().write", "tpuhuff_torch.io.host:_Hf2Sink.write_aligned"]}


def value(run):
    return ms_per_gib(run, "compress", "write")
