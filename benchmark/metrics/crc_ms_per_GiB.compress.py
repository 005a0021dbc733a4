"""Own time of the CRC column's computation (the host runtime's
``crc32_blocks``), in ms per GiB of input."""

from harness import ms_per_gib

SPANS = {"crc": ["tpuhuff_torch.native:crc32_blocks"]}


def value(run):
    return ms_per_gib(run, "compress", "crc")
