"""Own time of the CRC column's check (``_CrcVerifier``), in ms per GiB
of output."""

from harness import ms_per_gib

SPANS = {"crc": ["tpuhuff_torch.io.host:_CrcVerifier.feed", "tpuhuff_torch.io.host:_CrcVerifier.finish"]}


def value(run):
    return ms_per_gib(run, "decompress", "crc")
