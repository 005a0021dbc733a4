"""Host time in the kernel wrappers of decompress (the row gather S2, the
decoders K2 and K4), in ms per GiB of output."""

from harness import ms_per_gib

SPANS = {"launch": ["tpuhuff_torch.io.stream:lane_rows", "tpuhuff_torch.kernels.decode:decode_rows",
                    "tpuhuff_torch.kernels.decode:decode_rows_general"]}


def value(run):
    return ms_per_gib(run, "decompress", "launch")
