"""The decode's share of its roofline, in %: each payload byte and each
block-table byte read once, each output byte written once, at the card's
published bandwidth, over the device time of the kernels named below in
the traced window."""

from harness import roofline

KERNELS = ("lane_rows_kernel", "decode_rows_kernel",
           "decode_rows_general_kernel")


def value(run):
    return roofline(run, "decompress", KERNELS,
                    lambda c: c.payload_bytes + c.out_bytes + c.table_bytes)
