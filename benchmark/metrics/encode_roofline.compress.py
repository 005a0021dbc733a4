"""The encode's share of its roofline, in %: each input byte read once,
each payload byte and each block-table byte written once, at the card's
published bandwidth, over the device time of the kernels named below
(however the work is split between them) in the traced window."""

from harness import roofline

KERNELS = ("encode_tiles", "stitch_kernel", "stitch_carry_kernel")


def value(run):
    return roofline(run, "compress", KERNELS,
                    lambda c: c.in_bytes + c.payload_bytes + c.table_bytes)
