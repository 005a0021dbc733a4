"""The histogram's share of its roofline, in %: each input byte read once
at the card's published bandwidth, over the device time of the kernels
named below in the traced window."""

from harness import roofline

KERNELS = ("hist256_kernel",)


def value(run):
    return roofline(run, "compress", KERNELS, lambda c: c.in_bytes)
