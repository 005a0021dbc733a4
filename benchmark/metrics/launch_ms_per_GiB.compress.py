"""Host time in the kernel wrappers of compress (the histogram K3, the
encode K1, the stitch S1), in ms per GiB of input."""

from harness import ms_per_gib

SPANS = {"launch": ["tpuhuff_torch.io.stream:histogram", "tpuhuff_torch.io.stream:encode_blocks", "tpuhuff_torch.io.stream:stitch_lanes"]}


def value(run):
    return ms_per_gib(run, "compress", "launch")
