"""Host time blocked on the device (CUDA event and stream synchronisation),
in ms per GiB of the compress calls' data."""

from harness import ms_per_gib

SPANS = {"wait": ["torch.cuda:Event.synchronize",
                  "torch.cuda:Stream.synchronize"]}


def value(run):
    return ms_per_gib(run, "compress", "wait")
