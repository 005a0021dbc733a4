"""Device histogram: exact 256-bin byte counts.

Counterpart of :func:`tpuhuff.kernels.histogram.histogram` and of the Pallas
kernel ``tpuhuff.kernels.pallas_histogram._hist_kernel``.  Counts are int64,
so no partial sum can overflow and callers need no flush rule.
"""

from __future__ import annotations

import ctypes

import torch

from ..profiling import span
from . import _build

__all__ = ["histogram", "histogram_grid", "histogram_reference"]

_MAX_BYTES = 1 << 40  # one launch's n, well inside the kernel's int64 offsets


def histogram(data: torch.Tensor, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """(..., n) uint8 -> (256,) int64 counts over all elements.

    With ``out`` (a (256,) int64 tensor on ``data``'s device) the counts
    are added into it and it is returned; else they go into new zeros.
    CUDA tensors launch the kernel (``csrc/histogram.cu``), one launch per
    call; CPU tensors take :func:`histogram_reference`."""
    if data.dtype != torch.uint8:
        raise TypeError(f"histogram needs uint8 data, got {data.dtype}")
    if data.device.type == "cpu":
        return histogram_reference(data, out)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    with span("launch"):
        if out is not None:
            _build.check_tensor(out, "out", torch.int64, (256,), data.device)
        if not data.is_contiguous():
            raise ValueError("data must be contiguous")
        n = data.numel()
        if n >= _MAX_BYTES:
            raise ValueError(f"histogram of {n} bytes exceeds one launch")
        if out is None:
            out = torch.zeros(256, dtype=torch.int64, device=data.device)
        if n == 0:
            return out
        _build.launch("tpuhuff_hist256", data.device, data.data_ptr(), n,
                      out.data_ptr())
        histogram.launches += 1
        return out


histogram.launches = 0


def histogram_grid(n: int, device="cuda") -> tuple[int, int]:
    """(thread blocks, blocks per SM) of :func:`histogram`'s launch over
    ``n`` bytes on ``device``: the blocks the card holds at once, or fewer
    where ``n`` gives less than one step of loads to each."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        grid = _build.lib().tpuhuff_hist256_grid(int(n), ctypes.byref(per_sm))
    if grid < 0:
        raise RuntimeError(f"tpuhuff_hist256_grid: CUDA error {-grid}")
    return grid, per_sm.value


def histogram_reference(data: torch.Tensor, out: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram` (any device)."""
    if out is not None:
        _build.check_tensor(out, "out", torch.int64, (256,), data.device)
    counts = torch.bincount(data.reshape(-1), minlength=256)
    return counts if out is None else out.add_(counts)
