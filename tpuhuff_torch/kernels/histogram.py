"""Device histogram: exact 256-bin byte counts.

Counterpart of :func:`tpuhuff.kernels.histogram.histogram` and of the Pallas
kernel ``tpuhuff.kernels.pallas_histogram._hist_kernel``.  Counts are int64,
so no partial sum can overflow and callers need no flush rule.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["histogram", "histogram_reference"]

_MAX_BYTES = 1 << 40  # per-block u32 shared-memory counts stay exact below


def histogram(data: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 -> (256,) int64 counts over all elements.

    CUDA tensors launch the kernel (``csrc/histogram.cu``); CPU tensors take
    :func:`histogram_reference`."""
    if data.dtype != torch.uint8:
        raise TypeError(f"histogram needs uint8 data, got {data.dtype}")
    if data.device.type == "cpu":
        return histogram_reference(data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    n = data.numel()
    if n >= _MAX_BYTES:
        raise ValueError(f"histogram of {n} bytes exceeds one launch")
    out = torch.zeros(256, dtype=torch.int64, device=data.device)
    if n == 0:
        return out
    _build.launch("tpuhuff_hist256", data.device, data.data_ptr(), n,
                  out.data_ptr())
    histogram.launches += 1
    return out


histogram.launches = 0


def histogram_reference(data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram` (any device)."""
    return torch.bincount(data.reshape(-1), minlength=256)
