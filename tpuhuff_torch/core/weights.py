"""256-bin byte histograms ("weights") that seed a tree.

The port's copy of :class:`tpuhuff.core.weights.ByteWeights` and
:func:`tpuhuff.core.weights.weights_items`: iteration yields ``(byte,
weight)`` in ascending byte order, skipping zero bins — the seed order that
makes a tree's shape, and so its bytes, the reference's.
"""

from __future__ import annotations

from typing import Hashable, Iterator, List, Tuple, Union

import numpy as np

__all__ = ["ByteWeights", "weights_items"]

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]

# below this many bytes one bincount beats the threaded C++ histogram's start
_NATIVE_MIN = 1 << 16


def _as_u8_array(data: BytesLike) -> np.ndarray:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.ravel()
    return np.frombuffer(bytes(data) if isinstance(data, memoryview) else data,
                         dtype=np.uint8)


class ByteWeights:
    """256-bin byte histogram: ``counts`` is an ``int64[256]`` array."""

    __slots__ = ("counts",)

    def __init__(self, counts: np.ndarray | None = None):
        if counts is None:
            counts = np.zeros(256, dtype=np.int64)
        else:
            counts = np.asarray(counts, dtype=np.int64)
            if counts.shape != (256,):
                raise ValueError("counts must have shape (256,)")
            if (counts < 0).any():
                raise ValueError("counts must be non-negative")
        self.counts = counts

    @classmethod
    def from_bytes(cls, data: BytesLike) -> "ByteWeights":
        """Count bytes: the threaded C++ histogram of the port's host runtime
        for large inputs, ``np.bincount`` for small ones."""
        arr = _as_u8_array(data)
        if arr.size >= _NATIVE_MIN:
            from .. import native

            return cls(native.hist(arr))
        return cls(np.bincount(arr, minlength=256).astype(np.int64))

    def __len__(self) -> int:
        return int(np.count_nonzero(self.counts))

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        for b in np.nonzero(self.counts)[0]:
            yield int(b), int(self.counts[b])

    def __iadd__(self, other: "ByteWeights") -> "ByteWeights":
        self.counts += other.counts
        return self

    def __repr__(self) -> str:
        return f"ByteWeights({dict(self)})"


def weights_items(weights) -> List[Tuple[Hashable, int]]:
    """Normalize any weights collection to an ordered ``[(letter, weight)]``:
    a :class:`ByteWeights`, a dict, or any iterable of pairs."""
    if isinstance(weights, ByteWeights):
        return list(weights)
    if isinstance(weights, dict):
        return list(weights.items())
    return list(weights)
