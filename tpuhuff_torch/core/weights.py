"""Histograms ("weights") over letters, which seed a tree.

The port's copy of :mod:`tpuhuff.core.weights`:

* :func:`build_weights_map` counts any letters into a dict in order of
  first occurrence, the seed order of a generic tree (ties between equal
  weights resolve by it, so it decides the tree's bytes);
* :class:`ByteWeights` is the 256-bin byte histogram, whose iteration
  yields ``(byte, weight)`` in ascending byte order, skipping zero bins —
  the seed order that makes a byte tree the reference's.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, List, Sequence, Tuple, Union

import numpy as np

__all__ = ["ByteWeights", "build_weights_map", "weights_items"]

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


def build_weights_map(letters: Sequence[Hashable]) -> Dict[Hashable, int]:
    """Count letters into a dict of letter -> weight, in order of first
    occurrence (``weights.rs:116-123``'s entry-or-insert loop); bytes and
    numpy arrays are counted vectorised."""
    if isinstance(letters, (bytes, bytearray, memoryview)) or (
        isinstance(letters, np.ndarray) and letters.dtype == np.uint8
    ):
        arr = _as_u8_array(letters)
        counts = np.bincount(arr, minlength=256)
        return {int(b): int(counts[b]) for b in _first_occurrence_order(arr)}
    if isinstance(letters, np.ndarray):
        values, first_idx, counts = np.unique(
            letters, return_index=True, return_counts=True
        )
        order = np.argsort(first_idx, kind="stable")
        return {values[i].item(): int(counts[i]) for i in order}
    weights: Dict[Hashable, int] = {}
    for letter in letters:
        weights[letter] = weights.get(letter, 0) + 1
    return weights


def _first_occurrence_order(arr: np.ndarray) -> np.ndarray:
    """Byte values in order of their first occurrence in ``arr``."""
    if arr.size == 0:
        return np.empty(0, dtype=np.int64)
    first = np.full(256, arr.size, dtype=np.int64)
    # written in reverse, so the earliest index of each value is kept
    first[arr[::-1]] = np.arange(arr.size - 1, -1, -1)
    vals = np.nonzero(first < arr.size)[0]
    return vals[np.argsort(first[vals], kind="stable")]


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

    @classmethod
    def threaded_from_bytes(cls, data: BytesLike,
                            thread_num: int = 12) -> "ByteWeights":
        """Count bytes on ``thread_num`` threads of the host runtime
        (``weights.rs:293-319``; the reference CLI passes 12)."""
        from .. import native

        return cls(native.hist(_as_u8_array(data), threads=max(1, int(thread_num))))

    def get(self, byte: int) -> int | None:
        w = int(self.counts[byte])
        return w if w else None

    def __len__(self) -> int:
        return int(np.count_nonzero(self.counts))

    def is_empty(self) -> bool:
        return len(self) == 0

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        for b in np.nonzero(self.counts)[0]:
            yield int(b), int(self.counts[b])

    def items(self) -> Iterator[Tuple[int, int]]:
        return iter(self)

    def add_byte_weights(self, other: "ByteWeights") -> None:
        self.counts += other.counts

    def __add__(self, other: "ByteWeights") -> "ByteWeights":
        return ByteWeights(self.counts + other.counts)

    def __iadd__(self, other: "ByteWeights") -> "ByteWeights":
        self.add_byte_weights(other)
        return self

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ByteWeights) and bool(
            np.array_equal(self.counts, other.counts)
        )

    def __hash__(self) -> int:
        return hash(self.counts.tobytes())

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
