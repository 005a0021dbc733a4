"""Letter types: the wire width of a tree's leaves.

The part of :mod:`tpuhuff.core.letters` that :mod:`tpuhuff_torch.core.tree`
needs: :class:`LetterType`, the ``u8`` type of every ``.hf2`` tree, and
:func:`letter_type`.  A leaf in a tree's binary form carries
``size_bytes * 8`` big-endian letter bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["LetterType", "letter_type", "U8"]


@dataclass(frozen=True)
class LetterType:
    """A letter type with a fixed wire width, mirroring a Rust primitive."""

    name: str
    size_bytes: int
    signed: bool

    @property
    def size_bits(self) -> int:
        return self.size_bytes * 8

    def as_be_bytes(self, letter: int) -> bytes:
        """Big-endian bytes of ``letter``."""
        if not isinstance(letter, int):
            raise TypeError(f"{self.name} letter must be an int, got {type(letter)!r}")
        return int(letter).to_bytes(self.size_bytes, "big", signed=self.signed)

    def try_from_be_bytes(self, data: bytes) -> int:
        """Parse a letter from exactly ``size_bytes`` big-endian bytes."""
        if len(data) != self.size_bytes:
            raise ValueError(
                f"{self.name} letter needs exactly {self.size_bytes} bytes, got {len(data)}"
            )
        return int.from_bytes(data, "big", signed=self.signed)


U8 = LetterType("u8", 1, False)


def letter_type(name_or_type: Any) -> LetterType:
    """Look up a :class:`LetterType` by name (``"u8"``) or pass one through."""
    if isinstance(name_or_type, LetterType):
        return name_or_type
    if str(name_or_type) == U8.name:
        return U8
    raise KeyError(f"unknown letter type {name_or_type!r}; known: ['u8']")
