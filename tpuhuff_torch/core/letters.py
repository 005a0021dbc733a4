"""Letter types: what can be a symbol of a tree, and its wire width.

The port's copy of :mod:`tpuhuff.core.letters`.  Any hashable Python value
can be a letter of a tree; a registered :class:`LetterType` gives it the
big-endian byte form that puts the tree on the wire.  The integer types of
every Rust width are registered, as the reference implements its byte
form for all primitive integers
(``huff_coding/src/tree/letter.rs:57-60``); ``str`` letters build trees
and read codes but have no wire form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

__all__ = [
    "LetterType",
    "letter_type",
    "U8", "U16", "U32", "U64", "U128", "USIZE",
    "I8", "I16", "I32", "I64", "I128", "ISIZE",
]


@dataclass(frozen=True)
class LetterType:
    """A letter type with a fixed wire width, mirroring a Rust primitive:
    every leaf of a tree's binary form carries ``size_bytes * 8``
    big-endian letter bits."""

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

    def check(self, letter: int) -> None:
        """Raise ``ValueError`` if ``letter`` is out of this type's range."""
        lo = -(1 << (self.size_bits - 1)) if self.signed else 0
        hi = (1 << (self.size_bits - 1)) if self.signed else (1 << self.size_bits)
        if not (lo <= letter < hi):
            raise ValueError(f"letter {letter} out of range for {self.name}")


U8 = LetterType("u8", 1, False)
U16 = LetterType("u16", 2, False)
U32 = LetterType("u32", 4, False)
U64 = LetterType("u64", 8, False)
U128 = LetterType("u128", 16, False)
USIZE = LetterType("usize", 8, False)
I8 = LetterType("i8", 1, True)
I16 = LetterType("i16", 2, True)
I32 = LetterType("i32", 4, True)
I64 = LetterType("i64", 8, True)
I128 = LetterType("i128", 16, True)
ISIZE = LetterType("isize", 8, True)

_REGISTRY: Dict[str, LetterType] = {
    t.name: t
    for t in (U8, U16, U32, U64, U128, USIZE, I8, I16, I32, I64, I128, ISIZE)
}


def letter_type(name_or_type: Any) -> LetterType:
    """Look up a :class:`LetterType` by name (``"u8"``) or pass one through."""
    if isinstance(name_or_type, LetterType):
        return name_or_type
    try:
        return _REGISTRY[str(name_or_type)]
    except KeyError:
        raise KeyError(
            f"unknown letter type {name_or_type!r}; known: {sorted(_REGISTRY)}"
        ) from None
