"""The ``CompressData`` container and the ``.hff`` wire layout.

The port's copy of :mod:`tpuhuff.core.format`, with the same validation,
error messages and bytes (the reference's container,
``huff_coding/src/comp.rs:279-300`` writer, ``comp.rs:128-184`` parser):

```
byte 0        : (tree_padding_bits << 4) | data_padding_bits
bytes 1..5    : u32 big-endian tree length in BYTES
bytes 5..5+T  : HuffTree pre-order bit encoding, zero-padded to a byte
                boundary (padding bits = high nibble of byte 0)
bytes 5+T..   : payload, MSB-first concatenated codes; final byte zero-padded
                with data_padding_bits low bits
```
"""

from __future__ import annotations

from typing import Hashable

from .bits import BitString, calc_padding_bits
from .letters import LetterType, U8, letter_type
from .tree import FromBinError, HuffTree

__all__ = [
    "CompressData",
    "CompressError",
    "CompressedDataFromBytesError",
    "HFF_HEADER_LEN",
]

HFF_HEADER_LEN = 5  # padding byte + u32 tree length


class CompressError(ValueError):
    """A letter of the input has no code in the tree (``comp.rs:557-565``)."""

    def __init__(self, message: str, missing_letter: Hashable):
        super().__init__(f"{message} ({missing_letter!r})")
        self.missing_letter = missing_letter


class CompressedDataFromBytesError(ValueError):
    """Malformed container bytes (``comp.rs:530-554``)."""


class CompressData:
    """Compressed payload, its padding and the tree that produced it.

    An empty payload or ``padding_bits > 7`` is a programmer error, as in
    the reference (``comp.rs:55-61``).
    """

    __slots__ = ("comp_bytes", "padding_bits", "huff_tree", "ltype")

    def __init__(
        self,
        comp_bytes: bytes,
        padding_bits: int,
        huff_tree: HuffTree,
        ltype: LetterType | str = U8,
    ):
        if len(comp_bytes) == 0:
            raise ValueError("provided comp_bytes are empty")
        if not 0 <= padding_bits <= 7:
            raise ValueError("padding bits cannot be larger than 7")
        self.comp_bytes = bytes(comp_bytes)
        self.padding_bits = int(padding_bits)
        self.huff_tree = huff_tree
        self.ltype = letter_type(ltype)

    def into_inner(self):
        return self.comp_bytes, self.padding_bits, self.huff_tree

    def to_bytes(self) -> bytes:
        """Serialise per the container layout (``comp.rs:279-300``)."""
        tree_bin = self.huff_tree.as_bin(self.ltype)
        tree_padding = calc_padding_bits(len(tree_bin))
        tree_bytes = tree_bin.to_bytes()
        out = bytearray()
        out.append((tree_padding << 4) | self.padding_bits)
        out += len(tree_bytes).to_bytes(4, "big")
        out += tree_bytes
        out += self.comp_bytes
        return bytes(out)

    @classmethod
    def try_from_bytes(
        cls, data: bytes, ltype: LetterType | str = U8
    ) -> "CompressData":
        """Parse the container with the reference's error conditions
        (``comp.rs:128-184``).  A stored tree length < 2 is a panic in the
        reference (``comp.rs:153-155``), raised here as ``ValueError``, not
        :class:`CompressedDataFromBytesError`."""
        data = bytes(data)
        if len(data) < 1:
            raise CompressedDataFromBytesError("slice is empty")
        tree_padding = data[0] >> 4
        data_padding = data[0] & 0x0F
        if len(data) < 5:
            raise CompressedDataFromBytesError("slice too short to read tree length")
        tree_len = int.from_bytes(data[1:5], "big")
        if tree_len < 2:
            raise ValueError("stored tree length must be at least 2")
        if len(data) < 5 + tree_len:
            raise CompressedDataFromBytesError("slice too short to read tree")
        tree_bytes = data[5 : 5 + tree_len]
        try:
            tree = HuffTree.try_from_bin(
                BitString.from_bytes(tree_bytes, tree_len * 8 - tree_padding),
                ltype,
            )
        except (FromBinError, ValueError):
            raise CompressedDataFromBytesError("invalid tree in slice") from None
        # an empty payload reaches the constructor and raises there, as the
        # reference panics in `CompressData::new` (comp.rs:56-58)
        return cls(data[5 + tree_len :], data_padding, tree, ltype)

    def __repr__(self) -> str:
        return (
            f"CompressData(len={len(self.comp_bytes)}, "
            f"padding_bits={self.padding_bits}, tree={self.huff_tree!r})"
        )
