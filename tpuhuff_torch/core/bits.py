"""MSB-first bit vectors and padding math.

The port's copy of :mod:`tpuhuff.core.bits` (``BitString``,
``calc_padding_bits`` and ``offset_bytes``), with the same arithmetic and
bytes: bits are stored most-significant-first, and a bit vector converts
to bytes by zero-padding the low bits of the last byte, as the reference's
``BitVec<Msb0, u8>`` does (``huff_coding/src/utils.rs:37-40`` for the
padding).
"""

from __future__ import annotations

from typing import Iterable, Iterator

__all__ = ["BitString", "calc_padding_bits", "offset_bytes"]


def calc_padding_bits(bit_count: int) -> int:
    """Number of low zero bits needed to pad ``bit_count`` bits to bytes."""
    return (8 - bit_count % 8) % 8


class BitString:
    """A growable MSB-first bit vector backed by a Python int.

    ``value`` holds the bits as a big integer where the FIRST pushed bit is
    the most significant; ``length`` is the bit count.  ``to_bytes``
    zero-pads ``calc_padding_bits(length)`` low bits.
    """

    __slots__ = ("value", "length")

    def __init__(self, value: int = 0, length: int = 0):
        if length < 0 or value < 0 or (value >> length):
            raise ValueError("value has more bits than length")
        self.value = value
        self.length = length

    @classmethod
    def from_bytes(cls, data: bytes, bit_length: int | None = None) -> "BitString":
        """Interpret ``data`` MSB-first; optionally truncate to ``bit_length``."""
        total = len(data) * 8
        value = int.from_bytes(data, "big")
        if bit_length is None:
            bit_length = total
        if not 0 <= bit_length <= total:
            raise ValueError("bit_length out of range")
        value >>= total - bit_length
        return cls(value, bit_length)

    @classmethod
    def from_bits(cls, bits: Iterable[int]) -> "BitString":
        s = cls()
        for b in bits:
            s.push(b)
        return s

    def push(self, bit: int) -> None:
        self.value = (self.value << 1) | (1 if bit else 0)
        self.length += 1

    def extend(self, other: "BitString") -> None:
        self.value = (self.value << other.length) | other.value
        self.length += other.length

    def push_uint(self, value: int, width: int) -> None:
        """Append ``width`` big-endian bits of ``value``."""
        if value < 0 or value >> width:
            raise ValueError("value does not fit in width")
        self.value = (self.value << width) | value
        self.length += width

    def pop(self) -> int:
        """Remove and return the last bit (``BitVec::pop``)."""
        if self.length == 0:
            raise IndexError("pop from empty BitString")
        bit = self.value & 1
        self.value >>= 1
        self.length -= 1
        return bit

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> int:
        if i < 0:
            i += self.length
        if not 0 <= i < self.length:
            raise IndexError("bit index out of range")
        return (self.value >> (self.length - 1 - i)) & 1

    def __iter__(self) -> Iterator[int]:
        for i in range(self.length):
            yield (self.value >> (self.length - 1 - i)) & 1

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, BitString)
            and self.length == other.length
            and self.value == other.value
        )

    def __hash__(self) -> int:
        return hash((self.value, self.length))

    def __repr__(self) -> str:
        return f"BitString('{self.to01()}')"

    def to01(self) -> str:
        return format(self.value, f"0{self.length}b") if self.length else ""

    def to_bytes(self) -> bytes:
        """Zero-pad the low bits of the last byte and return bytes."""
        pad = calc_padding_bits(self.length)
        nbytes = (self.length + pad) // 8
        return (self.value << pad).to_bytes(nbytes, "big")

    def group_string(self) -> str:
        """8-bit groups, the last possibly short: ``"[10111111, 11101100, ...]"``."""
        s = self.to01()
        groups = [s[i : i + 8] for i in range(0, len(s), 8)]
        return "[" + ", ".join(groups) + "]"


def offset_bytes(data: bytes, n: int) -> bytes:
    """Shift a byte string right by ``n`` bits, re-packed MSB-first
    (``huff/src/utils.rs:2-25``): ``n // 8`` zero bytes first, the first
    data bit at bit ``n % 8`` of the next byte, zero-padded to a byte."""
    if n < 0:
        raise ValueError("negative offset")
    total_bits = n + len(data) * 8
    pad = calc_padding_bits(total_bits)
    value = int.from_bytes(data, "big") << pad
    return value.to_bytes((total_bits + pad) // 8, "big")
