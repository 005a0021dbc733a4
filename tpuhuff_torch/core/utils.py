"""Small helpers of the reference's ``huff_coding/src/utils.rs``.

The port's copy of :mod:`tpuhuff.core.utils`; ``calc_padding_bits`` lives
in :mod:`.bits` and is re-exported here.
"""

from __future__ import annotations

from typing import List, Sequence, TypeVar

from .bits import calc_padding_bits
from .letters import letter_type

T = TypeVar("T")

__all__ = ["ration_vec", "size_of_bits", "calc_padding_bits"]


def ration_vec(seq: Sequence[T], ration_count: int) -> List[Sequence[T]]:
    """Split ``seq`` into ``ration_count`` chunks (``utils.rs:6-28``): the
    remainder goes into the last chunk; an input shorter than
    ``ration_count`` gives one chunk holding everything."""
    n = len(seq)
    per = n // ration_count
    if per == 0:
        return [seq[:]]
    out: List[Sequence[T]] = []
    pos = 0
    for i in range(ration_count):
        if i == ration_count - 1:
            out.append(seq[pos:])
            break
        out.append(seq[pos : pos + per])
        pos += per
    return out


def size_of_bits(ltype) -> int:
    """``size_of::<T>() * 8`` (``utils.rs:31-33``) of a letter type."""
    return letter_type(ltype).size_bits
