"""The ``.hf2`` block-indexed container: prelude, table and CRC writers,
and the header reader.

The port's copy of the ``.hf2`` part of :mod:`tpuhuff.io.hff`, writing
and reading the same bytes (:func:`write_hf2` writes a whole container
in one call).  Version 2 (written) layout:

```
bytes 0..4   : magic "HF2\\x02"
byte  4      : flags (bit0: tree is canonical; bit1: CRC column present)
byte  5      : block-table entry width in bytes (2, 4, or 8)
bytes 6..10  : u32 BE tree byte length T
byte  10     : tree padding bits
bytes 11..19 : u64 BE original data length
bytes 19..23 : u32 BE block length (bytes of input per block)
bytes 23..27 : u32 BE number of blocks B
[bytes ..+4  : u32 BE crc_every — blocks per CRC span; only if flags bit1]
bytes ..+wB  : per-block payload BIT LENGTH, width w each, big-endian
[bytes ..+4S : u32 BE zlib-CRC32 of each span's ORIGINAL bytes,
               S = ceil(B / crc_every); only if flags bit1]
bytes ..+T   : tree bits (zero-padded)
bytes ..     : payload (all block bitstreams bit-concatenated, zero-padded)
```

Version 1 (still read) has no width byte and holds u64 BE cumulative
end-bit offsets in its table.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Tuple

import numpy as np

from ..core.bits import BitString, calc_padding_bits
from ..core.tree import HuffTree

__all__ = [
    "HF2_MAGIC",
    "Hf2Header",
    "default_crc_every",
    "hf2_table_width",
    "write_hf2_prelude",
    "write_hf2_table_slice",
    "write_hf2_crc_slice",
    "write_hf2",
    "read_hf2_header",
]

HF2_MAGIC_V1 = b"HF2\x01"
HF2_MAGIC = b"HF2\x02"


@dataclass
class Hf2Header:
    tree: HuffTree
    canonical: bool
    orig_len: int
    block_len: int
    end_bits: np.ndarray  # (B,) uint64 cumulative end-bit offsets
    payload_offset: int   # file offset where payload bytes start
    crc_every: int = 0    # blocks per CRC span (0: no integrity column)
    crcs: np.ndarray | None = None  # (S,) uint32 per-span CRC32s

    @property
    def num_blocks(self) -> int:
        return int(self.end_bits.size)

    @property
    def total_bits(self) -> int:
        return int(self.end_bits[-1]) if self.end_bits.size else 0


def default_crc_every(block_len: int) -> int:
    """One CRC span per ~64 KiB of input (>= 1 block)."""
    return max(1, 65536 // max(block_len, 1))


def hf2_table_width(block_len: int, max_code_len: int) -> int:
    """Block-table entry width from the static bound on a block's bit
    length, ``block_len * max_code_len`` plus ``max_code_len + 7`` bits of
    headroom (a transcoded block may carry a trailing partial code and the
    byte padding); known before pass 2, so the table is reserved first."""
    ml = max(max_code_len, 1)
    bound = block_len * ml + ml + 7
    return 2 if bound < (1 << 16) else 4 if bound < (1 << 32) else 8


def write_hf2_prelude(
    fp: BinaryIO,
    tree: HuffTree,
    orig_len: int,
    block_len: int,
    n_blocks: int,
    width: int,
    canonical: bool = False,
    crc_every: int = 0,
) -> Tuple[int, int, int]:
    """Write the v2 header with zero-filled block and CRC tables, patched
    later by :func:`write_hf2_table_slice` / :func:`write_hf2_crc_slice`.
    ``crc_every > 0`` reserves the CRC column.  Returns ``(table_offset,
    crc_offset, payload_offset)``; ``crc_offset`` is 0 without a column."""
    tree_bin = tree.as_bin()
    tree_padding = calc_padding_bits(len(tree_bin))
    tree_bytes = tree_bin.to_bytes()
    flags = (1 if canonical else 0) | (2 if crc_every > 0 else 0)
    fp.write(HF2_MAGIC)
    fp.write(bytes([flags]))
    fp.write(bytes([width]))
    fp.write(struct.pack(">I", len(tree_bytes)))
    fp.write(bytes([tree_padding]))
    fp.write(struct.pack(">Q", orig_len))
    fp.write(struct.pack(">I", block_len))
    fp.write(struct.pack(">I", n_blocks))
    if crc_every > 0:
        fp.write(struct.pack(">I", crc_every))
    table_offset = fp.tell()
    n_spans = -(-n_blocks // crc_every) if crc_every > 0 else 0
    left = width * n_blocks + 4 * n_spans
    crc_offset = table_offset + width * n_blocks if crc_every > 0 else 0
    zeros = b"\x00" * min(left, 1 << 20)
    while left > 0:
        fp.write(zeros[: min(left, len(zeros))])
        left -= min(left, len(zeros))
    fp.write(tree_bytes)
    return table_offset, crc_offset, fp.tell()


def write_hf2_table_slice(
    fp: BinaryIO, table_offset: int, width: int, first_block: int,
    bit_lens: np.ndarray,
) -> None:
    """Patch per-block bit lengths for blocks ``first_block..`` in place;
    a length that does not fit the entry width raises ``OverflowError``."""
    lens = np.ascontiguousarray(bit_lens, dtype=np.uint64)
    if lens.size and width < 8 and int(lens.max()) >= (1 << (8 * width)):
        raise OverflowError(
            f"hf2 block bit length {int(lens.max())} does not fit the "
            f"{width}-byte table entry"
        )
    pos = fp.tell()
    fp.seek(table_offset + width * first_block)
    fp.write(lens.astype(f">u{width}").tobytes())
    fp.seek(pos)


def write_hf2_crc_slice(
    fp: BinaryIO, crc_offset: int, first_span: int, crcs: np.ndarray,
) -> None:
    """Patch per-span CRC32s for spans ``first_span..`` in place."""
    pos = fp.tell()
    fp.seek(crc_offset + 4 * first_span)
    fp.write(np.ascontiguousarray(crcs, dtype=np.uint32).astype(">u4")
             .tobytes())
    fp.seek(pos)


def write_hf2(
    fp: BinaryIO,
    tree: HuffTree,
    orig_len: int,
    block_len: int,
    end_bits: np.ndarray,
    payload: bytes,
    canonical: bool = False,
    version: int = 2,
) -> None:
    """Write a whole container from its block end bits and payload: v2
    with no CRC column (no original bytes are in scope), or v1 with
    ``version=1``."""
    tree_bin = tree.as_bin()
    tree_padding = calc_padding_bits(len(tree_bin))
    tree_bytes = tree_bin.to_bytes()
    end = np.ascontiguousarray(end_bits, dtype=np.uint64)
    if version == 1:
        fp.write(HF2_MAGIC_V1)
        fp.write(bytes([1 if canonical else 0]))
        fp.write(struct.pack(">I", len(tree_bytes)))
        fp.write(bytes([tree_padding]))
        fp.write(struct.pack(">Q", orig_len))
        fp.write(struct.pack(">I", block_len))
        fp.write(struct.pack(">I", end.size))
        fp.write(end.astype(">u8").tobytes())
        fp.write(tree_bytes)
        fp.write(payload)
        return
    if version != 2:
        raise ValueError(f"unknown hf2 version {version}")
    lens = np.diff(end, prepend=np.uint64(0))
    lens_lut, _ = tree.encode_tables()
    width = hf2_table_width(block_len, int(np.asarray(lens_lut).max(initial=1)))
    table_off, _, _ = write_hf2_prelude(fp, tree, orig_len, block_len,
                                        end.size, width, canonical)
    write_hf2_table_slice(fp, table_off, width, 0, lens)
    fp.seek(0, 2)
    fp.write(payload)


def read_hf2_header(fp: BinaryIO) -> Hf2Header:
    """Parse a v1 or v2 header; malformed fields raise ``ValueError``."""
    magic = fp.read(4)
    if magic not in (HF2_MAGIC, HF2_MAGIC_V1):
        raise ValueError("not an hf2 file (bad magic)")
    flags = fp.read(1)[0]
    width = 0
    if magic == HF2_MAGIC:
        width = fp.read(1)[0]
        if width not in (2, 4, 8):
            raise ValueError(f"hf2: invalid block-table width {width}")
    (tree_len,) = struct.unpack(">I", fp.read(4))
    tree_padding = fp.read(1)[0]
    (orig_len,) = struct.unpack(">Q", fp.read(8))
    (block_len,) = struct.unpack(">I", fp.read(4))
    (n_blocks,) = struct.unpack(">I", fp.read(4))
    crc_every = 0
    if magic == HF2_MAGIC and (flags & 2):
        (crc_every,) = struct.unpack(">I", fp.read(4))
        if crc_every == 0:
            raise ValueError("hf2: invalid crc_every 0")
    if magic == HF2_MAGIC:
        lens = np.frombuffer(fp.read(width * n_blocks), dtype=f">u{width}")
        if lens.size != n_blocks:
            raise ValueError("hf2: truncated block table")
        end_bits = np.cumsum(lens.astype(np.uint64))
    else:
        end_bits = np.frombuffer(fp.read(8 * n_blocks), dtype=">u8").astype(
            np.uint64
        )
    crcs = None
    if crc_every:
        n_spans = -(-n_blocks // crc_every)
        crcs = np.frombuffer(fp.read(4 * n_spans), dtype=">u4").astype(
            np.uint32
        )
        if crcs.size != n_spans:
            raise ValueError("hf2: truncated crc column")
    tree_bytes = fp.read(tree_len)
    if len(tree_bytes) != tree_len:
        raise ValueError("hf2: truncated tree")
    tree = HuffTree.try_from_bin(
        BitString.from_bytes(tree_bytes, tree_len * 8 - tree_padding)
    )
    return Hf2Header(
        tree=tree,
        canonical=bool(flags & 1),
        orig_len=orig_len,
        block_len=block_len,
        end_bits=end_bits,
        payload_offset=fp.tell(),
        crc_every=crc_every,
        crcs=crcs,
    )
