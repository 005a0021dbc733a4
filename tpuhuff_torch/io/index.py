"""The ``.hff`` block index: a ``.hf2`` around a ``.hff``'s own tree and
payload bits, built without recompressing.

The port's copy of the sidecar code of :mod:`tpuhuff.io.stream`, writing
the same bytes and raising the same error kinds:

* :func:`transcode_hff_to_hf2` — re-index a ``.hff`` into ``.hf2``; the
  container's non-canonical tree then decodes on the card with the
  general decoder (K4), or block-parallel on the host;
* :func:`decode_hff_indexed` — decode a ``.hff`` and write its index
  (the ``<src>.hf2x`` sidecar of :func:`.host.read_decompress_write`) in
  the same walk;
* :func:`_sidecar_matches` — the content check that a sidecar was built
  from this source.

The walk is the C++ DFA of :mod:`tpuhuff_torch.native`: ``spec_index``
finds each window's block boundaries on all threads and
``decode_blocks`` decodes the blocks; where that plan does not apply, the
serial ``decode_index`` walk does both.  No torch is imported.
"""

from __future__ import annotations

import os
from typing import BinaryIO

import numpy as np

from .. import native
from ..core.tree import HuffTree
from .hff import (
    default_crc_every,
    hf2_table_width,
    read_hf2_header,
    write_hf2_crc_slice,
    write_hf2_prelude,
    write_hf2_table_slice,
)
from .host import (
    _CHUNK,
    HOST_HF2_BLOCK,
    StreamError,
    _CrcCollector,
    _invalid,
    _read_hff_header,
    _Window,
)

__all__ = ["decode_hff_indexed", "transcode_hff_to_hf2"]

def _sidecar_matches(src_path: str, sidecar: str) -> bool:
    """Whether the ``.hf2x`` ``sidecar`` was built from this source.

    A timestamp is not enough (``cp -p``, ``rsync -t`` and ``tar -x``
    keep one), so the tree bits, the payload bit count and 16 payload
    regions of 4 KiB (the first, the last and 14 evenly spread; seeks,
    not a full read) are compared.  A source that differs only between
    those regions passes; decoding it against the sidecar's CRC column,
    which was computed from the original's decode, then raises
    ``CorruptData`` (or the decode is the same bytes anyway)."""
    try:
        with open(src_path, "rb") as s:
            tree, data_padding, header_len = _read_hff_header(s, src_path)
            plen = os.path.getsize(src_path) - header_len
            total_bits = max(plen * 8 - data_padding, 0)
            with open(sidecar, "rb") as f:
                hdr = read_hf2_header(f)
                if hdr.total_bits != total_bits:
                    return False
                if hdr.tree.as_bin().to_bytes() != tree.as_bin().to_bytes():
                    return False
                offs = {0, max(0, plen - 4096)}
                for k in range(1, 15):
                    offs.add(max(0, (plen * k) // 15 - 2048))
                for off in sorted(offs):
                    s.seek(header_len + off)
                    f.seek(hdr.payload_offset + off)
                    n = min(4096, plen - off)
                    if s.read(n) != f.read(n):
                        return False
        return True
    except (OSError, StreamError, ValueError):
        return False


def _write_hf2_from_hff(
    dst_path: str, src: BinaryIO, header_len: int, tree: HuffTree,
    total_bits: int, boundaries: np.ndarray, in_block: int, block_len: int,
    crcs: np.ndarray | None, crc_every: int, chunk: int,
) -> None:
    """Write a ``.hf2`` around a ``.hff``'s tree and its payload bits,
    copied verbatim, from a block index already walked (and a CRC column
    or None)."""
    orig_len = boundaries.size * block_len + in_block
    if in_block or not boundaries.size:
        # the last, partial block ends at total_bits
        end_bits = np.concatenate(
            [boundaries, [np.uint64(total_bits)]]).astype(np.uint64)
    else:
        # the last block is whole: it takes the trailing bits (the byte
        # padding, and a malformed source's partial last code), at most
        # (max code length - 1) + 7 bits, which hf2_table_width allows for
        end_bits = boundaries.copy()
        end_bits[-1] = total_bits
    n_blocks = max(end_bits.size, 1)
    lens_lut, _ = tree.encode_tables()
    width = hf2_table_width(block_len, int(np.asarray(lens_lut).max(initial=1)))
    with open(dst_path, "wb") as dst:
        table_off, crc_off, _ = write_hf2_prelude(
            dst, tree, orig_len, block_len, n_blocks, width, canonical=False,
            crc_every=crc_every if crcs is not None else 0)
        write_hf2_table_slice(dst, table_off, width, 0,
                              np.diff(end_bits, prepend=np.uint64(0)))
        if crcs is not None and crcs.size:
            write_hf2_crc_slice(dst, crc_off, 0, crcs)
        src.seek(header_len)
        left = (total_bits + 7) // 8
        while left > 0:
            piece = src.read(min(left, chunk))
            if not piece:
                break
            dst.write(piece)
            left -= len(piece)


def _hff_walk_parallel(
    src: BinaryIO, src_path: str, tree: HuffTree, total_bits: int,
    block_len: int, chunk: int, on_output,
) -> tuple[np.ndarray, int]:
    """Index and decode a ``.hff`` payload on all threads, window by
    window: ``spec_index`` finds the block boundaries, ``decode_blocks``
    decodes the blocks and ``on_output`` gets their bytes in order.  The
    next window starts at the last boundary, so at most one block per
    window is walked twice.  Returns ``(boundaries, tail_letters)``, the
    absolute boundary bits and the last block's letter count.

    Raises ``RuntimeError`` (not :class:`StreamError`) where the input
    defeats this plan; the callers then take :func:`_hff_walk_serial`."""
    tables = native.build_dfa(tree)
    window = _Window(src, total_bits, chunk)
    bounds_parts = []
    pos_bit = 0
    tail_letters = 0
    while pos_bit < total_bits:
        arr, end_bit = window.slide(pos_bit)
        base = window.byte0 * 8
        bounds, _, _ = native.spec_index(arr, pos_bit - base, end_bit - base,
                                         tables, block_len, 0)
        final = end_bit == total_bits
        if bounds.size == 0 and not final:
            raise RuntimeError("block spans a whole window")
        ls = (np.concatenate([[np.uint64(pos_bit - base)], bounds[:-1]])
              if bounds.size else np.asarray([pos_bit - base], np.uint64))
        le = bounds.copy() if bounds.size else np.zeros(0, np.uint64)
        if final:
            if bounds.size:
                ls = np.append(ls, np.uint64(int(bounds[-1])))
            le = np.append(le, np.uint64(end_bit - base))
        nb = ls.size
        caps = np.full(nb, block_len, dtype=np.uint64)
        offs = np.arange(nb, dtype=np.uint64) * np.uint64(block_len)
        out, out_lens = native.decode_blocks(arr, ls.astype(np.uint64),
                                             le.astype(np.uint64), tables,
                                             offs, caps)
        n_complete = nb - (1 if final else 0)
        if not np.all(out_lens[:n_complete] == block_len):
            raise RuntimeError("boundary/letter-count disagreement")
        on_output(out[: int(out_lens.sum())])
        if bounds.size:
            bounds_parts.append(bounds + np.uint64(base))
        if final:
            tail_letters = int(out_lens[-1])
            break
        new_pos = int(bounds[-1]) + base
        if new_pos <= pos_bit:
            raise _invalid(src_path)
        pos_bit = new_pos
    boundaries = (np.concatenate(bounds_parts) if bounds_parts
                  else np.zeros(0, np.uint64))
    return boundaries, tail_letters


def _hff_walk_serial(
    src: BinaryIO, src_path: str, tree: HuffTree, total_bits: int,
    block_len: int, chunk: int, on_output,
) -> tuple[np.ndarray, int]:
    """The serial walk (``decode_index``: decode and index in one DFA
    pass) behind :func:`_hff_walk_parallel`, with its contract."""
    tables = native.build_dfa(tree)
    window = _Window(src, total_bits, chunk)
    bounds_parts = []
    pos_bit = 0
    in_block = 0
    while pos_bit < total_bits:
        arr, end_bit = window.slide(pos_bit)
        base = window.byte0 * 8
        out, bounds, resume, in_block = native.decode_index(
            arr, pos_bit - base, end_bit - base, tables, end_bit - pos_bit,
            block_len, in_block)
        on_output(out)
        if bounds.size:
            bounds_parts.append(bounds + np.uint64(base))
        if end_bit == total_bits:
            break
        new_pos = resume + base
        if new_pos <= pos_bit:
            raise _invalid(src_path)
        pos_bit = new_pos
    boundaries = (np.concatenate(bounds_parts) if bounds_parts
                  else np.zeros(0, np.uint64))
    return boundaries, in_block


def _walk(src: BinaryIO, src_path: str, tree: HuffTree, total_bits: int,
          header_len: int, block_len: int, chunk: int, emit, restart):
    """The parallel walk, or the serial one where it does not apply
    (``restart()`` first undoes what the parallel walk emitted).  Returns
    ``(boundaries, in_block, collector)``."""
    span = default_crc_every(block_len) * block_len
    collector = _CrcCollector(span)

    def on_output(piece) -> None:
        emit(piece)
        collector.feed(piece)

    try:
        bounds, in_block = _hff_walk_parallel(
            src, src_path, tree, total_bits, block_len, chunk, on_output)
    except RuntimeError:
        restart()
        src.seek(header_len)
        collector = _CrcCollector(span)
        bounds, in_block = _hff_walk_serial(
            src, src_path, tree, total_bits, block_len, chunk, on_output)
    return bounds, in_block, collector


def decode_hff_indexed(
    src_path: str, dst_path: str, sidecar_path: str,
    block_len: int = HOST_HF2_BLOCK, chunk_bytes: int | None = None,
) -> bool:
    """Decode a ``.hff`` into ``dst_path`` and write its block index to
    ``sidecar_path`` (a ``.hf2``: prelude, tables, then the payload copied
    verbatim) from the same walk.  Returns True if the sidecar was written;
    an I/O error on the sidecar is swallowed, since the decoded output is
    complete without it.  A malformed source raises :class:`StreamError`."""
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    size = os.path.getsize(src_path)
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        tree, data_padding, header_len = _read_hff_header(src, src_path)
        total_bits = max((size - header_len) * 8 - data_padding, 0)

        def emit(piece) -> None:
            dst.write(piece.tobytes() if isinstance(piece, np.ndarray)
                      else piece)

        def restart() -> None:
            dst.seek(0)
            dst.truncate()

        bounds, in_block, collector = _walk(
            src, src_path, tree, total_bits, header_len, block_len, chunk,
            emit, restart)
        try:
            _write_hf2_from_hff(sidecar_path, src, header_len, tree,
                                total_bits, bounds, in_block, block_len,
                                collector.finish(),
                                default_crc_every(block_len), chunk)
        except OSError:
            return False
    return True


def transcode_hff_to_hf2(
    src_path: str, dst_path: str, block_len: int = HOST_HF2_BLOCK,
    chunk_bytes: int | None = None,
) -> None:
    """Re-index a ``.hff`` into ``.hf2`` without recompressing.

    One walk of the payload with the decoding DFA records the bit offset
    after every ``block_len``-th letter and the CRC32s of the decoded
    spans (the decoded bytes are dropped); then the same tree and payload
    bits are written inside the block-indexed container, CRC column
    included.  The tree is the ``.hff``'s, not canonicalised, so on the
    card the container decodes with the general decoder (K4).  Memory is
    ``O(chunk_bytes)`` plus 8 bytes per block."""
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    size = os.path.getsize(src_path)
    with open(src_path, "rb") as src:
        tree, data_padding, header_len = _read_hff_header(src, src_path)
        total_bits = max((size - header_len) * 8 - data_padding, 0)
        bounds, in_block, collector = _walk(
            src, src_path, tree, total_bits, header_len, block_len, chunk,
            lambda piece: None, lambda: None)
        _write_hf2_from_hff(dst_path, src, header_len, tree, total_bits,
                            bounds, in_block, block_len, collector.finish(),
                            default_crc_every(block_len), chunk)
