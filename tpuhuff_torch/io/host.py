"""Host side of the ``.hf2`` codec: stream helpers, the host C++ writer
and the threaded-DFA reader.

The port's copies of the host pieces of :mod:`tpuhuff.io.stream`, writing
and reading the same bytes:

* helpers the device routes share: :class:`StreamError`, the carrying
  :class:`_BitSink`, the CRC column's :class:`_CrcVerifier`, the chunk
  and block defaults;
* :func:`read_compress_write_hf2_host` — the ``device=False`` writer
  (threaded C++ block encode, one worker thread ahead of the writes);
* :func:`read_decompress_write_hf2_host` — the threaded-DFA reader.  The
  device reader hands it the cases that have no per-block device decode:
  an empty file, a one-letter tree and blocks longer than 2048 bytes.

Both run on the port's C++ host runtime (:mod:`tpuhuff_torch.native`);
there is no Python fallback.  Config 4's ``collect_hist`` option of the
JAX writer is not copied.
"""

from __future__ import annotations

import concurrent.futures
import os
import zlib
from typing import BinaryIO

import numpy as np

from .. import native
from ..core.bits import calc_padding_bits
from ..core.canonical import build_tree_for_device, canonicalize
from ..core.tree import HuffTree
from ..core.weights import ByteWeights
from .hff import (
    default_crc_every,
    hf2_table_width,
    read_hf2_header,
    write_hf2_crc_slice,
    write_hf2_prelude,
    write_hf2_table_slice,
)

__all__ = [
    "StreamError",
    "DEVICE_HF2_BLOCK",
    "HOST_HF2_BLOCK",
    "read_compress_write_hf2_host",
    "read_decompress_write_hf2_host",
]

_CHUNK = 64 << 20  # streaming granularity, independent of the block length
DEVICE_HF2_BLOCK = 256  # the device writer's default block
HOST_HF2_BLOCK = 65536  # the host writer's: per-block dispatch dominates below


class StreamError(ValueError):
    """Header and stream errors; ``kind`` names the reference's error kind
    (``InvalidHeaderInfo``, ``MissingHeaderInfo``, ``CorruptData``, ...)."""

    def __init__(self, message: str, kind: str = "Io"):
        super().__init__(message)
        self.kind = kind


def _record_call(stats: dict | None, dt: float) -> None:
    """Append one device-call wall time to ``stats["device_call_s"]``."""
    if stats is not None:
        stats.setdefault("device_call_s", []).append(dt)


def _invalid(src_path: str) -> StreamError:
    return StreamError(f"{src_path!r} stores invalid header information",
                       "InvalidHeaderInfo")


def _read_header(src: BinaryIO, src_path: str):
    """:func:`read_hf2_header`, with every malformed field raised as
    ``StreamError(kind="InvalidHeaderInfo")``."""
    try:
        return read_hf2_header(src)
    except StreamError:
        raise
    except ValueError as e:
        raise StreamError(f"{src_path!r}: {e}", "InvalidHeaderInfo") from None


def _check_sizes(hdr, src_path: str) -> None:
    """Header self-consistency, before any allocation sized from its fields."""
    if (hdr.block_len == 0 or hdr.num_blocks == 0
            or hdr.orig_len > hdr.num_blocks * hdr.block_len
            or hdr.orig_len <= (hdr.num_blocks - 1) * hdr.block_len):
        raise _invalid(src_path)


def _block_bits(hdr, src_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Each block's ``(start, end)`` payload bits; a table that runs
    backwards raises ``StreamError(kind="InvalidHeaderInfo")``."""
    ends = hdr.end_bits.astype(np.uint64)
    if ends.size and np.any(np.diff(ends.astype(np.int64)) < 0):
        raise _invalid(src_path)
    return np.concatenate([[np.uint64(0)], ends[:-1]]), ends


class _CrcVerifier:
    """Streaming verifier of the ``.hf2`` CRC column.

    Fed the decoded output in file order (any piece sizes); compares each
    completed span's CRC with the stored column and raises
    ``StreamError(kind="CorruptData")`` at the first mismatch.  Whole
    spans go through the threaded C++ CRC; ragged edges chain through
    ``zlib.crc32``.
    """

    def __init__(self, crcs: np.ndarray, span_bytes: int, path: str):
        self.crcs = np.asarray(crcs, dtype=np.uint32)
        self.span = int(span_bytes)
        self.path = path
        self.idx = 0      # next span to complete
        self.run = 0      # running CRC of the current partial span
        self.in_span = 0  # bytes fed into the current span

    def _fail(self, k: int) -> None:
        raise StreamError(
            f"{self.path!r} block CRC mismatch in span {k} "
            f"(corrupt payload or index)", "CorruptData",
        )

    def feed(self, piece) -> None:
        arr = np.frombuffer(piece, dtype=np.uint8) if isinstance(
            piece, (bytes, bytearray, memoryview)) else np.asarray(
            piece, dtype=np.uint8).reshape(-1)
        pos, n = 0, arr.size
        while pos < n:
            if self.in_span == 0 and n - pos >= self.span:
                k = (n - pos) // self.span
                got = native.crc32_blocks(arr[pos : pos + k * self.span],
                                          self.span)
                want = self.crcs[self.idx : self.idx + k]
                if want.size < k:
                    self._fail(self.idx + want.size)
                if not np.array_equal(got, want):
                    self._fail(self.idx + int(np.argmax(got != want)))
                self.idx += k
                pos += k * self.span
                continue
            take = min(self.span - self.in_span, n - pos)
            chunk = np.ascontiguousarray(arr[pos : pos + take])
            self.run = (zlib.crc32(chunk, self.run) if self.in_span
                        else zlib.crc32(chunk)) & 0xFFFFFFFF
            self.in_span += take
            pos += take
            if self.in_span == self.span:
                if (self.idx >= self.crcs.size
                        or self.run != int(self.crcs[self.idx])):
                    self._fail(self.idx)
                self.idx += 1
                self.run = 0
                self.in_span = 0

    def finish(self) -> None:
        if self.in_span:
            if (self.idx >= self.crcs.size
                    or self.run != int(self.crcs[self.idx])):
                self._fail(self.idx)
            self.idx += 1
            self.run = 0
            self.in_span = 0


class _BitSink:
    """Write a bitstream to a file through byte-aligned chunks, carrying
    the partial byte between writes."""

    def __init__(self, fp: BinaryIO):
        self.fp = fp
        self.partial = 0  # current partial byte value (high bits occupied)
        self.partial_bits = 0
        self.total_bits = 0

    def write(self, payload: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        self.total_bits += nbits
        if self.partial_bits == 0:
            full, rem = divmod(nbits, 8)
            self.fp.write(payload[:full])
            if rem:
                self.partial = payload[full]
                self.partial_bits = rem
            return
        # shift the payload right by partial_bits, OR into the partial byte
        arr = np.frombuffer(payload, dtype=np.uint8)
        s = self.partial_bits
        shifted = (arr >> s).astype(np.uint8)
        shifted |= np.concatenate(
            [np.uint8([self.partial]), (arr[:-1] << (8 - s)).astype(np.uint8)]
        )
        carry = int(arr[-1] << (8 - s)) & 0xFF
        total = s + nbits
        full, rem = divmod(total, 8)
        stream = shifted.tobytes() + bytes([carry])
        self.fp.write(stream[:full])
        self.partial = stream[full] if rem else 0
        self.partial_bits = rem

    def flush(self) -> int:
        """Write the final partial byte; returns the data padding bits."""
        if self.partial_bits:
            self.fp.write(bytes([self.partial]))
        pad = calc_padding_bits(self.total_bits)
        self.partial = 0
        self.partial_bits = 0
        return pad


def read_compress_write_hf2_host(
    src_path: str, dst_path: str, block_len: int | None = None,
    canonical: bool = True, chunk_bytes: int | None = None,
    hist_sample: int = 1, check: bool = True,
    tree: HuffTree | None = None, max_code_len: int | None = None,
) -> None:
    """Compress into ``.hf2`` on the host; the same bytes as
    ``tpuhuff.io.stream.read_compress_write_hf2(..., device=False)``.

    Pass 1 histograms the file (unless ``tree`` is given; ``hist_sample >
    1`` counts each chunk's first ``1/hist_sample`` bytes and adds one to
    every bin).  The tree is the reference's, or the optimal tree limited
    to ``max_code_len`` bits when one is given, canonicalised when
    ``canonical``.  Pass 2 encodes chunk k on a worker thread while the
    main thread writes chunk k-1 and reads chunk k+1.  ``block_len``
    defaults to 65536; ``check`` writes the CRC32 column.
    """
    if block_len is None:
        block_len = HOST_HF2_BLOCK
    size = os.path.getsize(src_path)
    n_blocks = max(1, -(-size // block_len)) if size else 1
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    crc_every = default_crc_every(block_len) if check else 0
    span_bytes = crc_every * block_len
    # a chunk is a whole number of blocks AND of CRC spans, so each chunk
    # patches its own table and CRC slices
    step_unit = span_bytes if crc_every else block_len
    step = max(1, chunk // step_unit) * step_unit
    samp = max(1, int(hist_sample))
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        if tree is None:
            bw = ByteWeights()
            left = size
            while left > 0:
                piece = src.read(min(step, left))
                if not piece:
                    break
                bw += ByteWeights.from_bytes(
                    piece if samp == 1 else piece[: max(1, len(piece) // samp)])
                left -= len(piece)
            if samp > 1 and size > 0:
                bw = ByteWeights(bw.counts + 1)  # every byte gets a code
            if max_code_len is not None:
                tree, _limited = build_tree_for_device(bw, max_len=max_code_len)
            else:
                tree = HuffTree.from_weights(bw)
        if canonical:
            tree = canonicalize(tree)
        lens_lut, codes_lut = tree.encode_tables()
        width = hf2_table_width(block_len, int(lens_lut.max(initial=1)))
        table_off, crc_off, _ = write_hf2_prelude(
            dst, tree, size, block_len, n_blocks, width, canonical,
            crc_every=crc_every,
        )
        src.seek(0)

        def encode_job(piece: bytes):
            data = np.frombuffer(piece, dtype=np.uint8)
            payload, nbits, bit_lens = native.encode_blocks_host(
                data, block_len, lens_lut, codes_lut)
            crcs = native.crc32_blocks(data, span_bytes) if crc_every else None
            return payload, nbits, bit_lens, crcs

        sink = _BitSink(dst)
        bidx = 0
        left = size
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            pending = None
            while True:
                fut = None
                if left > 0:
                    piece = src.read(min(step, left))
                    if piece:
                        left -= len(piece)
                        fut = ex.submit(encode_job, piece)
                    else:
                        left = 0
                if pending is not None:
                    payload, nbits, bit_lens, crcs = pending.result()
                    write_hf2_table_slice(dst, table_off, width, bidx, bit_lens)
                    if crcs is not None:
                        write_hf2_crc_slice(dst, crc_off, bidx // crc_every,
                                            crcs)
                    sink.write(payload, nbits)
                    bidx += bit_lens.size
                pending = fut
                if pending is None and left <= 0:
                    break
        sink.flush()


def read_decompress_write_hf2_host(
    src_path: str, dst_path: str, chunk_bytes: int | None = None,
    check: bool = True,
) -> None:
    """Decode ``.hf2`` with the threaded C++ DFA, in groups of about
    ``chunk_bytes`` output bytes; the native route of
    ``tpuhuff.io.stream.read_decompress_write_hf2(..., device=False)``.

    ``check`` verifies the CRC32 column (when present) on a worker thread,
    one group behind the decode, raising ``StreamError(kind="CorruptData")``
    on a mismatch.
    """
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        hdr = _read_header(src, src_path)
        if hdr.orig_len == 0:
            return
        _check_sizes(hdr, src_path)
        verifier = None
        if check and hdr.crcs is not None and hdr.crc_every:
            verifier = _CrcVerifier(hdr.crcs, hdr.crc_every * hdr.block_len,
                                    src_path)
        if hdr.tree.is_leaf(hdr.tree.root):
            letter = bytes([int(hdr.tree.letters[hdr.tree.root])])
            left = hdr.orig_len
            while left > 0:
                n = min(left, _CHUNK)
                dst.write(letter * n)
                if verifier is not None:
                    verifier.feed(letter * n)
                left -= n
            if verifier is not None:
                verifier.finish()
            return
        starts, ends = _block_bits(hdr, src_path)
        B = hdr.num_blocks
        tables = native.build_dfa(hdr.tree)
        gsize = max(1, chunk // hdr.block_len)
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        pending_v = None
        try:
            for g0 in range(0, B, gsize):
                g1 = min(g0 + gsize, B)
                byte_lo = int(starts[g0]) // 8
                byte_hi = (int(ends[g1 - 1]) + 7) // 8
                src.seek(hdr.payload_offset + byte_lo)
                buf = np.frombuffer(src.read(byte_hi - byte_lo), dtype=np.uint8)
                if buf.size < byte_hi - byte_lo:
                    raise StreamError(f"{src_path!r} truncated payload",
                                      "MissingHeaderInfo")
                ls = starts[g0:g1] - np.uint64(byte_lo * 8)
                le = ends[g0:g1] - np.uint64(byte_lo * 8)
                nb = g1 - g0
                caps = np.full(nb, hdr.block_len, dtype=np.uint64)
                if g1 == B:
                    caps[-1] = hdr.orig_len - (B - 1) * hdr.block_len
                offs = np.arange(nb, dtype=np.uint64) * hdr.block_len
                try:
                    out, out_lens = native.decode_blocks(buf, ls, le, tables,
                                                         offs, caps)
                except RuntimeError:
                    # a corrupt payload can overflow a block's output slot
                    raise _invalid(src_path) from None
                if not np.array_equal(out_lens, caps):
                    raise StreamError(
                        f"{src_path!r} block decode length mismatch",
                        "InvalidHeaderInfo")
                piece = out[: int(caps.sum())]
                dst.write(piece.tobytes())
                if verifier is not None:
                    if pending_v is not None:
                        pending_v.result()  # surfaces CorruptData
                    # each group's `out` is a fresh buffer, so the view stays
                    pending_v = pool.submit(verifier.feed, piece)
            if pending_v is not None:
                pending_v.result()
            if verifier is not None:
                verifier.finish()
        finally:
            pool.shutdown(wait=False)
