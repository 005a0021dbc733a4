"""Host side of the codec: stream helpers, the host C++ writers and the
threaded-DFA readers.

The port's copies of the host pieces of :mod:`tpuhuff.io.stream`, writing
and reading the same bytes:

* helpers the device routes share: :class:`StreamError`, the carrying
  :class:`_BitSink`, the CRC column's :class:`_CrcVerifier`, the chunk
  and block defaults, K1's lane (:func:`lane_of`), pass 1's sampled
  reads (:func:`_sampled_pieces`), the writers' reads (:func:`_pieces`)
  and the one double-buffered loop of every file call (:func:`_pipeline`);
* :func:`read_compress_write_hf2_host` — the ``.hf2`` ``device=False``
  writer (threaded C++ block encode, one worker thread ahead of the
  writes), with config 4's ``collect_hist``;
* :func:`read_decompress_write_hf2_host` — the threaded-DFA ``.hf2``
  reader.  The device reader hands it the cases that have no per-block
  device decode: an empty file, a one-letter tree and, on a device other
  than CUDA, blocks longer than 2048 bytes;
* :func:`read_compress_write_host` and :func:`read_decompress_write` — the
  reference's ``.hff`` format: the ``device=False`` writer, and the reader,
  which indexes a large ``.hff`` into a ``<src>.hf2x`` sidecar on its
  first decode and reuses it after (:mod:`.index`);
* :func:`huff_tree_from_stream` — pass 1 of the ``.hff`` writers.

All run on the port's C++ host runtime (:mod:`tpuhuff_torch.native`);
there is no Python fallback.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import zlib
from typing import BinaryIO

import numpy as np

from .. import native
from ..core.bits import BitString, calc_padding_bits
from ..core.canonical import build_tree_for_device, canonicalize
from ..core.tree import FromBinError, HuffTree
from ..core.weights import ByteWeights
from ..profiling import span, tracing
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
    "AUTO_INDEX_MIN",
    "DEFAULT_BLOCK",
    "DEVICE_HF2_BLOCK",
    "HOST_HF2_BLOCK",
    "read_compress_write_hf2_host",
    "read_decompress_write_hf2_host",
    "read_compress_write_host",
    "read_decompress_write",
    "huff_tree_from_stream",
]

_CHUNK = 64 << 20  # streaming granularity, independent of the block length
_PASS1_PIECE = 256 << 20  # pass 1 reads (and samples) at most this at once
DEFAULT_BLOCK = 2_000_000_000  # the reference's default block size ("2G")
DEVICE_HF2_BLOCK = 256  # the device writer's default block
HOST_HF2_BLOCK = 65536  # the host writer's: per-block dispatch dominates below
# a .hff payload of at least this many bytes is indexed into a sidecar on
# its first decode (one extra payload copy then; block-parallel decodes
# from then on)
AUTO_INDEX_MIN = 32 << 20


def lane_of(block_len: int) -> int:
    """K1's lane for blocks of ``block_len``: the largest power of two
    that divides it, at most the device writer's block (256 bytes); the
    lanes of every device writer and pipeline."""
    return min(block_len & -block_len, DEVICE_HF2_BLOCK)


class StreamError(ValueError):
    """Header and stream errors; ``kind`` names the reference's error kind
    (``InvalidHeaderInfo``, ``MissingHeaderInfo``, ``CorruptData``, ...)."""

    def __init__(self, message: str, kind: str = "Io"):
        super().__init__(message)
        self.kind = kind


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


class _CrcCollector:
    """Producer of the ``.hf2`` CRC column: fed the decoded bytes in file
    order (any piece sizes), it keeps one CRC32 per ``span_bytes``.  Whole
    spans go through the threaded C++ CRC; ragged edges chain through
    ``zlib.crc32``."""

    def __init__(self, span_bytes: int):
        self.span = int(span_bytes)
        self.crcs: list = []
        self.run = 0      # running CRC of the current partial span
        self.in_span = 0  # bytes fed into the current span

    def feed(self, piece) -> None:
        arr = np.frombuffer(piece, dtype=np.uint8) if isinstance(
            piece, (bytes, bytearray, memoryview)) else np.asarray(
            piece, dtype=np.uint8).reshape(-1)
        pos, n = 0, arr.size
        while pos < n:
            if self.in_span == 0 and n - pos >= self.span:
                k = (n - pos) // self.span
                self.crcs.extend(native.crc32_blocks(
                    arr[pos : pos + k * self.span], self.span).tolist())
                pos += k * self.span
                continue
            take = min(self.span - self.in_span, n - pos)
            chunk = np.ascontiguousarray(arr[pos : pos + take])
            self.run = (zlib.crc32(chunk, self.run) if self.in_span
                        else zlib.crc32(chunk)) & 0xFFFFFFFF
            self.in_span += take
            pos += take
            if self.in_span == self.span:
                self.crcs.append(self.run)
                self.run = 0
                self.in_span = 0

    def finish(self) -> np.ndarray:
        if self.in_span:
            self.crcs.append(self.run)
            self.run = 0
            self.in_span = 0
        return np.asarray(self.crcs, dtype=np.uint32)


class _CrcVerifier:
    """Streaming verifier of the ``.hf2`` CRC column.

    Fed the decoded output in file order (any piece sizes), it computes
    the spans' CRCs with a :class:`_CrcCollector` and compares each
    completed span's with the stored column, raising
    ``StreamError(kind="CorruptData")`` at the first mismatch (or at the
    first span past the column's end).
    """

    def __init__(self, crcs: np.ndarray, span_bytes: int, path: str):
        self.crcs = np.asarray(crcs, dtype=np.uint32)
        self.path = path
        self.collector = _CrcCollector(span_bytes)
        self.idx = 0  # spans checked so far

    def _fail(self, k: int) -> None:
        raise StreamError(
            f"{self.path!r} block CRC mismatch in span {k} "
            f"(corrupt payload or index)", "CorruptData",
        )

    def _check(self) -> None:
        """Compare the spans completed since the last check, then drop
        them, so that memory stays bounded whatever the file's size."""
        got = np.asarray(self.collector.crcs, dtype=np.uint32)
        self.collector.crcs.clear()
        want = self.crcs[self.idx : self.idx + got.size]
        if want.size < got.size:
            self._fail(self.idx + want.size)
        if not np.array_equal(got, want):
            self._fail(self.idx + int(np.argmax(got != want)))
        self.idx += got.size

    def feed(self, piece) -> None:
        self.collector.feed(piece)
        self._check()

    def finish(self) -> None:
        self.collector.finish()
        self._check()


class _BitSink:
    """Write a bitstream to a file through byte-aligned chunks, carrying
    the partial byte between writes."""

    def __init__(self, fp: BinaryIO):
        self.fp = fp
        self.partial = 0  # current partial byte value (high bits occupied)
        self.partial_bits = 0
        self.total_bits = 0

    def write_aligned(self, full, nbits: int, partial: int,
                      partial_bits: int) -> None:
        """Append ``nbits`` bits whose stream starts at the partial byte:
        ``full`` (bytes or a uint8 array) are the stream's whole bytes, the
        first completing the sink's partial byte, and ``partial`` (its bits
        high) with ``partial_bits`` (0-7) is the new partial byte, written
        by the next call or by :meth:`flush`.  Nothing is shifted: the
        device stitch has placed the carried bits (``tpuhuff_torch.kernels.
        stitch_lanes``)."""
        if self.partial_bits + nbits != 8 * len(full) + partial_bits:
            raise ValueError("write_aligned: the bytes do not continue the "
                             "sink's partial byte")
        self.total_bits += nbits
        self.fp.write(full)
        self.partial = partial
        self.partial_bits = partial_bits

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


class _Hf2Sink:
    """Write side of a ``.hf2`` writer after its prelude: each chunk's
    block-table and CRC slices are patched in place, then its payload bits
    are appended."""

    def __init__(self, dst: BinaryIO, table_off: int, crc_off: int,
                 width: int, crc_every: int):
        self.dst = dst
        self.table_off, self.crc_off = table_off, crc_off
        self.width, self.crc_every = width, crc_every
        self.bits = _BitSink(dst)
        self.bidx = 0  # first block of the next chunk

    def _patch(self, bit_lens: np.ndarray, crcs: np.ndarray | None) -> None:
        write_hf2_table_slice(self.dst, self.table_off, self.width, self.bidx,
                              bit_lens)
        if crcs is not None:
            write_hf2_crc_slice(self.dst, self.crc_off,
                                self.bidx // self.crc_every, crcs)
        self.bidx += bit_lens.size

    def write(self, payload: bytes, nbits: int, bit_lens: np.ndarray,
              crcs: np.ndarray | None) -> None:
        self._patch(bit_lens, crcs)
        self.bits.write(payload, nbits)

    def write_aligned(self, full, nbits: int, partial: int, partial_bits: int,
                      bit_lens: np.ndarray, crcs: np.ndarray | None) -> None:
        """:meth:`write` for the device writers' byte-aligned chunks
        (:meth:`_BitSink.write_aligned`)."""
        self._patch(bit_lens, crcs)
        self.bits.write_aligned(full, nbits, partial, partial_bits)

    def finish(self) -> None:
        self.bits.flush()


def _start_hf2(dst: BinaryIO, tree: HuffTree, size: int, block_len: int,
               canonical: bool, crc_every: int) -> tuple[HuffTree, _Hf2Sink]:
    """Canonicalise ``tree`` when ``canonical`` and write the ``.hf2``
    prelude; returns the tree to encode with and the sink of the chunks
    (spans ``tree``, the canonicalisation, inside ``prelude``)."""
    with span("prelude"):
        if canonical:
            with span("tree"):
                tree = canonicalize(tree)
        lens_lut, _ = tree.encode_tables()
        width = hf2_table_width(block_len, int(lens_lut.max(initial=1)))
        n_blocks = max(1, -(-size // block_len)) if size else 1
        table_off, crc_off, _ = write_hf2_prelude(
            dst, tree, size, block_len, n_blocks, width, canonical,
            crc_every=crc_every,
        )
        return tree, _Hf2Sink(dst, table_off, crc_off, width, crc_every)


class _HffSink(_BitSink):
    """Write side of a ``.hff`` writer: the header (padding byte, tree
    length, tree; `huff/src/comp.rs:54-59`), the payload bits, then the
    padding byte patched (`comp.rs:69-70`)."""

    def __init__(self, dst: BinaryIO, tree: HuffTree):
        tree_bin = tree.as_bin()
        self.tree_padding = calc_padding_bits(len(tree_bin))
        tree_bytes = tree_bin.to_bytes()
        dst.write(b"\x00")  # the padding byte, patched by finish()
        dst.write(len(tree_bytes).to_bytes(4, "big"))
        dst.write(tree_bytes)
        super().__init__(dst)

    def finish(self) -> None:
        data_padding = self.flush()
        self.fp.seek(0)
        self.fp.write(bytes([(self.tree_padding << 4) | data_padding]))


def _chunk_step(block_len: int, chunk_bytes: int | None,
                check: bool) -> tuple[int, int, int]:
    """``(step, crc_every, span_bytes)`` of a ``.hf2`` writer: a chunk is
    a whole number of blocks AND of CRC spans, so each chunk patches its
    own table and CRC slices."""
    chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
    crc_every = default_crc_every(block_len) if check else 0
    span_bytes = crc_every * block_len
    step_unit = span_bytes if crc_every else block_len
    return max(1, chunk // step_unit) * step_unit, crc_every, span_bytes


def _sampled_pieces(fp: BinaryIO, size: int, step: int, hist_sample: int = 1):
    """Pass 1's reads: up to ``size`` bytes of ``fp``, in pieces of
    ``min(step, 256 MiB)``, each cut to its first ``1/hist_sample`` (at
    least one byte).  The 256 MiB cap is the JAX writers' (their device
    histogram counts in int32), so ``hist_sample > 1`` samples the same
    bytes whatever the chunk size."""
    samp = max(1, int(hist_sample))
    piece_len = min(step, _PASS1_PIECE)
    left = size
    while left > 0:
        piece = fp.read(min(piece_len, left))
        if not piece:
            break
        left -= len(piece)
        yield piece if samp == 1 else piece[: max(1, len(piece) // samp)]


def _weights_from_stream(fp: BinaryIO, size: int, step: int,
                         hist_sample: int = 1) -> ByteWeights:
    """Pass 1 on the host: the counts of :func:`_sampled_pieces`, plus one
    in every bin when sampled (so that every byte gets a code)."""
    bw = ByteWeights()
    for piece in _sampled_pieces(fp, size, step, hist_sample):
        bw += ByteWeights.from_bytes(piece)
    if max(1, int(hist_sample)) > 1 and size > 0:
        bw = ByteWeights(bw.counts + 1)
    return bw


def huff_tree_from_stream(fp: BinaryIO, size: int, block_size: int,
                          hist_sample: int = 1) -> HuffTree:
    """Pass 1 of the ``.hff`` writers: the reference's tree of the first
    ``size`` bytes of ``fp``, counted in pieces of ``min(block_size,
    64 MiB)`` (``hist_sample > 1``: the first ``1/hist_sample`` of each
    piece, plus one in every bin)."""
    return HuffTree.from_weights(_weights_from_stream(
        fp, size, min(block_size, _CHUNK), hist_sample))


def _timed(timer):
    """``tracing(timer)`` for a writer given a ``timer``; without one the
    active tracer, if any, stays."""
    return tracing(timer) if timer is not None else contextlib.nullcontext()


def _host_tree(bw: ByteWeights, max_code_len: int | None) -> HuffTree:
    """The host writers' tree: the reference's, or the optimal tree limited
    to ``max_code_len`` bits when one is given."""
    if max_code_len is not None:
        return build_tree_for_device(bw, max_len=max_code_len)[0]
    return HuffTree.from_weights(bw)


def _pieces(src: BinaryIO, size: int, step: int, read=None):
    """The writers' reads: up to ``size`` bytes of ``src`` in ``step``
    pieces, each a uint8 array, until the file ends.  ``read(n, slot)``,
    where given, reads a piece of at most ``n`` bytes in place of
    ``src.read``, ``slot`` alternating 0, 1 as in :func:`_pipeline`: the
    device writers read straight into the slot's pinned buffer."""
    left, k = size, 0
    while left > 0:
        n = min(step, left)
        piece = (read(n, k % 2) if read is not None else
                 np.frombuffer(src.read(n), dtype=np.uint8))
        if not piece.size:
            return
        left -= piece.size
        k += 1
        yield piece


def _pipeline(items, submit, collect) -> None:
    """The one double-buffered loop of the file calls: item k+1 is drawn
    from ``items`` and handed to ``submit(item, slot)`` before ``collect``
    takes item k's handle, so that the work on one item (on a worker
    thread, or on the card) overlaps the collect of the one before it;
    ``slot`` alternates 0, 1, and the last handle is collected at the
    end.  Drawing an item may read it (:func:`_pieces`)."""
    pending = None
    for k, item in enumerate(items):
        handle = submit(item, k % 2)
        if pending is not None:
            collect(pending)
        pending = handle
    if pending is not None:
        collect(pending)


def read_compress_write_hf2_host(
    src_path: str, dst_path: str, block_len: int | None = None,
    canonical: bool = True, chunk_bytes: int | None = None,
    hist_sample: int = 1, check: bool = True,
    tree: HuffTree | None = None, max_code_len: int | None = None,
    collect_hist: bool = False,
) -> np.ndarray | None:
    """Compress into ``.hf2`` on the host; the same bytes as
    ``tpuhuff.io.stream.read_compress_write_hf2(..., device=False)``.

    Pass 1 histograms the file (unless ``tree`` is given; ``hist_sample >
    1`` counts the first ``1/hist_sample`` of each piece of
    :func:`_sampled_pieces` and adds one to every bin).  The tree is the
    reference's, or the optimal tree limited to ``max_code_len`` bits when
    one is given, canonicalised when ``canonical``.  Pass 2 encodes chunk k
    on a worker thread while the main thread writes chunk k-1 and reads
    chunk k+1.  ``block_len`` defaults to 65536; ``check`` writes the
    CRC32 column.  Returns the file's exact (256,) int64 histogram, counted
    during pass 2, when ``collect_hist``, else None.
    """
    if block_len is None:
        block_len = HOST_HF2_BLOCK
    size = os.path.getsize(src_path)
    step, crc_every, span_bytes = _chunk_step(block_len, chunk_bytes, check)
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        if tree is None:
            tree = _host_tree(_weights_from_stream(src, size, step, hist_sample),
                              max_code_len)
        tree, sink = _start_hf2(dst, tree, size, block_len, canonical,
                                crc_every)
        lens_lut, codes_lut = tree.encode_tables()
        src.seek(0)
        hist = np.zeros(256, dtype=np.int64) if collect_hist else None

        def encode_job(data: np.ndarray):
            payload, nbits, bit_lens = native.encode_blocks_host(
                data, block_len, lens_lut, codes_lut)
            crcs = native.crc32_blocks(data, span_bytes) if crc_every else None
            counts = native.hist(data) if collect_hist else None
            return payload, nbits, bit_lens, crcs, counts

        def collect(fut) -> None:
            payload, nbits, bit_lens, crcs, counts = fut.result()
            if counts is not None:
                hist[:] += counts
            sink.write(payload, nbits, bit_lens, crcs)

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            _pipeline(_pieces(src, size, step),
                      lambda data, slot: ex.submit(encode_job, data), collect)
        sink.finish()
    return hist


def read_compress_write_host(
    src_path: str, dst_path: str, block_size: int = DEFAULT_BLOCK,
    hist_sample: int = 1, tree: HuffTree | None = None,
    max_code_len: int | None = None, timer=None,
) -> None:
    """Compress into the reference's ``.hff`` format on the host; the same
    bytes as ``tpuhuff.io.stream.read_compress_write(..., device=False)``.

    Pass 1 (unless ``tree`` is given) counts the file in pieces of
    ``min(block_size, 64 MiB)``, sampled as in
    :func:`read_compress_write_hf2_host`; the tree is the reference's, or
    limited to ``max_code_len`` bits.  A ``tree`` with no code for some
    byte of the file raises :class:`CompressError`.  Pass 2 encodes piece
    k on a worker thread while piece k-1 is written.  A ``timer``
    (:class:`tpuhuff_torch.profiling.StageTimer`) is made the active tracer
    for the call, and records the stages ``histogram`` and ``write``.
    """
    size = os.path.getsize(src_path)
    step = min(block_size, _CHUNK)
    with _timed(timer), open(src_path, "rb") as src, \
            open(dst_path, "wb") as dst:
        if tree is None:
            with span("histogram", size):
                bw = _weights_from_stream(src, size, step, hist_sample)
            tree = _host_tree(bw, max_code_len)
        sink = _HffSink(dst, tree)
        lens_lut, codes_lut = tree.encode_tables()
        src.seek(0)

        def encode_job(data: np.ndarray):
            payload, pad = native.encode(data, lens_lut, codes_lut)
            return payload, len(payload) * 8 - pad

        def collect(fut) -> None:
            payload, nbits = fut.result()
            with span("write", (nbits + 7) // 8):
                sink.write(payload, nbits)

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            _pipeline(_pieces(src, size, step),
                      lambda data, slot: ex.submit(encode_job, data), collect)
        sink.finish()


def read_decompress_write_hf2_host(
    src_path: str, dst_path: str, chunk_bytes: int | None = None,
    check: bool = True, threads: int | None = None,
) -> None:
    """Decode ``.hf2`` with the threaded C++ DFA (``threads`` threads, by
    default one per core), in groups of about ``chunk_bytes`` output
    bytes; the native route of
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
                                                         offs, caps, threads)
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


class _Window:
    """The payload window of a ``.hff`` walk: the whole bytes before
    ``pos_bit`` are dropped, and up to ``step`` more are read ahead."""

    def __init__(self, src: BinaryIO, total_bits: int, step: int):
        self.src, self.total_bits, self.step = src, total_bits, step
        self.data = b""
        self.byte0 = 0  # payload byte index of data[0]

    def slide(self, pos_bit: int) -> tuple[np.ndarray, int]:
        """``(bytes, end_bit)``: the window from ``pos_bit``'s byte, and
        the payload bit it ends at; local bit offsets subtract
        ``8 * byte0``."""
        drop = pos_bit // 8 - self.byte0
        if drop > 0:
            self.data = self.data[drop:]
            self.byte0 += drop
        want_end = min(self.byte0 + len(self.data) + self.step,
                       (self.total_bits + 7) // 8)
        need = want_end - (self.byte0 + len(self.data))
        if need > 0:
            self.data += self.src.read(need)
        end_bit = min((self.byte0 + len(self.data)) * 8, self.total_bits)
        return np.frombuffer(self.data, dtype=np.uint8), end_bit


def _read_hff_header(src: BinaryIO, src_path: str):
    """Parse a ``.hff`` header: padding byte, tree length, tree
    (`huff/src/comp.rs:92-145`).  Returns ``(tree, data_padding,
    header_len)``."""
    head = src.read(5)
    if len(head) < 5:
        raise StreamError(
            f"{src_path!r} too short to decompress, missing header information",
            "MissingHeaderInfo",
        )
    tree_padding = head[0] >> 4
    data_padding = head[0] & 0x0F
    if tree_padding > 7 or data_padding > 7:
        raise _invalid(src_path)
    tree_len = int.from_bytes(head[1:5], "big")
    tree_bytes = src.read(tree_len)
    if len(tree_bytes) < tree_len:
        raise StreamError(
            f"{src_path!r} too short to decompress, missing header information",
            "MissingHeaderInfo",
        )
    try:
        tree = HuffTree.try_from_bin(
            BitString.from_bytes(tree_bytes, tree_len * 8 - tree_padding))
    except (FromBinError, ValueError):
        raise _invalid(src_path) from None
    return tree, data_padding, 5 + tree_len


def _decode_with_sidecar(src_path: str, dst_path: str,
                         stats: dict | None) -> bool:
    """The sidecar route of :func:`read_decompress_write`: False where
    the serial decode must run after all."""
    from .index import _sidecar_matches, decode_hff_indexed

    sidecar = src_path + ".hf2x"
    try:
        fresh = (os.path.exists(sidecar)
                 and os.path.getmtime(sidecar) >= os.path.getmtime(src_path)
                 and _sidecar_matches(src_path, sidecar))
    except OSError:
        fresh = False
    if fresh:
        try:
            read_decompress_write_hf2_host(sidecar, dst_path)
            if stats is not None:
                stats["auto_index"] = "reused"
            return True
        except StreamError:
            # a bad sidecar is not a bad source: drop it and build it again
            try:
                os.remove(sidecar)
            except OSError:
                pass
    # a name of this process's own, so that two decoders never write into
    # one file (a torn sidecar would be served to later decodes)
    tmp = f"{sidecar}.tmp.{os.getpid()}"
    try:
        try:
            wrote = decode_hff_indexed(src_path, dst_path, tmp)
        except StreamError:
            raise  # a malformed source: the serial decode's error
        except Exception:  # noqa: BLE001 - the serial decode runs instead
            if stats is not None:
                stats["auto_index"] = "failed"
            return False
        if wrote:
            try:
                os.replace(tmp, sidecar)
            except OSError:
                wrote = False
        if stats is not None:
            stats["auto_index"] = "created" if wrote else "nosidecar"
        return True
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def read_decompress_write(
    src_path: str, dst_path: str, block_size: int = DEFAULT_BLOCK,
    auto_index: bool | None = None, stats: dict | None = None,
) -> None:
    """Decode a ``.hff`` file, streaming; the same bytes as
    ``tpuhuff.io.stream.read_decompress_write`` (`huff/src/comp.rs:79-157`).

    ``auto_index`` (by default: a file of at least :data:`AUTO_INDEX_MIN`
    bytes): a ``.hff`` has no block boundaries, so its first decode also
    writes a ``<src>.hf2x`` sidecar (the same tree and payload bits and a
    block index, :func:`.index.decode_hff_indexed`), and later decodes
    take the sidecar's blocks in parallel
    (:func:`read_decompress_write_hf2_host`).  A sidecar older than the
    source, or not built from it (:func:`.index._sidecar_matches`), or
    that fails to decode, is built again.  ``stats["auto_index"]`` says
    what happened: ``"created"``, ``"reused"``, ``"nosidecar"`` (decoded,
    sidecar not written) or ``"failed"`` (the indexed decode failed and
    the serial one ran).

    Otherwise the payload is read in windows of ``min(max(block_size,
    1 MiB), 64 MiB)`` and decoded serially by the C++ DFA; a code that
    straddles a window's end is decoded again from the next window.  A
    one-letter tree emits one letter per payload bit.
    """
    size = os.path.getsize(src_path)
    want_auto = auto_index if auto_index is not None else (
        size >= AUTO_INDEX_MIN)
    if want_auto and _decode_with_sidecar(src_path, dst_path, stats):
        return
    with open(src_path, "rb") as src, open(dst_path, "wb") as dst:
        tree, data_padding, header_len = _read_hff_header(src, src_path)
        payload_len = size - header_len
        total_bits = payload_len * 8 - data_padding
        if payload_len <= 0:
            return
        if tree.is_leaf(tree.root):
            letter = bytes([int(tree.letters[tree.root])])
            left_bits = total_bits
            while left_bits > 0:
                emit = min(left_bits, _CHUNK * 8)
                dst.write(letter * emit)
                left_bits -= emit
            return
        tables = native.build_dfa(tree)
        window = _Window(src, total_bits, min(max(block_size, 1 << 20), _CHUNK))
        pos_bit = 0   # next bit to decode (in the payload)
        while pos_bit < total_bits:
            arr, end_bit = window.slide(pos_bit)
            base = window.byte0 * 8
            out, resume = native.decode_resume(arr, pos_bit - base,
                                               end_bit - base, tables,
                                               end_bit - pos_bit)
            dst.write(out)
            if end_bit == total_bits:
                break  # the tail bits are padding: done
            new_pos = resume + base
            if new_pos <= pos_bit:
                raise _invalid(src_path)
            pos_bit = new_pos
