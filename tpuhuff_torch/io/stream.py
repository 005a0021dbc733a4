"""Streaming compress/decompress through the port's device kernels.

Counterparts of the device routes of :mod:`tpuhuff.io.stream`:
:func:`read_compress_write_hf2`, :func:`read_decompress_write_hf2` and the
``.hff`` writer :func:`read_compress_write`, with the same arguments
(``device`` names a torch device instead of a flag) and the same bytes.
The container, tree, CRC and bit-sink code is the port's own copy of the
JAX package's host code (:mod:`tpuhuff_torch.io.hff`, :mod:`.host`).

Compress: pass 1 histograms the file on the device (:func:`histogram`);
the host builds the length-limited canonical tree and writes the prelude;
pass 2 encodes each chunk's 256-byte lanes on the device
(:func:`encode_blocks`; with ``collect_hist`` the same launches count the
bytes, config 4's adaptive refresh) and stitches them there into the
payload's bytes, the previous chunk's trailing bits carried in on the
device (:func:`stitch_lanes`) and takes the chunk's CRC column there
(:func:`crc32_spans`), while the host patches the block table and CRC
column and writes the previous chunk's bytes, which it copies back
alone.  Pass 1 reads each chunk straight into a pinned buffer and
copies it to the device.  Where it counts every byte on a CUDA device
and the file fits in half the memory the device can give
(:func:`_resident`), each byte is read and copied to the device once:
pass 1 keeps each chunk in a device copy of the file, from which pass 2
encodes.  Else pass 2 reads each chunk again, straight into a pinned
buffer, and copies it.  Decompress copies
each group's payload bytes to the device, cuts the blocks' rows out of
them there (:func:`lane_rows`), decodes them (:func:`decode_rows` for
canonical codes, :func:`decode_rows_general` for any other tree) and
takes the decoded bytes' CRCs there (:func:`crc32_spans`), which the
host checks against the stored column before it writes the group.

Pipelining: every file call runs its chunks or groups through one loop,
:func:`~tpuhuff_torch.io.host._pipeline` (submit k+1, then collect k).
Launches are asynchronous on the current CUDA stream, and
:class:`_Staging` makes every pinned buffer, every copy and every wait for
a slot of a call.  The host waits for the card where a slot's buffer is
reused (``sync.slot``) and where it collects the previous chunk
(``sync.result``, ``sync.fetch``); pass 1 waits once, for its counts.

Tracing: each file call is a root span (``compress`` or ``decompress``)
of the active tracer (:func:`tpuhuff_torch.profiling.tracing`), with spans
at its stages (``pass1``, ``tree``, ``prelude``, ``tables``, ``header``,
``submit``, ``collect``, ``sink``, ``crc``), at each host copy into a
pinned buffer (``pin_copy``) and each new one (``pin_alloc``, with its
bytes), at each point where the host waits for the card (``sync.slot``,
``sync.result``, ``sync.fetch``, ``sync.counts``), at each file read and
write (with their bytes), and in the kernel wrappers (``launch``);
counters ``h2d_bytes`` and ``d2h_bytes`` (on the CPU, where no copy is
made, the bytes a copy would move), ``resident_bytes`` (the input
bytes pass 2 encoded from the device copy), ``host_route_bytes`` (the
output bytes of a decompress handed to the host decoder), in the
decoders' wrappers ``global_rows_blocks`` (the blocks decoded on their
global-rows route), and in :func:`crc32_spans` ``crc_device_bytes`` (the
bytes whose CRC the device took).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import profiling
from ..core.canonical import build_tree_for_device
from ..core.format import CompressError
from ..core.tree import HuffTree
from ..core.weights import ByteWeights
from ..kernels import (
    crc32_spans,
    decoder_for,
    encode_blocks,
    histogram,
    lane_rows,
    make_encode_tables,
    new_carry,
    row_width,
    stitch_lanes,
)
from ..kernels._build import resolve_device as _resolve
from ..profiling import count, span
from .crc import crc32_combine
from .host import (
    DEFAULT_BLOCK,
    DEVICE_HF2_BLOCK,
    _CHUNK,
    StreamError,
    _block_bits,
    _check_sizes,
    _chunk_step,
    _HffSink,
    _pieces,
    _pipeline,
    _read_header,
    _sampled_pieces,
    _start_hf2,
    _timed,
    _weights_from_stream,
    lane_of,
    read_decompress_write_hf2_host,
)

__all__ = ["read_compress_write_hf2", "read_decompress_write_hf2",
           "read_compress_write"]

# largest block that the kernels' plain versions (a CPU device) and
# dist.multihost's torch route decode: past it they hand the container to
# the threaded host DFA (the rule of the JAX device route), as a plain
# version steps once per output position.  A CUDA device decodes every
# block length: rows too wide for shared memory take the decoders'
# global-rows route (kernels/decode.py)
DEVICE_DECODE_MAX_BLOCK = 2048

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64}


def _open(path: str, mode: str):
    """``open(path, mode)``; under a tracer the open (an output's
    truncation) is a ``read`` or ``write`` span, and so is each of the
    file's reads and writes (:class:`profiling.TracedFile`)."""
    t = profiling.active()
    if t is None:
        return open(path, mode)
    kind = "read" if mode.startswith("r") else "write"
    with t.stage(kind):
        fp = open(path, mode)
    return profiling.TracedFile(fp, t, kind)


def _tables_to(tables, dev: torch.device):
    """``tables.to(dev)``, its tensors' bytes counted in ``h2d_bytes``."""
    if profiling.active() is not None:
        count("h2d_bytes", sum(t.numel() * t.element_size()
                               for t in vars(tables).values()
                               if isinstance(t, torch.Tensor)))
    return tables.to(dev)


class _Staging:
    """Host side of the asynchronous copies, and the only owner of a file
    call's pinned buffers, copies and waits for a slot: reusable pinned
    buffers keyed by (role, slot).  A buffer is rewritten only after the
    copy that last used it has finished (its event).  On the CPU every
    call is synchronous and arrays pass through as tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: dict = {}
        self._events: dict = {}
        self._side = None  # the copy-back stream of fetch()

    def _buffer(self, key, nbytes: int) -> torch.Tensor:
        ev = self._events.pop(key, None)
        if ev is not None:
            with span("sync.slot"):
                ev.synchronize()
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 1)
            with span("pin_alloc", size):
                buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self._bufs[key] = buf
        return buf[:nbytes]

    def _mark(self, key) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[key] = ev

    def h2d(self, arr: np.ndarray, key) -> torch.Tensor:
        """Copy a uint8, int32 or int64 array to the device (async on
        CUDA)."""
        arr = np.ascontiguousarray(arr)
        if not self.cuda:
            count("h2d_bytes", arr.nbytes)
            return torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        host = self._buffer(key, arr.nbytes)
        with span("pin_copy"):
            host.numpy()[:] = arr.reshape(-1).view(np.uint8)
        return self._send(host, key).view(_TORCH_DTYPES[arr.dtype]).view(
            arr.shape)

    def _send(self, host: torch.Tensor, key, out=None) -> torch.Tensor:
        count("h2d_bytes", host.numel())
        dev = (host.to(self.device, non_blocking=True) if out is None
               else out.copy_(host, non_blocking=True))
        self._mark(key)
        return dev

    def read_into(self, src, n: int, nbytes: int, key
                  ) -> tuple[torch.Tensor, int]:
        """Read up to ``n`` bytes of ``src`` straight into ``key``'s host
        buffer of ``nbytes >= n`` bytes and zero the rest of it; returns
        the buffer (a pinned tensor on CUDA) and the bytes read."""
        buf = (self._buffer(key, nbytes) if self.cuda
               else torch.empty(nbytes, dtype=torch.uint8))
        arr = buf.numpy()
        got = src.readinto(memoryview(arr)[:n]) or 0
        with span("pin_copy"):
            arr[got:] = 0
        return buf, got

    def to_device(self, buf: torch.Tensor, key, out=None) -> torch.Tensor:
        """Start copying ``key``'s buffer from :meth:`read_into` to the
        device, into ``out`` (a device tensor of its size) where given;
        returns the device tensor (on the CPU, the buffer itself or
        ``out`` filled)."""
        if not self.cuda:
            count("h2d_bytes", buf.numel())
            return buf if out is None else out.copy_(buf)
        return self._send(buf, key, out)

    def d2h(self, t: torch.Tensor, key) -> torch.Tensor:
        """Start copying ``t`` to the host; read it after :meth:`fence`'s
        event has completed."""
        nbytes = t.numel() * t.element_size()
        count("d2h_bytes", nbytes)
        if not self.cuda:
            return t
        host = self._buffer(key, nbytes).view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=True)
        self._mark(key)
        return host

    def fetch(self, t: torch.Tensor, key, after) -> np.ndarray:
        """Copy ``t`` to ``key``'s host buffer once the event ``after`` has
        completed, on a stream of its own, so that the copy does not queue
        behind the work enqueued since; waits for it and returns the bytes
        (``t`` itself on the CPU)."""
        nbytes = t.numel() * t.element_size()
        count("d2h_bytes", nbytes)
        if not self.cuda:
            return t.numpy()
        host = self._buffer(key, nbytes).view(t.dtype)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_event(after)
        with torch.cuda.stream(self._side):
            host.copy_(t, non_blocking=True)
        with span("sync.fetch"):
            self._side.synchronize()
        return host.numpy()

    def fence(self):
        """An event after everything enqueued so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev


@dataclass
class _Chunk:
    """One encoded chunk, as the byte-aligned sinks take it: ``full``, the
    stream's whole bytes (the first completing the bits carried in),
    ``nbits`` the chunk's own bits, the new partial byte and its bit count,
    the per-block bit lengths, the (256,) counts or None, and the chunk's
    CRC column or None."""

    full: np.ndarray
    nbits: int
    partial: int
    partial_bits: int
    bit_lens: np.ndarray
    hist: np.ndarray | None
    crcs: np.ndarray | None = None

    def payload(self) -> bytes:
        """The chunk's bytes, its partial byte last (for a chunk encoded
        ``fresh``: its own payload, padded to a byte)."""
        tail = bytes([self.partial]) if self.partial_bits else b""
        return self.full.tobytes() + tail


class _DeviceBlockEncoder:
    """Device encoder for ``.hf2`` block groups (counterpart of
    ``tpuhuff.io.stream._device_block_encoder``).

    Each ``block_len`` block is encoded as ``block_len // lane`` independent
    lanes and the lane streams are bit-concatenated in order, which is
    bit-identical to encoding the block whole (prefix-code concatenation
    is associative); per-block bit lengths are lane sums.

    A chunk enters in one of two ways: read straight into its slot's host
    buffer (:meth:`read`), sized to whole blocks of lanes with only the
    tail zeroed, then copied to the device (:meth:`__call__`); or as a
    view of a device copy of the file (:meth:`on_device`).  Its lanes'
    valid counts are made on the device.  Then, on one
    stream: K1 (K5 with ``collect_hist``: the same launch counts the
    chunk's bytes, ``hist_data`` the lanes), the device stitch S1
    (:func:`stitch_lanes`), which takes the previous chunk's trailing bits
    from the carry its stitch left on the device, and the per-block bit
    sums and the summed missing count, copied back; with ``crc_span``
    (the ``.hf2`` writer's CRC span in bytes) also C1
    (:func:`crc32_spans`), the chunk's CRC column from the same lanes,
    copied back with them.  :meth:`collect` waits for those, then copies
    back exactly the chunk's stream bytes on a side stream, and subtracts
    the lanes' zero padding from bin 0 of the counts, as the JAX route
    does.  Chunks must be collected in the order they were submitted;
    ``fresh=True`` starts a stream of its own."""

    def __init__(self, tree: HuffTree, block_len: int, device: torch.device,
                 staging: _Staging, collect_hist: bool = False,
                 crc_span: int = 0):
        with span("tables"):
            self.tables = _tables_to(
                make_encode_tables(*tree.encode_tables()), device)
        self.block_len = block_len
        self.lane = lane_of(block_len)
        self.per_block = block_len // self.lane
        self.device, self.staging = device, staging
        self.collect_hist = collect_hist
        self.crc_span = crc_span        # bytes a CRC covers; 0: no column
        self.carry = new_carry(device)  # the stream's trailing bits, on the device
        self.carry_bits = 0             # their count, as the host knows it
        self._read = {}                 # slot -> the buffer read() filled

    def _padded(self, n: int) -> int:
        return max(1, -(-n // self.block_len)) * self.block_len

    def read(self, src, n: int, slot: int) -> np.ndarray:
        """Read up to ``n`` bytes into ``slot``'s buffer (for
        :func:`_pieces`); returns the bytes read."""
        buf, got = self.staging.read_into(src, n, self._padded(n),
                                          ("lanes", slot))
        self._read[slot] = buf
        return buf.numpy()[:got]

    def __call__(self, data: np.ndarray, slot: int, fresh: bool = False):
        """H2D + kernels + the small D2H of the chunk that :meth:`read`
        put in ``slot`` (``data``, the bytes it returned), without waiting
        for any."""
        with span("submit"):
            n = data.size
            buf = self._read.pop(slot)[: self._padded(n)]
            return self._launch(self.staging.to_device(buf, ("lanes", slot)),
                                n, slot, fresh)

    def on_device(self, copy: torch.Tensor, lo: int, n: int, slot: int):
        """The kernels and the small D2H of the chunk of ``n`` bytes at
        ``lo`` in ``copy``, the device copy of the file, zero past its end
        to whole blocks; its bytes are counted in ``resident_bytes``."""
        with span("submit"):
            count("resident_bytes", n)
            return self._launch(copy[lo:lo + self._padded(n)], n, slot)

    def _launch(self, lanes: torch.Tensor, n: int, slot: int,
                fresh: bool = False):
        """K1 (K5), S1, C1 and the small D2H of the ``n`` bytes at the
        start of the device tensor ``lanes``, which holds whole blocks."""
        if fresh:
            self.carry, self.carry_bits = new_carry(self.device), 0
        nbytes = lanes.numel()
        lanes = lanes.view(nbytes // self.lane, self.lane)
        starts = torch.arange(0, nbytes, self.lane, device=self.device)
        valid = (n - starts).clamp_(0, self.lane).to(torch.int32)
        out = encode_blocks(lanes, valid, self.tables, self.tables.max_len,
                            hist_data=lanes if self.collect_hist else None)
        words, bits, miss = out[:3]
        payload, self.carry = stitch_lanes(words, bits, self.carry)
        small = {"sums": bits.view(-1, self.per_block).sum(1),
                 "miss": miss.sum().view(1)}
        if self.collect_hist:
            small["hist"] = out[3]
        if self.crc_span:
            small["crc"] = crc32_spans(lanes, n, self.crc_span)
        host = {name: self.staging.d2h(t, (name, slot))
                for name, t in small.items()}
        return host, payload, nbytes - n, slot, self.staging.fence()

    def collect(self, handle) -> _Chunk:
        """Wait for a submitted chunk and copy back its stream's bytes."""
        host, payload, pad, slot, done = handle
        with span("sync.result"):
            if done is not None:
                done.synchronize()
        with span("collect"):
            if int(host["miss"][0]):
                raise CompressError("letter not found in codes", None)
            bit_lens = host["sums"].numpy().astype(np.uint64)  # a copy: slots are reused
            nbits = int(bit_lens.sum())
            total = self.carry_bits + nbits
            stream = self.staging.fetch(payload[: (total + 7) // 8],
                                        ("payload", slot), done)
            full, rem = divmod(total, 8)
            self.carry_bits = rem
            hist = None
            if self.collect_hist:
                hist = host["hist"].numpy().astype(np.int64)
                hist[0] -= pad  # the padding lanes' zeros
        crcs = None
        if self.crc_span:
            with span("crc"):
                crcs = host["crc"].numpy().view(np.uint32).copy()
        return _Chunk(stream[:full], nbits, int(stream[full]) if rem else 0,
                      rem, bit_lens, hist, crcs)


def read_compress_write_hf2(
    src_path: str, dst_path: str, block_len: int | None = None,
    device="cuda", canonical: bool = True,
    chunk_bytes: int | None = None, stats: dict | None = None,
    hist_sample: int = 1, check: bool = True,
    tree: HuffTree | None = None, max_code_len: int | None = None,
    collect_hist: bool = False,
) -> np.ndarray | None:
    """Compress into the block-indexed ``.hf2`` container on ``device``,
    streaming in ``chunk_bytes`` pieces; writes the same bytes as
    ``tpuhuff.io.stream.read_compress_write_hf2(..., device=True)``.

    ``device`` is a torch device (``"cuda"``, ``"cuda:1"``, ``"cpu"``); on
    the CPU the kernels' plain versions run.  ``block_len`` defaults to
    256.  Pass 1 (the device histogram) is skipped when ``tree`` is given;
    ``hist_sample > 1`` counts the first ``1/hist_sample`` of each piece
    of :func:`_sampled_pieces` and adds one to every bin.  The tree is
    length-limited to ``min(max_code_len, 32)`` bits and canonicalised
    when ``canonical``.  A ``tree`` with no code for some byte of the file
    raises :class:`CompressError`.  ``check`` writes the CRC32 column,
    taken on the device from each chunk's lanes (:func:`crc32_spans`).
    ``collect_hist`` returns the file's exact (256,) int64 histogram,
    counted during pass 2 by the encode launches themselves (K5); else
    None is returned.  ``stats`` is taken for the JAX package's signature
    and left untouched.

    Routes (the same bytes on both): where pass 1 counts every byte (no
    ``tree``, ``hist_sample`` 1) on a CUDA device, and the file, padded to
    whole blocks, takes at most half the memory the device can give at
    the call's start (:func:`_resident`: the card's free memory and what
    the caching allocator holds unused), the file is read once: pass 1
    reads each chunk into a pinned buffer and copies it into a device
    copy of the whole file, which pass 2 encodes without reading the file
    again (counter ``resident_bytes``).
    Else pass 2 reads and copies the file a second time, in chunks.  The
    device copy takes the padded file's bytes of device memory during
    the call; at its end PyTorch's caching allocator keeps them reserved
    for the next call (``torch.cuda.empty_cache()`` hands them back to
    the card).
    """
    with profiling.call("compress"):
        dev = _resolve(device)
        if block_len is None:
            block_len = DEVICE_HF2_BLOCK
        size = os.path.getsize(src_path)
        step, crc_every, span_bytes = _chunk_step(block_len, chunk_bytes,
                                                  check)
        staging = _Staging(dev)
        padded = max(1, -(-size // block_len)) * block_len
        resident = _resident(dev, size, padded, tree, hist_sample)
        with _open(src_path, "rb") as src, _open(dst_path, "wb") as dst:
            copy = None
            if tree is None:
                if max(1, int(hist_sample)) == 1:
                    counts, copy = _pass1(src, src_path, size, padded, step,
                                          staging, dev, resident)
                else:
                    counts = _pass1_sampled(src, size, step, hist_sample,
                                            staging, dev)
                tree = _pass1_tree(counts, size, hist_sample, max_code_len)
            tree, sink = _start_hf2(dst, tree, size, block_len, canonical,
                                    crc_every)
            encoder = _DeviceBlockEncoder(tree, block_len, dev, staging,
                                          collect_hist, crc_span=span_bytes)
            hist = np.zeros(256, dtype=np.int64) if collect_hist else None

            def collect(handle) -> None:
                c = encoder.collect(handle)
                if c.hist is not None:
                    with span("collect"):
                        hist[:] += c.hist
                with span("sink"):
                    sink.write_aligned(c.full, c.nbits, c.partial,
                                       c.partial_bits, c.bit_lens, c.crcs)

            # pass 2: chunk k+1 is launched (its stitch and CRCs too)
            # before chunk k's bytes are copied back and written; its
            # lanes are a view of the device copy, or read again into a
            # pinned slot and copied
            if copy is not None:
                _pipeline(range(0, size, step), lambda lo, slot:
                          encoder.on_device(copy, lo, min(step, size - lo),
                                            slot), collect)
            else:
                src.seek(0)
                _pipeline(_pieces(src, size, step, lambda n, slot:
                                  encoder.read(src, n, slot)),
                          encoder, collect)
            with span("sink"):
                sink.finish()
        return hist


def _device_free_bytes(dev: torch.device) -> int:
    """The memory a new tensor on ``dev`` can take when it is a CUDA
    device: the card's free memory and what this process's caching
    allocator holds reserved but unused (a previous call's device copy
    among it); 0 on any other device, which keeps no resident copy."""
    if dev.type != "cuda":
        return 0
    return (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


def _resident(dev: torch.device, size: int, padded: int,
              tree: HuffTree | None, hist_sample: int) -> bool:
    """Whether :func:`read_compress_write_hf2` keeps the file on the
    device: pass 1 runs and counts every byte, and the file's ``padded``
    bytes take at most half of :func:`_device_free_bytes`."""
    return (tree is None and max(1, int(hist_sample)) == 1 and size > 0
            and padded <= _device_free_bytes(dev) // 2)


def _pass1(src, src_path: str, size: int, padded: int, step: int,
           staging: _Staging, dev: torch.device, resident: bool):
    """Pass 1 over every byte (span ``pass1``): each ``step`` chunk is read
    straight into a pinned slot, copied to the device and counted there,
    one histogram launch adding into the running counts.  With
    ``resident`` each chunk goes into its slice of a device copy of the
    file (``padded`` bytes, zero past its end).  Returns the (256,)
    counts and the copy (None unless ``resident``)."""
    with span("pass1"):
        copy = (torch.empty(padded, dtype=torch.uint8, device=dev)
                if resident else None)
        acc = torch.zeros(256, dtype=torch.int64, device=dev)
        for k, lo in enumerate(range(0, size, step)):
            n = min(step, size - lo)
            key = ("hist", k % 2)
            buf, got = staging.read_into(src, n, n, key)
            if got < n:
                raise StreamError(f"{src_path!r} ended before its {size} "
                                  "bytes")
            out = None if copy is None else copy[lo:lo + n]
            histogram(staging.to_device(buf, key, out=out), out=acc)
        counts = _fetch_counts(acc)
        if copy is not None:
            copy[size:].zero_()  # the last block's padding, read by its lanes
    return counts, copy


def _pass1_sampled(src, size: int, step: int, hist_sample: int,
                   staging: _Staging, dev: torch.device) -> np.ndarray:
    """Pass 1 of a sampled histogram (span ``pass1``): one histogram launch
    per piece of :func:`_sampled_pieces`, each adding into the running
    int64 counts on the device, and one 256-count transfer at the end."""
    with span("pass1"):
        acc = torch.zeros(256, dtype=torch.int64, device=dev)
        for k, piece in enumerate(_sampled_pieces(src, size, step,
                                                  hist_sample)):
            histogram(staging.h2d(np.frombuffer(piece, dtype=np.uint8),
                                  ("hist", k % 2)), out=acc)
        piece = None  # the last piece's memory is freed in pass 1
        return _fetch_counts(acc)


def _fetch_counts(acc: torch.Tensor) -> np.ndarray:
    """Pass 1's running counts, copied back (span ``sync.counts``)."""
    with span("sync.counts"):
        counts = acc.cpu().numpy()
    count("d2h_bytes", counts.nbytes)
    return counts


def _pass1_tree(counts: np.ndarray, size: int, hist_sample: int,
                max_code_len: int | None) -> HuffTree:
    """The length-limited tree of pass 1's ``counts`` (span ``tree``)."""
    with span("tree"):
        if max(1, int(hist_sample)) > 1 and size > 0:
            counts = counts + 1  # every byte gets a code
        ml_cap = 32 if max_code_len is None else min(max_code_len, 32)
        return build_tree_for_device(ByteWeights(counts), max_len=ml_cap)[0]


def read_compress_write(
    src_path: str, dst_path: str, block_size: int = DEFAULT_BLOCK,
    device="cuda", stats: dict | None = None, hist_sample: int = 1,
    tree: HuffTree | None = None, max_code_len: int | None = None,
    timer=None,
) -> None:
    """Compress into the reference's ``.hff`` format on ``device``; writes
    the same bytes as ``tpuhuff.io.stream.read_compress_write(...,
    device=True)``.

    Pass 1 (unless ``tree`` is given) counts the file on the host in
    pieces of ``min(block_size, 64 MiB)`` (sampled as in
    :func:`read_compress_write_hf2`) and builds the tree limited to
    ``min(max_code_len, 32)`` bits, not canonicalised.  Pass 2 encodes each
    piece as 256-byte lanes with :func:`encode_blocks` (K1), piece k+1
    launched before piece k is stitched and written; a byte with no code
    raises :class:`CompressError`.  A ``timer``
    (:class:`tpuhuff_torch.profiling.StageTimer`) is made the active tracer
    for the call; besides the spans of :mod:`this module <.stream>` it
    records the stages ``histogram`` (pass 1) and ``pack`` (lanes, copies
    and launch, with the piece's bytes; then the wait and the copy back).
    ``stats`` is taken for the JAX package's signature and left untouched.
    """
    with _timed(timer), profiling.call("compress"):
        dev = _resolve(device)
        size = os.path.getsize(src_path)
        step = min(block_size, _CHUNK)
        with _open(src_path, "rb") as src, _open(dst_path, "wb") as dst:
            if tree is None:
                with span("histogram", size):
                    bw = _weights_from_stream(src, size, step, hist_sample)
                cap = 32 if max_code_len is None else min(max_code_len, 32)
                with span("tree"):
                    tree, _limited = build_tree_for_device(bw, max_len=cap)
            with span("prelude"):
                sink = _HffSink(dst, tree)
            src.seek(0)
            encoder = _DeviceBlockEncoder(tree, DEVICE_HF2_BLOCK, dev,
                                          _Staging(dev))

            def submit(data: np.ndarray, slot: int):
                with span("pack", data.size):
                    return encoder(data, slot)

            def collect(handle) -> None:
                with span("pack", 0):
                    c = encoder.collect(handle)
                with span("sink"):
                    sink.write_aligned(c.full, c.nbits, c.partial,
                                       c.partial_bits)

            _pipeline(_pieces(src, size, step, lambda n, slot:
                              encoder.read(src, n, slot)), submit, collect)
            with span("sink"):
                sink.finish()


def read_decompress_write_hf2(
    src_path: str, dst_path: str, device="cuda",
    chunk_bytes: int | None = None, stats: dict | None = None,
    check: bool = True, threads: int | None = None,
) -> None:
    """Decode a ``.hf2`` container on ``device``, in groups of about
    ``chunk_bytes`` output bytes (:func:`_group_blocks`); the counterpart
    of ``tpuhuff.io.stream.read_decompress_write_hf2(..., device=True)``.

    Routes (:func:`_host_route`): an empty file and a one-letter tree go
    to the host decoder (:func:`read_decompress_write_hf2_host`, on
    ``threads`` threads), counted in ``host_route_bytes``.  A CUDA device
    decodes every block length on the card: rows of which shared memory
    holds fewer than 32 (host-written 64 KiB blocks among them) take the
    decoders' global-rows route.  On any other device, where the kernels'
    plain versions step once per output position, blocks longer than
    ``DEVICE_DECODE_MAX_BLOCK`` (2048) bytes go to the host decoder too,
    as in the JAX device route.  Canonical codes, detected from the tree
    itself and not from the container's flag, decode with
    :func:`decode_rows`; any other tree with :func:`decode_rows_general`.
    ``check`` verifies the CRC32 column, raising
    ``StreamError(kind="CorruptData")`` on a mismatch.  ``stats`` is taken
    for the JAX package's signature and left untouched.
    """
    with profiling.call("decompress"):
        dev = _resolve(device)
        chunk = chunk_bytes if chunk_bytes is not None else _CHUNK
        with _open(src_path, "rb") as src, _open(dst_path, "wb") as dst:
            with span("header"):
                hdr = _read_header(src, src_path)
            if not _host_route(hdr, dev):
                _decode_groups(hdr, src, dst, src_path, dev, chunk, check)
                return
        count("host_route_bytes", hdr.orig_len)
        read_decompress_write_hf2_host(src_path, dst_path,
                                       chunk_bytes=chunk_bytes, check=check,
                                       threads=threads)


def _host_route(hdr, dev: torch.device) -> bool:
    """Whether :func:`read_decompress_write_hf2` hands the container of
    ``hdr`` to the host decoder on ``dev``: an empty file, a one-letter
    tree, or, on a device other than CUDA, blocks longer than
    ``DEVICE_DECODE_MAX_BLOCK``."""
    return (hdr.orig_len == 0 or hdr.tree.is_leaf(hdr.tree.root)
            or (dev.type != "cuda"
                and hdr.block_len > DEVICE_DECODE_MAX_BLOCK))


def _group_blocks(block_len: int, chunk: int) -> int:
    """Blocks per decode group: about ``chunk`` bytes of output, at least
    1024 blocks up to ``DEVICE_DECODE_MAX_BLOCK``, and rows under one
    :func:`lane_rows` launch's 2^31 words (``block_len + 3`` words a row
    at most, for codes of up to 32 bits)."""
    n = max(1024 if block_len <= DEVICE_DECODE_MAX_BLOCK else 1,
            chunk // block_len)
    return min(n, max(1, ((1 << 31) - 1) // (block_len + 3)))


class _ColumnCheck:
    """The ``.hf2`` CRC column checked against CRCs that the device takes
    of each decoded group (:func:`crc32_spans`), groups in file order.

    A group at byte ``off`` of the output that starts inside a span (a
    block length that does not divide the span, or a small
    ``chunk_bytes``) has its head's CRC folded onto the CRC of the span's
    part that the groups before it decoded (:func:`crc32_combine`); a
    group that ends inside a span leaves that part's CRC to the next.
    Every span is compared once complete (or at the output's end), and a
    mismatch, or a span past the column's end, raises
    ``StreamError(kind="CorruptData")``."""

    def __init__(self, crcs: np.ndarray, span_bytes: int, size: int,
                 path: str):
        self.crcs = np.asarray(crcs, dtype=np.uint32)
        self.span, self.size, self.path = span_bytes, size, path
        self.partial = 0  # CRC of the span's part the groups before decoded

    def launch(self, out: torch.Tensor, off: int, valid: int) -> torch.Tensor:
        """C1 over the group's ``valid`` decoded bytes at ``off``."""
        return crc32_spans(out, valid, self.span,
                           min(-off % self.span, valid))

    def _fail(self, k: int) -> None:
        raise StreamError(f"{self.path!r} block CRC mismatch in span {k} "
                          f"(corrupt payload or index)", "CorruptData")

    def _compare(self, k: int, got: np.ndarray) -> None:
        want = self.crcs[k:k + got.size]
        if want.size < got.size:
            self._fail(k + want.size)
        bad = np.flatnonzero(got != want)
        if bad.size:
            self._fail(k + int(bad[0]))

    def check(self, got: np.ndarray, off: int, valid: int) -> None:
        """Compare the CRCs ``got`` of the group at ``off`` (uint32)."""
        end = off + valid
        k, into = divmod(off, self.span)
        if into:
            head = min(self.span - into, valid)
            crc = crc32_combine(self.partial, int(got[0]), head)
            got = got[1:]
            if (off + head) % self.span and off + head != self.size:
                self.partial = crc  # the group ends inside this span
                return
            self._compare(k, np.array([crc], dtype=np.uint32))
            k += 1
        if end % self.span and end != self.size:
            self.partial = int(got[-1])
            got = got[:-1]
        self._compare(k, got)


def _decode_groups(hdr, src, dst, src_path: str, dev: torch.device,
                   chunk: int, check: bool) -> None:
    """The device branch of :func:`read_decompress_write_hf2`."""
    with span("header"):
        _check_sizes(hdr, src_path)
        starts, ends = _block_bits(hdr, src_path)
        column = None
        if check and hdr.crcs is not None and hdr.crc_every:
            column = _ColumnCheck(hdr.crcs, hdr.crc_every * hdr.block_len,
                                  hdr.orig_len, src_path)
    with span("tables"):
        decode, tables = decoder_for(hdr.tree)
        tables = _tables_to(tables, dev)

    B = hdr.num_blocks
    gsize = _group_blocks(hdr.block_len, chunk)
    staging = _Staging(dev)

    def submit_group(g0: int, slot: int):
        """Read + H2D of the group's payload bytes and block starts, then
        the row gather S2, the decoder and C1 on the device, and the D2H of
        the output and its CRCs."""
        with span("submit"):
            g1 = min(g0 + gsize, B)
            byte_lo = int(starts[g0]) // 8
            nbytes = (int(ends[g1 - 1]) + 7) // 8 - byte_lo
            src.seek(hdr.payload_offset + byte_lo)
            buf, got = staging.read_into(src, nbytes, nbytes,
                                         ("payload", slot))
            if got < nbytes:
                raise StreamError(f"{src_path!r} truncated payload",
                                  "MissingHeaderInfo")
            ls = (starts[g0:g1] - np.uint64(byte_lo * 8)).astype(np.int64)
            le = (ends[g0:g1] - np.uint64(byte_lo * 8)).astype(np.int64)
            # the payload's device copy is a temporary: freed once S2 has
            # its rows, before the decoder's output is allocated
            rows, bit0 = lane_rows(staging.to_device(buf, ("payload", slot)),
                                   staging.h2d(ls, ("starts", slot)),
                                   row_width(ls, le))
            out = decode(
                rows, bit0,
                staging.h2d((le - ls).astype(np.int32), ("nbits", slot)),
                tables, hdr.block_len)
            last = (hdr.orig_len - (B - 1) * hdr.block_len if g1 == B
                    else hdr.block_len)
            off = g0 * hdr.block_len
            valid = (g1 - g0 - 1) * hdr.block_len + last
            crcs = (None if column is None else
                    staging.d2h(column.launch(out, off, valid), ("crc", slot)))
            return (staging.d2h(out, ("out", slot)), crcs, off, valid, last,
                    staging.fence())

    def collect_group(handle) -> None:
        """Wait for a group, check its CRCs against the column, then write
        its bytes: the writer stage of a decompress."""
        out, crcs, off, valid, last, done = handle
        with span("sync.result"):
            if done is not None:
                done.synchronize()
        if column is not None:
            with span("crc"):
                column.check(crcs.numpy().view(np.uint32), off, valid)
        with span("collect"):
            out = out.numpy()
            if last != hdr.block_len:
                dst.write(out[:-1].reshape(-1))
                dst.write(out[-1, :last])
            else:
                dst.write(out.reshape(-1))

    _pipeline(range(0, B, gsize), submit_group, collect_group)
