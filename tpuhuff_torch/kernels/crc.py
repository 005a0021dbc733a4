"""CRC32 of spans on the card (C1): the ``.hf2`` CRC column.

Replaces no TPU kernel: the JAX package, and the port before it, computed
the column on the host (``native.crc32_blocks``).  :func:`crc32_spans`
takes the zlib CRC32 of each span of bytes that already lie on the card,
the writer's chunk lanes or the decoder's output, so that no host pass
over the bytes is left for the column.

The arithmetic (``csrc/crc32_common.cuh`` sets it out): CRC32 is affine
over GF(2).  Each span is put at the end of a window of 256 pieces of
``L = ceil(span / 256)`` bytes, its head being zeros that add nothing to a
register started at 0; each piece's raw CRC (register 0, no final xor) is
taken alone, and the pieces are folded in a tree of eight levels, level k
shifting the left half by the right half's ``L 2^k`` bytes (the operator
of that many zero bytes on the register, applied as four byte-indexed
tables); zlib's value is the raw CRC xor ``crc32`` of as many zero bytes.
The tables are made here, on the host, and the plain version uses the same
ones and the same fold.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..profiling import count, span
from . import _build

__all__ = ["crc32_spans", "crc32_spans_reference", "crc32_segments",
           "shift_tables"]

_POLY = 0xEDB88320  # the CRC-32 polynomial, bit-reflected
PIECES = 256        # csrc/crc32_common.cuh: kPieces
LEVELS = 8          # kLevels


@functools.lru_cache(maxsize=None)
def slice_tables() -> np.ndarray:
    """(16, 256) uint32: table k holds the raw CRC of a byte followed by k
    zero bytes (table 0 is the byte table)."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(
            np.uint32)
    out = np.empty((16, 256), dtype=np.uint32)
    out[0] = t
    for k in range(1, 16):
        out[k] = (out[k - 1] >> 8) ^ t[out[k - 1] & 0xFF]
    return out


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The GF(2) map with columns ``cols`` (32,) applied to each of ``v``."""
    v = np.asarray(v, dtype=np.uint32)
    out = np.zeros(v.shape, dtype=np.uint32)
    for j in range(32):
        out ^= np.where((v >> np.uint32(j)) & 1, cols[j], 0).astype(np.uint32)
    return out


@functools.lru_cache(maxsize=1024)
def _zeros_operator(nbytes: int) -> np.ndarray:
    """Columns (32,) of the map of ``nbytes`` zero bytes on the register,
    by squaring the map of one."""
    e = np.uint32(1) << np.arange(32, dtype=np.uint32)
    one = slice_tables()[0][e & 0xFF] ^ (e >> np.uint32(8))
    result = e.copy()  # the identity
    power = one
    while nbytes:
        if nbytes & 1:
            result = _apply(power, result)
        nbytes >>= 1
        if nbytes:
            power = _apply(power, power)
    return result


@functools.lru_cache(maxsize=256)
def shift_tables(nbytes: int) -> np.ndarray:
    """(4, 256) uint32 byte tables of the map of ``nbytes`` zero bytes: the
    map of ``v`` is ``t[0][v & 255] ^ t[1][v >> 8 & 255] ^ t[2][v >> 16 &
    255] ^ t[3][v >> 24]``, and ``crc32(A || B)`` is that map of
    ``crc32(A)`` over ``len(B)`` bytes xor ``crc32(B)``."""
    cols = _zeros_operator(int(nbytes))
    b = np.arange(256, dtype=np.uint32)
    out = np.zeros((4, 256), dtype=np.uint32)
    for i in range(4):
        for q in range(8):
            out[i] ^= np.where((b >> np.uint32(q)) & 1, cols[8 * i + q],
                               0).astype(np.uint32)
    return out


@functools.lru_cache(maxsize=64)
def _fold_tables(piece: int) -> np.ndarray:
    """(8, 4, 256) uint32: level k shifts by ``piece * 2^k`` bytes."""
    return np.stack([shift_tables(piece << k) for k in range(LEVELS)])


@functools.lru_cache(maxsize=1024)
def _zeros_crc(nbytes: int) -> int:
    """``zlib.crc32`` of ``nbytes`` zero bytes."""
    return int(_apply(_zeros_operator(int(nbytes)),
                      np.uint32(0xFFFFFFFF))) ^ 0xFFFFFFFF


def crc32_segments(n: int, span_len: int, head: int = 0) -> int:
    """How many CRCs :func:`crc32_spans` returns for ``n`` bytes."""
    return (1 if head else 0) + -(-(n - head) // span_len)


def _plan(data: torch.Tensor, n: int, span_len: int, head: int):
    """Check the arguments; the flat bytes, the segment count, the piece
    length and the three zero-byte constants of the launch."""
    if data.dtype != torch.uint8:
        raise TypeError(f"crc32_spans needs uint8 data, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    flat = data.reshape(-1)
    n, span_len, head = int(n), int(span_len), int(head)
    if span_len < 1:
        raise ValueError(f"span length {span_len} is not positive")
    if not 0 <= n <= flat.numel():
        raise ValueError(f"{n} valid bytes of a tensor of {flat.numel()}")
    if not 0 <= head <= min(n, span_len):
        raise ValueError(f"head {head} outside 0..min({n}, {span_len})")
    nseg = crc32_segments(n, span_len, head)
    if nseg >= 1 << 31:
        raise ValueError(f"{nseg} spans exceed one launch")
    body = nseg - (1 if head else 0)
    last = (n - head) - (body - 1) * span_len if body else head
    consts = (_zeros_crc(span_len), _zeros_crc(head), _zeros_crc(last))
    return flat, nseg, -(-span_len // PIECES), consts


_DEVICE_TABLES: dict = {}  # (device, piece) -> the slicing and fold tables


def _tables_on(dev: torch.device, piece: int):
    """The slicing and fold tables on ``dev``, copied once a process (not
    counted in ``h2d_bytes``, which counts a call's copies)."""
    key = (str(dev), piece)
    got = _DEVICE_TABLES.get(key)
    if got is None:
        got = tuple(torch.from_numpy(t.view(np.int32).copy()).to(dev)
                    for t in (slice_tables(), _fold_tables(piece)))
        _DEVICE_TABLES[key] = got
    return got


def crc32_spans(data: torch.Tensor, n: int, span_len: int, head: int = 0
                ) -> torch.Tensor:
    """zlib CRC32s of the first ``n`` bytes of ``data`` (any contiguous
    uint8 tensor, read flat): of ``[0, head)`` where ``head > 0``, then of
    each ``span_len`` bytes from ``head`` on, the last one short.  Returns
    a (:func:`crc32_segments`,) int32 tensor of the CRCs' bit patterns on
    ``data``'s device (``.numpy().view(np.uint32)`` on the host).
    ``head`` is at most ``span_len`` and ``n``.

    CUDA tensors launch the kernel (``csrc/crc32.cu``) on the current
    stream: one launch, counted in ``crc32_spans.launches`` and its bytes
    in ``crc32_spans.bytes``; CPU tensors take
    :func:`crc32_spans_reference`.  Either way ``n`` is added to the
    tracer's counter ``crc_device_bytes``."""
    flat, nseg, piece, consts = _plan(data, n, span_len, head)
    count("crc_device_bytes", int(n))
    if data.device.type == "cpu":
        return crc32_spans_reference(data, n, span_len, head)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    with span("launch"):
        dev = data.device
        out = torch.empty(nseg, dtype=torch.int32, device=dev)
        if nseg == 0:
            return out
        slices, fold = _tables_on(dev, piece)
        _build.launch("tpuhuff_crc32_spans", dev, flat.data_ptr(), int(n),
                      int(span_len), int(head), piece, nseg, *consts,
                      slices.data_ptr(), fold.data_ptr(), out.data_ptr())
        crc32_spans.launches += 1
        crc32_spans.bytes += int(n)
        return out


crc32_spans.launches = 0
crc32_spans.bytes = 0


def _apply_tables(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The map of the (4, 256) byte tables ``t`` on each int32 of ``v``."""
    return (t[0][(v & 0xFF).long()] ^ t[1][((v >> 8) & 0xFF).long()]
            ^ t[2][((v >> 16) & 0xFF).long()] ^ t[3][((v >> 24) & 0xFF).long()])


def _tables32(t: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(t.view(np.int32).copy()).to(dev)


def crc32_spans_reference(data: torch.Tensor, n: int, span_len: int,
                          head: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`crc32_spans` (any device), with the
    same windows, tables and fold, vectorized over every piece of every
    segment.  A piece's raw CRC is itself a fold: each 16-byte word's raw
    CRC from the slicing tables (one gather a byte position), then the
    words folded pairwise, level k shifting by ``16 * 2^k`` bytes; then
    the pieces' eight levels.  So its steps do not grow with the span."""
    flat, nseg, piece, (k_span, k_head, k_last) = _plan(data, n, span_len,
                                                        head)
    dev = data.device
    if nseg == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    W = PIECES * piece
    flat = flat[:n]

    def window(seg: torch.Tensor) -> torch.Tensor:  # (k, len) -> (k, W)
        return torch.nn.functional.pad(seg, (W - seg.shape[1], 0))

    parts, zeros = [], []
    if head:
        parts.append(window(flat[:head].view(1, head)))
        zeros.append(k_head)
    body = flat[head:]
    whole = body.numel() // span_len
    if whole:
        full = body[:whole * span_len].view(whole, span_len)
        parts.append(full if W == span_len else window(full))
        zeros += [k_span] * whole
    if body.numel() > whole * span_len:
        parts.append(window(body[whole * span_len:].view(1, -1)))
        zeros.append(k_last)
    win = parts[0] if len(parts) == 1 else torch.cat(parts)
    # each piece, zeros in front to a power of two of 16-byte words
    words = 1 << (-(-piece // 16) - 1).bit_length()
    pieces = torch.nn.functional.pad(win.reshape(nseg * PIECES, piece),
                                     (16 * words - piece, 0))
    pieces = pieces.view(-1, words, 16)
    T = _tables32(slice_tables(), dev)
    v = T[15][pieces[:, :, 0].long()]
    for i in range(1, 16):  # byte i of a word takes table 15 - i
        v ^= T[15 - i][pieces[:, :, i].long()]
    k = 0
    while v.shape[1] > 1:
        v = _apply_tables(_tables32(shift_tables(16 << k), dev),
                          v[:, 0::2]) ^ v[:, 1::2]
        k += 1
    vals = v.view(nseg, PIECES)
    F = _tables32(_fold_tables(piece), dev)
    for k in range(LEVELS):
        vals = _apply_tables(F[k], vals[:, 0::2]) ^ vals[:, 1::2]
    return vals[:, 0] ^ torch.from_numpy(
        np.array(zeros, dtype=np.uint32).view(np.int32)).to(dev)
