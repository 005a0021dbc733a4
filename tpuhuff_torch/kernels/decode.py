"""Device decode: prefix-code decode of independent blocks.

Counterpart of :func:`tpuhuff.kernels.decode.decode_rows_device` and its
two Pallas kernels.  The ``.hf2`` block index makes every block an
independent lane: ``rows`` (B, W) holds each block's payload words,
``bit0``/``nbits`` its start bit and bit count, and the output is (B,
block_len) uint8, zero past each block's symbols.  Two kernels map the
next 32 bits to (symbol, code length):

* :func:`decode_rows` (K2, ``csrc/decode.cu``) — the canonical ladder, for
  trees whose codes are canonical (``tpuhuff.kernels.pallas_decode.
  _decode_kernel``);
* :func:`decode_rows_general` (K4, ``csrc/decode_general.cu``) — an
  interval search over the sorted left-aligned leaf codes, for any prefix
  tree (``tpuhuff.kernels.pallas_decode._decode_kernel_general``).

:func:`decoder_for` picks one from the tree itself.  The table
construction and the host row gather (:func:`payload_to_lane_words`) are
the JAX package's, with the same arithmetic, so both packages feed their
kernels identical operands; :func:`lane_rows` (S2, ``csrc/lane_rows.cu``)
makes the same rows from a payload that lies on the device.

Both kernels first look the window's top ``LUT_BITS`` bits up in a
first-level table, ``lut`` (:func:`first_level_table`, built here on the
host), and run their own rule above only where an entry escapes.  Rows of
which shared memory holds fewer than 32 (:func:`decode_tile_rows` 0) take
the kernels' global-rows route, which reads them from device memory with
one thread block per block, the block's bits split across its threads into
subsequences that synchronise themselves (``csrc/decode_split.cuh``); the
launch reports the route it took.  Each wrapper counts its launches and
their blocks in ``<wrapper>.launches`` and ``.blocks``, and those of the
global-rows route also in ``.global_launches`` and ``.global_blocks``:
totals over the process, which read without a tracer.  The active
tracer's counter ``global_rows_blocks`` gives the same blocks per traced
file call, in that call's record.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core.canonical import canonical_codes_from_lengths
from ..core.tree import HuffTree
from ..profiling import count, span
from . import _build
from .encode import _i64_to_i32, as_i32

__all__ = [
    "DecodeTables",
    "GeneralDecodeTables",
    "make_canonical_decode_tables",
    "make_decode_tables",
    "first_level_table",
    "LUT_BITS",
    "decoder_for",
    "payload_to_lane_words",
    "row_width",
    "lane_rows",
    "lane_rows_reference",
    "decode_rows",
    "decode_rows_reference",
    "decode_rows_general",
    "decode_rows_general_reference",
    "decode_tile_rows",
    "decode_hf2_device",
]

_U32 = 0xFFFFFFFF
# k of the first-level table: 2^k entries of 16 bits in each thread block's
# shared memory.  14 covers every code of the main input's trees, so none
# escapes (experiments/decode_lut_sweep.py).  The kernels' own k is
# TPUHUFF_DECODE_LUT_BITS in csrc/decode_split.cuh, the same number.
LUT_BITS = 14


def first_level_table(tables, k: int = LUT_BITS) -> torch.Tensor:
    """The (2^k,) int16 first-level table of ``tables``' rule (a
    :class:`DecodeTables`' ladder or a :class:`GeneralDecodeTables`'
    search); the kernels take ``k = LUT_BITS``.

    The rule maps a u32 window to ``(symbol, length)`` and a step that
    never falls as the window grows and that, held on a k-bit prefix with
    ``length <= k``, holds ``(symbol, length)`` too.  Entry ``e`` holds
    ``symbol | length << 8`` if the step is the same at the lowest window
    ``e << (32-k)`` and at the highest ``lo | (2^(32-k) - 1)``, hence on
    every window in between, with ``1 <= length <= k``; else 0 ("escape":
    the kernel runs the rule on the window).
    """
    rule = (_search_rule(tables) if isinstance(tables, GeneralDecodeTables)
            else _ladder_rule(tables))
    lo = np.arange(1 << k, dtype=np.uint64) << np.uint64(32 - k)
    hi = lo | np.uint64((1 << (32 - k)) - 1)
    (sym, ln, step_lo), (_, _, step_hi) = rule(lo), rule(hi)
    ok = (step_lo == step_hi) & (ln >= 1) & (ln <= k)
    return torch.from_numpy(np.where(ok, sym | (ln << 8), 0).astype(np.int16))


def _u32(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor's bit patterns as uint64 numpy."""
    return t.cpu().numpy().view(np.uint32).astype(np.uint64)


def _ladder_rule(tables: "DecodeTables"):
    """K2's rule (:func:`decode_rows_reference`) on numpy windows; its step
    is the length, the count of thresholds at or below the window: where
    the count holds, so does the set of thresholds counted, hence the
    index offset, and a length <= k reads only the prefix's bits."""
    ml = tables.max_len
    ub = _u32(tables.ub)[: ml - 1]
    dd = tables.dd.cpu().numpy().astype(np.int64)
    perm = tables.perm.cpu().numpy().astype(np.int64)

    def rule(w):
        ind = (w[:, None] >= ub[None, :]).astype(np.int64)
        ln = 1 + ind.sum(axis=1)
        delta = dd[0] + (ind * dd[None, 1:ml]).sum(axis=1)
        idx = ((w >> (32 - ln).astype(np.uint64)).astype(np.int64)
               + delta) & 255
        return perm[idx], ln, ln

    return rule


def _search_rule(tables: "GeneralDecodeTables"):
    """K4's rule (:func:`decode_rows_general_reference`) on numpy windows;
    its step is the leaf index."""
    thr = _u32(tables.thr)
    sym = tables.sym.cpu().numpy().astype(np.int64)
    lens = tables.len.cpu().numpy().astype(np.int64)

    def rule(w):
        idx = np.maximum(np.searchsorted(thr, w, side="right") - 1, 0)
        return sym[idx], lens[idx], idx

    return rule


def _unpack4(perm4: np.ndarray) -> np.ndarray:
    """(64,) u32 packed 4 bytes per word (low byte first) -> (256,) uint8."""
    return np.ascontiguousarray(perm4, dtype=np.uint32).reshape(64).view(
        "<u4").view(np.uint8).copy()


@dataclass(frozen=True)
class DecodeTables:
    """Canonical decode ladder: ``ub`` (32,) int32 bit patterns of the u32
    left-aligned exclusive upper bounds per length, ``dd`` (32,) int32
    ladder deltas, ``perm`` (256,) uint8 canonical index -> byte, the
    tree's ``max_len`` (1..32), and ``lut`` (2^LUT_BITS,) int16, the
    ladder's first-level table (:func:`first_level_table`), built from the
    other fields where none is given."""

    ub: torch.Tensor
    dd: torch.Tensor
    perm: torch.Tensor
    max_len: int
    lut: torch.Tensor | None = None

    def __post_init__(self):
        if self.lut is None:
            object.__setattr__(self, "lut", first_level_table(self))

    @classmethod
    def from_numpy(cls, ub, dd, perm4, max_len: int) -> "DecodeTables":
        """From :func:`tpuhuff.kernels.decode.make_canonical_decode_tables`
        output as numpy: ``(ub u32[<=31], dd i32[<=32], perm4 u32[64], ml)``."""
        ml = int(max_len)
        if not 1 <= ml <= 32:
            raise OverflowError("device decoder supports code lengths <= 32")
        ub32 = np.zeros(32, np.uint32)
        ub = np.asarray(ub, dtype=np.uint32).reshape(-1)
        ub32[: ub.size] = ub
        dd32 = np.zeros(32, np.int32)
        dd = np.asarray(dd, dtype=np.int32).reshape(-1)
        dd32[: dd.size] = dd
        return cls(as_i32(ub32), torch.from_numpy(dd32),
                   torch.from_numpy(_unpack4(perm4)), ml)

    def to(self, device) -> "DecodeTables":
        return DecodeTables(self.ub.to(device), self.dd.to(device),
                            self.perm.to(device), self.max_len,
                            self.lut.to(device))


def make_canonical_decode_tables(tree: HuffTree) -> DecodeTables | None:
    """Ladder tables for a tree with CANONICAL codes, or None otherwise
    (same construction as :func:`tpuhuff.kernels.decode.make_canonical_decode_tables`):

    * ``ub[L-1]``: exclusive upper bound, left-aligned, of all codes of
      length <= L, clamped to 0xFFFFFFFF; ``len = 1 + #(window >= ub)``;
    * ``dd``: deltas folding the index offsets into the same compares,
      ``idx = (window >> (32-len)) + dd[0] + sum ind_L * dd[L]``;
    * ``perm``: canonical index -> byte, padded with the last symbol;
    * ``lut``: the ladder's first-level table of ``2^LUT_BITS`` entries.
    """
    codes = tree.read_codes()
    lengths = [(letter, code.length) for letter, code in codes.items()]
    if any(l > 32 for _, l in lengths):
        return None
    want = canonical_codes_from_lengths(lengths)
    for letter, code in codes.items():
        if want[letter] != (code.value, code.length):
            return None
    items = sorted(codes.items(), key=lambda kv: (kv[1].length, kv[0]))
    ml = max(l for _, l in lengths)
    count = np.zeros(ml + 1, dtype=np.int64)
    for _, l in lengths:
        count[l] += 1
    first = np.zeros(ml + 1, dtype=np.int64)
    code_v = 0
    for L in range(1, ml + 1):
        code_v = (code_v + count[L - 1]) << 1
        first[L] = code_v
    cum_before = np.concatenate([[0], np.cumsum(count[1:])])[:-1]
    delta = [int(cum_before[L - 1] - first[L]) for L in range(1, ml + 1)]
    ub = np.zeros(max(ml - 1, 1), dtype=np.uint32)
    for L in range(1, ml):
        ub[L - 1] = min(int(first[L] + count[L]) << (32 - L), _U32)
    dd = np.zeros(ml, dtype=np.int32)
    dd[0] = delta[0]
    for j in range(1, ml):
        dd[j] = delta[j] - delta[j - 1]
    perm = np.zeros(256, dtype=np.uint8)
    K = len(items)
    perm[:K] = [int(letter) for letter, _ in items]
    if K < 256:
        perm[K:] = perm[K - 1]
    perm4 = perm.view("<u4").copy()
    return DecodeTables.from_numpy(ub, dd, perm4, ml)


@dataclass(frozen=True)
class GeneralDecodeTables:
    """Interval tables for any prefix tree: ``thr`` (256,) int32 bit
    patterns of the u32 left-aligned leaf codes, ascending; ``sym`` and
    ``len`` (256,) uint8 each leaf's byte and code length.  Entries past
    the leaf count repeat the last leaf.  ``lut`` (2^LUT_BITS,) int16 is
    the search's first-level table (:func:`first_level_table`), built from
    the other fields where none is given."""

    thr: torch.Tensor
    sym: torch.Tensor
    len: torch.Tensor
    lut: torch.Tensor | None = None

    def __post_init__(self):
        if self.lut is None:
            object.__setattr__(self, "lut", first_level_table(self))

    def to(self, device) -> "GeneralDecodeTables":
        return GeneralDecodeTables(self.thr.to(device), self.sym.to(device),
                                   self.len.to(device), self.lut.to(device))


def make_decode_tables(tree: HuffTree) -> GeneralDecodeTables:
    """Interval tables of any prefix tree (the construction of
    :func:`tpuhuff.kernels.decode.make_decode_tables`, unpacked): leaf k in
    left-to-right order has the k-th smallest left-aligned code, so the
    leaves partition [0, 2^32) and ``count(thr <= window) - 1`` is the
    leaf whose code starts the window.  Codes longer than 32 bits raise
    :class:`OverflowError`."""
    items = []
    for letter, code in tree.read_codes().items():
        if code.length > 32:
            raise OverflowError("device decoder supports code lengths <= 32")
        items.append((code.value << (32 - code.length), int(letter),
                      code.length))
    items.sort()
    K = len(items)
    thr = np.zeros(256, dtype=np.uint32)
    sym = np.zeros(256, dtype=np.uint8)
    lens = np.zeros(256, dtype=np.uint8)
    thr[:K] = [a for a, _, _ in items]
    sym[:K] = [s for _, s, _ in items]
    lens[:K] = [l for _, _, l in items]
    thr[K:], sym[K:], lens[K:] = thr[K - 1], sym[K - 1], lens[K - 1]
    return GeneralDecodeTables(as_i32(thr), torch.from_numpy(sym),
                               torch.from_numpy(lens))


def decoder_for(tree: HuffTree):
    """``(wrapper, tables)`` that decode ``tree``'s blocks: the canonical
    ladder (:func:`decode_rows`) when its codes are canonical, detected
    from the tree itself and not from a container's flag, else the
    interval search (:func:`decode_rows_general`) — the choice of
    :func:`tpuhuff.kernels.decode.decode_rows_device`."""
    tables = make_canonical_decode_tables(tree)
    if tables is not None:
        return decode_rows, tables
    return decode_rows_general, make_decode_tables(tree)


def payload_to_lane_words(payload, start_bits: np.ndarray, end_bits: np.ndarray,
                          block_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Slice a stitched payload into per-block u32 word rows (host).

    Block k's row starts at the u32 word holding ``start_bits[k]``.  Returns
    ``(rows (B, W) uint32, bit0 (B,) int32)``, ``bit0`` the start bit inside
    the row; W is :func:`row_width`.  Same layout as
    :func:`tpuhuff.kernels.decode.payload_to_lane_words`; the gather is
    the host runtime's threaded ``extract_rows``.
    """
    raw = (payload.view(np.uint8) if isinstance(payload, np.ndarray)
           else np.frombuffer(bytes(payload), dtype=np.uint8))
    nwords = (raw.size + 3) // 4 + 2  # whole words + slack for window overreach
    buf = np.zeros(nwords * 4, dtype=np.uint8)
    buf[: raw.size] = raw
    words = buf.view(">u4").astype(np.uint32)
    start_w = (np.asarray(start_bits) // 32).astype(np.int64)
    rows = native.extract_rows(words, start_w.astype(np.uint64),
                               row_width(start_bits, end_bits))
    bit0 = (np.asarray(start_bits) - start_w * 32).astype(np.int32)
    return rows, bit0


def row_width(start_bits, end_bits) -> int:
    """W, the words of each block's row (:func:`lane_rows`,
    :func:`payload_to_lane_words`): the longest block's words, from the
    word of its first bit to that of its last, and one slack word, so that
    the 2-word window never reads past the row; 2 for no blocks.
    ``start_bits`` and ``end_bits`` (B,) are each block's bit offsets, as
    host arrays."""
    starts = np.asarray(start_bits, dtype=np.int64).reshape(-1)
    ends = np.asarray(end_bits, dtype=np.int64).reshape(-1)
    if starts.shape != ends.shape:
        raise ValueError("start_bits and end_bits must have one entry a block")
    if starts.size and min(int(starts.min()), int(ends.min())) < 0:
        raise ValueError("bit offsets must not be negative")
    # shifts, not floor divisions: numpy's integer division is slow
    return int(np.max(((ends + 31) >> 5) - (starts >> 5), initial=0)) + 2


def lane_rows(payload: torch.Tensor, starts: torch.Tensor, width: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cut each block's row of big-endian u32 words out of a payload that
    lies on the device (S2): the decoders' operand, without a host gather.

    ``payload`` is a contiguous (n,) uint8 tensor; ``starts`` (B,) int64,
    on the payload's device, is each block's first bit in it, and
    ``width`` the words of a row (:func:`row_width` of the blocks' bit
    offsets).  Returns ``(rows (B, W) int32, bit0 (B,) int32)`` on the
    payload's device, the layout of :func:`payload_to_lane_words`:
    ``rows[b, j]`` is the big-endian word ``starts[b] // 32 + j`` of the
    payload, 0 past its end, and ``bit0[b] = starts[b] % 32``.  CUDA
    tensors launch the kernel (``csrc/lane_rows.cu``), counted in
    ``lane_rows.launches``; CPU tensors take :func:`lane_rows_reference`.
    """
    _check_rows_args(payload, starts)
    if payload.device.type == "cpu":
        return lane_rows_reference(payload, starts, width)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    with span("launch"):
        B = starts.numel()
        if B * width >= 1 << 31:
            raise ValueError(f"{B} rows of {width} words exceed one launch")
        dev = payload.device
        rows = torch.empty((B, width), dtype=torch.int32, device=dev)
        bit0 = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return rows, bit0
        _build.launch("tpuhuff_lane_rows", dev, payload.data_ptr(),
                      payload.numel(), starts.data_ptr(), rows.data_ptr(),
                      bit0.data_ptr(), B, width)
        lane_rows.launches += 1
        return rows, bit0


lane_rows.launches = 0


def _check_rows_args(payload, starts) -> None:
    if payload.dim() != 1 or payload.dtype != torch.uint8:
        raise ValueError("payload must be a (n,) uint8 tensor")
    if not payload.is_contiguous():
        raise ValueError("payload must be contiguous")
    _build.check_tensor(starts, "starts", torch.int64, (starts.numel(),),
                        payload.device)


def lane_rows_reference(payload: torch.Tensor, starts: torch.Tensor,
                        width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lane_rows` (any device): the payload
    padded to whole words and two slack words, assembled into big-endian
    int64 words, and gathered by index (indices past the end give 0)."""
    _check_rows_args(payload, starts)
    dev = payload.device
    n = payload.numel()
    nwords = (n + 3) // 4 + 2
    buf = torch.zeros(nwords * 4, dtype=torch.int64, device=dev)
    buf[:n] = payload.long()
    b = buf.view(nwords, 4)
    words = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    idx = (starts >> 5)[:, None] + torch.arange(width, device=dev)[None, :]
    rows = torch.where(idx < nwords, words[idx.clamp(max=nwords - 1)], 0)
    return _i64_to_i32(rows), (starts & 31).to(torch.int32)


def _check_args(rows, bit0, nbits, tables, block_len):
    """Operand checks of both decoders; returns ``(B, W)``."""
    if rows.dim() != 2:
        raise ValueError("rows must be (B, W) int32")
    B, W = rows.shape
    if block_len < 1:
        raise ValueError("block_len must be positive")
    dev = rows.device
    _build.check_tensor(rows, "rows", torch.int32, (B, W), dev)
    _build.check_tensor(bit0, "bit0", torch.int32, (B,), dev)
    _build.check_tensor(nbits, "nbits", torch.int32, (B,), dev)
    if isinstance(tables, GeneralDecodeTables):
        _build.check_tensor(tables.thr, "tables.thr", torch.int32, (256,), dev)
        _build.check_tensor(tables.sym, "tables.sym", torch.uint8, (256,), dev)
        _build.check_tensor(tables.len, "tables.len", torch.uint8, (256,), dev)
    else:
        _build.check_tensor(tables.ub, "tables.ub", torch.int32, (32,), dev)
        _build.check_tensor(tables.dd, "tables.dd", torch.int32, (32,), dev)
        _build.check_tensor(tables.perm, "tables.perm", torch.uint8, (256,),
                            dev)
    if isinstance(tables, DecodeTables) and not 1 <= tables.max_len <= 32:
        raise ValueError("tables.max_len must be in 1..32")
    _build.check_tensor(tables.lut, "tables.lut", torch.int16,
                        (1 << LUT_BITS,), dev)
    return B, W


def _windows(rows: torch.Tensor):
    """The plain versions' window reader: ``window(cur)`` gives each
    block's next 32 bits at bit ``cur`` (int64), words past W read as 0."""
    B, W = rows.shape
    words = torch.zeros((B, W + 2), dtype=torch.int64, device=rows.device)
    words[:, :W] = rows.long() & _U32

    def window(cur: torch.Tensor) -> torch.Tensor:
        q = (cur >> 5).clamp(max=W)[:, None]
        rr = cur & 31
        w0 = words.gather(1, q)[:, 0]
        w1 = words.gather(1, q + 1)[:, 0]
        return ((w0 << rr) | (w1 >> (32 - rr))) & _U32

    return window


def decode_rows(rows: torch.Tensor, bit0: torch.Tensor, nbits: torch.Tensor,
                tables: DecodeTables, block_len: int) -> torch.Tensor:
    """Decode B blocks of up to ``block_len`` symbols; returns (B,
    block_len) uint8, zero past each block's last whole code within
    ``nbits``.  ``rows`` (B, W) int32 holds u32 bit patterns, MSB-first.

    CUDA tensors launch the kernel (``csrc/decode.cu``); CPU tensors take
    :func:`decode_rows_reference`."""
    B, W = _check_args(rows, bit0, nbits, tables, block_len)
    if rows.device.type == "cpu":
        return decode_rows_reference(rows, bit0, nbits, tables, block_len)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    with span("launch"):
        out = torch.empty((B, block_len), dtype=torch.uint8, device=rows.device)
        route = ctypes.c_int(0)
        _build.launch("tpuhuff_decode_rows", rows.device, rows.data_ptr(),
                      bit0.data_ptr(), nbits.data_ptr(), tables.ub.data_ptr(),
                      tables.dd.data_ptr(), tables.perm.data_ptr(),
                      tables.lut.data_ptr(), out.data_ptr(), B, W, int(block_len),
                      tables.max_len, ctypes.addressof(route))
        _counted(_K2, B, route.value)
        return out


def _counted(wrapper, B: int, global_rows: int) -> None:
    """One launch of ``B`` blocks, on the global-rows route where
    ``global_rows`` is 1, added to ``wrapper``'s counters."""
    wrapper.launches += 1
    wrapper.blocks += B
    if global_rows:
        wrapper.global_launches += 1
        wrapper.global_blocks += B
        count("global_rows_blocks", B)


# The counters live on the functions as defined here (_K2, _K4), so that a
# wrapper set over a module name from outside (a benchmark's timer) leaves
# every launch counted where it is read.
_K2 = decode_rows
decode_rows.launches = 0         # K2, both routes
decode_rows.global_launches = 0  # K2's global-rows route
decode_rows.blocks = 0           # the blocks of those launches
decode_rows.global_blocks = 0


def decode_rows_reference(rows: torch.Tensor, bit0: torch.Tensor,
                          nbits: torch.Tensor, tables: DecodeTables,
                          block_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_rows` (any device): one
    vectorised step over all blocks per output position, in int64."""
    B, W = _check_args(rows, bit0, nbits, tables, block_len)
    dev = rows.device
    ml = tables.max_len
    window_at = _windows(rows)
    ub = (tables.ub.long() & _U32)[: ml - 1]
    dd = tables.dd.long()
    perm = tables.perm.long()
    cur = bit0.long()
    consumed = torch.zeros(B, dtype=torch.int64, device=dev)
    limit = nbits.long()
    out = torch.zeros((B, block_len), dtype=torch.uint8, device=dev)
    for i in range(block_len):
        window = window_at(cur)
        ind = (window[:, None] >= ub[None, :]).long()
        ln = 1 + ind.sum(dim=1)
        delta = dd[0] + (ind * dd[None, 1:ml]).sum(dim=1)
        idx = ((window >> (32 - ln)) + delta) & 255
        active = consumed + ln <= limit
        out[:, i] = torch.where(active, perm[idx], 0).to(torch.uint8)
        ln = torch.where(active, ln, 0)
        cur = cur + ln
        consumed = consumed + ln
    return out


def decode_rows_general(rows: torch.Tensor, bit0: torch.Tensor,
                        nbits: torch.Tensor, tables: GeneralDecodeTables,
                        block_len: int) -> torch.Tensor:
    """:func:`decode_rows` for any prefix tree: the same operands and
    output, with :func:`make_decode_tables`' interval tables.

    CUDA tensors launch the kernel (``csrc/decode_general.cu``); CPU
    tensors take :func:`decode_rows_general_reference`."""
    B, W = _check_args(rows, bit0, nbits, tables, block_len)
    if rows.device.type == "cpu":
        return decode_rows_general_reference(rows, bit0, nbits, tables,
                                             block_len)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    with span("launch"):
        out = torch.empty((B, block_len), dtype=torch.uint8, device=rows.device)
        route = ctypes.c_int(0)
        _build.launch("tpuhuff_decode_rows_general", rows.device, rows.data_ptr(),
                      bit0.data_ptr(), nbits.data_ptr(), tables.thr.data_ptr(),
                      tables.sym.data_ptr(), tables.len.data_ptr(),
                      tables.lut.data_ptr(), out.data_ptr(), B, W, int(block_len),
                      ctypes.addressof(route))
        _counted(_K4, B, route.value)
        return out


_K4 = decode_rows_general
decode_rows_general.launches = 0         # K4, both routes
decode_rows_general.global_launches = 0  # K4's global-rows route
decode_rows_general.blocks = 0           # the blocks of those launches
decode_rows_general.global_blocks = 0


def decode_rows_general_reference(rows: torch.Tensor, bit0: torch.Tensor,
                                  nbits: torch.Tensor,
                                  tables: GeneralDecodeTables,
                                  block_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_rows_general` (any device):
    one vectorised step over all blocks per output position, the leaf
    found by ``searchsorted`` over the thresholds."""
    B, W = _check_args(rows, bit0, nbits, tables, block_len)
    dev = rows.device
    window_at = _windows(rows)
    thr = tables.thr.long() & _U32
    sym = tables.sym.long()
    lens = tables.len.long()
    cur = bit0.long()
    consumed = torch.zeros(B, dtype=torch.int64, device=dev)
    limit = nbits.long()
    out = torch.zeros((B, block_len), dtype=torch.uint8, device=dev)
    for i in range(block_len):
        # count(thr <= window) - 1; thr[0] is 0 for every full binary tree
        idx = (torch.searchsorted(thr, window_at(cur), right=True) - 1
               ).clamp(min=0)
        ln = lens[idx]
        active = consumed + ln <= limit
        out[:, i] = torch.where(active, sym[idx], 0).to(torch.uint8)
        ln = torch.where(active, ln, 0)
        cur = cur + ln
        consumed = consumed + ln
    return out


def decode_tile_rows(B: int, W: int, block_len: int, general: bool,
                     device="cuda") -> int:
    """Huffman blocks per thread block that :func:`decode_rows` (or, with
    ``general``, :func:`decode_rows_general`) stages through shared memory
    on ``device`` for B rows of W words; 0 where the launch takes the
    global-rows route (fewer than 32 rows fit there)."""
    name = ("tpuhuff_decode_rows_general_tile" if general
            else "tpuhuff_decode_rows_tile")
    with torch.cuda.device(torch.device(device)):
        n = getattr(_build.lib(), name)(int(B), int(W), int(block_len))
    if n < 0:
        raise RuntimeError(f"{name}: CUDA error")
    return n


def decode_hf2_device(header, payload: bytes, device="cuda") -> bytes:
    """Decode a whole ``.hf2`` payload on ``device``; returns the original
    bytes (counterpart of :func:`tpuhuff.kernels.decode.decode_hf2_device`,
    with its choice of decoder, :func:`decoder_for`)."""
    decode, tables = decoder_for(header.tree)
    ends = header.end_bits.astype(np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    rows, bit0 = payload_to_lane_words(payload, starts, ends, header.block_len)
    device = torch.device(device)
    out = decode(
        as_i32(rows).to(device), torch.from_numpy(bit0).to(device),
        torch.from_numpy((ends - starts).astype(np.int32)).to(device),
        tables.to(device), header.block_len)
    return out.cpu().numpy().reshape(-1)[: header.orig_len].tobytes()
