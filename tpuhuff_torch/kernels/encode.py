"""Device encode: pack lanes of bytes into MSB-first Huffman bitstreams.

Counterpart of :mod:`tpuhuff.kernels.encode` (``encode_blocks``) and of the
Pallas kernels of ``tpuhuff.kernels.pallas_encode2``: the fused
``_encode_kernel_fused`` with and without its ``hist_data`` histogram, and
``_encode_kernel`` behind the flat and cell-major layouts.
The contract is the same: per lane, u32 words MSB-first plus an exact bit
count; bytes past ``valid_lens`` emit nothing; valid bytes without a code
are counted as missing; with ``hist_data``, the exact counts of a second
byte operand.  The lookup is a dense 256-entry ``(len, left-aligned
code)`` table, so one kernel serves every tree with codes of up to 32
bits, canonical or not, and every power-of-two lane length up to 1024.

32-bit words cross the kernel interface as ``torch.int32`` bit patterns;
the plain version computes in ``int64``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..profiling import span
from . import _build

__all__ = [
    "EncodeTables",
    "make_encode_tables",
    "out_words",
    "encode_blocks",
    "encode_blocks_reference",
    "count_missing",
    "block_bit_lengths",
    "words_to_payload",
]

_U32 = 0xFFFFFFFF


def as_i32(values_u32: np.ndarray) -> torch.Tensor:
    """u32 numpy values -> int32 tensor holding the same bit patterns."""
    arr = np.ascontiguousarray(values_u32, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy())


def as_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> u32 numpy values (on the host)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _i64_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


@dataclass(frozen=True)
class EncodeTables:
    """Dense encode LUT: ``lens`` (256,) int32 code lengths (0 = no code)
    and ``acodes`` (256,) int32 bit patterns of the u32 codes left-aligned
    to bit 31.  ``max_len`` bounds the lengths (at least 1)."""

    lens: torch.Tensor
    acodes: torch.Tensor
    max_len: int

    @classmethod
    def from_numpy(cls, lens: np.ndarray, acodes: np.ndarray) -> "EncodeTables":
        """From :func:`tpuhuff.kernels.encode.make_encode_tables` output as
        numpy: ``(lens i32[256], acodes u32[256])``."""
        lens = np.asarray(lens, dtype=np.int64).reshape(256)
        if lens.min() < 0 or lens.max() > 32:
            raise OverflowError("device encoder supports code lengths <= 32 bits")
        return cls(torch.from_numpy(lens.astype(np.int32)),
                   as_i32(np.asarray(acodes).reshape(256)),
                   max(1, int(lens.max())))

    def to(self, device) -> "EncodeTables":
        return EncodeTables(self.lens.to(device), self.acodes.to(device),
                            self.max_len)


def make_encode_tables(lens_lut: np.ndarray, codes_lut: np.ndarray) -> EncodeTables:
    """Dense LUT from :meth:`tpuhuff.core.tree.HuffTree.encode_tables`
    output (same arithmetic as :func:`tpuhuff.kernels.encode.make_encode_tables`).
    Codes longer than 32 bits raise :class:`OverflowError`."""
    lens = np.asarray(lens_lut, dtype=np.int64)
    codes = np.asarray(codes_lut, dtype=np.uint64)
    if lens.max(initial=0) > 32:
        raise OverflowError("device encoder supports code lengths <= 32 bits")
    full = np.zeros(256, dtype=np.uint64)
    has = lens > 0
    full[has] = codes[has] << (32 - lens[has]).astype(np.uint64)
    return EncodeTables.from_numpy(lens, (full & _U32).astype(np.uint32))


def out_words(n_syms: int, max_len: int) -> int:
    """Words per lane: a lane of ``n_syms`` codes of <= ``max_len`` bits."""
    return max(1, -(-n_syms * max_len // 32))


def _check_args(lanes, valid_lens, tables, max_code_len):
    if lanes.dim() != 2:
        raise ValueError("lanes must be (B, N) uint8")
    B, N = lanes.shape
    if N < 1 or N & (N - 1) or N > 1024:
        raise ValueError(f"lane length {N} must be a power of two <= 1024")
    ml = tables.max_len if max_code_len is None else int(max_code_len)
    if not tables.max_len <= ml <= 32:
        raise ValueError(f"max_code_len {ml} must cover the tables' "
                         f"{tables.max_len} and be <= 32")
    dev = lanes.device
    _build.check_tensor(lanes, "lanes", torch.uint8, (B, N), dev)
    _build.check_tensor(valid_lens, "valid_lens", torch.int32, (B,), dev)
    _build.check_tensor(tables.lens, "tables.lens", torch.int32, (256,), dev)
    _build.check_tensor(tables.acodes, "tables.acodes", torch.int32, (256,), dev)
    return B, N, out_words(N, ml)


def _check_hist(hist_data, limit: int, device) -> None:
    if hist_data.device != device:
        raise ValueError(f"hist_data is on {hist_data.device}, expected {device}")
    if hist_data.dtype != torch.uint8:
        raise TypeError(f"hist_data has dtype {hist_data.dtype}, expected uint8")
    if not hist_data.is_contiguous():
        raise ValueError("hist_data must be contiguous")
    if hist_data.numel() > limit:
        raise ValueError(f"hist_data has {hist_data.numel()} bytes, more than "
                         f"the lanes' {limit}")


def encode_blocks(lanes: torch.Tensor, valid_lens: torch.Tensor,
                  tables: EncodeTables, max_code_len: int | None = None,
                  hist_data: torch.Tensor | None = None):
    """Encode (B, N) uint8 lanes; returns ``(words (B, R) int32, bits (B,)
    int32, miss (B,) int32)`` with ``R = out_words(N, max_code_len)``.

    ``words`` hold u32 bit patterns, numeric MSB-first (serialise as
    ``>u4``); only the first ``ceil(bits/32)`` words of a lane are nonzero.
    ``miss`` counts each lane's valid bytes that have no code; the caller
    sums it.  ``hist_data``, a contiguous uint8 tensor of at most ``B * N``
    bytes on the lanes' device, adds a fourth result: the (256,) int64
    counts of its bytes, taken in the same launch (K5, counted in
    ``encode_blocks.hist_launches``; without it K1, counted in
    ``encode_blocks.launches``).  Where ``hist_data`` is the lanes' own
    storage from their first byte (the same ``data_ptr``), the kernel
    counts the bytes it holds for the encode; any other operand is read
    apart in the same launch.  CUDA tensors launch the kernel
    (``csrc/encode.cu``), which writes every word of ``words``; CPU tensors
    take :func:`encode_blocks_reference`.
    """
    B, N, R = _check_args(lanes, valid_lens, tables, max_code_len)
    if hist_data is not None:
        _check_hist(hist_data, B * N, lanes.device)
    if lanes.device.type == "cpu":
        return encode_blocks_reference(lanes, valid_lens, tables, max_code_len,
                                       hist_data)
    if lanes.device.type != "cuda":
        raise ValueError(f"unsupported device {lanes.device}")
    with span("launch"):
        dev = lanes.device
        words = torch.empty((B, R), dtype=torch.int32, device=dev)
        bits = torch.empty(B, dtype=torch.int32, device=dev)
        miss = torch.empty(B, dtype=torch.int32, device=dev)
        args = (lanes.data_ptr(), valid_lens.data_ptr(), tables.lens.data_ptr(),
                tables.acodes.data_ptr(), words.data_ptr(), bits.data_ptr(),
                miss.data_ptr(), B, N, R)
        if hist_data is None:
            _build.launch("tpuhuff_encode_lanes", dev, *args)
            encode_blocks.launches += 1
            return words, bits, miss
        counts = torch.zeros(256, dtype=torch.int64, device=dev)
        _build.launch("tpuhuff_encode_lanes_hist", dev, *args,
                      hist_data.data_ptr(), hist_data.numel(), counts.data_ptr())
        encode_blocks.hist_launches += 1
        return words, bits, miss, counts


encode_blocks.launches = 0       # K1
encode_blocks.hist_launches = 0  # K5


def encode_blocks_reference(lanes: torch.Tensor, valid_lens: torch.Tensor,
                            tables: EncodeTables,
                            max_code_len: int | None = None,
                            hist_data: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`encode_blocks` (any device): LUT
    gather, per-lane ``cumsum`` for bit offsets, and ``scatter_add_`` of
    disjoint bit fields into int64 words, where the sum equals the OR;
    ``hist_data``'s counts by ``torch.bincount``."""
    B, N, R = _check_args(lanes, valid_lens, tables, max_code_len)
    if hist_data is not None:
        _check_hist(hist_data, B * N, lanes.device)
    dev = lanes.device
    idx = lanes.long()
    lens = tables.lens.long()[idx]
    codes = tables.acodes.long()[idx] & _U32
    live = torch.arange(N, device=dev)[None, :] < valid_lens.long()[:, None]
    miss = (live & (lens == 0)).sum(dim=1).to(torch.int32)
    lens = torch.where(live, lens, 0)
    codes = torch.where(lens > 0, codes, 0)
    end = torch.cumsum(lens, dim=1)
    start = end - lens
    word = start >> 5
    off = start & 31
    hi = codes >> off
    # the bits shifted out of `hi` land at the top of the next word
    lo = torch.where(off > 0, (codes << ((32 - off) & 31)) & _U32, 0)
    # a zero-length field may sit at bit R*32, so its word + 1 is R + 1
    acc = torch.zeros((B, R + 2), dtype=torch.int64, device=dev)
    acc.scatter_add_(1, word, hi)
    acc.scatter_add_(1, word + 1, lo)
    bits = end[:, -1].to(torch.int32)
    out = (_i64_to_i32(acc[:, :R]), bits, miss)
    if hist_data is None:
        return out
    return (*out, torch.bincount(hist_data.reshape(-1), minlength=256))


def _lens_lut(lens_lut, device) -> tuple[torch.Tensor, torch.dtype]:
    """A 256-entry code-length LUT (tensor or array) as int64 on
    ``device``, and the dtype of its sum in the JAX package (x64 off):
    uint32 for an unsigned LUT, else int32."""
    if not isinstance(lens_lut, torch.Tensor):
        lens_lut = torch.from_numpy(np.ascontiguousarray(lens_lut))
    unsigned = lens_lut.dtype in (torch.uint8, torch.uint16, torch.uint32,
                                  torch.uint64)
    return (lens_lut.reshape(256).to(device=device, dtype=torch.int64),
            torch.uint32 if unsigned else torch.int32)


def count_missing(data: torch.Tensor, lens_lut,
                  valid_lens: torch.Tensor | None = None) -> int:
    """Number of valid bytes of ``data`` with no code (length 0 in
    ``lens_lut``): the device-side guard of the reference's missing-letter
    ``CompressError`` (``comp.rs:427-432``).

    ``data`` is (B, N) or (N,) uint8 (one block); ``valid_lens`` (B,)
    counts each block's valid bytes, ``None`` makes every byte valid.
    The gather and the sum run on ``data``'s device; only the count
    crosses to the host.  Counterpart of
    :func:`tpuhuff.kernels.encode.count_missing`."""
    if data.dim() == 1:
        data = data[None, :]
    lens, _ = _lens_lut(lens_lut, data.device)
    miss = lens[data.long()] == 0
    if valid_lens is not None:
        valid = torch.as_tensor(valid_lens).to(data.device).reshape(-1, 1)
        miss &= torch.arange(data.shape[1], device=data.device) < valid
    return int(miss.sum())


def block_bit_lengths(data: torch.Tensor, lens_lut) -> torch.Tensor:
    """Exact bit length of each block of (..., N) uint8 ``data``: the sum
    of ``lens_lut`` over every byte, padding included.  It is computed on
    ``data``'s device and has the JAX function's dtype (int32, or uint32
    for an unsigned LUT).  Counterpart of
    :func:`tpuhuff.kernels.encode.block_bit_lengths`."""
    lens, dtype = _lens_lut(lens_lut, data.device)
    return lens[data.long()].sum(dim=-1).to(dtype)


def words_to_payload(words, bit_len: int) -> bytes:
    """One block's payload bytes from its MSB-first u32 words (a numpy
    array, or a tensor of u32 bit patterns, copied to the host once), cut
    to ``ceil(bit_len / 8)`` bytes."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    nbytes = (int(bit_len) + 7) // 8
    return np.asarray(words).astype(">u4").tobytes()[:nbytes]
