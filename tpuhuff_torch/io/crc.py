"""CRC32 pieces of the ``.hf2`` integrity column, for writers whose spans
are spread over several processes.

The port's copies of ``crc32_combine``, ``crc_span_pieces`` and
``_crc_spans`` of :mod:`tpuhuff.io.stream`, on the port's C++ host
runtime: each process CRCs its own bytes cut at the global span
boundaries, and the one that writes folds the pieces into whole-span
CRCs with :func:`crc32_combine`, so no byte crosses between processes for
it (:func:`tpuhuff_torch.dist.multihost.compress_file_multihost`).
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["crc32_combine", "crc_span_pieces"]


def _crc_spans(data: np.ndarray, span: int) -> np.ndarray:
    """Per-span zlib CRC32s of ``data`` (threaded C++); the last span may
    be short."""
    return native.crc32_blocks(data, span)


def _gf2_matrix_times(mat, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(square, mat) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``crc32(A || B)`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``:
    zlib's ``crc32_combine``, by GF(2) matrix exponentiation, O(32^2 log
    len2)."""
    if len2 <= 0:
        return crc1
    even = [0] * 32
    odd = [0] * 32
    odd[0] = 0xEDB88320  # the CRC-32 polynomial, bit-reflected
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    _gf2_matrix_square(even, odd)   # even = x^2
    _gf2_matrix_square(odd, even)   # odd = x^4
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def crc_span_pieces(data: np.ndarray, global_off: int, span: int) -> list:
    """Cut ``data``, which lives at ``global_off`` of the logical stream,
    at the stream's ``span`` boundaries and CRC each piece: ``[(crc,
    nbytes), ...]`` in order.  A run of whole aligned spans takes one
    threaded call."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    pieces = []
    pos, n = 0, data.size
    while pos < n:
        take = min(span - ((global_off + pos) % span), n - pos)
        if take == span and n - pos >= span:
            k = (n - pos) // span
            for c in _crc_spans(data[pos : pos + k * span], span):
                pieces.append((int(c), span))
            pos += k * span
            continue
        pieces.append((native.crc32(data[pos : pos + take]), take))
        pos += take
    return pieces
