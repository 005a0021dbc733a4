"""Host helpers of the block pipelines: lane padding and the bit stitch.

Counterparts of :func:`tpuhuff.dist.stitch_words` and
:func:`tpuhuff.dist.block.pad_to_blocks`, which live in modules that import
JAX at the top.  The sharded (multi-GPU) pipelines are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["pad_to_blocks", "stitch_words"]


def pad_to_blocks(data: np.ndarray, block_len: int,
                  n_shards: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Reshape a byte stream to (B, block_len), B a multiple of ``n_shards``.

    Returns ``(blocks, valid_lens, orig_len)``; ``valid_lens[b]`` is the
    number of real bytes in block b (the encode kernel emits no bits for
    the zero padding past it)."""
    n = data.size
    blocks = max(1, -(-n // block_len))
    blocks = -(-blocks // n_shards) * n_shards
    padded = np.zeros(blocks * block_len, dtype=np.uint8)
    padded[:n] = data
    valid = np.clip(n - np.arange(blocks, dtype=np.int64) * block_len, 0,
                    block_len)
    return padded.reshape(blocks, block_len), valid.astype(np.int32), n


def stitch_words(words: np.ndarray, bits: np.ndarray) -> tuple[bytes, int]:
    """Bit-carry concatenation of per-lane word rows into one payload.

    ``words`` (B, W) u32 values, MSB-first; ``bits`` (B,) exact bit
    lengths.  Returns ``(payload, padding_bits)``, through the threaded C++
    stitcher of the port's host runtime."""
    words = np.asarray(words, dtype=np.uint32)
    rows = np.ascontiguousarray(words).astype(">u4").view(np.uint8)
    rows = rows.reshape(words.shape[0], words.shape[1] * 4)
    return native.stitch_blocks(rows, np.asarray(bits, dtype=np.uint64))
