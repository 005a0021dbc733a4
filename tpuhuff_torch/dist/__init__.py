"""Block-parallel pipelines over a mesh of devices, and the host bit stitch.

Counterpart of :mod:`tpuhuff.dist`: the mesh (:mod:`.mesh`), the sharded
histogram, encode and decode and the two-pass pipeline (:mod:`.block`),
and :func:`compress_sharded`, the in-memory codec on the mesh.  The
multi-process file codec is :mod:`.multihost`, on ``torch.distributed``;
the n-device dry run is :mod:`.dryrun`.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .block import (
    _pipeline,
    _place,
    encode_pipeline,
    encode_pipeline_arrays,
    pad_to_blocks,
    sharded_count_missing,
    sharded_decode_blocks,
    sharded_encode,
    sharded_histogram,
)
from .mesh import BLOCK_AXIS, make_mesh, shard_ranges

__all__ = [
    "BLOCK_AXIS",
    "make_mesh",
    "shard_ranges",
    "encode_pipeline",
    "encode_pipeline_arrays",
    "pad_to_blocks",
    "sharded_count_missing",
    "sharded_decode_blocks",
    "sharded_encode",
    "sharded_histogram",
    "compress_sharded",
    "stitch_words",
]


def stitch_words(words: np.ndarray, bits: np.ndarray) -> tuple[bytes, int]:
    """Bit-carry concatenation of per-block word rows into one payload.

    ``words`` (B, W) u32 values, MSB-first; ``bits`` (B,) exact bit
    lengths.  Returns ``(payload, padding_bits)``, through the threaded C++
    stitcher of the port's host runtime."""
    words = np.asarray(words, dtype=np.uint32)
    rows = np.ascontiguousarray(words).astype(">u4").view(np.uint8)
    rows = rows.reshape(words.shape[0], words.shape[1] * 4)
    return native.stitch_blocks(rows, np.asarray(bits, dtype=np.uint64))


def compress_sharded(data, block_len: int = 65536, mesh=None):
    """Compress on the mesh (default: every CUDA device of the process) to
    a :class:`~tpuhuff_torch.core.format.CompressData`, bit-identical to
    :func:`tpuhuff_torch.compress` (the same tree and stream) wherever the
    tree needs no code longer than 32 bits.  The blocks are histogrammed
    and packed on the devices; their lanes are stitched straight into the
    payload on the host, with no per-block row built."""
    from ..core.format import CompressData

    if mesh is None:
        mesh = make_mesh()
    arr = (data.reshape(-1) if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), dtype=np.uint8))
    blocks, valid, _ = pad_to_blocks(arr, block_len, len(mesh))
    tree, rows, lane_bits, _, _ = _pipeline(_place(blocks, valid, mesh), mesh,
                                            32, False, None)
    payload, padding = native.stitch_blocks(rows, lane_bits)
    return CompressData(payload, padding, tree)
