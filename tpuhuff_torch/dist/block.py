"""Block-parallel two-pass compress over a mesh of devices.

Counterpart of :mod:`tpuhuff.dist.block`, whose ``shard_map`` programs
become a loop over the mesh (:mod:`.mesh`): shard k's blocks are copied
to ``mesh[k]`` and its kernels go out on that device's current stream;
every shard is launched before any result is read, so distinct cards run
side by side, and the results come back in mesh order.

* pass 1 — each shard's histogram (K3, :func:`~tpuhuff_torch.kernels.
  histogram`) less its zero padding, summed over the mesh and, given a
  process ``group``, over the processes (``all_reduce``, the JAX
  package's ``psum``); the host builds the tree from the 256 counts;
* pass 2 — each shard's blocks are cut into kernel lanes (K1,
  :func:`~tpuhuff_torch.kernels.encode_blocks`, takes lanes of a power of
  two up to 1024 bytes, so a block of any length is ``block_len // lane``
  lanes), and the lane streams are bit-concatenated in order, which is
  bit-identical to encoding each block whole.  :func:`sharded_encode`
  joins each block's lanes into the block's row, the JAX function's
  result; the pipelines that want only the payload stitch the lanes
  straight into it.

Decode (:func:`sharded_decode_blocks`) runs K2 or K4 per shard, picked
from the tree (:func:`~tpuhuff_torch.kernels.decoder_for`).  CPU devices
run the kernels' plain versions; nothing moves a shard to the CPU when a
CUDA launch fails.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import native
from ..core.canonical import build_tree_for_device, canonicalize
from ..core.format import CompressError
from ..core.tree import HuffTree
from ..core.weights import ByteWeights
from ..io.host import lane_of
from ..kernels import (
    EncodeTables,
    count_missing,
    decoder_for,
    encode_blocks,
    histogram,
    make_encode_tables,
    out_words,
)
from .mesh import Mesh, make_mesh, shard_ranges

__all__ = [
    "sharded_histogram",
    "sharded_encode",
    "sharded_count_missing",
    "sharded_decode_blocks",
    "encode_pipeline",
    "encode_pipeline_arrays",
    "pad_to_blocks",
]

def pad_to_blocks(data: np.ndarray, block_len: int,
                  n_shards: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Reshape a byte stream to (B, block_len), B a multiple of ``n_shards``.

    Returns ``(blocks, valid_lens, orig_len)``; ``valid_lens[b]`` is the
    number of real bytes in block b (the encode kernel emits no bits for
    the zero padding past it, and the histogram takes its count out)."""
    n = data.size
    blocks = max(1, -(-n // block_len))
    blocks = -(-blocks // n_shards) * n_shards
    padded = np.zeros(blocks * block_len, dtype=np.uint8)
    padded[:n] = data
    valid = np.clip(n - np.arange(blocks, dtype=np.int64) * block_len, 0,
                    block_len)
    return padded.reshape(blocks, block_len), valid.astype(np.int32), n


def _tensor(x, dtype) -> torch.Tensor:
    """A numpy array or tensor as a tensor of ``dtype`` (where it lies)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _place(blocks, valid_lens, mesh: Mesh):
    """Shard k's ``(blocks, valid_lens)`` on ``mesh[k]``, in mesh order."""
    blocks = _tensor(blocks, torch.uint8)
    valid_lens = _tensor(valid_lens, torch.int32)
    if blocks.dim() != 2 or valid_lens.shape != (blocks.shape[0],):
        raise ValueError("blocks must be (B, N) uint8 and valid_lens (B,)")
    return [(blocks[lo:hi].to(dev).contiguous(), valid_lens[lo:hi].to(dev))
            for (lo, hi), dev in zip(shard_ranges(blocks.shape[0], mesh), mesh)]


def _on_each(mesh: Mesh, make) -> list:
    """``make(device)`` once per distinct device of the mesh (tables that
    every shard on the device reads), listed in mesh order."""
    made = {}
    for dev in mesh:
        if dev not in made:
            made[dev] = make(dev)
    return [made[dev] for dev in mesh]


def _reduce(total: torch.Tensor, group) -> torch.Tensor:
    """Sum a CPU tensor over the processes of ``group`` (None: this
    process alone)."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, group=group)
    return total


def _histogram(shards, group) -> np.ndarray:
    hists = []
    for blocks, valid in shards:
        h = histogram(blocks)
        # the padding bytes are zeros: count only what was read
        h[0] -= blocks.numel() - valid.sum()
        hists.append(h)
    total = sum(h.cpu() for h in hists)
    return _reduce(total, group).numpy().astype(np.int64)


def sharded_histogram(blocks, valid_lens, mesh: Mesh,
                      group=None) -> np.ndarray:
    """Global (256,) int64 histogram of the valid bytes of (B, N) blocks
    split over the mesh, and over the processes of ``group``."""
    return _histogram(_place(blocks, valid_lens, mesh), group)


def _missing(shards, lens_lut) -> int:
    return sum(count_missing(blocks, lens_lut, valid) for blocks, valid in shards)


def sharded_count_missing(blocks, valid_lens, lens_lut, mesh: Mesh) -> int:
    """Global count of valid bytes with no code (length 0 in
    ``lens_lut``) over the mesh: the guard of the missing-letter case
    (``comp.rs:427-432``), :func:`~tpuhuff_torch.kernels.count_missing`
    on each shard's device."""
    return _missing(_place(blocks, valid_lens, mesh), lens_lut)


def _encode_lanes(shards, tables: EncodeTables, mesh: Mesh,
                  check_missing: bool):
    """K1 on every shard's blocks as lanes.  Returns ``(rows (n_lanes,
    R*4) uint8, lane_bits (n_lanes,) uint64, lanes per block)``, each
    lane's words as big-endian bytes (the layout of
    :func:`native.stitch_blocks`), shards in mesh order."""
    N = shards[0][0].shape[1]
    lane = lane_of(N)
    per_block = N // lane
    on_dev = _on_each(mesh, tables.to)
    outs = []
    for (blocks, valid), tab in zip(shards, on_dev):
        cuts = torch.arange(per_block, device=valid.device,
                            dtype=torch.int32) * lane
        lane_valid = (valid[:, None] - cuts[None, :]).clamp(0, lane)
        words, bits, miss = encode_blocks(blocks.view(-1, lane),
                                          lane_valid.reshape(-1).contiguous(),
                                          tab)
        # u32 values to big-endian bytes on the device
        rows = words.view(torch.uint8).view(*words.shape, 4).flip(-1)
        outs.append((rows.reshape(words.shape[0], -1), bits, miss.sum()))
    if check_missing:
        miss = int(sum(m.cpu() for _, _, m in outs))
        if miss:
            raise CompressError(f"letter not found in codes ({miss} bytes)",
                                None)
    # into one host array, shard by shard in mesh order
    n = sum(r.shape[0] for r, _, _ in outs)
    rows = np.empty((n, outs[0][0].shape[1]), dtype=np.uint8)
    bits = np.empty(n, dtype=np.int32)
    at = 0
    for r, b, _ in outs:
        torch.from_numpy(rows[at : at + r.shape[0]]).copy_(r)
        torch.from_numpy(bits[at : at + r.shape[0]]).copy_(b)
        at += r.shape[0]
    return rows, bits.astype(np.uint64), per_block


def _block_rows(payload: bytes, block_bits: np.ndarray, W: int) -> np.ndarray:
    """(B, W) uint32 rows: block b's bits of the stitched ``payload``,
    MSB-first from bit 0 of its row, zero past them."""
    nbits = block_bits.astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    raw = np.frombuffer(payload, dtype=np.uint8)
    buf = np.zeros(-(-raw.size // 4) * 4, dtype=np.uint8)
    buf[: raw.size] = raw
    words = buf.view(">u4").astype(np.uint32)
    got = native.extract_rows(words, (starts // 32).astype(np.uint64), W + 1)
    r = (starts % 32).astype(np.uint64)[:, None]
    hi = got[:, :W].astype(np.uint64)
    lo = got[:, 1:].astype(np.uint64)
    rows = ((hi << r) | (lo >> (np.uint64(32) - r))) & np.uint64(0xFFFFFFFF)
    keep = np.clip(nbits[:, None] - 32 * np.arange(W)[None, :], 0, 32)
    mask = (np.uint64(0xFFFFFFFF) << (np.uint64(32) - keep.astype(np.uint64))
            ) & np.uint64(0xFFFFFFFF)
    return (rows & mask).astype(np.uint32)


def _join(rows: np.ndarray, lane_bits: np.ndarray, per_block: int,
          W: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each block's lanes joined into its row: one threaded stitch of
    every lane, then every block's bits cut out of the payload."""
    payload, _ = native.stitch_blocks(rows, lane_bits)
    block_bits = lane_bits.reshape(-1, per_block).sum(axis=1)
    return _block_rows(payload, block_bits, W), block_bits.astype(np.int32)


def sharded_encode(blocks, valid_lens, tables: EncodeTables, mesh: Mesh,
                   max_code_len: int | None = None,
                   check_missing: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Pack (B, N) blocks data-parallel; returns ``(words (B, W) uint32,
    bits (B,) int32)``, block b's codes MSB-first from bit 0 of its row,
    ``W = ceil(N * max_code_len / 32)`` (N where ``max_code_len`` is None),
    the width of the JAX function.

    ``tables`` from :func:`~tpuhuff_torch.kernels.make_encode_tables` (the
    JAX function's ``lens_lut``, ``acodes_lut``; its ``canon_tables`` and
    ``full_alphabet`` only choose a TPU lookup, and have no counterpart).
    ``check_missing``: valid bytes with no code, counted by K1 and summed
    over the mesh, raise :class:`CompressError`."""
    ml = 32 if max_code_len is None else int(max_code_len)
    if not tables.max_len <= ml <= 32:
        raise ValueError(f"max_code_len {ml} must cover the tables' "
                         f"{tables.max_len} and be <= 32")
    shards = _place(blocks, valid_lens, mesh)
    N = shards[0][0].shape[1]
    rows, lane_bits, per_block = _encode_lanes(shards, tables, mesh,
                                               check_missing)
    return _join(rows, lane_bits, per_block, out_words(N, ml))


def sharded_decode_blocks(rows, bit0, nbits, tree: HuffTree, block_len: int,
                          mesh: Mesh) -> np.ndarray:
    """Block-parallel decode over the mesh: (B, W) u32 word rows
    (:func:`~tpuhuff_torch.kernels.payload_to_lane_words`' layout), their
    start bits and bit counts, split over the mesh; the tables are copied
    to every device.  Each shard runs K2 where the tree's codes are
    canonical, else K4 (the choice of the JAX function).  Returns (B,
    block_len) uint8, zero past each block's last whole code."""
    if not isinstance(rows, torch.Tensor):  # u32 values as int32 patterns
        rows = np.asarray(rows, dtype=np.uint32).view(np.int32)
    rows = _tensor(rows, torch.int32)
    bit0 = _tensor(bit0, torch.int32)
    nbits = _tensor(nbits, torch.int32)
    decode, tables = decoder_for(tree)
    on_dev = _on_each(mesh, tables.to)
    outs = []
    for (lo, hi), dev, tab in zip(shard_ranges(rows.shape[0], mesh), mesh,
                                  on_dev):
        outs.append(decode(rows[lo:hi].to(dev).contiguous(),
                           bit0[lo:hi].to(dev), nbits[lo:hi].to(dev), tab,
                           block_len))
    return np.concatenate([o.cpu().numpy() for o in outs])


def _pipeline(shards, mesh: Mesh, max_code_len: int, canonical: bool,
              group):
    """Pass 1, the tree, pass 2 as lanes: ``(tree, rows, lane_bits,
    lanes per block, max code length)``."""
    counts = _histogram(shards, group)
    # codes live in u32 words: a tree deeper than max_code_len becomes the
    # optimal length-limited one (a valid .hff tree, a little larger output)
    tree, _limited = build_tree_for_device(ByteWeights(counts),
                                           max_len=max_code_len)
    if canonical:
        tree = canonicalize(tree)
    lens, codes = tree.encode_tables()
    # every byte the histogram saw must have a code, or K1 would emit no
    # bits for it (comp.rs:427-432); only a faulty tree construction trips this
    uncovered = np.flatnonzero((counts > 0) & (lens == 0))
    if uncovered.size:
        raise CompressError("letter not found in codes", int(uncovered[0]))
    rows, lane_bits, per_block = _encode_lanes(
        shards, make_encode_tables(lens, codes), mesh, False)
    return tree, rows, lane_bits, per_block, int(lens.max())


def encode_pipeline_arrays(blocks, valid_lens, mesh: Mesh,
                           max_code_len: int = 32, canonical: bool = False,
                           group=None):
    """The pipeline on (B, N) blocks: histogram over the mesh (and the
    processes of ``group``), host tree, sharded pack.  Returns ``(words
    (B, W) uint32, bits (B,) int32, tree)``; the tree is the same on every
    process of ``group``.  ``canonical`` reassigns canonical codes (the
    same lengths and size; the decoder K2 applies)."""
    shards = _place(blocks, valid_lens, mesh)
    tree, rows, lane_bits, per_block, ml = _pipeline(
        shards, mesh, max_code_len, canonical, group)
    words, bits = _join(rows, lane_bits, per_block,
                        out_words(shards[0][0].shape[1], ml))
    return words, bits, tree


def encode_pipeline(data: np.ndarray, block_len: int = 65536,
                    mesh: Mesh | None = None, max_code_len: int = 32,
                    canonical: bool = False):
    """The full two-pass pipeline on a byte stream; returns ``(words (B,
    W) uint32, bits (B,) int32, tree, orig_len)``, B a multiple of the
    mesh size (trailing blocks of padding emit no bits)."""
    if mesh is None:
        mesh = make_mesh()
    blocks, valid, orig_len = pad_to_blocks(
        np.asarray(data, dtype=np.uint8).ravel(), block_len, len(mesh))
    words, bits, tree = encode_pipeline_arrays(blocks, valid, mesh,
                                               max_code_len, canonical)
    return words, bits, tree, orig_len
