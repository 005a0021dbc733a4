"""tpuhuff_torch decode (plain version, CPU) against the JAX Pallas decoder.

The JAX side is ``decode_blocks_pallas_canonical(..., interpret=True)`` at
two unroll factors (its semantics do not depend on the unroll); the port
must give the same (B, block_len) bytes, including the zeros past a block's
``nbits`` and on arbitrary, non-code input.
"""

import numpy as np
import pytest
import torch

from tpuhuff.core.canonical import build_tree_for_device, canonicalize
from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights
from tpuhuff.io.stream import _encode_block_group, _native
from tpuhuff.kernels import decode as jax_decode
from tpuhuff.kernels.pallas_decode import decode_blocks_pallas_canonical

from tpuhuff_torch.kernels import (
    DecodeTables,
    decode_hf2_device,
    decode_rows,
    make_canonical_decode_tables,
    payload_to_lane_words,
)
from tpuhuff_torch.kernels.encode import as_i32


def _blocks(data, block_len, tree):
    lens, codes = tree.encode_tables()
    payload, _, bit_lens = _encode_block_group(data, block_len, lens, codes,
                                               _native())
    ends = np.cumsum(bit_lens.astype(np.int64))
    return payload, ends - bit_lens.astype(np.int64), ends


def _jax(rows, bit0, nbits, tree, block_len, unroll):
    ub, dd, perm4, ml = jax_decode.make_canonical_decode_tables(tree)
    return decode_blocks_pallas_canonical(rows, bit0, nbits, ub, dd, perm4, ml,
                                          block_len, unroll=unroll,
                                          interpret=True)


def _port(rows, bit0, nbits, tree, block_len):
    ub, dd, perm4, ml = jax_decode.make_canonical_decode_tables(tree)
    tables = DecodeTables.from_numpy(np.asarray(ub), np.asarray(dd),
                                     np.asarray(perm4), ml)
    out = decode_rows(as_i32(rows), torch.from_numpy(bit0.astype(np.int32)),
                      torch.from_numpy(nbits.astype(np.int32)), tables,
                      block_len)
    assert out.dtype == torch.uint8 and out.shape == (rows.shape[0], block_len)
    return out.numpy()


def _fib_tree():
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    return canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])


@pytest.mark.parametrize("block_len", [32, 256])
@pytest.mark.parametrize("alphabet", [1, 2, 17, 256])
def test_decode_matches_pallas_and_source(alphabet, block_len):
    rng = np.random.default_rng(alphabet + block_len)
    data = rng.integers(0, alphabet, 21 * block_len - 13, dtype=np.uint8)
    tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(data)))
    payload, starts, ends = _blocks(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    nbits = (ends - starts).astype(np.int32)
    got = _port(rows, bit0, nbits, tree, block_len)
    for unroll in (1, 4):
        assert np.array_equal(got, _jax(rows, bit0, nbits, tree, block_len,
                                        unroll)), unroll
    flat = got.reshape(-1)
    assert np.array_equal(flat[: data.size], data)
    assert not flat[data.size:].any()


def test_decode_nbits_cutoff_writes_zeros():
    rng = np.random.default_rng(4)
    block_len = 64
    data = rng.integers(0, 40, 30 * block_len, dtype=np.uint8)
    tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(data)))
    payload, starts, ends = _blocks(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    nbits = (ends - starts).astype(np.int32)
    nbits[::2] -= rng.integers(1, 60, nbits[::2].size).astype(np.int32)
    nbits[1] = 0
    got = _port(rows, bit0, nbits, tree, block_len)
    assert np.array_equal(got, _jax(rows, bit0, nbits, tree, block_len, 4))
    assert not got[1].any()
    lens = tree.encode_tables()[0]
    for b in range(0, starts.size, 2):  # the longest whole-code prefix
        blk = data[b * block_len:(b + 1) * block_len]
        used = np.cumsum(lens[blk].astype(np.int64))
        k = int(np.searchsorted(used, nbits[b], side="right"))
        assert np.array_equal(got[b, :k], blk[:k]) and not got[b, k:].any()


def test_decode_deep_tree_32_bit_codes():
    tree = _fib_tree()
    rng = np.random.default_rng(9)
    block_len = 128
    data = rng.integers(0, 34, 9 * block_len + 5, dtype=np.uint8)
    data[:block_len] = 0  # a block of 32-bit codes
    payload, starts, ends = _blocks(data, block_len, tree)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    nbits = (ends - starts).astype(np.int32)
    got = _port(rows, bit0, nbits, tree, block_len)
    assert np.array_equal(got, _jax(rows, bit0, nbits, tree, block_len, 1))
    assert np.array_equal(got.reshape(-1)[: data.size], data)


def test_decode_arbitrary_rows_match_pallas():
    """Random words, start bits and bit counts: not a valid stream, but
    both decoders must still agree bit for bit (window reads past the row
    are zeros, the cursor stops at nbits)."""
    rng = np.random.default_rng(12)
    tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(
        rng.integers(0, 90, 4000, dtype=np.uint8))))
    B, W, block_len = 40, 9, 48
    rows = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    bit0 = rng.integers(0, 32, B).astype(np.int32)
    nbits = rng.integers(0, 32 * (W - 1) - 31, B).astype(np.int32)
    got = _port(rows, bit0, nbits, tree, block_len)
    assert np.array_equal(got, _jax(rows, bit0, nbits, tree, block_len, 4))


def test_decode_hf2_device_on_cpu(tmp_path):
    """A JAX-written container, read by the port's own header reader."""
    from tpuhuff.io.stream import read_compress_write_hf2

    from tpuhuff_torch.io.hff import read_hf2_header

    rng = np.random.default_rng(2)
    data = rng.integers(0, 30, 5000, dtype=np.uint8)
    src, hf2 = tmp_path / "a.bin", tmp_path / "a.hf2"
    src.write_bytes(data.tobytes())
    read_compress_write_hf2(str(src), str(hf2), block_len=256)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
        fp.seek(hdr.payload_offset)
        payload = fp.read()
    assert make_canonical_decode_tables(hdr.tree) is not None
    assert decode_hf2_device(hdr, payload, device="cpu") == data.tobytes()
