"""tpuhuff_torch encode (plain version, CPU) against the JAX encoder.

The JAX side runs the fused Pallas kernel in interpret mode (``pallas=True``,
the canonical tables, ``with_miss=True``) where its pair mode allows
(max code length <= 16), and its XLA merge otherwise.  The stitched payload,
the per-lane bit counts and the missing-letter count must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuhuff.core.canonical import build_tree_for_device, canonicalize
from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights
from tpuhuff.dist import stitch_words
from tpuhuff.kernels import encode as jax_encode

from tpuhuff_torch.kernels import EncodeTables, encode_blocks, make_encode_tables
from tpuhuff_torch.kernels.encode import as_u32, out_words


def _jax_encode(data, valid, tree):
    lens, codes = tree.encode_tables()
    dl, da = jax_encode.make_encode_tables(lens, codes)
    inv4, pres, cumle, dd, ml, full = jax_encode.make_canonical_encode_tables(tree)
    words, bits, miss = jax_encode.encode_blocks(
        jnp.asarray(data), dl, da, jnp.asarray(valid), max_code_len=ml,
        canon_tables=(inv4, pres, cumle, dd), full_alphabet=full,
        pallas=True, with_miss=True)
    return np.asarray(words), np.asarray(bits), int(miss), (dl, da)


def _port_encode(data, valid, tables):
    words, bits, miss = encode_blocks(torch.from_numpy(data),
                                      torch.from_numpy(valid), tables)
    return as_u32(words), bits.numpy(), miss.numpy()


def _check(data, valid, tree):
    jw, jb, jmiss, (dl, da) = _jax_encode(data, valid, tree)
    # the state crosses over as the JAX package's own tables
    tables = EncodeTables.from_numpy(np.asarray(dl), np.asarray(da))
    pw, pb, pmiss = _port_encode(data, valid, tables)
    assert pw.shape == (data.shape[0], out_words(data.shape[1], tables.max_len))
    assert np.array_equal(pb, jb)
    assert int(pmiss.sum()) == jmiss
    assert stitch_words(pw, pb) == stitch_words(jw, jb)
    # only the first ceil(bits/32) words of a lane may be nonzero
    for b in range(pw.shape[0]):
        assert not pw[b, -(-int(pb[b]) // 32):].any()
    return pb, pmiss


def _ragged(B, N, rng):
    valid = rng.integers(0, N + 1, B).astype(np.int32)
    valid[0], valid[1], valid[-1] = N, 0, 1  # full, empty and 1-byte lanes
    return valid


@pytest.mark.parametrize("N", [16, 256])
@pytest.mark.parametrize("alphabet", [2, 17, 256])
def test_encode_matches_pallas_ragged(alphabet, N):
    rng = np.random.default_rng(alphabet * 3 + N)
    B = 24
    data = rng.integers(0, alphabet, (B, N), dtype=np.uint8)
    tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(data)))
    assert tree.max_code_len() <= 16  # the Pallas pair mode applies
    bits, miss = _check(data, _ragged(B, N, rng), tree)
    assert bits[1] == 0 and not miss.any()


def test_encode_stale_tree_counts_missing_letters():
    rng = np.random.default_rng(5)
    B, N = 12, 256
    data = rng.integers(0, 60, (B, N), dtype=np.uint8)
    tree = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(data[:, :100])))
    data[:, 200:] = 200  # no code for 200 ...
    valid = _ragged(B, N, rng)
    bits, miss = _check(data, valid, tree)
    # ... counted only where it lies inside a lane's valid prefix
    assert np.array_equal(miss, np.clip(valid - 200, 0, None).astype(np.int32))


def test_encode_deep_tree_32_bit_codes():
    """Fibonacci weights: 32-bit codes; the JAX side takes its XLA merge
    (2 * 32 > 32 rules out the Pallas pair mode); the port's kernel has no
    such bound."""
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    tree, _ = build_tree_for_device(ByteWeights(counts), 32)
    tree = canonicalize(tree)
    assert tree.max_code_len() == 32
    rng = np.random.default_rng(1)
    B, N = 16, 256
    data = rng.integers(0, 10, (B, N), dtype=np.uint8)  # the longest codes
    data[2] = 0  # 32 bits each
    bits, _ = _check(data, _ragged(B, N, rng), tree)
    assert bits[0] >= 24 * N


def test_encode_rejects_bad_operands():
    tables = make_encode_tables(*canonicalize(HuffTree.from_weights(
        ByteWeights.from_bytes(b"abcabd"))).encode_tables())
    lanes = torch.zeros((4, 16), dtype=torch.uint8)
    valid = torch.full((4,), 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        encode_blocks(torch.zeros((4, 12), dtype=torch.uint8), valid, tables)
    with pytest.raises(TypeError):
        encode_blocks(lanes, valid.long(), tables)
    with pytest.raises(ValueError):
        encode_blocks(lanes, valid, tables, max_code_len=1)
    with pytest.raises(OverflowError):
        lens = np.zeros(256, np.uint8)
        lens[0] = 33
        make_encode_tables(lens, np.zeros(256, np.uint64))
