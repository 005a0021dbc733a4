"""tpuhuff_torch tables and host helpers against the JAX package's own.

Every comparison is exact: the tables, rows and payloads are integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuhuff.core import canonical as jax_canonical
from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights
from tpuhuff.dist import stitch_words as jax_stitch_words
from tpuhuff.dist.block import pad_to_blocks as jax_pad_to_blocks
from tpuhuff.kernels import decode as jax_decode
from tpuhuff.kernels import encode as jax_encode

import tpuhuff_torch.dist as port_dist
from tpuhuff_torch.core import canonical as port_canonical
from tpuhuff_torch.core.tree import HuffTree as PortTree
from tpuhuff_torch.core.weights import ByteWeights as PortWeights
from tpuhuff_torch.kernels import (
    DecodeTables,
    EncodeTables,
    encode_blocks_reference,
    make_canonical_decode_tables,
    make_encode_tables,
    payload_to_lane_words,
)
from tpuhuff_torch.kernels.encode import as_u32

ALPHABETS = [1, 2, 17, 256, "fib"]


def _fib_counts() -> np.ndarray:
    """fib(1..34) counts: the optimal tree is 33 deep, so the device
    tree constructor length-limits it to 32-bit codes."""
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    return counts


def _tree(alphabet, canonical=True, port=False):
    """The JAX package's tree, or with ``port`` the port's tree built from
    the same counts by the port's own copies."""
    Tree, Weights, canon = ((PortTree, PortWeights, port_canonical) if port
                            else (HuffTree, ByteWeights, jax_canonical))
    if alphabet == "fib":
        tree, limited = canon.build_tree_for_device(Weights(_fib_counts()), 32)
        assert limited and tree.max_code_len() == 32
    else:
        rng = np.random.default_rng(7 + (alphabet if isinstance(alphabet, int) else 0))
        data = rng.integers(0, alphabet, 5000, dtype=np.uint8)
        data = (data.astype(np.int64) * 251 // max(alphabet, 1) % 256).astype(np.uint8)
        tree = Tree.from_weights(Weights.from_bytes(data))
    return canon.canonicalize(tree) if canonical else tree


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_encode_tables_match_jax(alphabet, canonical):
    tree = _tree(alphabet, canonical)
    lens, codes = tree.encode_tables()
    port = make_encode_tables(lens, codes)
    jl, ja = jax_encode.make_encode_tables(lens, codes)
    assert np.array_equal(port.lens.numpy(), np.asarray(jl))
    assert np.array_equal(as_u32(port.acodes), np.asarray(ja))
    assert port.max_len == max(1, int(lens.max()))
    carried = EncodeTables.from_numpy(np.asarray(jl), np.asarray(ja))
    assert torch.equal(carried.lens, port.lens)
    assert torch.equal(carried.acodes, port.acodes)


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_decode_tables_match_jax(alphabet):
    tree = _tree(alphabet)
    ub, dd, perm4, ml = jax_decode.make_canonical_decode_tables(tree)
    port = make_canonical_decode_tables(_tree(alphabet, port=True))
    carried = DecodeTables.from_numpy(np.asarray(ub), np.asarray(dd),
                                      np.asarray(perm4), ml)
    assert port.max_len == ml == tree.max_code_len()
    for got, want in ((port.ub, carried.ub), (port.dd, carried.dd),
                      (port.perm, carried.perm)):
        assert torch.equal(got, want)
    # unpacked perm == the packed words' bytes, low byte first
    perm4 = np.asarray(perm4, dtype=np.uint32)
    for k in range(256):
        assert int(port.perm[k]) == int(perm4[k // 4] >> (8 * (k % 4))) & 0xFF


def test_decode_tables_reject_noncanonical():
    tree = _tree(17, canonical=False)
    assert jax_decode.make_canonical_decode_tables(tree) is None
    assert make_canonical_decode_tables(_tree(17, False, port=True)) is None


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_dense_lut_reproduces_canonical_ladder(alphabet):
    """The port's dense LUT gives every byte the (len, left-aligned code)
    that the JAX kernels compute with the canonical rank ladder."""
    tree = _tree(alphabet)
    inv4, pres, cumle, dd, ml, full = jax_encode.make_canonical_encode_tables(tree)
    ln, acode = jax_encode.lut_canonical(jnp.arange(256, dtype=jnp.int32), inv4,
                                         pres, cumle, dd, ml, full)
    port = make_encode_tables(*tree.encode_tables())
    assert np.array_equal(port.lens.numpy(), np.asarray(ln))
    assert np.array_equal(as_u32(port.acodes), np.asarray(acode))
    # and the plain encoder packs exactly those codes: one lane per byte
    lanes = torch.arange(256, dtype=torch.uint8)[:, None]
    valid = torch.ones(256, dtype=torch.int32)
    words, bits, miss = encode_blocks_reference(lanes, valid, port)
    assert np.array_equal(bits.numpy(), np.asarray(ln))
    assert np.array_equal(as_u32(words)[:, 0], np.asarray(acode))
    assert np.array_equal(miss.numpy(), (np.asarray(ln) == 0).astype(np.int32))


def _payload_case(seed: int):
    rng = np.random.default_rng(seed)
    bit_lens = rng.integers(0, 700, 37).astype(np.int64)
    bit_lens[5] = 0
    ends = np.cumsum(bit_lens)
    starts = ends - bit_lens
    payload = rng.integers(0, 256, (int(ends[-1]) + 7) // 8, dtype=np.uint8)
    return payload, starts, ends


@pytest.mark.parametrize("with_native", [True, False])
def test_payload_to_lane_words_matches_jax(with_native, monkeypatch):
    """The port's gather (always its own C++ runtime) against the JAX
    package's, through that package's runtime or its numpy gather."""
    import tpuhuff.native as jax_native

    payload, starts, ends = _payload_case(3)
    if not with_native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    want_rows, want_bit0 = jax_decode.payload_to_lane_words(payload, starts,
                                                            ends, 256)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, 256)
    assert rows.dtype == np.uint32 and bit0.dtype == np.int32
    assert rows.shape == want_rows.shape
    # the slack tail past each block's own words is don't-care; the bits a
    # decoder may read (through the slack word) must agree
    for k in range(starts.size):
        used = (int(ends[k]) + 31) // 32 - int(starts[k]) // 32 + 1
        assert np.array_equal(rows[k, :used], want_rows[k, :used]), k
    assert np.array_equal(bit0, want_bit0)


@pytest.mark.parametrize("with_native", [True, False])
def test_stitch_words_matches_jax(with_native, monkeypatch):
    """The port's stitch (always its own C++ runtime) against the JAX
    package's, through that package's runtime or its Python big-int stitch."""
    import tpuhuff.native as jax_native

    rng = np.random.default_rng(11)
    B, W = 29, 6
    bits = rng.integers(0, 32 * W + 1, B).astype(np.uint64)
    bits[3] = 0
    words = np.zeros((B, W), dtype=np.uint32)
    for b in range(B):  # only the first ceil(bits/32) words carry bits
        nb = int(bits[b])
        full = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
        for w in range(W):
            keep = min(max(nb - 32 * w, 0), 32)
            mask = 0 if keep == 0 else ((0xFFFFFFFF << (32 - keep)) & 0xFFFFFFFF)
            words[b, w] = full[w] & np.uint32(mask)
    if not with_native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    want = jax_stitch_words(words, bits)
    assert port_dist.stitch_words(words, bits) == want


@pytest.mark.parametrize("n,block_len,shards", [(0, 16, 1), (1, 16, 1),
                                                (100, 16, 3), (4096, 256, 1),
                                                (4097, 256, 8)])
def test_pad_to_blocks_matches_jax(n, block_len, shards):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    got = port_dist.pad_to_blocks(data, block_len, shards)
    want = jax_pad_to_blocks(data, block_len, shards)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
    assert got[2] == want[2]
