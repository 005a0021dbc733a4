"""tpuhuff_torch decode (plain version, CPU) against the JAX Pallas decoder.

The JAX side is ``decode_blocks_pallas_canonical(..., interpret=True)`` at
two unroll factors (its semantics do not depend on the unroll); the port
must give the same (B, block_len) bytes, including the zeros past a block's
``nbits`` and on arbitrary, non-code input.  K2's first-level table is held
against the plain wrapper's ladder and against the JAX package's ladder
tables built from the same counts; tolerance: none, every value is an
integer.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from tpuhuff.core.canonical import build_tree_for_device, canonicalize
from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights
from tpuhuff.io.stream import _encode_block_group, _native
from tpuhuff.kernels import decode as jax_decode
from tpuhuff.kernels.pallas_decode import decode_blocks_pallas_canonical

from tpuhuff_torch.core import canonical as port_canonical
from tpuhuff_torch.core.tree import HuffTree as PortTree
from tpuhuff_torch.core.weights import ByteWeights as PortWeights
from tpuhuff_torch.kernels import (
    LUT_BITS,
    DecodeTables,
    decode_hf2_device,
    decode_rows,
    decode_rows_reference,
    first_level_table,
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


def _counts(alphabet):
    """Byte counts with codes of many lengths; "fib": fib(1..34), whose
    tree the device constructor limits to 32-bit codes."""
    if alphabet == "fib":
        fib = [1, 1]
        while len(fib) < 34:
            fib.append(fib[-1] + fib[-2])
        counts = np.zeros(256, dtype=np.int64)
        counts[:34] = fib
        return counts
    rng = np.random.default_rng(alphabet)
    data = (rng.zipf(1.4, 6000) % alphabet) * 251 % 256
    return np.bincount(data, minlength=256)


def _canonical_trees(alphabet):
    """(JAX tree, port tree), each package building its own from the same
    counts and canonicalising it."""
    counts = _counts(alphabet)
    if alphabet == "fib":
        jax = build_tree_for_device(ByteWeights(counts), 32)[0]
        port = port_canonical.build_tree_for_device(PortWeights(counts), 32)[0]
    else:
        jax = HuffTree.from_weights(ByteWeights(counts))
        port = PortTree.from_weights(PortWeights(counts))
    return canonicalize(jax), port_canonical.canonicalize(port)


def _prefix_ends(k):
    """The lowest and the highest u32 window of each k-bit prefix."""
    lo = np.arange(1 << k, dtype=np.uint64) << np.uint64(32 - k)
    return lo, lo | np.uint64((1 << (32 - k)) - 1)


def _plain_pairs(tables, windows):
    """(symbol, length) that the plain wrapper gives each u32 window, one
    one-word row per window: the symbol at nbits = 32, the length as the
    least nbits at which a table whose every symbol is 1 still emits."""
    B = windows.size
    rows = as_i32(windows.reshape(B, 1))
    bit0 = torch.zeros(B, dtype=torch.int32)

    def emit(tabs, nbits):
        return decode_rows_reference(rows, bit0, torch.full(
            (B,), nbits, dtype=torch.int32), tabs, 1)[:, 0].numpy()

    ones = dataclasses.replace(tables, perm=torch.ones_like(tables.perm))
    emitted = sum(emit(ones, m).astype(np.int64) for m in range(33))
    return emit(tables, 32).astype(np.int64), 33 - emitted


def _jax_ladder_table(jax_tree, k):
    """K2's first-level table from the JAX package's ladder tables: an
    entry resolves where both ends of its prefix give the same (symbol,
    length) with length <= k."""
    ub, dd, perm4, ml = (np.asarray(a) for a in
                         jax_decode.make_canonical_decode_tables(jax_tree))
    ub = ub.astype(np.uint64)[: ml - 1]
    dd = dd.astype(np.int64)
    perm = perm4.astype("<u4").view(np.uint8).astype(np.int64)

    def rule(w):
        ind = (w[:, None] >= ub[None, :]).astype(np.int64)
        ln = 1 + ind.sum(axis=1)
        idx = ((w >> (32 - ln).astype(np.uint64)).astype(np.int64) + dd[0]
               + (ind * dd[None, 1:ml]).sum(axis=1)) & 255
        return perm[idx], ln

    (s_lo, l_lo), (s_hi, l_hi) = (rule(w) for w in _prefix_ends(k))
    ok = (s_lo == s_hi) & (l_lo == l_hi) & (l_lo >= 1) & (l_lo <= k)
    return np.where(ok, s_lo | (l_lo << 8), 0)


@pytest.mark.parametrize("k", [10, 12, 14])
@pytest.mark.parametrize("alphabet", [1, 2, 17, 256, "fib"])
def test_first_level_table_matches_ladder(alphabet, k):
    """Every resolved entry of K2's table is the plain ladder's (symbol,
    length <= k) at both ends of its prefix, and every escape is a prefix
    where it is not; the table equals the one from the JAX package's
    ladder tables."""
    jax_tree, port_tree = _canonical_trees(alphabet)
    tables = make_canonical_decode_tables(port_tree)
    table = first_level_table(tables, k)
    assert table.dtype == torch.int16 and table.shape == (1 << k,)
    if k == LUT_BITS:  # the table the kernel takes
        assert torch.equal(tables.lut, table)
    lut = table.numpy().astype(np.int64)
    (s_lo, l_lo), (s_hi, l_hi) = (_plain_pairs(tables, w)
                                  for w in _prefix_ends(k))
    same = (s_lo == s_hi) & (l_lo == l_hi) & (l_lo <= k)
    hit = lut != 0
    assert np.array_equal(hit, same)
    assert np.array_equal(lut[hit] & 255, s_lo[hit])
    assert np.array_equal(lut[hit] >> 8, l_lo[hit])
    assert np.array_equal(lut, _jax_ladder_table(jax_tree, k))
    if port_tree.max_code_len() <= k:
        assert hit.all()  # every code fits: no prefix escapes


@pytest.mark.parametrize("k", [10, 12, 14])
def test_first_level_table_of_a_ladder_of_no_tree(k):
    """Ladder tables that no tree gives (thresholds in no order, inside
    k-bit prefixes): where the two ends of a prefix disagree, the entry
    escapes, and every resolved entry is the plain ladder's."""
    rng = np.random.default_rng(k)
    ub = rng.integers(0, 1 << 32, 31, dtype=np.uint64).astype(np.uint32)
    ub[:3] = [1 << 20, 3 << 28, 0xFFFFFFFF]  # short codes; the clamp
    dd = rng.integers(-300, 300, 32).astype(np.int32)
    perm4 = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    tables = DecodeTables.from_numpy(ub, dd, perm4, 24)
    lut = first_level_table(tables, k).numpy().astype(np.int64)
    (s_lo, l_lo), (s_hi, l_hi) = (_plain_pairs(tables, w)
                                  for w in _prefix_ends(k))
    same = (s_lo == s_hi) & (l_lo == l_hi) & (l_lo <= k)
    hit = lut != 0
    assert np.array_equal(hit, same)
    assert np.array_equal(lut[hit], s_lo[hit] | (l_lo[hit] << 8))
    assert hit.any() and not hit.all()
    assert ((l_lo <= k) & ~same).any()  # prefixes that straddle
    # and inside each resolved prefix: random windows give the same pair
    lo = _prefix_ends(k)[0][hit]
    for _ in range(2):
        inner = lo | rng.integers(0, 1 << (32 - k), lo.size, dtype=np.uint64)
        s_in, l_in = _plain_pairs(tables, inner)
        assert np.array_equal(lut[hit], s_in | (l_in << 8))


def test_lut_bits_match_the_kernels():
    """The tables' k is the k the kernels are built with."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tpuhuff_torch",
                        "csrc", "decode_split.cuh")
    with open(path) as fp:
        found = re.findall(r"#define TPUHUFF_DECODE_LUT_BITS (\d+)", fp.read())
    assert found == [str(LUT_BITS)]
    tables = make_canonical_decode_tables(_canonical_trees(17)[1])
    assert tables.lut.shape == (1 << LUT_BITS,)
    assert torch.equal(tables.to("cpu").lut, tables.lut)


@pytest.mark.parametrize("alphabet", [2, 17, 256, "fib"])
def test_decode_hf2_device_on_cpu_matches_jax(alphabet, tmp_path):
    """A JAX-written canonical container decodes through the port's
    ``decode_hf2_device(..., device="cpu")`` to the JAX decoder's bytes."""
    from tpuhuff.io.hff import read_hf2_header as jax_read_header
    from tpuhuff.io.stream import read_compress_write_hf2

    from tpuhuff_torch.io.hff import read_hf2_header

    counts = _counts(alphabet)
    rng = np.random.default_rng(5)
    data = rng.choice(256, 3000, p=counts / counts.sum()).astype(np.uint8)
    jax_tree, _ = _canonical_trees(alphabet)
    src, hf2 = tmp_path / "a.bin", tmp_path / "a.hf2"
    src.write_bytes(data.tobytes())
    read_compress_write_hf2(str(src), str(hf2), block_len=256, tree=jax_tree)
    with open(hf2, "rb") as fp:
        jax_hdr = jax_read_header(fp)
        fp.seek(0)
        hdr = read_hf2_header(fp)
        fp.seek(hdr.payload_offset)
        payload = fp.read()
    assert make_canonical_decode_tables(hdr.tree) is not None
    want = jax_decode.decode_hf2_device(jax_hdr, payload)
    assert decode_hf2_device(hdr, payload, device="cpu") == want
    assert want == data.tobytes()
