"""tpuhuff_torch general-tree decode (K4's plain version, CPU) against the
JAX package's general decoders.

The JAX side is ``tpuhuff.kernels.decode.decode_rows_device`` on a
non-canonical tree, with ``TPUHUFF_DECODER=pallas`` (the Pallas kernel
``_decode_kernel_general`` in interpret mode, at unroll 1 and 4, with the
``levels`` and ``max_sym_bits`` that function passes) and with
``TPUHUFF_DECODER=xla`` (``decode_blocks_device``).  Tolerance: none, the
outputs are uint8 and must be equal, including the zeros past a block's
``nbits`` and on rows of random words that are not codes.  K4's
first-level table is held against the plain wrapper's search and against
the JAX package's interval tables built from the same counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuhuff.core import canonical as jax_canonical
from tpuhuff.core.tree import HuffTree as JaxTree
from tpuhuff.core.weights import ByteWeights as JaxWeights
from tpuhuff.io.stream import _encode_block_group, _native
from tpuhuff.kernels import decode as jax_decode

from tpuhuff_torch.core import canonical as port_canonical
from tpuhuff_torch.core.tree import HuffTree
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.kernels import (
    LUT_BITS,
    GeneralDecodeTables,
    decode_hf2_device,
    decode_rows,
    decode_rows_general,
    decode_rows_general_reference,
    decoder_for,
    first_level_table,
    make_canonical_decode_tables,
    make_decode_tables,
    payload_to_lane_words,
)
from tpuhuff_torch.kernels.encode import as_i32, as_u32


def _mirror(tree):
    """The same tree with every code's bits inverted (never canonical for
    two or more leaves)."""
    return type(tree)(tree.right, tree.left, tree.letters, tree.weights,
                      tree.root)


def _trees(counts, limit=None):
    """(JAX tree, port tree) from the same counts, each package building
    its own; mirrored when the built tree happens to be canonical."""
    if limit is None:
        jax = JaxTree.from_weights(JaxWeights(counts))
        port = HuffTree.from_weights(ByteWeights(counts))
    else:
        jax = jax_canonical.build_tree_for_device(JaxWeights(counts), limit)[0]
        port = port_canonical.build_tree_for_device(ByteWeights(counts),
                                                    limit)[0]
    if jax_decode.make_canonical_decode_tables(jax) is not None:
        jax, port = _mirror(jax), _mirror(port)
    return jax, port


def _fib_counts(n=34):
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:n] = fib
    return counts


def _alphabet_data(alphabet, n, seed):
    rng = np.random.default_rng(seed)
    letters = rng.choice(256, size=alphabet, replace=False).astype(np.uint8)
    # skewed: a Huffman tree with codes of many lengths
    idx = np.minimum(rng.geometric(0.15, n) - 1, alphabet - 1)
    data = letters[idx]
    data[: alphabet] = letters  # every letter present
    return data


def _blocks(data, block_len, jax_tree):
    lens, codes = jax_tree.encode_tables()
    payload, _, bit_lens = _encode_block_group(data, block_len, lens, codes,
                                               _native())
    ends = np.cumsum(bit_lens.astype(np.int64))
    starts = ends - bit_lens.astype(np.int64)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    return rows, bit0, (ends - starts).astype(np.int32)


def _port(rows, bit0, nbits, port_tree, block_len):
    out = decode_rows_general(as_i32(rows),
                              torch.from_numpy(bit0.astype(np.int32)),
                              torch.from_numpy(nbits.astype(np.int32)),
                              make_decode_tables(port_tree), block_len)
    assert out.dtype == torch.uint8 and out.shape == (rows.shape[0], block_len)
    return out.numpy()


def _jax(rows, bit0, nbits, jax_tree, block_len, route, unroll, monkeypatch):
    if route == "pallas" and jax_tree.num_leaves() == 2:
        return _jax_pallas_two_leaves(rows, bit0, nbits, jax_tree, block_len,
                                      unroll)
    monkeypatch.setenv("TPUHUFF_DECODER", route)
    return np.asarray(jax_decode.decode_rows_device(
        rows, bit0, nbits, jax_tree, block_len, unroll=unroll))


def _jax_pallas_two_leaves(rows, bit0, nbits, jax_tree, block_len, unroll):
    """The Pallas route of ``decode_rows_device`` at ``levels=2``: for a
    2-leaf tree that function passes ``levels=1``, which the JAX kernel
    cannot trace (``bits_msb[6]`` stays a Python bool,
    ``pallas_decode.py:303``).  Two levels search the same padded table."""
    import jax.numpy as jnp

    from tpuhuff.kernels.pallas_decode import (
        LANES, SUB, decode_rows_fused_general, make_general_fused_tables)

    eytz, s4, l4 = make_general_fused_tables(
        *jax_decode.make_decode_tables(jax_tree))
    B, W = rows.shape
    Bp = -(-B // (SUB * LANES)) * SUB * LANES
    rows_p = np.zeros((Bp, max(W, unroll + 1)), np.uint32)
    rows_p[:B, :W] = rows
    bit0_p, nbits_p = np.zeros(Bp, np.int32), np.zeros(Bp, np.int32)
    bit0_p[:B], nbits_p[:B] = bit0, nbits
    out = decode_rows_fused_general(
        jnp.asarray(rows_p), jnp.asarray(bit0_p), jnp.asarray(nbits_p), eytz,
        s4, l4, block_len, unroll, True, 2,
        max_sym_bits=jax_tree.max_code_len())
    return np.asarray(out[:B])


def _check_all_routes(rows, bit0, nbits, jax_tree, port_tree, block_len,
                      monkeypatch, unrolls=(1, 4)):
    got = _port(rows, bit0, nbits, port_tree, block_len)
    for unroll in unrolls:
        want = _jax(rows, bit0, nbits, jax_tree, block_len, "pallas", unroll,
                    monkeypatch)
        assert np.array_equal(got, want), ("pallas", unroll)
    want = _jax(rows, bit0, nbits, jax_tree, block_len, "xla", 1, monkeypatch)
    assert np.array_equal(got, want), "xla"
    return got


@pytest.mark.parametrize("alphabet", [1, 2, 17, 200, 256, "fib"])
def test_tables_match_jax(alphabet):
    if alphabet == "fib":
        jax, port = _trees(_fib_counts(), limit=32)
        assert port.max_code_len() == 32
    else:
        counts = np.bincount(_alphabet_data(alphabet, 5000, alphabet),
                             minlength=256)
        jax = JaxTree.from_weights(JaxWeights(counts))
        port = HuffTree.from_weights(ByteWeights(counts))
    thr, sym4, len4 = (np.asarray(a) for a in jax_decode.make_decode_tables(jax))
    tables = make_decode_tables(port)
    assert isinstance(tables, GeneralDecodeTables)
    assert np.array_equal(as_u32(tables.thr), thr)
    for got, packed in ((tables.sym, sym4), (tables.len, len4)):
        assert got.dtype == torch.uint8 and got.shape == (256,)
        unpacked = packed.astype("<u4").view(np.uint8)  # low byte first
        assert np.array_equal(got.numpy(), unpacked)


@pytest.mark.parametrize("block_len", [32, 256])
@pytest.mark.parametrize("alphabet", [2, 17, 200, 256])
def test_decode_general_matches_jax_and_source(alphabet, block_len,
                                               monkeypatch):
    data = _alphabet_data(alphabet, 13 * block_len - 5, alphabet + block_len)
    jax_tree, port_tree = _trees(np.bincount(data, minlength=256))
    assert make_canonical_decode_tables(port_tree) is None
    rows, bit0, nbits = _blocks(data, block_len, jax_tree)
    got = _check_all_routes(rows, bit0, nbits, jax_tree, port_tree, block_len,
                            monkeypatch)
    flat = got.reshape(-1)
    assert np.array_equal(flat[: data.size], data)
    assert not flat[data.size:].any()


def test_decode_general_fib_32_bit_codes(monkeypatch):
    jax_tree, port_tree = _trees(_fib_counts(), limit=32)
    assert port_tree.max_code_len() == 32
    rng = np.random.default_rng(9)
    block_len = 64
    data = rng.integers(0, 34, 7 * block_len + 3, dtype=np.uint8)
    data[:block_len] = 0  # a block of 32-bit codes
    rows, bit0, nbits = _blocks(data, block_len, jax_tree)
    got = _check_all_routes(rows, bit0, nbits, jax_tree, port_tree, block_len,
                            monkeypatch)
    assert np.array_equal(got.reshape(-1)[: data.size], data)


def test_decode_general_nbits_cut_short(monkeypatch):
    rng = np.random.default_rng(4)
    block_len = 64
    data = _alphabet_data(40, 20 * block_len, 4)
    jax_tree, port_tree = _trees(np.bincount(data, minlength=256))
    rows, bit0, nbits = _blocks(data, block_len, jax_tree)
    nbits[::2] -= rng.integers(1, 60, nbits[::2].size).astype(np.int32)
    nbits = np.maximum(nbits, 0)
    nbits[1] = 0
    got = _check_all_routes(rows, bit0, nbits, jax_tree, port_tree, block_len,
                            monkeypatch, unrolls=(4,))
    assert not got[1].any()
    lens = port_tree.encode_tables()[0]
    for b in range(0, nbits.size, 2):  # the longest whole-code prefix
        blk = data[b * block_len:(b + 1) * block_len]
        used = np.cumsum(lens[blk].astype(np.int64))
        k = int(np.searchsorted(used, nbits[b], side="right"))
        assert np.array_equal(got[b, :k], blk[:k]) and not got[b, k:].any()


@pytest.mark.parametrize("alphabet", [3, 256])
def test_decode_general_random_rows(alphabet, monkeypatch):
    """Random words, start bits and bit counts: not a valid stream, but
    every decoder must agree bit for bit."""
    rng = np.random.default_rng(12 + alphabet)
    data = _alphabet_data(alphabet, 4000, alphabet)
    jax_tree, port_tree = _trees(np.bincount(data, minlength=256))
    B, W, block_len = 40, 9, 48
    rows = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    bit0 = rng.integers(0, 32, B).astype(np.int32)
    nbits = rng.integers(0, 32 * (W - 1) - 31, B).astype(np.int32)
    _check_all_routes(rows, bit0, nbits, jax_tree, port_tree, block_len,
                      monkeypatch, unrolls=(4,))


def test_decoder_for_reads_the_tree_not_the_flag(tmp_path):
    """A canonical tree goes to the ladder (K2) and any other to K4,
    whatever the container's flag says; both decode a whole container."""
    from tpuhuff_torch.io import read_compress_write_hf2
    from tpuhuff_torch.io.hff import read_hf2_header

    data = _alphabet_data(30, 9000, 1)
    src = tmp_path / "a.bin"
    src.write_bytes(data.tobytes())
    counts = np.bincount(data, minlength=256)
    canon = port_canonical.canonicalize(HuffTree.from_weights(ByteWeights(counts)))
    for tree, want in ((canon, decode_rows), (_mirror(canon), decode_rows_general)):
        hf2 = tmp_path / "a.hf2"
        # flagged non-canonical in both cases
        read_compress_write_hf2(str(src), str(hf2), device="cpu", tree=tree,
                                canonical=False)
        with open(hf2, "rb") as fp:
            hdr = read_hf2_header(fp)
            fp.seek(hdr.payload_offset)
            payload = fp.read()
        assert not hdr.canonical
        assert decoder_for(hdr.tree)[0] is want
        assert decode_hf2_device(hdr, payload, device="cpu") == data.tobytes()


def test_decode_general_rejects_bad_operands():
    tables = make_decode_tables(HuffTree.from_weights(ByteWeights.from_bytes(b"abbc")))
    rows = torch.zeros((4, 3), dtype=torch.int32)
    vec = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        decode_rows_general(rows, vec, vec, GeneralDecodeTables(
            tables.thr, tables.sym.int(), tables.len, tables.lut), 16)
    with pytest.raises(ValueError):
        decode_rows_general(rows, vec[:3], vec, tables, 16)
    with pytest.raises(ValueError):
        decode_rows_general(rows, vec, vec, tables, 0)
    with pytest.raises(OverflowError):
        make_decode_tables(HuffTree.from_weights(ByteWeights(_fib_counts())))


def _lut_trees(alphabet):
    """(JAX tree, port tree) from the same counts, not canonical where a
    tree can be otherwise (see :func:`_trees`); "fib": 32-bit codes."""
    if alphabet == "fib":
        return _trees(_fib_counts(), limit=32)
    rng = np.random.default_rng(alphabet)
    data = (rng.zipf(1.4, 6000) % alphabet) * 251 % 256
    return _trees(np.bincount(data, minlength=256))


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
        return decode_rows_general_reference(rows, bit0, torch.full(
            (B,), nbits, dtype=torch.int32), tabs, 1)[:, 0].numpy()

    ones = dataclasses.replace(tables, sym=torch.ones_like(tables.sym))
    emitted = sum(emit(ones, m).astype(np.int64) for m in range(33))
    return emit(tables, 32).astype(np.int64), 33 - emitted


def _search(thr, sym, lens):
    """The interval search of the contract on numpy windows: (symbol,
    length, leaf index)."""
    def rule(w):
        idx = np.searchsorted(thr.astype(np.uint64), w, side="right") - 1
        idx = np.maximum(idx, 0)
        return sym.astype(np.int64)[idx], lens.astype(np.int64)[idx], idx

    return rule


def _jax_search_table(jax_tree, k):
    """K4's first-level table from the JAX package's interval tables: an
    entry resolves where both ends of its prefix land on leaves of the
    same (symbol, length) with length <= k."""
    thr, sym4, len4 = (np.asarray(a) for a in
                       jax_decode.make_decode_tables(jax_tree))
    rule = _search(thr, *(a.astype("<u4").view(np.uint8)
                          for a in (sym4, len4)))
    (s_lo, l_lo, _), (s_hi, l_hi, _) = (rule(w) for w in _prefix_ends(k))
    ok = (s_lo == s_hi) & (l_lo == l_hi) & (l_lo >= 1) & (l_lo <= k)
    return np.where(ok, s_lo | (l_lo << 8), 0)


@pytest.mark.parametrize("k", [10, 12, 14])
@pytest.mark.parametrize("alphabet", [1, 2, 17, 256, "fib"])
def test_first_level_table_matches_search(alphabet, k):
    """Every resolved entry of K4's table is the plain search's (symbol,
    length <= k) at both ends of its prefix, and every escape is a prefix
    where it is not; the table equals the one from the JAX package's
    interval tables."""
    jax_tree, port_tree = _lut_trees(alphabet)
    tables = make_decode_tables(port_tree)
    table = first_level_table(tables, k)
    assert table.dtype == torch.int16 and table.shape == (1 << k,)
    if k == LUT_BITS:  # the table the kernel takes
        assert torch.equal(tables.lut, table)
    lut = table.numpy().astype(np.int64)
    (s_lo, l_lo), (s_hi, l_hi) = (_plain_pairs(tables, w)
                                  for w in _prefix_ends(k))
    same = (s_lo == s_hi) & (l_lo == l_hi) & (l_lo >= 1) & (l_lo <= k)
    hit = lut != 0
    assert np.array_equal(hit, same)
    assert np.array_equal(lut[hit] & 255, s_lo[hit])
    assert np.array_equal(lut[hit] >> 8, l_lo[hit])
    assert np.array_equal(lut, _jax_search_table(jax_tree, k))
    if port_tree.max_code_len() <= k:
        assert hit.all()  # every code fits: no prefix escapes


@pytest.mark.parametrize("k", [10, 12, 14])
def test_first_level_table_of_intervals_of_no_tree(k):
    """Interval tables that no full tree gives (leaf boundaries inside
    k-bit prefixes, lengths that do not match them): where the two ends of
    a prefix disagree, the entry escapes, and every resolved entry is the
    plain search's on its whole prefix.  The symbols are distinct, as a
    tree's are, so equal pairs at both ends mean one leaf."""
    rng = np.random.default_rng(k)
    thr = np.sort(rng.integers(0, 1 << 32, 256, dtype=np.uint64)
                  ).astype(np.uint32)
    sym = rng.permutation(256).astype(np.uint8)
    lens = rng.integers(1, 20, 256).astype(np.uint8)
    thr[:4] = [0, 1 << 27, (1 << 27) + 5, 1 << 31]  # wide and narrow leaves
    tables = GeneralDecodeTables(as_i32(thr), torch.from_numpy(sym),
                                 torch.from_numpy(lens))
    lut = first_level_table(tables, k).numpy().astype(np.int64)
    (s_lo, l_lo), (s_hi, l_hi) = (_plain_pairs(tables, w)
                                  for w in _prefix_ends(k))
    same = (s_lo == s_hi) & (l_lo == l_hi) & (l_lo >= 1) & (l_lo <= k)
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


@pytest.mark.parametrize("alphabet", [2, 17, 256, "fib"])
def test_decode_hf2_device_on_cpu_matches_jax(alphabet, tmp_path):
    """A JAX-written container under a non-canonical tree decodes through
    the port's ``decode_hf2_device(..., device="cpu")`` to the JAX
    decoder's bytes."""
    from tpuhuff.io.hff import read_hf2_header as jax_read_header
    from tpuhuff.io.stream import read_compress_write_hf2

    from tpuhuff_torch.io.hff import read_hf2_header

    jax_tree, _ = _lut_trees(alphabet)
    letters = np.array(sorted(int(c) for c in jax_tree.read_codes()),
                       dtype=np.uint8)
    data = np.random.default_rng(5).choice(letters, 3000)
    src, hf2 = tmp_path / "a.bin", tmp_path / "a.hf2"
    src.write_bytes(data.tobytes())
    read_compress_write_hf2(str(src), str(hf2), block_len=256, tree=jax_tree,
                            canonical=False)
    with open(hf2, "rb") as fp:
        jax_hdr = jax_read_header(fp)
        fp.seek(0)
        hdr = read_hf2_header(fp)
        fp.seek(hdr.payload_offset)
        payload = fp.read()
    assert make_canonical_decode_tables(hdr.tree) is None
    want = jax_decode.decode_hf2_device(jax_hdr, payload)
    assert decode_hf2_device(hdr, payload, device="cpu") == want
    assert want == data.tobytes()
