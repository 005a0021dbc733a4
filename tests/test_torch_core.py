"""The port's host core (``tpuhuff_torch.core``, ``tpuhuff_torch.io.hff``)
against the JAX package's originals: every output must be identical.

Trees are built by each package from the same counts; the comparisons are
of bytes, codes and integer tables.
"""

import io

import numpy as np
import pytest

from tpuhuff.core import canonical as jax_canonical
from tpuhuff.core.tree import HuffTree as JaxTree
from tpuhuff.core.tree import _RustBinaryHeap as JaxHeap
from tpuhuff.core.weights import ByteWeights as JaxWeights
from tpuhuff.io import hff as jax_hff

from tpuhuff_torch.core import canonical as port_canonical
from tpuhuff_torch.core.bits import BitString, calc_padding_bits
from tpuhuff_torch.core.tree import FromBinError, HuffTree
from tpuhuff_torch.core.tree import _RustBinaryHeap as PortHeap
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.io import hff as port_hff


def _codes(tree):
    return {letter: (c.value, c.length) for letter, c in tree.read_codes().items()}


def _fib_counts(n=34):
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:n] = fib
    return counts


def _tie_heavy(rng):
    """Few distinct weights over a random alphabet: many heap ties (the
    cases of tests/test_heap_ties.py)."""
    k = int(rng.integers(1, 256))
    counts = np.zeros(256, dtype=np.int64)
    counts[rng.choice(256, size=k, replace=False)] = rng.integers(1, 6, size=k)
    return counts


def _random(rng):
    counts = rng.integers(0, 10_000, 256).astype(np.int64)
    counts[rng.random(256) < 0.3] = 0
    counts[int(rng.integers(0, 256))] += 1  # never empty
    return counts


@pytest.mark.parametrize("kind", ["tie_heavy", "random"])
@pytest.mark.parametrize("seed", range(4))
def test_tree_bin_and_codes_match_jax(kind, seed):
    rng = np.random.default_rng(100 * seed + len(kind))
    for _ in range(25):
        counts = (_tie_heavy if kind == "tie_heavy" else _random)(rng)
        port = HuffTree.from_weights(ByteWeights(counts))
        jax = JaxTree.from_weights(JaxWeights(counts))
        assert port.as_bin().to_bytes() == jax.as_bin().to_bytes()
        assert len(port.as_bin()) == len(jax.as_bin())
        assert _codes(port) == _codes(jax)
        assert port.max_code_len() == jax.max_code_len()
        for got, want in zip(port.encode_tables(), jax.encode_tables()):
            assert np.array_equal(got, want) and got.dtype == want.dtype
        for got, want in zip(port.node_arrays(), jax.node_arrays()):
            assert np.array_equal(got, want)
        back = HuffTree.try_from_bin(port.as_bin())
        assert _codes(back) == _codes(port)


@pytest.mark.parametrize("seed", range(3))
def test_heap_pop_order_matches_jax(seed):
    """Huffman traffic on tie-heavy weights: the same item identities pop."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        items = [(i, int(w)) for i, w in
                 enumerate(rng.integers(1, 6, int(rng.integers(1, 40))))]
        port, jax = PortHeap(key=lambda it: it[1]), JaxHeap(key=lambda it: it[1])
        for it in items:
            port.push(it)
            jax.push(it)
        nxt = len(items)
        while len(port) > 1:
            a, b = port.pop(), port.pop()
            assert (a, b) == (jax.pop(), jax.pop())
            port.push((nxt, a[1] + b[1]))
            jax.push((nxt, a[1] + b[1]))
            nxt += 1
        assert port.pop() == jax.pop()


@pytest.mark.parametrize("max_len", [16, 32])
def test_build_tree_for_device_fib_matches_jax(max_len):
    counts = _fib_counts()
    port, port_limited = port_canonical.build_tree_for_device(
        ByteWeights(counts), max_len)
    jax, jax_limited = jax_canonical.build_tree_for_device(
        JaxWeights(counts), max_len)
    assert port_limited and jax_limited
    assert port.max_code_len() == jax.max_code_len() == max_len
    assert _codes(port) == _codes(jax)
    assert port.as_bin().to_bytes() == jax.as_bin().to_bytes()


@pytest.mark.parametrize("alphabet", [1, 2, 17, 256, "fib"])
def test_canonicalize_and_encode_tables_match_jax(alphabet):
    if alphabet == "fib":
        counts = _fib_counts(33)  # depth 32, not length-limited
    else:
        counts = np.zeros(256, dtype=np.int64)
        rng = np.random.default_rng(alphabet)
        counts[rng.choice(256, size=alphabet, replace=False)] = rng.integers(
            1, 1000, size=alphabet)
    port = port_canonical.canonicalize(HuffTree.from_weights(ByteWeights(counts)))
    jax = jax_canonical.canonicalize(JaxTree.from_weights(JaxWeights(counts)))
    assert _codes(port) == _codes(jax)
    assert port.as_bin().to_bytes() == jax.as_bin().to_bytes()
    for got, want in zip(port.encode_tables(), jax.encode_tables()):
        assert np.array_equal(got, want)
    lengths = [(letter, c.length) for letter, c in port.read_codes().items()]
    assert (port_canonical.canonical_codes_from_lengths(lengths)
            == jax_canonical.canonical_codes_from_lengths(lengths))


def test_golden_abbccc_tree_bin():
    """The reference's doctest tree for b"abbccc" (comp.rs:218-262)."""
    tree = HuffTree.from_weights(ByteWeights.from_bytes(b"abbccc"))
    assert tree.as_bin().group_string() == "[10011000, 11100110, 00010011, 00010]"
    assert _codes(tree) == {ord("a"): (0b10, 2), ord("b"): (0b11, 2),
                            ord("c"): (0b0, 1)}


def test_bits_and_tree_serde_errors():
    bits = BitString.from_bytes(b"\xa5\x80", 9)
    assert bits.to01() == "101001011" and bits.to_bytes() == b"\xa5\x80"
    assert [calc_padding_bits(n) for n in (0, 1, 7, 8, 9)] == [0, 7, 1, 0, 7]
    assert len(bits) == 9 and bits[0] == 1 and bits[-1] == 1
    with pytest.raises(FromBinError):
        HuffTree.try_from_bin(BitString.from_bytes(b"\x80"))  # truncated
    tree_bits = HuffTree.from_weights(ByteWeights.from_bytes(b"ab")).as_bin()
    tree_bits.push(0)
    with pytest.raises(FromBinError):
        HuffTree.try_from_bin(tree_bits)  # leftover bit


def test_byte_weights_large_input_uses_native_and_matches():
    data = np.random.default_rng(3).integers(0, 200, 1 << 17, dtype=np.uint8)
    got = ByteWeights.from_bytes(data)  # >= 64 KiB: the C++ histogram
    assert np.array_equal(got.counts, np.bincount(data, minlength=256))
    assert list(got) == list(JaxWeights.from_bytes(data))


@pytest.mark.parametrize("canonical,crc_every", [(True, 0), (False, 4),
                                                 (True, 256)])
def test_hf2_prelude_and_header_match_jax(canonical, crc_every):
    counts = _random(np.random.default_rng(7))
    port_tree = HuffTree.from_weights(ByteWeights(counts))
    jax_tree = JaxTree.from_weights(JaxWeights(counts))
    n_blocks, block_len = 37, 4096
    width = port_hff.hf2_table_width(block_len, port_tree.max_code_len())
    assert width == jax_hff.hf2_table_width(block_len, jax_tree.max_code_len())
    lens = np.random.default_rng(8).integers(0, 4000, n_blocks).astype(np.uint64)
    crcs = np.arange(-(-n_blocks // crc_every) if crc_every else 0,
                     dtype=np.uint32) * 2654435761
    outs = []
    for hff, tree in ((port_hff, port_tree), (jax_hff, jax_tree)):
        fp = io.BytesIO()
        offs = hff.write_hf2_prelude(fp, tree, 123_456, block_len, n_blocks,
                                     width, canonical, crc_every=crc_every)
        hff.write_hf2_table_slice(fp, offs[0], width, 0, lens)
        if crc_every:
            hff.write_hf2_crc_slice(fp, offs[1], 0, crcs)
        fp.write(b"\x5a" * 9)  # a payload
        outs.append((fp.getvalue(), offs))
    assert outs[0] == outs[1]
    port_hdr = port_hff.read_hf2_header(io.BytesIO(outs[0][0]))
    jax_hdr = jax_hff.read_hf2_header(io.BytesIO(outs[0][0]))
    for field in ("canonical", "orig_len", "block_len", "payload_offset",
                  "crc_every", "num_blocks"):
        assert getattr(port_hdr, field) == getattr(jax_hdr, field), field
    assert np.array_equal(port_hdr.end_bits, jax_hdr.end_bits)
    assert np.array_equal(port_hdr.end_bits, np.cumsum(lens))
    assert (port_hdr.crcs is None) == (not crc_every)
    if crc_every:
        assert np.array_equal(port_hdr.crcs, jax_hdr.crcs)
    assert _codes(port_hdr.tree) == _codes(jax_hdr.tree) == _codes(port_tree)
    assert port_hff.default_crc_every(block_len) == jax_hff.default_crc_every(
        block_len)


@pytest.mark.parametrize("blob", [b"HF3\x02", b"HF2\x02\x00\x03",
                                  b"HF2\x02\x02\x02" + b"\x00" * 21])
def test_hf2_header_rejects_malformed(blob):
    with pytest.raises(ValueError):
        port_hff.read_hf2_header(io.BytesIO(blob + b"\x00" * 4))
