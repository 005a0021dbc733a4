"""The plain reference: the tree of the reference coder, the container the
program must write, and the decoder."""

import os

import numpy as np
import pytest

import corpus
import reference

# b"abbccc" under the reference coder: a: 10, b: 11, c: 0 (the repository's
# golden bytes of the .hff format, tpuhuff.compress(b"abbccc"))
ABBCCC = b"abbccc"


def test_tree_of_abbccc():
    code = reference.huff_code(np.bincount(np.frombuffer(ABBCCC, np.uint8),
                                           minlength=256), canonical=False)
    got = {chr(b): format(int(code.values[b]), f"0{code.lengths[b]}b")
           for b in np.nonzero(code.lengths)[0]}
    assert got == {"a": "10", "b": "11", "c": "0"}
    # pre-order: joint, leaf c, joint, leaf a, leaf b
    assert code.tree_bits == ("1" + "0" + format(ord("c"), "08b") + "1"
                              + "0" + format(ord("a"), "08b")
                              + "0" + format(ord("b"), "08b"))


def test_decodes_a_tiny_container():
    data = np.frombuffer(b"abbccc" * 50 + b"xyz", dtype=np.uint8)
    for block_len in (4, 256, 1000):
        buf = reference.encode(data, block_len=block_len)
        whole = np.frombuffer(buf.prelude + buf.payload.tobytes(), np.uint8)
        h = reference.parse_header(whole)
        assert (h.orig_len, h.block_len) == (data.size, block_len)
        assert h.n_blocks == -(-data.size // block_len)
        assert np.array_equal(reference.decode(whole), data)


def test_narrowed_decoder_is_wrong_on_the_longest_codes():
    data = corpus.make({"parts": [{"recipe": "textlike", "share": 1}]},
                       1 << 16, 3, 0)
    buf = reference.encode(data)
    whole = np.frombuffer(buf.prelude + buf.payload.tobytes(), np.uint8)
    longest = buf.code.max_len
    assert np.array_equal(reference.decode(whole, max_bits=longest), data)
    assert np.count_nonzero(reference.decode(whole, max_bits=longest - 1)
                            != data) > 0


def test_differing_bytes_counts_lengths_too():
    data = np.frombuffer(b"hello world" * 100, dtype=np.uint8)
    want = reference.encode(data)
    got = np.frombuffer(want.prelude + want.payload.tobytes(), np.uint8)
    assert reference.differing_bytes(got, want) == 0
    bent = got.copy()
    bent[-1] ^= 1
    assert reference.differing_bytes(bent, want) == 1
    assert reference.differing_bytes(got[:-3], want) == 3


RECIPES = (("textlike", 1 << 18), ("uniform", 1 << 16), ("geometric", 1 << 18),
           ("mixed", 3 << 16), ("textlike", 100_003))


@pytest.mark.parametrize("canonical", (True, False))
@pytest.mark.parametrize("recipe,n", RECIPES)
def test_equals_the_program_container(tmp_path, recipe, n, canonical):
    """The program's writer, on the CPU, writes what the reference works
    out (the tests may import the program; the reference never does)."""
    from tpuhuff_torch.io import read_compress_write_hf2

    parts = ([{"recipe": r, "share": 1} for r in
              ("textlike", "uniform", "geometric")] if recipe == "mixed"
             else [{"recipe": recipe, "share": 1}])
    data = corpus.make({"parts": parts}, n, 11, 0)
    src, dst = os.path.join(tmp_path, "src"), os.path.join(tmp_path, "dst")
    data.tofile(src)
    read_compress_write_hf2(src, dst, device="cpu", canonical=canonical)
    got = np.fromfile(dst, dtype=np.uint8)
    assert reference.differing_bytes(got, reference.encode(
        data, canonical=canonical)) == 0


@pytest.mark.parametrize("seed", range(40))
def test_tree_ties_as_the_program_breaks_them(seed):
    """Histograms full of equal counts: the reference's heap walk must put
    every tie where the program's (the huff reference's) does."""
    from tpuhuff_torch.core.tree import HuffTree
    from tpuhuff_torch.core.weights import ByteWeights

    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, 256) * rng.integers(1, 3)
    counts[rng.integers(0, 256, 3)] = rng.integers(1, 50, 3)
    if np.count_nonzero(counts) < 2:
        counts[:2] = 1
    tree = HuffTree.from_weights(ByteWeights(counts))
    want = {b: c.to01() for b, c in tree.read_codes().items()}
    code = reference.huff_code(counts, canonical=False)
    got = {int(b): format(int(code.values[b]), f"0{code.lengths[b]}b")
           for b in np.nonzero(code.lengths)[0]}
    assert got == want
