"""The port's block-parallel pipelines (``tpuhuff_torch.dist``) on a mesh of
8 CPU entries, where the kernels run their plain versions, against the JAX
package's (``tpuhuff.dist``) on its 8-device virtual CPU mesh.

Tolerance: none.  Histograms, word rows, bit counts, decoded bytes and
container bytes must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuhuff
from tpuhuff.core.canonical import canonicalize as jax_canonicalize
from tpuhuff.core.codec import pack_codes_u8 as jax_pack
from tpuhuff.dist import block as jax_block
from tpuhuff.dist import compress_sharded as jax_compress_sharded
from tpuhuff.dist import encode_pipeline as jax_encode_pipeline
from tpuhuff.dist import make_mesh as jax_make_mesh
from tpuhuff.kernels import make_encode_tables as jax_tables

import tpuhuff_torch
from tpuhuff_torch.core.canonical import canonicalize
from tpuhuff_torch.dist import (
    compress_sharded,
    encode_pipeline,
    make_mesh,
    pad_to_blocks,
    shard_ranges,
    sharded_count_missing,
    sharded_decode_blocks,
    sharded_encode,
    sharded_histogram,
    stitch_words,
)
from tpuhuff_torch.dist.dryrun import dryrun_multichip
from tpuhuff_torch.kernels import make_encode_tables, payload_to_lane_words

MESH = make_mesh([torch.device("cpu")] * 8)


def _trees(data):
    """The same tree in both packages (from the same counts)."""
    port = tpuhuff_torch.HuffTree.from_weights(
        tpuhuff_torch.ByteWeights.from_bytes(data))
    jax_tree = tpuhuff.HuffTree.from_weights(tpuhuff.ByteWeights.from_bytes(data))
    return port, jax_tree


def test_the_meshes(monkeypatch):
    assert len(MESH) == len(jax.devices()) == 8
    assert shard_ranges(16, MESH)[3] == (6, 8)
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_ranges(12, MESH)
    # with no card the default mesh raises, it does not take the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_pad_to_blocks():
    data = np.arange(1000, dtype=np.uint8)
    got = pad_to_blocks(data, 256, 8)
    want = jax_block.pad_to_blocks(data, 256, 8)
    assert got[2] == want[2] == 1000
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1].tolist() == [256, 256, 256, 232, 0, 0, 0, 0]


@pytest.mark.parametrize("block_len", [256, 4096])
def test_sharded_histogram(block_len):
    data = np.random.default_rng(0).integers(0, 256, 100_000, dtype=np.uint8)
    blocks, valid, _ = pad_to_blocks(data, block_len, 8)
    got = sharded_histogram(blocks, valid, MESH)
    want = np.asarray(jax_block.sharded_histogram(
        jnp.asarray(blocks), jnp.asarray(valid), jax_make_mesh()))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.bincount(data, minlength=256))


def test_sharded_count_missing():
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, 8 * 512 + 99, dtype=np.uint8)
    tree, jtree = _trees(data[data < 100])
    blocks, valid, _ = pad_to_blocks(data, 512, 8)
    got = sharded_count_missing(blocks, valid, tree.encode_tables()[0], MESH)
    want = jax_block.sharded_count_missing(
        jnp.asarray(blocks), jnp.asarray(valid),
        jnp.asarray(jtree.encode_tables()[0].astype(np.int32)), jax_make_mesh())
    assert got == want == int((data >= 100).sum())


@pytest.mark.parametrize("max_code_len", ["none", "tree"])
@pytest.mark.parametrize("block_len", [32, 64, 4096])
def test_sharded_encode_equals_jax(block_len, max_code_len):
    rng = np.random.default_rng(block_len)
    data = rng.integers(0, 250, 8 * block_len * 2 + 37, dtype=np.uint8)
    tree, jtree = _trees(data)
    ml = None if max_code_len == "none" else tree.max_code_len()
    blocks, valid, _ = pad_to_blocks(data, block_len, 8)
    words, bits = sharded_encode(blocks, valid,
                                 make_encode_tables(*tree.encode_tables()),
                                 MESH, max_code_len=ml)
    jw, jb = jax_block.sharded_encode(
        jnp.asarray(blocks), jnp.asarray(valid),
        *jax_tables(*jtree.encode_tables()), jax_make_mesh(), max_code_len=ml)
    assert words.shape == np.asarray(jw).shape  # W included
    assert np.array_equal(words, np.asarray(jw))
    assert np.array_equal(bits, np.asarray(jb))


def test_sharded_encode_block_len_1000():
    """Blocks of 1000 bytes (lanes of 8): the JAX function takes powers of
    two only, so each row is held against the JAX host packer's bytes of
    its block."""
    rng = np.random.default_rng(1000)
    data = rng.integers(0, 120, 8 * 1000 + 301, dtype=np.uint8)
    tree, jtree = _trees(data)
    blocks, valid, _ = pad_to_blocks(data, 1000, 8)
    words, bits = sharded_encode(blocks, valid,
                                 make_encode_tables(*tree.encode_tables()),
                                 MESH, max_code_len=tree.max_code_len())
    lens, codes = jtree.encode_tables()
    for b in range(blocks.shape[0]):
        want, pad = (jax_pack(blocks[b, : valid[b]], lens, codes)
                     if valid[b] else (b"", 0))
        assert bits[b] == len(want) * 8 - pad
        got = words[b].astype(">u4").tobytes()
        assert got[: len(want)] == want and not any(got[len(want):])


def test_sharded_encode_uneven_blocks_per_device():
    """9 real blocks (and a ragged tail) padded to 16 over the mesh: the
    padding blocks emit nothing, and the stitched payload is the host
    packer's."""
    rng = np.random.default_rng(23)
    data = rng.integers(0, 250, 8 * 64 + 37, dtype=np.uint8)
    tree, jtree = _trees(data)
    blocks, valid, _ = pad_to_blocks(data, 64, 8)
    assert blocks.shape[0] == 16 and int((valid > 0).sum()) == 9
    words, bits = sharded_encode(blocks, valid,
                                 make_encode_tables(*tree.encode_tables()),
                                 MESH, check_missing=False)
    assert (bits[9:] == 0).all()
    assert stitch_words(words, bits) == jax_pack(data, *jtree.encode_tables())


def test_sharded_encode_raises_on_a_stale_tree():
    rng = np.random.default_rng(11)
    train = rng.integers(0, 64, 8 * 256, dtype=np.uint8)
    tree, _ = _trees(train)
    tables = make_encode_tables(*tree.encode_tables())
    data = train.copy()
    data[5] = 200  # not in the tree
    blocks, valid, _ = pad_to_blocks(data, 256, 8)
    with pytest.raises(tpuhuff_torch.CompressError, match=r"\(1 bytes\)"):
        sharded_encode(blocks, valid, tables, MESH)
    blocks, valid, _ = pad_to_blocks(train, 256, 8)
    assert int(sharded_encode(blocks, valid, tables, MESH)[1].sum()) > 0


@pytest.mark.parametrize("canonical", [True, False])
def test_sharded_decode_blocks(canonical):
    """K2's plain version on a canonical tree, K4's on a non-canonical one;
    the bytes restored, and equal to the JAX function's output."""
    rng = np.random.default_rng(17)
    block_len = 32
    data = rng.integers(0, 120, 8 * 16 * block_len - 7, dtype=np.uint8)
    tree, jtree = _trees(data)
    if canonical:
        tree, jtree = canonicalize(tree), jax_canonicalize(jtree)
    blocks, valid, _ = pad_to_blocks(data, block_len, 8)
    words, bits = sharded_encode(blocks, valid,
                                 make_encode_tables(*tree.encode_tables()),
                                 MESH, check_missing=False)
    payload, _ = stitch_words(words, bits)
    ends = np.cumsum(bits.astype(np.int64))
    starts = np.concatenate([[0], ends[:-1]])
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    nbits = (ends - starts).astype(np.int32)
    out = sharded_decode_blocks(rows, bit0, nbits, tree, block_len, MESH)
    assert np.array_equal(out.reshape(-1)[: data.size], data)
    jout = np.asarray(jax_block.sharded_decode_blocks(
        jnp.asarray(rows), jnp.asarray(bit0), jnp.asarray(nbits), jtree,
        block_len, jax_make_mesh()))
    assert np.array_equal(out, jout)


@pytest.mark.parametrize("n", [5000, 65536, 200_001])
def test_compress_sharded_bit_identical(n):
    data = np.random.default_rng(n).integers(0, 200, n, dtype=np.uint8).tobytes()
    got = compress_sharded(data, block_len=4096, mesh=MESH)
    want = tpuhuff.compress(data)
    assert got.to_bytes() == want.to_bytes()
    assert got.to_bytes() == tpuhuff_torch.compress(data).to_bytes()
    assert got.to_bytes() == jax_compress_sharded(data, block_len=4096).to_bytes()
    assert tpuhuff_torch.decompress(got) == data


def test_compress_sharded_text():
    text = b"the quick brown fox jumps over the lazy dog " * 3000
    assert (compress_sharded(text, block_len=8192, mesh=MESH).to_bytes()
            == tpuhuff.compress(text).to_bytes())


@pytest.mark.parametrize("canonical", [False, True])
def test_encode_pipeline_equals_jax(canonical):
    data = np.random.default_rng(2).integers(0, 50, 10_000, dtype=np.uint8)
    words, bits, tree, orig = encode_pipeline(data, block_len=1024, mesh=MESH,
                                              canonical=canonical)
    jw, jb, jtree, jorig = jax_encode_pipeline(data, block_len=1024,
                                               canonical=canonical)
    assert orig == jorig == 10_000
    assert words.shape[0] % 8 == 0
    assert np.array_equal(words, jw) and np.array_equal(bits, jb)
    assert tree.as_bin().to_bytes() == jtree.as_bin().to_bytes()


def test_encode_pipeline_deep_tree_fallback():
    """Fibonacci weights deeper than an (artificially low) cap: the
    length-limited tree, as in the JAX function, and a round trip."""
    fib = [1, 1]
    for _ in range(12):
        fib.append(fib[-1] + fib[-2])
    raw = np.repeat(np.arange(14, dtype=np.uint8), fib)
    words, bits, tree, _ = encode_pipeline(raw, block_len=256, mesh=MESH,
                                           max_code_len=8)
    jw, jb, jtree, _ = jax_encode_pipeline(raw, block_len=256, max_code_len=8)
    assert tree.max_code_len() <= 8
    assert tree.as_bin().to_bytes() == jtree.as_bin().to_bytes()
    assert np.array_equal(words, jw) and np.array_equal(bits, jb)
    comp = tpuhuff_torch.CompressData(*stitch_words(words, bits), tree)
    assert tpuhuff_torch.decompress(comp) == raw.tobytes()


def test_compress_multihost_single_process_degenerates():
    from tpuhuff_torch.dist.multihost import (
        compress_multihost, host_shard_range, is_coordinator,
    )

    assert is_coordinator()
    assert host_shard_range(10_000, 1024) == (0, 10_000)
    data = np.random.default_rng(3).integers(0, 99, 5000, dtype=np.uint8)
    words, bits, _, orig = compress_multihost(data, block_len=512, device="cpu")
    host = tpuhuff.compress(data.tobytes())
    assert orig == 5000
    assert stitch_words(words, bits) == (host.comp_bytes, host.padding_bits)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_dryrun(n, capsys):
    out = dryrun_multichip(n, "cpu")
    assert out["blocks"] % n == 0 and out["bits"] > 0
    assert f"dryrun_multichip({n})" in capsys.readouterr().out
