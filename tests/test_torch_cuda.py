"""tpuhuff_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU (or without nvcc) every test skips.  On a
machine with an H100 run ``python -m pytest tests/test_torch_cuda.py``.
This file imports nothing of JAX or of the JAX package, so it runs where
JAX is not installed.
"""

import numpy as np
import pytest
import torch

from tpuhuff_torch import native
from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
from tpuhuff_torch.core.tree import HuffTree
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.kernels import (
    decode_rows,
    decode_rows_general,
    decode_rows_general_reference,
    decode_rows_reference,
    encode_blocks,
    encode_blocks_reference,
    histogram,
    histogram_reference,
    make_canonical_decode_tables,
    make_decode_tables,
    make_encode_tables,
    payload_to_lane_words,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _tree(data):
    counts = np.bincount(data, minlength=256)
    return canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])


@pytest.mark.parametrize("N", [1, 2, 8, 16, 256, 1024])
def test_encode_kernel_matches_plain(dev, N):
    rng = np.random.default_rng(N)
    B = 1000
    data = rng.zipf(1.3, (B, N)).clip(0, 255).astype(np.uint8)
    tables = make_encode_tables(*_tree(data.reshape(-1)).encode_tables()).to(dev)
    valid = torch.from_numpy(rng.integers(0, N + 1, B).astype(np.int32)).to(dev)
    lanes = torch.from_numpy(data).to(dev)
    got = encode_blocks(lanes, valid, tables)
    want = encode_blocks_reference(lanes, valid, tables)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("N", [8, 256])
@pytest.mark.parametrize("operand", ["lanes", "unaligned"])
def test_encode_hist_kernel_matches_plain(dev, N, operand):
    """K5: K1's results and the exact counts of ``hist_data``, which is the
    lanes themselves or a shorter operand 3 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(N + len(operand))
    B = 3000
    data = rng.zipf(1.3, (B, N)).clip(0, 255).astype(np.uint8)
    tables = make_encode_tables(*_tree(data.reshape(-1)).encode_tables()).to(dev)
    valid = torch.from_numpy(rng.integers(0, N + 1, B).astype(np.int32)).to(dev)
    lanes = torch.from_numpy(data).to(dev)
    if operand == "lanes":
        hist = lanes
    else:
        buf = torch.from_numpy(rng.integers(0, 256, B * N + 16,
                                            dtype=np.uint8)).to(dev)
        hist = buf[3: 3 + B * N - 13]
        assert hist.data_ptr() % 16 == 3
    before = encode_blocks.hist_launches, encode_blocks.launches
    got = encode_blocks(lanes, valid, tables, hist_data=hist)
    want = encode_blocks_reference(lanes, valid, tables, hist_data=hist)
    torch.cuda.synchronize()
    assert (encode_blocks.hist_launches, encode_blocks.launches) == (
        before[0] + 1, before[1])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows_kind", ["codes", "cut short", "random words"])
@pytest.mark.parametrize("block_len", [256, 1000, 2048, 100, 255])
@pytest.mark.parametrize("alphabet", [2, 40, 256])
@pytest.mark.parametrize("decoder", ["K2", "K4"])
def test_decode_kernels_match_plain(dev, decoder, alphabet, block_len,
                                    rows_kind):
    """K2 on the canonical tree and K4 on a non-canonical one (the device
    tree, mirrored if canonical): bit-exact against the plain version on
    whole blocks, on blocks cut short and on rows of random words, with
    ``rows`` a view 4 bytes past a 16-byte boundary; whole blocks decode to
    their source, and the wrapper counts one launch.  Block lengths 100 and
    255 leave the output in 4- and 1-byte stores and a last group of 4 and
    15 symbols."""
    rng = np.random.default_rng(alphabet * 7 + block_len + len(rows_kind))
    B = 3000 if block_len == 256 else 700
    data = (rng.zipf(1.3, (B, block_len)) % alphabet).astype(np.uint8)
    tree = build_tree_for_device(
        ByteWeights(np.bincount(data.reshape(-1), minlength=256)), 32)[0]
    if decoder == "K2":
        tree = canonicalize(tree)
        wrapper, plain = decode_rows, decode_rows_reference
        tables = make_canonical_decode_tables(tree).to(dev)
    else:
        if make_canonical_decode_tables(tree) is not None:
            tree = HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                            tree.root)
        assert make_canonical_decode_tables(tree) is None
        wrapper, plain = decode_rows_general, decode_rows_general_reference
        tables = make_decode_tables(tree).to(dev)
    payload, _, bit_lens = native.encode_blocks_host(
        data, block_len, *tree.encode_tables())
    ends = np.cumsum(bit_lens.astype(np.int64))
    starts = ends - bit_lens.astype(np.int64)
    rows_np, bit0_np = payload_to_lane_words(payload, starts, ends, block_len)
    W = rows_np.shape[1]
    if rows_kind == "random words":
        rows_np = rng.integers(0, 1 << 32, rows_np.shape, dtype=np.uint64
                               ).astype(np.uint32)
        bit0_np = rng.integers(0, 32, B).astype(np.int32)
    nbits_np = (ends - starts).astype(np.int32)
    if rows_kind == "cut short":
        nbits_np[::3] = np.maximum(nbits_np[::3] - 5, 0)
    if rows_kind == "random words":
        nbits_np = rng.integers(0, 32 * (W - 1), B).astype(np.int32)
    flat = torch.zeros(B * W + 8, dtype=torch.int32, device=dev)
    off = (-flat.data_ptr() // 4) % 4 + 1  # 4 bytes past a 16-byte boundary
    rows = flat[off: off + B * W].view(B, W)
    assert rows.data_ptr() % 16 == 4
    rows.copy_(torch.from_numpy(rows_np.view(np.int32)))
    bit0 = torch.from_numpy(bit0_np).to(dev)
    nbits = torch.from_numpy(nbits_np).to(dev)
    before = wrapper.launches
    got = wrapper(rows, bit0, nbits, tables, block_len)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(rows, bit0, nbits, tables, block_len)
    assert torch.equal(got, want)
    if rows_kind == "codes":
        assert torch.equal(got.cpu(), torch.from_numpy(data))


@pytest.mark.parametrize("n", [1, 15, 4096 + 7, (8 << 20) + 5])
def test_histogram_kernel_matches_plain(dev, n):
    data = torch.from_numpy(np.random.default_rng(n).zipf(1.2, n + 1)
                            .clip(0, 255).astype(np.uint8)).to(dev)
    for view in (data[:n], data[1:]):  # aligned and unaligned starts
        got = histogram(view)
        torch.cuda.synchronize()
        assert torch.equal(got, histogram_reference(view))
