"""tpuhuff_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU (or without nvcc) every test skips.  On a
machine with an H100 run ``python -m pytest tests/test_torch_cuda.py``.
This file imports nothing of JAX or of the JAX package, so it runs where
JAX is not installed.
"""

import numpy as np
import pytest
import torch

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


def test_decode_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    B, N = 3000, 256
    data = rng.zipf(1.3, (B, N)).clip(0, 255).astype(np.uint8)
    tree = _tree(data.reshape(-1))
    etab = make_encode_tables(*tree.encode_tables()).to(dev)
    words, bits, _ = encode_blocks(torch.from_numpy(data).to(dev),
                                   torch.full((B,), N, dtype=torch.int32,
                                              device=dev), etab)
    rows = torch.nn.functional.pad(words, (0, 1))
    bit0 = torch.zeros(B, dtype=torch.int32, device=dev)
    bits[::3] -= 5  # cut some blocks short
    bits.clamp_(min=0)
    dtab = make_canonical_decode_tables(tree).to(dev)
    got = decode_rows(rows, bit0, bits, dtab, N)
    want = decode_rows_reference(rows, bit0, bits, dtab, N)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("alphabet", [2, 40, 256])
def test_decode_general_kernel_matches_plain(dev, alphabet):
    """K4 on a non-canonical tree (the device tree, mirrored if canonical):
    bit-exact against its plain version, on cut-short blocks and on rows of
    random words, and the full blocks decode to their source."""
    rng = np.random.default_rng(alphabet)
    B, N = 3000, 256
    data = (rng.zipf(1.3, (B, N)) % alphabet).astype(np.uint8)
    tree = build_tree_for_device(
        ByteWeights(np.bincount(data.reshape(-1), minlength=256)), 32)[0]
    if make_canonical_decode_tables(tree) is not None:
        tree = HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                        tree.root)
    assert make_canonical_decode_tables(tree) is None
    etab = make_encode_tables(*tree.encode_tables()).to(dev)
    lanes = torch.from_numpy(data).to(dev)
    words, bits, _ = encode_blocks(lanes, torch.full((B,), N, dtype=torch.int32,
                                                     device=dev), etab)
    rows = torch.nn.functional.pad(words, (0, 1))
    bit0 = torch.zeros(B, dtype=torch.int32, device=dev)
    gtab = make_decode_tables(tree).to(dev)
    full = decode_rows_general(rows, bit0, bits, gtab, N)
    torch.cuda.synchronize()
    assert torch.equal(full, lanes)
    bits[::3] = (bits[::3] - 5).clamp(min=0)  # cut some blocks short
    noise = torch.from_numpy(rng.integers(0, 1 << 32, tuple(rows.shape),
                                          dtype=np.uint64).astype(np.uint32)
                             .view(np.int32)).to(dev)
    for r in (rows, noise):
        got = decode_rows_general(r, bit0, bits, gtab, N)
        want = decode_rows_general_reference(r, bit0, bits, gtab, N)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 15, 4096 + 7, (8 << 20) + 5])
def test_histogram_kernel_matches_plain(dev, n):
    data = torch.from_numpy(np.random.default_rng(n).zipf(1.2, n + 1)
                            .clip(0, 255).astype(np.uint8)).to(dev)
    for view in (data[:n], data[1:]):  # aligned and unaligned starts
        got = histogram(view)
        torch.cuda.synchronize()
        assert torch.equal(got, histogram_reference(view))
