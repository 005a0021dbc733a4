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
    out_words,
    payload_to_lane_words,
)

from chip_smoke import HIST_KINDS, make_hist_input, make_textlike
from test_torch_decode_split import CASES, split_case
from test_torch_lane_rows import CASES as ROW_CASES
from test_torch_lane_rows import blocks_case
from test_torch_stitch import KINDS as STITCH_KINDS
from test_torch_stitch import _carry, lanes_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _tree(data):
    counts = np.bincount(data, minlength=256)
    return canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])


def _fib_tree():
    """A tree of Fibonacci weights: codes of up to 32 bits."""
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    return canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])


def _encode_case(dev, N, case, seed):
    """(lanes, valid, tables, max_code_len) for one case: ``ragged`` (B not
    a multiple of the tile, ragged valid counts, missing letters), ``one
    lane``, ``no lanes``, ``wide`` (max_code_len 32, above the tables':
    more zero words), ``fib32`` (32-bit codes) or ``poisoned`` (the
    allocator's blocks of the words' size hold 0xFF first, so a word the
    kernel leaves unwritten shows)."""
    rng = np.random.default_rng(seed)
    B = {"one lane": 1, "no lanes": 0}.get(case, 1000 + 7)
    if case == "fib32":
        data = rng.integers(0, 12, (B, N), dtype=np.uint8)
        tree = _fib_tree()
    else:
        data = rng.zipf(1.3, (B, N)).clip(0, 255).astype(np.uint8)
        # bytes >= 200 have no code: missing letters
        tree = _tree(np.concatenate([data[data < 200], np.arange(200)]))
    tables = make_encode_tables(*tree.encode_tables()).to(dev)
    valid = torch.from_numpy(rng.integers(0, N + 1, B).astype(np.int32)).to(dev)
    max_code_len = 32 if case == "wide" else None
    if case == "poisoned":
        R = out_words(N, tables.max_len)
        junk = [torch.empty((B, R), dtype=torch.int32, device=dev).fill_(-1)
                for _ in range(4)]
        torch.cuda.synchronize()
        del junk
    return torch.from_numpy(data).to(dev), valid, tables, max_code_len


_CASES = ["ragged", "one lane", "no lanes", "wide", "fib32", "poisoned"]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32, 256, 1024])
def test_encode_kernel_matches_plain(dev, N, case):
    """K1 bit-exact against its plain version: words (all R of them),
    bits and miss, and one launch counted."""
    lanes, valid, tables, ml = _encode_case(dev, N, case, N + len(case))
    before = encode_blocks.launches
    got = encode_blocks(lanes, valid, tables, ml)
    want = encode_blocks_reference(lanes, valid, tables, ml)
    torch.cuda.synchronize()
    assert encode_blocks.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["ragged", "one lane", "fib32", "poisoned"])
@pytest.mark.parametrize("operand", ["lanes", "prefix", "offset view",
                                     "unaligned"])
@pytest.mark.parametrize("N", [1, 4, 8, 32, 256, 1024])
def test_encode_hist_kernel_matches_plain(dev, N, operand, case):
    """K5: K1's results and the exact counts of ``hist_data``: the lanes
    themselves or an odd-length prefix of their storage (counted from the
    bytes the encode holds), a view of the lanes one byte in, or another
    tensor 3 bytes past a 16-byte boundary (read apart)."""
    lanes, valid, tables, ml = _encode_case(dev, N, case,
                                            N + len(operand) + len(case))
    flat = lanes.reshape(-1)
    n = flat.numel()
    if operand == "lanes":
        hist = lanes
    elif operand == "prefix":
        hist = flat[: max(1, n - 2 * N - 1) | 1]
    elif operand == "offset view":
        hist = flat[1:]
    else:
        buf = torch.from_numpy(np.random.default_rng(n).integers(
            0, 256, n + 16, dtype=np.uint8)).to(dev)
        hist = buf[3: 3 + max(1, n - 13)]
        assert hist.data_ptr() % 16 == 3
    # the kernel counts from the bytes it holds only where the operand
    # starts at the lanes' first byte
    assert (hist.data_ptr() == lanes.data_ptr()) == (operand in ("lanes",
                                                                 "prefix"))
    before = encode_blocks.hist_launches, encode_blocks.launches
    got = encode_blocks(lanes, valid, tables, ml, hist_data=hist)
    want = encode_blocks_reference(lanes, valid, tables, ml, hist_data=hist)
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


@pytest.mark.parametrize("n", [17, (1 << 20) + 3, (64 << 20) - 1, 256 << 20])
@pytest.mark.parametrize("kind", HIST_KINDS)
def test_histogram_kernel_on_every_input_kind(dev, kind, n):
    """K3 on each input kind, up to 256 MiB (config 3's per-shard launch),
    at starts 0 to 15 bytes past a 16-byte boundary: exact, one launch per
    call."""
    buf = torch.from_numpy(make_hist_input(kind, n + 15, np, seed=n)).to(dev)
    for off in (range(16) if n < (64 << 20) else (0, 7, 15)):
        view = buf[off: off + n]
        before = histogram.launches
        got = histogram(view)
        torch.cuda.synchronize()
        assert histogram.launches == before + 1
        assert torch.equal(got, histogram_reference(view)), (kind, n, off)


@pytest.mark.parametrize("kind", HIST_KINDS)
def test_histogram_kernel_out_accumulates(dev, kind):
    """``out=`` over pieces of several sizes and starts equals one call over
    the whole input; each call is exactly one launch, and a wrong ``out``
    raises before any launch."""
    data = torch.from_numpy(make_hist_input(kind, (40 << 20) + 77, np,
                                            seed=1)).to(dev)
    cuts = [0, 1, 17, 4096 + 3, (1 << 20) + 5, (24 << 20) + 9, data.numel()]
    out = torch.full((256,), 5, dtype=torch.int64, device=dev)
    before = histogram.launches
    for lo, hi in zip(cuts, cuts[1:]):
        assert histogram(data[lo:hi], out=out) is out
    torch.cuda.synchronize()
    assert histogram.launches == before + len(cuts) - 1
    assert torch.equal(out - 5, histogram_reference(data))
    for bad in (torch.zeros(256, dtype=torch.int64),
                torch.zeros(256, dtype=torch.int32, device=dev)):
        with pytest.raises((TypeError, ValueError)):
            histogram(data, out=bad)
    assert histogram.launches == before + len(cuts) - 1


@pytest.mark.parametrize("block_len", [256, 1000])
@pytest.mark.parametrize("mirrored", [False, True])
@pytest.mark.parametrize("letters", [(97, 98), (0, 255)])
def test_decode_general_two_leaf_tree(dev, letters, mirrored, block_len):
    """K4 on a tree of two leaves (one-bit codes; the tree the JAX Pallas
    kernel cannot trace at ``levels=1``), either way round, whole blocks
    and blocks cut short: bit-exact against its plain version, and whole
    blocks restore their source."""
    rng = np.random.default_rng(sum(letters) + block_len + mirrored)
    B = 600
    data = np.where(rng.random((B, block_len)) < 0.7, letters[0],
                    letters[1]).astype(np.uint8)
    counts = np.bincount(data.reshape(-1), minlength=256)
    tree = HuffTree.from_weights(ByteWeights(counts))
    assert (tree.encode_tables()[0] > 0).sum() == 2
    if mirrored:
        tree = HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                        tree.root)
    tables = make_decode_tables(tree).to(dev)
    payload, _, bit_lens = native.encode_blocks_host(
        data, block_len, *tree.encode_tables())
    ends = np.cumsum(bit_lens.astype(np.int64))
    starts = ends - bit_lens.astype(np.int64)
    rows_np, bit0_np = payload_to_lane_words(payload, starts, ends, block_len)
    rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)
    bit0 = torch.from_numpy(bit0_np).to(dev)
    nbits_np = (ends - starts).astype(np.int32)
    for cut in (False, True):
        if cut:
            nbits_np[::3] = np.maximum(nbits_np[::3] - 5, 0)
        nbits = torch.from_numpy(nbits_np).to(dev)
        before = decode_rows_general.launches
        got = decode_rows_general(rows, bit0, nbits, tables, block_len)
        torch.cuda.synchronize()
        assert decode_rows_general.launches == before + 1
        want = decode_rows_general_reference(rows, bit0, nbits, tables,
                                             block_len)
        assert torch.equal(got, want)
        if not cut:
            assert torch.equal(got.cpu(), torch.from_numpy(data))


def _rows_of(payload, bit_lens, block_len):
    ends = np.cumsum(bit_lens.astype(np.int64))
    starts = ends - bit_lens.astype(np.int64)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    return rows, bit0, (ends - starts).astype(np.int32)


@pytest.mark.parametrize("decoder", ["K2", "K4"])
def test_decode_global_rows_route_matches_plain(dev, decoder):
    """Rows too wide for shared memory (60,000 words of random bits) take
    the decoders' global-rows route: bit-exact against the plain version,
    counted in ``global_launches``."""
    from tpuhuff_torch.kernels import decode_tile_rows

    rng = np.random.default_rng(60_000 + len(decoder))
    B, W, block_len = 40, 60_000, 300
    assert decode_tile_rows(B, W, block_len, decoder == "K4", dev) == 0
    tree = _fib_tree()
    if decoder == "K2":
        wrapper, plain = decode_rows, decode_rows_reference
        tables = make_canonical_decode_tables(tree).to(dev)
    else:
        tree = HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                        tree.root)
        wrapper, plain = decode_rows_general, decode_rows_general_reference
        tables = make_decode_tables(tree).to(dev)
    rows = torch.from_numpy(rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    bit0 = torch.from_numpy(rng.integers(0, 32 * W, B).astype(np.int32)).to(dev)
    nbits = torch.from_numpy(rng.integers(0, 32 * W, B).astype(np.int32)).to(dev)
    before = wrapper.launches, wrapper.global_launches
    got = wrapper(rows, bit0, nbits, tables, block_len)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.global_launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(got, plain(rows, bit0, nbits, tables, block_len))


WIDE = 50_000  # words: a row of which not one fits in shared memory


def _widened(rows, nbits):
    """Rows padded with zero words to WIDE words, so that the launch takes
    the global-rows route; an end past the rows' old width moves past the
    new one (words past W still read as 0)."""
    B, W = rows.shape
    wide = np.zeros((B, WIDE), dtype=np.uint32)
    wide[:, :W] = rows
    return wide, np.where(nbits > 32 * W, 32 * WIDE + 5000, nbits).astype(np.int32)


@pytest.mark.parametrize("name,rule", [
    (name, rule) for name in CASES for rule in ("K2", "K4")] + [
    ("zero-length leaf", "K4")])
def test_global_rows_route_edge_cases(dev, name, rule):
    """The CPU harness's cases (``tests/test_torch_decode_split.py``) on
    the card, their rows widened past shared memory: the global-rows route
    (one thread block per Huffman block), bit-exact against the plain
    version, whole blocks restoring their source.  Random words at
    ``block_len`` 299 leave the output in 1-byte stores; the other cases
    take 16-, 8- (``nbits`` edges, 3000) and 4-byte stores (3-bit codes,
    2500).  The zero-length leaf is a K4 table with a leaf of 0 bits."""
    from tpuhuff_torch.kernels import GeneralDecodeTables, decode_tile_rows

    case = "bit0 > 0" if name == "zero-length leaf" else name
    rows, bit0, nbits, tables, block_len, data = split_case(case, rule)
    if name == "zero-length leaf":
        lens = tables.len.clone()
        lens[5] = 0
        tables = GeneralDecodeTables(tables.thr, tables.sym, lens)
        data = None
    if name == "random words":
        block_len -= 1
    rows, nbits = _widened(rows, nbits)
    B = rows.shape[0]
    assert decode_tile_rows(B, WIDE, block_len, rule == "K4", dev) == 0
    wrapper, plain = ((decode_rows, decode_rows_reference) if rule == "K2"
                      else (decode_rows_general, decode_rows_general_reference))
    rows = torch.from_numpy(rows.view(np.int32)).to(dev)
    bit0 = torch.from_numpy(bit0).to(dev)
    nbits = torch.from_numpy(nbits).to(dev)
    tables = tables.to(dev)
    before = wrapper.launches, wrapper.global_launches
    got = wrapper(rows, bit0, nbits, tables, block_len)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.global_launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(got, plain(rows, bit0, nbits, tables, block_len))
    if data is not None:
        assert np.array_equal(got.cpu().numpy().reshape(-1), data)


def test_global_rows_route_output_past_shared_memory(dev):
    """Blocks of 200,000 bytes: the output row does not fit beside the
    table, so the global-rows route writes it straight to device memory.
    Whole blocks restore their source; a block cut 7 bits short keeps its
    whole codes and is 0 after them."""
    from tpuhuff_torch.kernels import decode_tile_rows

    rng = np.random.default_rng(200_000)
    block_len, B = 200_000, 3
    data = (rng.zipf(1.3, B * block_len) % 90 + 30).astype(np.uint8)
    tree = _tree(data)
    payload, _, bit_lens = native.encode_blocks_host(data, block_len,
                                                     *tree.encode_tables())
    rows, bit0, nbits = _rows_of(payload, bit_lens, block_len)
    nbits[1] -= 7
    rows, nbits = _widened(rows, nbits)
    assert decode_tile_rows(B, WIDE, block_len, False, dev) == 0
    tables = make_canonical_decode_tables(tree).to(dev)
    before = decode_rows.global_launches
    got = decode_rows(torch.from_numpy(rows.view(np.int32)).to(dev),
                      torch.from_numpy(bit0).to(dev),
                      torch.from_numpy(nbits).to(dev), tables, block_len)
    torch.cuda.synchronize()
    assert decode_rows.global_launches == before + 1
    got = got.cpu().numpy()
    want = data.reshape(B, block_len).copy()
    lens = tree.encode_tables()[0][want[1]].astype(np.int64)
    whole = int(np.searchsorted(np.cumsum(lens), nbits[1], side="right"))
    assert whole < block_len
    want[1, whole:] = 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("codes", ["textlike", "32-bit"])
@pytest.mark.parametrize("canonical", [True, False])
def test_sharded_decode_blocks_at_64_kib(dev, codes, canonical):
    """``sharded_decode_blocks`` at 65536-byte blocks on ``[cuda] * 2``:
    K2 (canonical) or K4 alone, exact.  Blocks of the Fibonacci tree's
    rarest letters (codes of 25 to 32 bits) are rows too wide for shared
    memory, and of the textlike rows the staged route would fit fewer than
    32 to a thread block: both take the global-rows route."""
    from tpuhuff_torch.dist import make_mesh, sharded_decode_blocks
    from tpuhuff_torch.kernels import decode_tile_rows

    rng = np.random.default_rng(len(codes) + canonical)
    block_len, B = 65536, 4
    if codes == "32-bit":
        tree = _fib_tree()
        lens = tree.encode_tables()[0]
        rare = np.flatnonzero(lens >= 25).astype(np.uint8)
        data = rare[rng.integers(0, rare.size, B * block_len)]
    else:
        data = (rng.zipf(1.3, B * block_len) % 90).astype(np.uint8)
        tree = _tree(data)
    if not canonical:
        tree = HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                        tree.root)
    payload, _, bit_lens = native.encode_blocks_host(data, block_len,
                                                     *tree.encode_tables())
    rows, bit0, nbits = _rows_of(payload, bit_lens, block_len)
    wrapper = decode_rows if canonical else decode_rows_general
    other = decode_rows_general if canonical else decode_rows
    before = (wrapper.launches, wrapper.global_launches, other.launches)
    out = sharded_decode_blocks(rows, bit0, nbits, tree, block_len,
                                make_mesh([dev] * 2))
    torch.cuda.synchronize()
    assert np.array_equal(out.reshape(-1), data)
    assert decode_tile_rows(B // 2, rows.shape[1], block_len, not canonical,
                            dev) == 0
    assert (wrapper.launches - before[0], wrapper.global_launches - before[1],
            other.launches - before[2]) == (2, 2, 0)


def test_compress_sharded_on_four_entries_of_one_card(dev):
    """Config 3's shape on one card: the same container as the host codec,
    K3 and K1 once per shard, and the dry run on four entries."""
    import tpuhuff_torch
    from tpuhuff_torch.dist import compress_sharded, make_mesh
    from tpuhuff_torch.dist.dryrun import dryrun_multichip

    rng = np.random.default_rng(3)
    n = (3 << 20) + 12345
    data = np.concatenate([
        (rng.zipf(1.3, n // 3) % 200).astype(np.uint8),
        rng.integers(0, 256, n // 3, dtype=np.uint8),
        np.minimum(rng.geometric(0.08, n - 2 * (n // 3)), 255).astype(np.uint8),
    ])
    want = tpuhuff_torch.compress(data).to_bytes()
    for mesh in (make_mesh([dev]), make_mesh([dev] * 4)):
        before = histogram.launches, encode_blocks.launches
        got = compress_sharded(data, block_len=65536, mesh=mesh)
        torch.cuda.synchronize()
        assert (histogram.launches - before[0],
                encode_blocks.launches - before[1]) == (len(mesh), len(mesh))
        assert got.to_bytes() == want
        assert tpuhuff_torch.decompress(got) == data.tobytes()
    assert dryrun_multichip(4, dev)["bits"] > 0


@pytest.mark.parametrize("kind", STITCH_KINDS)
def test_stitch_kernel_matches_plain(dev, kind):
    """S1 against its plain version behind every carry of 0-7 bits, and a
    chain of chunks (one empty) through the carry the kernel leaves on the
    device: the whole payload, capacity included, and the carry out."""
    from tpuhuff_torch.kernels import (
        new_carry,
        stitch_lanes,
        stitch_lanes_reference,
    )

    words, bits = lanes_case(kind)
    dw, db = words.to(dev), bits.to(dev)
    for n in range(8):
        carry, _ = _carry(n, n)
        before = stitch_lanes.launches
        got = stitch_lanes(dw, db, carry.to(dev))
        want = stitch_lanes_reference(words, bits, carry)
        torch.cuda.synchronize()
        assert stitch_lanes.launches == before + 1
        assert got[0].cpu().equal(want[0]) and got[1].cpu().equal(want[1])
    carry_g, carry_r = new_carry(dev), new_carry()
    for lo, hi in ((0, 5), (5, 5), (5, 17), (17, words.shape[0])):
        pg, carry_g = stitch_lanes(dw[lo:hi], db[lo:hi], carry_g)
        pr, carry_r = stitch_lanes_reference(words[lo:hi], bits[lo:hi],
                                             carry_r)
        assert pg.cpu().equal(pr) and carry_g.cpu().equal(carry_r)


@pytest.mark.parametrize("offset", [0, 1])
def test_lane_rows_kernel_matches_plain(dev, offset):
    """S2 against its plain version at payload ends (slack words 0),
    unaligned block offsets and a payload view one byte in (the byte-wise
    loads)."""
    from tpuhuff_torch.kernels import lane_rows, lane_rows_reference, row_width

    for n_bytes, seed in ROW_CASES:
        payload, starts, ends = blocks_case(n_bytes, seed)
        store = torch.zeros(n_bytes + offset, dtype=torch.uint8, device=dev)
        store[offset:] = torch.from_numpy(payload).to(dev)
        width = row_width(starts, ends)
        before = lane_rows.launches
        rows, bit0 = lane_rows(store[offset:], torch.from_numpy(starts).to(dev),
                               width)
        want = lane_rows_reference(torch.from_numpy(payload),
                                   torch.from_numpy(starts), width)
        torch.cuda.synchronize()
        assert lane_rows.launches == before + 1
        assert rows.cpu().equal(want[0]) and bit0.cpu().equal(want[1])


def test_file_path_through_the_host_stage_kernels(dev, tmp_path):
    """The .hf2 round trip on the card in small chunks: S1 once per chunk,
    S2 once per decode group, the host writer's bytes, the source back."""
    from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2
    from tpuhuff_torch.io.host import read_compress_write_hf2_host
    from tpuhuff_torch.kernels import lane_rows, stitch_lanes

    data = (np.random.default_rng(4).zipf(1.3, 3_000_001) % 97).astype(np.uint8)
    src, port, host, out = (str(tmp_path / k) for k in ("s", "p", "h", "o"))
    data.tofile(src)
    before = stitch_lanes.launches, lane_rows.launches
    read_compress_write_hf2(src, port, device=dev, chunk_bytes=1 << 20)
    read_decompress_write_hf2(port, out, device=dev, chunk_bytes=1 << 20)
    torch.cuda.synchronize()
    read_compress_write_hf2_host(src, host, block_len=256, max_code_len=32,
                                 chunk_bytes=1 << 20)
    assert open(port, "rb").read() == open(host, "rb").read()
    assert open(out, "rb").read() == data.tobytes()
    assert stitch_lanes.launches - before[0] == 3  # 3 chunks of 1 MiB
    groups = -(-(-(-data.size // 256)) // 4096)  # 4096 blocks a 1 MiB group
    assert lane_rows.launches - before[1] == groups


@pytest.mark.parametrize("writer", ["host writer", "transcode"])
@pytest.mark.parametrize("block_len,full,chunk", [
    (65536, 1024, None), (65536, 5, 2 * 65536), (1 << 20, 5, 2 << 20)])
def test_file_path_at_wide_blocks(dev, tmp_path, block_len, full, chunk,
                                  writer):
    """Config 2's 64 KiB blocks, and 1 MiB ones, through
    ``read_decompress_write_hf2`` on the card: containers of the host
    writer (K2) and of the ``.hff`` to ``.hf2`` transcode (K4 unless its
    tree is canonical), ``full`` blocks and a short one, in groups of 1024
    blocks (the default chunk) or of 2.  Exact; S2 and the decoder once
    per group, every block on the global-rows route (``global_launches``,
    ``global_blocks``, the tracer's ``global_rows_blocks``), and no call
    handed to the host decoder (no ``host_route_bytes``)."""
    from tpuhuff_torch.io import read_decompress_write_hf2, stream
    from tpuhuff_torch.io import transcode_hff_to_hf2
    from tpuhuff_torch.io.hff import read_hf2_header
    from tpuhuff_torch.io.host import (
        _CHUNK,
        read_compress_write_hf2_host,
        read_compress_write_host,
    )
    from tpuhuff_torch.kernels import decoder_for, lane_rows
    from tpuhuff_torch.profiling import StageTimer, tracing

    data = make_textlike(full * block_len + block_len // 3 + 5, np,
                         seed=full)
    src, hf2, out = (str(tmp_path / k) for k in ("s", "c.hf2", "o"))
    data.tofile(src)
    if writer == "host writer":
        read_compress_write_hf2_host(src, hf2, block_len=block_len)
    else:
        read_compress_write_host(src, src + ".hff")
        transcode_hff_to_hf2(src + ".hff", hf2, block_len=block_len)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
    B = hdr.num_blocks
    assert B == full + 1
    groups = -(-B // stream._group_blocks(block_len, chunk or _CHUNK))
    assert groups == (2 if chunk is None else 3)
    wrapper = decoder_for(hdr.tree)[0]
    assert wrapper is decode_rows or writer == "transcode"
    attrs = ("launches", "global_launches", "blocks", "global_blocks")
    before = [getattr(wrapper, a) for a in attrs] + [lane_rows.launches]
    t = StageTimer()
    with tracing(t):
        read_decompress_write_hf2(hf2, out, device=dev, chunk_bytes=chunk)
    torch.cuda.synchronize()
    after = [getattr(wrapper, a) for a in attrs] + [lane_rows.launches]
    assert [a - b for a, b in zip(after, before)] == [groups, groups, B, B,
                                                      groups]
    rec, = t.records
    assert "host_route_bytes" not in rec.counters
    assert rec.counters["global_rows_blocks"].n == B
    assert np.array_equal(np.fromfile(out, dtype=np.uint8), data)


# -- C1: the .hf2 CRC column on the card --

def _crc_want(data: np.ndarray, n: int, span: int, head: int) -> np.ndarray:
    import zlib

    out = [zlib.crc32(data[:head].tobytes())] if head else []
    out += [zlib.crc32(data[p:min(p + span, n)].tobytes())
            for p in range(head, n, span)]
    return np.array(out, dtype=np.uint32)


@pytest.mark.parametrize("n,span,head,offset", [
    (64 << 20, 65536, 0, 0),            # a chunk of the cells' spans
    ((64 << 20) - 12_345, 65536, 0, 0),  # its ragged end
    ((8 << 20) + 7, 1 << 20, 0, 0),      # 1 MiB blocks' spans
    (3 * 65536 + 7, 65536, 65535, 0),    # a group's head, then a short end
    (1_000_003, 65280, 1, 3),            # 384-byte blocks, unaligned
    (300 * 3 + 7, 300, 299, 1),
    (1, 1, 0, 0), (0, 65536, 0, 0)])
def test_crc_kernel_matches_plain_and_zlib(dev, n, span, head, offset):
    """C1 against its plain version and zlib, one launch counted with its
    bytes; data at ``offset`` bytes past an allocation."""
    from tpuhuff_torch.kernels import crc32_spans, crc32_spans_reference

    data = np.random.default_rng(n + span).integers(0, 256, n + offset + 5,
                                                    dtype=np.uint8)
    want = _crc_want(data[offset:], n, span, head)
    t = torch.from_numpy(data).to(dev)[offset:offset + n + 5]
    before = crc32_spans.launches, crc32_spans.bytes
    got = crc32_spans(t, n, span, head)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want)
    assert crc32_spans.launches - before[0] == (1 if want.size else 0)
    assert crc32_spans.bytes - before[1] == (n if want.size else 0)
    if n <= 8 << 20:
        plain = crc32_spans_reference(t.cpu(), n, span, head)
        assert np.array_equal(plain.numpy().view(np.uint32), want)


@pytest.mark.parametrize("route,block_len", [("resident", 256),
                                             ("two_pass", 256),
                                             ("host writer", 65536)])
def test_file_calls_take_no_host_crc(dev, tmp_path, monkeypatch, route,
                                     block_len):
    """With the host runtime's ``crc32_blocks`` made to raise, the card's
    file calls still round-trip: the compress routes write the host
    writer's bytes, and the decode checks the column on the card (at 64
    KiB blocks too); ``crc_device_bytes`` is each call's data."""
    from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2
    from tpuhuff_torch.io import stream
    from tpuhuff_torch.io.host import read_compress_write_hf2_host
    from tpuhuff_torch.kernels import crc32_spans
    from tpuhuff_torch.profiling import StageTimer, tracing

    data = make_textlike(5_000_003, np, seed=7)
    src, port, host, out = (str(tmp_path / k) for k in ("s", "p", "h", "o"))
    data.tofile(src)
    read_compress_write_hf2_host(src, host, block_len=block_len,
                                 max_code_len=32)

    def host_crc(*a, **k):
        raise AssertionError("the host CRC ran in a device call")

    monkeypatch.setattr(native, "crc32_blocks", host_crc)
    if route == "two_pass":
        monkeypatch.setattr(stream, "_device_free_bytes", lambda d: 0)
    before = crc32_spans.launches
    t = StageTimer()
    with tracing(t):
        if route != "host writer":
            read_compress_write_hf2(src, port, device=dev, block_len=256,
                                    chunk_bytes=1 << 20)
        read_decompress_write_hf2(port if route != "host writer" else host,
                                  out, device=dev, chunk_bytes=1 << 20)
    torch.cuda.synchronize()
    if route != "host writer":
        assert open(port, "rb").read() == open(host, "rb").read()
        comp = t.records[0]
        assert comp.counters["crc_device_bytes"].n == data.size
        assert ("resident_bytes" in comp.counters) == (route == "resident")
    assert t.records[-1].counters["crc_device_bytes"].n == data.size
    assert np.array_equal(np.fromfile(out, dtype=np.uint8), data)
    chunks = 0 if route == "host writer" else -(-data.size // (1 << 20))
    blocks = -(-data.size // block_len)
    groups = -(-blocks // stream._group_blocks(block_len, 1 << 20))
    assert crc32_spans.launches - before == chunks + groups  # one each


@pytest.mark.parametrize("block_len", [256, 65536])
def test_flipped_byte_caught_on_the_card(dev, tmp_path, block_len):
    """A flipped payload byte in the second decode group raises
    ``CorruptData`` from the card's CRCs; the output holds the first
    group alone."""
    from tpuhuff_torch.io import read_decompress_write_hf2, stream
    from tpuhuff_torch.io.hff import read_hf2_header
    from tpuhuff_torch.io.host import StreamError, read_compress_write_hf2_host

    data = make_textlike(3_000_000, np, seed=9)
    src, hf2, out = (str(tmp_path / k) for k in ("s", "c.hf2", "o"))
    data.tofile(src)
    read_compress_write_hf2_host(src, hf2, block_len=block_len,
                                 max_code_len=32)
    group = stream._group_blocks(block_len, 1 << 20)
    with open(hf2, "rb") as fp:
        hdr = read_hf2_header(fp)
    ends = hdr.end_bits.astype(np.int64)
    raw = bytearray(open(hf2, "rb").read())
    raw[hdr.payload_offset + (int(ends[group]) + int(ends[group + 1])) // 16] ^= 0x20
    open(hf2, "wb").write(bytes(raw))
    with pytest.raises(StreamError) as err:
        read_decompress_write_hf2(hf2, out, device=dev, chunk_bytes=1 << 20)
    assert err.value.kind == "CorruptData"
    assert open(out, "rb").read() == data[:group * block_len].tobytes()
