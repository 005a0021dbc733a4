"""tpuhuff_torch encode (plain version, CPU) against the JAX package's other
encode kernels: K5, K6 and K7.

* K5 — the fused encode kernel with its ``hist_data`` histogram
  (``encode_blocks_pallas2(..., with_miss=True, hist_data=...)``, Pallas
  interpret mode) against ``encode_blocks(..., hist_data=...)``, on the
  operands of both of the port kernel's routes: the lanes' own storage
  (whole, or an odd-length prefix) and any other operand (a view of the
  lanes one byte in, another tensor, an empty one);
* K6 — the flat-layout kernel, which the JAX encoder takes for lanes of
  N < 16 bytes (``encode_blocks(..., pallas=True)`` at N = 2, 4, 8);
* K7 — the cell-major layout (``pallas_encode2.ENC_LAYOUT = "cell"``).

The port serves all three with K1's one kernel.  Everything must be
exact: the stitched payload, per-lane bit counts, the missing-letter count
and the histogram.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuhuff.core.canonical import build_tree_for_device, canonicalize
from tpuhuff.core.weights import ByteWeights
from tpuhuff.dist import stitch_words
from tpuhuff.kernels import encode as jax_encode
from tpuhuff.kernels import pallas_encode2 as pe2

from tpuhuff_torch.kernels import EncodeTables, encode_blocks
from tpuhuff_torch.kernels.encode import as_u32


def _tree(counts, max_len):
    tree, _ = build_tree_for_device(ByteWeights(np.asarray(counts)), max_len)
    return canonicalize(tree)


def _tables(tree):
    """The JAX package's dense and canonical tables, and the port's from
    the same dense arrays."""
    dl, da = jax_encode.make_encode_tables(*tree.encode_tables())
    tabs = jax_encode.make_canonical_encode_tables(tree)
    assert tabs is not None
    return dl, da, tabs, EncodeTables.from_numpy(np.asarray(dl), np.asarray(da))


def _port(data, valid, tables, hist=None):
    """The port's encode; ``hist`` is a numpy operand, or a function of
    the lanes tensor that gives a tensor (a view of the lanes' storage)."""
    lanes = torch.from_numpy(data)
    if callable(hist):
        hist = hist(lanes)
    elif hist is not None:
        hist = torch.from_numpy(hist)
    out = encode_blocks(lanes, torch.from_numpy(valid), tables, hist_data=hist)
    counts = out[3].numpy() if hist is not None else None
    return as_u32(out[0]), out[1].numpy(), int(out[2].sum()), counts


def _same_streams(jw, jb, pw, pb):
    assert np.array_equal(pb, np.asarray(jb))
    assert stitch_words(pw, pb) == stitch_words(np.asarray(jw), np.asarray(jb))


def _ragged(B, N, rng):
    valid = rng.integers(0, N + 1, B).astype(np.int32)
    valid[0], valid[1], valid[-1] = N, 0, 1  # full, empty and 1-byte lanes
    return valid


def _textlike(shape, rng):
    return (rng.zipf(1.3, shape) % 90 + 30).astype(np.uint8)


# K5's operands: (seed, the bytes counted as numpy from the lanes' flat
# bytes, the port's operand from the lanes tensor, whether it is a
# nonempty operand from the lanes' first byte: the kernel then counts the
# bytes it holds for the encode, and reads any other operand apart)
_PREFIX = 256 * 200 - 12_345  # odd, inside the last lanes
_OPERANDS = {
    "lanes": (1, lambda flat, rng: flat, lambda t: t, True),
    # the lanes' own storage, cut short at an odd length: counted from the
    # bytes the encode holds, up to the clip
    "prefix_odd": (4, lambda flat, rng: flat[:_PREFIX],
                   lambda t: t.reshape(-1)[:_PREFIX], True),
    # a view of the lanes one byte in: the same storage, not the same start
    "offset_view": (5, lambda flat, rng: flat[1:],
                    lambda t: t.reshape(-1)[1:], False),
    "shorter_odd": (2, lambda flat, rng: rng.integers(
        0, 256, _PREFIX, dtype=np.uint8), None, False),
    "missing": (3, lambda flat, rng: flat, lambda t: t, True),
    "empty": (6, lambda flat, rng: flat[:0], lambda t: t.reshape(-1)[:0],
              False),
}


@pytest.mark.parametrize("operand", list(_OPERANDS))
def test_k5_encode_hist_matches_pallas(operand):
    seed, numpy_op, torch_op, in_lanes = _OPERANDS[operand]
    rng = np.random.default_rng(seed)
    B, N = 200, 256  # B not a multiple of 128: the JAX side pads to 256 lanes
    data = _textlike((B, N), rng)
    valid = _ragged(B, N, rng)
    counted = data[:, :100] if operand == "missing" else data
    tree = _tree(np.bincount(counted.reshape(-1), minlength=256), 16)
    if operand == "missing":
        data[::3, 150:] = 250  # a byte the tree has no code for
    hist = numpy_op(data.reshape(-1), rng).copy()
    dl, da, tabs, tables = _tables(tree)
    assert pe2.fused_layout_ok(N, tabs[4])  # the JAX call takes K5
    jw, jb, jmiss, jhist = pe2.encode_blocks_pallas2(
        jnp.asarray(data), tabs[:4], tabs[4], valid_lens=jnp.asarray(valid),
        interpret=True, full_alphabet=bool(tabs[5]), with_miss=True,
        hist_data=jnp.asarray(hist))
    if torch_op is not None:
        lanes = torch.from_numpy(data)
        op = torch_op(lanes)
        assert (op.numel() > 0 and op.data_ptr() == lanes.data_ptr()) == in_lanes
    pw, pb, pmiss, phist = _port(data, valid, tables, torch_op or hist)
    _same_streams(jw, jb, pw, pb)
    assert pmiss == int(jmiss)
    assert (pmiss > 0) == (operand == "missing")
    assert np.array_equal(phist, np.asarray(jhist))
    assert np.array_equal(phist, np.bincount(hist, minlength=256))


@pytest.mark.parametrize("N", [2, 4, 8])
def test_k6_flat_layout_matches_port(N):
    """Lanes of N < 16 bytes: the JAX encoder takes the flat-layout kernel
    (``_encode_call``); the port takes K1's kernel."""
    rng = np.random.default_rng(N)
    B = 300
    data = _textlike((B, N), rng)
    valid = _ragged(B, N, rng)
    tree = _tree(np.bincount(data.reshape(-1), minlength=256), 16)
    dl, da, tabs, tables = _tables(tree)
    ml = tabs[4]
    assert pe2.ENC_LAYOUT == "fused" and not pe2.fused_layout_ok(N, ml)
    jw, jb = jax_encode.encode_blocks(
        jnp.asarray(data), dl, da, jnp.asarray(valid), max_code_len=ml,
        canon_tables=tabs[:4], full_alphabet=bool(tabs[5]), pallas=True)
    pw, pb, pmiss, _ = _port(data, valid, tables)
    _same_streams(jw, jb, pw, pb)
    assert pmiss == 0


@pytest.mark.parametrize("deep", [False, True])
def test_k7_cell_layout_matches_port(deep):
    """The cell-major layout (``TPUHUFF_ENC_LAYOUT=cell``) at N = 64, with
    paired bytes (max code <= 16) and without (a Fibonacci tree, > 16)."""
    rng = np.random.default_rng(7 + deep)
    B, N = 256, 64
    if deep:
        fib = [1, 1]
        while len(fib) < 24:
            fib.append(fib[-1] + fib[-2])
        counts = np.zeros(256, dtype=np.int64)
        counts[:24] = fib
        data = rng.integers(0, 24, (B, N), dtype=np.uint8)
        tree = _tree(counts, 32)
    else:
        data = _textlike((B, N), rng)
        tree = _tree(np.bincount(data.reshape(-1), minlength=256), 16)
    valid = _ragged(B, N, rng)
    dl, da, tabs, tables = _tables(tree)
    ml = tabs[4]
    assert (ml > 16) == deep
    old = pe2.ENC_LAYOUT
    pe2.ENC_LAYOUT = "cell"
    pe2._encode_call_cells.clear_cache()
    try:
        assert not pe2.fused_layout_ok(N, ml)
        jw, jb = pe2.encode_blocks_pallas2(
            jnp.asarray(data), tabs[:4], ml, valid_lens=jnp.asarray(valid),
            interpret=True, full_alphabet=bool(tabs[5]))
    finally:
        pe2.ENC_LAYOUT = old
        pe2._encode_call_cells.clear_cache()
    pw, pb, _, _ = _port(data, valid, tables)
    _same_streams(jw, jb, pw, pb)


def test_hist_operand_checks():
    tree = _tree(np.arange(1, 257), 16)
    tables = _tables(tree)[3]
    lanes = torch.zeros((4, 16), dtype=torch.uint8)
    valid = torch.full((4,), 16, dtype=torch.int32)
    # at most B * N bytes, as the JAX kernel's assert
    with pytest.raises(ValueError):
        encode_blocks(lanes, valid, tables,
                      hist_data=torch.zeros(65, dtype=torch.uint8))
    with pytest.raises(TypeError):
        encode_blocks(lanes, valid, tables,
                      hist_data=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        encode_blocks(lanes, valid, tables,
                      hist_data=torch.zeros((8, 8), dtype=torch.uint8).t())
    empty = encode_blocks(lanes, valid, tables,
                          hist_data=torch.zeros(0, dtype=torch.uint8))
    assert len(empty) == 4 and not empty[3].any()
    assert empty[3].dtype == torch.int64 and empty[3].shape == (256,)
