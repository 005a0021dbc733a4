"""The port's ``.hff`` writers and reader against ``tpuhuff.io.stream``:

* ``tpuhuff_torch.io.read_compress_write`` (``device="cpu"``: K1's plain
  version) against the JAX device route (``device=True``);
* ``tpuhuff_torch.io.host.read_compress_write_host`` against the JAX host
  route (``device=False``);
* ``tpuhuff_torch.io.read_decompress_write`` on files of both packages,
  and the JAX reader on the port's.

Every container must be byte-identical, every round trip exact.
"""

import numpy as np
import pytest

from tpuhuff.core.tree import HuffTree as JaxTree
from tpuhuff.core.weights import ByteWeights as JaxWeights
from tpuhuff.io import stream as jax_stream

from tpuhuff_torch.core.format import CompressError
from tpuhuff_torch.core.tree import HuffTree
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.io import read_compress_write, read_decompress_write
from tpuhuff_torch.io.host import StreamError, read_compress_write_host


def _textlike(n, seed):
    rng = np.random.default_rng(seed)
    text = b"<page><title>Huffman</title> the of and to in a is that it was "
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, n, n // 64)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


CASES = {
    "textlike": lambda: _textlike(300_001, 1),
    "random": lambda: np.random.default_rng(2).integers(0, 256, 200_000,
                                                        dtype=np.uint8),
    "one_letter": lambda: np.full(70_001, 7, dtype=np.uint8),
    "two_letters": lambda: np.random.default_rng(3).integers(
        97, 99, 50_000, dtype=np.uint8),
}


def _trees(counts):
    """The same tree in both packages, from the same counts."""
    return (HuffTree.from_weights(ByteWeights(counts)),
            JaxTree.from_weights(JaxWeights(counts)))


def _write_both(tmp_path, data, device, tree=(None, None), **kw):
    src = tmp_path / "src.bin"
    src.write_bytes(data.tobytes())
    port, jax = str(tmp_path / "p.hff"), str(tmp_path / "j.hff")
    if device:
        read_compress_write(str(src), port, device="cpu", tree=tree[0], **kw)
    else:
        read_compress_write_host(str(src), port, tree=tree[0], **kw)
    jax_stream.read_compress_write(str(src), jax, device=device, tree=tree[1],
                                   **kw)
    return port, jax


def _read_both(tmp_path, path, data, **kw):
    out, jax_out = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    read_decompress_write(path, out, **kw)
    jax_stream.read_decompress_write(path, jax_out, auto_index=False, **kw)
    assert open(out, "rb").read() == data.tobytes()
    assert open(jax_out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_hff_writers_byte_identical(tmp_path, case, device):
    data = CASES[case]()
    port, jax = _write_both(tmp_path, data, device)
    assert open(port, "rb").read() == open(jax, "rb").read()
    _read_both(tmp_path, port, data)


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("opts", [
    {"block_size": 50_000},                     # many pieces, ragged tail
    {"max_code_len": 11},
    {"hist_sample": 4, "block_size": 1 << 16},
    {"tree": True},
    {"tree": True, "block_size": 70_000},
])
def test_hff_writer_options_byte_identical(tmp_path, device, opts):
    data = _textlike(400_003, 4)
    kw = dict(opts)
    if kw.pop("tree", False):
        # a tree of other counts that still has a code for every byte
        kw["tree"] = _trees(np.bincount(data[::7], minlength=256) + 1)
    port, jax = _write_both(tmp_path, data, device, **kw)
    assert open(port, "rb").read() == open(jax, "rb").read()
    _read_both(tmp_path, port, data)


def test_hff_reader_many_windows(tmp_path):
    """A payload of several 1 MiB windows: codes straddle window ends."""
    data = _textlike(4 << 20, 5)
    port, jax = _write_both(tmp_path, data, False)
    assert open(port, "rb").read() == open(jax, "rb").read()
    _read_both(tmp_path, port, data, block_size=1)


def test_hff_reader_on_jax_files_and_empty(tmp_path):
    data = _textlike(100_000, 6)
    _, jax = _write_both(tmp_path, data, True)
    _read_both(tmp_path, jax, data)
    # an empty file under a given tree: a header and no payload
    empty = np.zeros(0, dtype=np.uint8)
    ab = np.bincount(np.frombuffer(b"ab", dtype=np.uint8), minlength=256)
    for device in (True, False):
        port, jax = _write_both(tmp_path, empty, device, tree=_trees(ab))
        assert open(port, "rb").read() == open(jax, "rb").read()
        _read_both(tmp_path, port, empty)
        _read_both(tmp_path, jax, empty)


@pytest.mark.parametrize("device", [True, False])
def test_hff_stale_tree_raises(tmp_path, device):
    data = _textlike(30_000, 7)
    counts = np.bincount(data, minlength=256)
    counts[int(data[-1])] = 0  # no code for a byte of the file
    src = tmp_path / "s.bin"
    src.write_bytes(data.tobytes())
    tree = HuffTree.from_weights(ByteWeights(counts))
    with pytest.raises(CompressError):
        if device:
            read_compress_write(str(src), str(tmp_path / "p.hff"),
                                device="cpu", tree=tree)
        else:
            read_compress_write_host(str(src), str(tmp_path / "p.hff"),
                                     tree=tree)


def test_hff_reader_refuses(tmp_path):
    data = _textlike(10_000, 8)
    port, _ = _write_both(tmp_path, data, False)
    # auto_index=True decodes and writes the sidecar (tests/test_torch_index.py)
    stats = {}
    read_decompress_write(port, str(tmp_path / "o"), auto_index=True,
                          stats=stats)
    assert stats["auto_index"] == "created"
    assert open(str(tmp_path / "o"), "rb").read() == data.tobytes()
    short = tmp_path / "short.hff"
    short.write_bytes(b"\x00\x00")
    with pytest.raises(StreamError) as err:
        read_decompress_write(str(short), str(tmp_path / "o"))
    assert err.value.kind == "MissingHeaderInfo"
    bad = tmp_path / "bad.hff"
    bad.write_bytes(b"\x88" + open(port, "rb").read()[1:])
    with pytest.raises(StreamError) as err:
        read_decompress_write(str(bad), str(tmp_path / "o"))
    assert err.value.kind == "InvalidHeaderInfo"
