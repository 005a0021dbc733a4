"""The port's ``.hff`` sidecar index against ``tpuhuff.io.stream``.

* the native bindings ``spec_index``, ``index_blocks``, ``decode_index``
  and ``crc32`` against :mod:`tpuhuff.native` on the same inputs;
* :func:`transcode_hff_to_hf2` and :func:`decode_hff_indexed`: the port's
  containers, sidecars and decoded bytes equal to the JAX package's;
* ``read_decompress_write``'s ``auto_index``: twins of the sidecar cases
  of ``tests/test_r4_stream.py`` and ``tests/test_stream.py``, with the
  sidecar byte-equal to the JAX reader's;
* ``write_hf2`` and ``huff_tree_from_stream`` against the JAX package's.

Tolerance: byte equality.
"""

import os

import numpy as np
import pytest

from tpuhuff import native as jax_native
from tpuhuff.core.tree import HuffTree as JaxTree
from tpuhuff.core.weights import ByteWeights as JaxWeights
from tpuhuff.io import hff as jax_hff
from tpuhuff.io import stream as jax_stream

from tpuhuff_torch import native
from tpuhuff_torch.core.tree import HuffTree
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.io import (
    decode_hff_indexed,
    huff_tree_from_stream,
    read_decompress_write,
    read_decompress_write_hf2,
    read_hf2_header,
    transcode_hff_to_hf2,
    write_hf2,
)
from tpuhuff_torch.io import host, index
from tpuhuff_torch.io.host import (
    StreamError,
    read_compress_write_host,
    read_decompress_write_hf2_host,
)


def _data(n=200_000, seed=3):
    """``tests/test_r4_stream.py``'s textlike bytes."""
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox jumps over the lazy dog 0123456789 "
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n]
    base = base.copy()
    idx = rng.integers(0, n, n // 32)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


CASES = {
    "textlike": lambda: _data(),
    "random": lambda: np.random.default_rng(55).integers(0, 230, 100_000,
                                                         dtype=np.uint8),
    "one letter": lambda: np.full(30_001, 9, dtype=np.uint8),
    "two letters": lambda: np.random.default_rng(4).integers(
        97, 99, 40_000, dtype=np.uint8),
    "block exact": lambda: np.frombuffer(b"abcd" * 256, dtype=np.uint8),
}


def _hff(tmp_path, data, name="a"):
    src = tmp_path / f"{name}.bin"
    src.write_bytes(data.tobytes())
    hff = tmp_path / f"{name}.hff"
    read_compress_write_host(str(src), str(hff))
    return str(hff)


def _tables(data):
    """The same DFA tables in both packages, and the payload."""
    counts = np.bincount(data, minlength=256)
    tree = HuffTree.from_weights(ByteWeights(counts))
    jtree = JaxTree.from_weights(JaxWeights(counts))
    payload, pad = native.encode(data, *tree.encode_tables())
    comp = np.frombuffer(payload, dtype=np.uint8)
    return (native.build_dfa(tree), jax_native.build_dfa(jtree), comp,
            len(payload) * 8 - pad)


@pytest.mark.parametrize("block_len", [1, 100, 4096])
@pytest.mark.parametrize("binding", ["spec_index", "index_blocks",
                                     "decode_index"])
def test_index_bindings_match_jax(binding, block_len):
    data = _data(300_000, seed=block_len)
    tabs, jtabs, comp, nbits = _tables(data)
    for lo, hi, in_block in ((0, nbits, 0), (13, nbits - 5, 7),
                             (8 * 1000 + 3, 8 * 90_000, block_len - 1)):
        if binding == "decode_index":
            args = (comp, lo, hi)
            got = native.decode_index(*args, tabs, hi - lo, block_len,
                                      in_block)
            want = jax_native.decode_index(*args, jtabs, hi - lo, block_len,
                                           in_block)
        else:
            got = getattr(native, binding)(comp, lo, hi, tabs, block_len,
                                           in_block)
            want = getattr(jax_native, binding)(comp, lo, hi, jtabs,
                                                block_len, in_block)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            else:
                assert g == w
    if binding == "spec_index":  # the thread count changes nothing
        for threads in (1, 3):
            got = native.spec_index(comp, 0, nbits, tabs, block_len,
                                    threads=threads)
            want = jax_native.spec_index(comp, 0, nbits, jtabs, block_len)
            assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_crc32_matches_jax_and_zlib():
    import zlib

    data = _data(70_001, seed=5)
    for piece in (data, data[:1], data[3:], data.tobytes(), b""):
        for seed in (0, 0x12345678):
            want = jax_native.crc32(piece, seed)
            assert native.crc32(piece, seed) == want
            assert want == zlib.crc32(bytes(piece), seed) & 0xFFFFFFFF


@pytest.mark.parametrize("chunk", [None, 997])
@pytest.mark.parametrize("block_len", [512, 65536, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_transcode_byte_equal_jax(tmp_path, case, block_len, chunk):
    data = CASES[case]()
    hff = _hff(tmp_path, data)
    port, jax = str(tmp_path / "p.hf2"), str(tmp_path / "j.hf2")
    transcode_hff_to_hf2(hff, port, block_len=block_len, chunk_bytes=chunk)
    jax_stream.transcode_hff_to_hf2(hff, jax, block_len=block_len,
                                    chunk_bytes=chunk)
    assert open(port, "rb").read() == open(jax, "rb").read()
    out = str(tmp_path / "o")
    read_decompress_write_hf2_host(port, out)
    assert open(out, "rb").read() == data.tobytes()


def test_transcode_hff_to_hf2(tmp_path):
    """Twin of ``tests/test_stream.py::test_transcode_hff_to_hf2``: the
    non-canonical tree decodes on the host and on the device route (K4's
    plain version on the CPU); tiny windows give the same container."""
    data = CASES["random"]()
    hff = _hff(tmp_path, data)
    hf2 = hff + ".hf2"
    transcode_hff_to_hf2(hff, hf2, block_len=512)
    hdr = read_hf2_header(open(hf2, "rb"))
    assert hdr.orig_len == len(data)
    assert hdr.num_blocks == -(-len(data) // 512)
    assert not hdr.canonical
    back = str(tmp_path / "back")
    read_decompress_write_hf2_host(hf2, back)
    assert open(back, "rb").read() == data.tobytes()
    read_decompress_write_hf2(hf2, back + ".dev", device="cpu")
    assert open(back + ".dev", "rb").read() == data.tobytes()
    hf2b = hff + ".b.hf2"
    transcode_hff_to_hf2(hff, hf2b, block_len=512, chunk_bytes=997)
    assert open(hf2b, "rb").read() == open(hf2, "rb").read()


def test_transcode_block_boundary_exact(tmp_path):
    """Twin of ``tests/test_stream.py::test_transcode_block_boundary_exact``."""
    data = CASES["block exact"]()  # 1024 bytes: exactly 2 blocks of 512
    hff = _hff(tmp_path, data)
    hf2 = hff + ".hf2"
    transcode_hff_to_hf2(hff, hf2, block_len=512)
    hdr = read_hf2_header(open(hf2, "rb"))
    assert hdr.orig_len == len(data) and hdr.num_blocks == 2
    back = str(tmp_path / "back")
    read_decompress_write_hf2(hf2, back, device="cpu")
    assert open(back, "rb").read() == data.tobytes()


@pytest.mark.parametrize("walk", ["parallel", "serial"])
@pytest.mark.parametrize("case", ["textlike", "one letter", "two letters"])
def test_decode_hff_indexed_byte_equal_jax(tmp_path, monkeypatch, case, walk):
    """Output and sidecar equal the JAX package's, on the parallel walk
    and on the serial one (the parallel walk made to refuse)."""
    data = CASES[case]()
    hff = _hff(tmp_path, data)
    if walk == "serial":
        def refuse(*args, **kwargs):
            raise RuntimeError("refused")

        monkeypatch.setattr(index, "_hff_walk_parallel", refuse)
    paths = {k: str(tmp_path / k) for k in ("po", "ps", "jo", "js")}
    assert decode_hff_indexed(hff, paths["po"], paths["ps"], block_len=4096,
                              chunk_bytes=5000)
    assert jax_stream.decode_hff_indexed(hff, paths["jo"], paths["js"],
                                         block_len=4096, chunk_bytes=5000)
    assert open(paths["po"], "rb").read() == data.tobytes()
    assert open(paths["jo"], "rb").read() == data.tobytes()
    assert open(paths["ps"], "rb").read() == open(paths["js"], "rb").read()


def test_auto_index_sidecar_roundtrip(tmp_path):
    """Twin of ``tests/test_r4_stream.py::test_auto_index_sidecar_roundtrip``,
    the sidecar byte-equal to the JAX reader's."""
    data = _data()
    hff = _hff(tmp_path, data)
    out = str(tmp_path / "a.out")
    stats = {}
    read_decompress_write(hff, out, auto_index=True, stats=stats)
    assert open(out, "rb").read() == data.tobytes()
    assert stats.get("auto_index") == "created"
    sidecar = hff + ".hf2x"
    port_sidecar = open(sidecar, "rb").read()
    jstats = {}
    os.remove(sidecar)
    jax_stream.read_decompress_write(hff, out, auto_index=True, stats=jstats)
    assert jstats.get("auto_index") == "created"
    assert open(sidecar, "rb").read() == port_sidecar
    # the second decode reuses the sidecar
    stats2 = {}
    out2 = str(tmp_path / "a2.out")
    read_decompress_write(hff, out2, auto_index=True, stats=stats2)
    assert open(out2, "rb").read() == data.tobytes()
    assert stats2.get("auto_index") == "reused"
    # a sidecar older than its source is built again
    os.utime(sidecar, (1, 1))
    stats3 = {}
    read_decompress_write(hff, out2, auto_index=True, stats=stats3)
    assert stats3.get("auto_index") == "created"
    assert open(out2, "rb").read() == data.tobytes()


def test_auto_index_disabled_leaves_no_sidecar(tmp_path, monkeypatch):
    """Twin of ``test_auto_index_disabled_leaves_no_sidecar``, also under a
    threshold the file passes."""
    monkeypatch.setattr(host, "AUTO_INDEX_MIN", 1)
    data = _data(50_000)
    hff = _hff(tmp_path, data, "b")
    out = str(tmp_path / "b.out")
    stats = {}
    read_decompress_write(hff, out, auto_index=False, stats=stats)
    assert open(out, "rb").read() == data.tobytes()
    assert not os.path.exists(hff + ".hf2x")
    assert "auto_index" not in stats


@pytest.mark.parametrize("threshold", ["below", "at", "above"])
def test_auto_index_default_threshold(tmp_path, monkeypatch, threshold):
    """The default indexes a file of at least ``AUTO_INDEX_MIN`` bytes, as
    the JAX reader does (its threshold set the same)."""
    data = _data(60_000, seed=8)
    hff = _hff(tmp_path, data, "t")
    size = os.path.getsize(hff)
    limit = {"below": size + 1, "at": size, "above": size - 1}[threshold]
    monkeypatch.setattr(host, "AUTO_INDEX_MIN", limit)
    monkeypatch.setattr(jax_stream, "AUTO_INDEX_MIN", limit)
    out, jout = str(tmp_path / "o"), str(tmp_path / "jo")
    stats, jstats = {}, {}
    read_decompress_write(hff, out, stats=stats)
    port_sidecar = (open(hff + ".hf2x", "rb").read()
                    if os.path.exists(hff + ".hf2x") else None)
    if port_sidecar is not None:
        os.remove(hff + ".hf2x")
    jax_stream.read_decompress_write(hff, jout, stats=jstats)
    assert stats == jstats
    assert (stats.get("auto_index") == "created") == (threshold != "below")
    jax_sidecar = (open(hff + ".hf2x", "rb").read()
                   if os.path.exists(hff + ".hf2x") else None)
    assert port_sidecar == jax_sidecar
    assert open(out, "rb").read() == open(jout, "rb").read() == data.tobytes()


def test_auto_index_detects_content_replacement(tmp_path):
    """Twin of ``test_auto_index_detects_content_replacement``: a source
    replaced under an older timestamp is not served from the sidecar."""
    d1 = _data(150_000, seed=31)
    d2 = _data(150_000, seed=32)
    hff = _hff(tmp_path, d1, "r")
    out = str(tmp_path / "r.out")
    read_decompress_write(hff, out, auto_index=True)
    sidecar = hff + ".hf2x"
    assert os.path.exists(sidecar)
    hff2 = _hff(tmp_path, d2, "r2")
    st = os.stat(sidecar)
    os.replace(hff2, hff)
    os.utime(hff, (st.st_atime - 10, st.st_mtime - 10))
    stats = {}
    read_decompress_write(hff, out, auto_index=True, stats=stats)
    assert open(out, "rb").read() == d2.tobytes()  # not d1
    assert stats.get("auto_index") == "created"  # built again, not reused


def test_auto_index_corrupt_sidecar_falls_back(tmp_path):
    """Twin of ``test_auto_index_corrupt_sidecar_falls_back``."""
    data = _data(120_000, seed=33)
    hff = _hff(tmp_path, data, "p")
    out = str(tmp_path / "p.out")
    read_decompress_write(hff, out, auto_index=True)
    sidecar = hff + ".hf2x"
    with open(sidecar, "r+b") as f:
        f.write(b"\xff" * 64)
    stats = {}
    read_decompress_write(hff, out, auto_index=True, stats=stats)
    assert open(out, "rb").read() == data.tobytes()
    assert stats.get("auto_index") in ("created", "failed")


def test_auto_index_malformed_source_raises(tmp_path):
    """A malformed source raises the serial reader's error kinds."""
    short = tmp_path / "short.hff"
    short.write_bytes(b"\x00\x00")
    for auto in (True, False):
        with pytest.raises(StreamError) as err:
            read_decompress_write(str(short), str(tmp_path / "o"),
                                  auto_index=auto)
        assert err.value.kind == "MissingHeaderInfo"


@pytest.mark.parametrize("version", [1, 2])
def test_write_hf2_matches_jax(tmp_path, version):
    data = _data(10_000, seed=9)
    counts = np.bincount(data, minlength=256)
    tree = HuffTree.from_weights(ByteWeights(counts))
    jtree = JaxTree.from_weights(JaxWeights(counts))
    payload, total, bit_lens = native.encode_blocks_host(
        data, 1000, *tree.encode_tables())
    ends = np.cumsum(bit_lens)
    port, jax = tmp_path / "p.hf2", tmp_path / "j.hf2"
    with open(port, "wb") as fp:
        write_hf2(fp, tree, data.size, 1000, ends, payload, version=version)
    with open(jax, "wb") as fp:
        jax_hff.write_hf2(fp, jtree, data.size, 1000, ends, payload,
                          version=version)
    assert port.read_bytes() == jax.read_bytes()
    out = str(tmp_path / "o")
    read_decompress_write_hf2_host(str(port), out)
    assert open(out, "rb").read() == data.tobytes()
    with pytest.raises(ValueError):
        write_hf2(open(port, "wb"), tree, data.size, 1000, ends, payload,
                  version=3)


@pytest.mark.parametrize("hist_sample", [1, 4])
@pytest.mark.parametrize("block_size", [1000, 2_000_000_000])
def test_huff_tree_from_stream_matches_jax(tmp_path, block_size, hist_sample):
    data = _data(50_000, seed=10)
    path = tmp_path / "s.bin"
    path.write_bytes(data.tobytes())
    with open(path, "rb") as fp:
        tree = huff_tree_from_stream(fp, data.size, block_size, hist_sample)
    with open(path, "rb") as fp:
        jtree = jax_stream.huff_tree_from_stream(fp, data.size, block_size,
                                                 hist_sample)
    assert tree.as_bin().to_bytes() == jtree.as_bin().to_bytes()


@pytest.mark.parametrize("max_piece", [1, 700, 2500, 20_000])
def test_crc_column_any_piece_sizes(max_piece):
    """The CRC collector (the sidecar's column) and the verifier built on
    it take pieces of any size and agree with the JAX collector; a wrong
    column, or a column too short, raises ``CorruptData`` at its span
    (twin of ``tests/test_r5_integrity.py``'s ragged-feeding case)."""
    import zlib

    span = 1000
    data = np.frombuffer((b"0123456789abcdef" * 1000)[:10_500], dtype=np.uint8)
    crcs = np.array([zlib.crc32(data[k * span:(k + 1) * span].tobytes())
                     for k in range(-(-data.size // span))], dtype=np.uint32)
    rng = np.random.default_rng(max_piece)
    cuts = [0]
    while cuts[-1] < data.size:
        step = int(rng.integers(1, max_piece + 1))
        cuts.append(min(data.size, cuts[-1] + step))
    pieces = [data[a:b] for a, b in zip(cuts, cuts[1:])]
    collector = host._CrcCollector(span)
    jax_collector = jax_stream._CrcCollector(span, jax_native)
    verifier = host._CrcVerifier(crcs, span, "x")
    for piece in pieces:
        collector.feed(piece)
        jax_collector.feed(piece)
        verifier.feed(piece)
    verifier.finish()
    assert np.array_equal(collector.finish(), crcs)
    assert np.array_equal(jax_collector.finish(), crcs)
    for bad, span_at in ((np.where(np.arange(crcs.size) == 3, crcs ^ 1, crcs),
                          3), (crcs[:7], 7)):
        verifier = host._CrcVerifier(bad, span, "x")
        with pytest.raises(StreamError, match=f"span {span_at} ") as err:
            for piece in pieces:
                verifier.feed(piece)
            verifier.finish()
        assert err.value.kind == "CorruptData"
