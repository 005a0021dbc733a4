"""Config 4 in the port (``tpuhuff_torch.io.dataset``, ``device="cpu"``:
the kernels' plain versions) against ``tpuhuff.io.dataset`` with
``device=True``, on the cases of ``tests/test_r5_dataset.py``: byte-equal
containers, equal ``stats``, exact histograms and round trips.
"""

import os

import numpy as np
import pytest

from tpuhuff.io import dataset as jax_dataset
from tpuhuff.io import stream as jax_stream

from tpuhuff_torch.io import (
    build_shared_tree,
    compress_dataset,
    decompress_dataset,
    read_compress_write_hf2,
    tree_from_counts,
)
from tpuhuff_torch.io.hff import read_hf2_header


def _mk_shards(tmp_path, n=3, size=200_000, drift=False):
    """The shards of ``tests/test_r5_dataset.py``."""
    rng = np.random.default_rng(5)
    paths = []
    for k in range(n):
        if drift:
            lo, hi = 32 + 40 * k, 128 + 40 * k
            data = rng.integers(lo, hi, size, dtype=np.uint8)
        else:
            text = (b"shared frequency table over shards %d " % k) * 6000
            data = np.frombuffer(text[:size], dtype=np.uint8)
        p = tmp_path / f"shard{k}.bin"
        p.write_bytes(data.tobytes())
        paths.append(str(p))
    return paths


def _both(tmp_path, srcs, tag, **kw):
    """Compress with both packages; the containers must be byte-equal and
    the stats equal.  Returns the port's outputs and stats."""
    pstats, jstats = {}, {}
    outs = compress_dataset(srcs, out_dir=str(tmp_path / f"p{tag}"),
                            device="cpu", stats=pstats, **kw)
    jouts = jax_dataset.compress_dataset(srcs, out_dir=str(tmp_path / f"j{tag}"),
                                         device=True, stats=jstats, **kw)
    assert [os.path.basename(p) for p in outs] == [
        os.path.basename(p) for p in jouts]
    for p, j in zip(outs, jouts):
        assert open(p, "rb").read() == open(j, "rb").read()
    assert pstats == jstats
    return outs, pstats


def _restores(outs, srcs, out_dir):
    decs = decompress_dataset(outs, out_dir=out_dir, device="cpu")
    for src, dec in zip(srcs, decs):
        assert os.path.basename(dec) == os.path.basename(src)
        assert open(dec, "rb").read() == open(src, "rb").read()


def _tree_bytes(path):
    with open(path, "rb") as fp:
        return read_hf2_header(fp).tree.as_bin().to_bytes()


def test_shared_mode_matches_jax(tmp_path):
    srcs = _mk_shards(tmp_path)
    outs, stats = _both(tmp_path, srcs, "s")
    assert stats["tree_builds"] == 1
    assert len({_tree_bytes(p) for p in outs}) == 1
    _restores(outs, srcs, str(tmp_path / "d"))


def test_tree_from_covers_unseen_bytes(tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    a.write_bytes(b"aaaabbbbcccc" * 1000)
    b.write_bytes(bytes(range(256)) * 100)  # every byte, unseen in a
    srcs = [str(a), str(b)]
    outs, _ = _both(tmp_path, srcs, "t", tree_from=str(a))
    _restores(outs, srcs, str(tmp_path / "d"))


def test_adaptive_mode_matches_jax(tmp_path):
    srcs = _mk_shards(tmp_path, n=4, drift=True)
    stale, sstats = _both(tmp_path, srcs, "s", tree_from=srcs[0])
    adaptive, astats = _both(tmp_path, srcs, "a", adaptive=True)
    assert astats["tree_builds"] == len(srcs)
    assert len({_tree_bytes(p) for p in adaptive}) > 1
    assert astats["ratio"] < sstats["ratio"]
    _restores(adaptive, srcs, str(tmp_path / "d"))


def test_hff_outputs_match_jax(tmp_path):
    srcs = _mk_shards(tmp_path, n=2)
    outs, stats = _both(tmp_path, srcs, "h", hf2=False)
    assert all(p.endswith(".hff") for p in outs) and stats["tree_builds"] == 1
    _restores(outs, srcs, str(tmp_path / "d"))


def test_adaptive_requires_hf2(tmp_path):
    srcs = _mk_shards(tmp_path, n=2)
    for compress, device in ((compress_dataset, "cpu"),
                             (jax_dataset.compress_dataset, True)):
        with pytest.raises(ValueError):
            compress(srcs, out_dir=str(tmp_path), adaptive=True, hf2=False,
                     device=device)


@pytest.mark.parametrize("kw", [
    {"hist_sample": 8},
    {"hist_sample": 8, "max_bytes_per_file": 50_000},
    {"hist_sample": 1, "max_bytes_per_file": 12_345},
])
def test_build_shared_tree_matches_jax(tmp_path, kw):
    srcs = _mk_shards(tmp_path, n=2, drift=True)
    tree = build_shared_tree(srcs, **kw)
    assert tree.as_bin().to_bytes() == jax_dataset.build_shared_tree(
        srcs, **kw).as_bin().to_bytes()
    lens, _ = tree.encode_tables()
    assert int((np.asarray(lens) > 0).sum()) == 256  # every byte has a code


@pytest.mark.parametrize("block_len", [256, 512])
def test_collect_hist_exact_over_chunks(tmp_path, block_len):
    """Several 64 KiB chunks and a ragged tail: the counts of the encode
    launches, less each chunk's lane padding, are the file's histogram."""
    rng = np.random.default_rng(block_len)
    data = (rng.zipf(1.2, 300_001) % 256).astype(np.uint8)
    src = tmp_path / "x.bin"
    src.write_bytes(data.tobytes())
    counts = np.bincount(data[:5000], minlength=256)
    tree = jax_dataset.tree_from_counts(counts)
    port_tree = tree_from_counts(counts)
    kw = {"block_len": block_len, "chunk_bytes": 1 << 16}
    hist = read_compress_write_hf2(str(src), str(tmp_path / "p.hf2"),
                                   device="cpu", tree=port_tree,
                                   collect_hist=True, **kw)
    jhist = jax_stream.read_compress_write_hf2(
        str(src), str(tmp_path / "j.hf2"), device=True, tree=tree,
        collect_hist=True, **kw)
    assert hist.dtype == np.int64
    assert np.array_equal(hist, np.bincount(data, minlength=256))
    assert np.array_equal(hist, jhist)
    assert (tmp_path / "p.hf2").read_bytes() == (tmp_path / "j.hf2").read_bytes()
    assert read_compress_write_hf2(str(src), str(tmp_path / "q.hf2"),
                                   device="cpu", tree=port_tree, **kw) is None


def test_decompress_dataset_of_jax_shards(tmp_path):
    srcs = _mk_shards(tmp_path, n=3)
    jouts = jax_dataset.compress_dataset(srcs, out_dir=str(tmp_path / "c"),
                                         device=True)
    _restores(jouts, srcs, str(tmp_path / "d"))
    with pytest.raises(ValueError):
        decompress_dataset(jouts, dsts=["one"], device="cpu")
