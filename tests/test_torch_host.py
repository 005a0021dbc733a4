"""The port's host ``.hf2`` writer and reader (``tpuhuff_torch.io.host``)
against ``tpuhuff.io.stream``'s host route (``device=False``): the same
container bytes, the same ``collect_hist`` counts, exact round trips both
ways, and pass 1 sampling the same bytes as the JAX writers.
"""

import numpy as np
import pytest

from tpuhuff.core.tree import HuffTree as JaxTree
from tpuhuff.core.weights import ByteWeights as JaxWeights
from tpuhuff.io import stream as jax_stream

from tpuhuff_torch.core.tree import HuffTree
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.io import read_decompress_write_hf2
from tpuhuff_torch.io.host import (
    StreamError,
    _chunk_step,
    _sampled_pieces,
    read_compress_write_hf2_host,
    read_decompress_write_hf2_host,
)


def _textlike(n, seed):
    rng = np.random.default_rng(seed)
    text = b"<page><title>Huffman</title> the of and to in a is that it was "
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, n, n // 64)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


def _fib():
    """fib(1..34) counts: a 33-deep optimal tree (33-bit codes unlimited,
    32-bit under ``max_code_len=32``), ~15 MB."""
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    data = np.repeat(np.arange(34, dtype=np.uint8), fib)
    np.random.default_rng(21).shuffle(data)
    return data


CASES = {
    "textlike": lambda: _textlike(300_001, 1),
    "random": lambda: np.random.default_rng(2).integers(0, 256, 200_000,
                                                        dtype=np.uint8),
    "fib": _fib,
    "empty": lambda: np.zeros(0, dtype=np.uint8),
    "one_letter": lambda: np.full(70_000, 7, dtype=np.uint8),
}


def jax_writer_host(src, dst, **kw):
    return jax_stream.read_compress_write_hf2(src, dst, device=False, **kw)


def _both(tmp_path, data, tree=(None, None), **kw):
    """Write ``data`` with both host writers; ``tree`` is the pair (port
    tree, JAX tree) built from the same counts, or none."""
    src = tmp_path / "src.bin"
    src.write_bytes(data.tobytes())
    port, jax = str(tmp_path / "p.hf2"), str(tmp_path / "j.hf2")
    read_compress_write_hf2_host(str(src), port, tree=tree[0], **kw)
    jax_writer_host(str(src), jax, tree=tree[1], **kw)
    return port, jax


def _check_round_trips(tmp_path, port, data, **kw):
    out, jax_out = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    read_decompress_write_hf2_host(port, out, **kw)
    jax_stream.read_decompress_write_hf2(port, jax_out, device=False, **kw)
    assert open(out, "rb").read() == data.tobytes()
    assert open(jax_out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_writer_byte_identical_and_round_trips(tmp_path, case, canonical):
    data = CASES[case]()
    kw = {"canonical": canonical}
    if case == "empty":
        # no counts, no tree: both writers refuse; with a given tree both
        # write an empty container that both readers read back as empty
        (tmp_path / "src.bin").write_bytes(b"")
        for writer in (read_compress_write_hf2_host, jax_writer_host):
            with pytest.raises(ValueError, match="empty weights"):
                writer(str(tmp_path / "src.bin"), str(tmp_path / "x.hf2"))
        kw["tree"] = (HuffTree.from_weights(ByteWeights.from_bytes(b"ab")),
                      JaxTree.from_weights(JaxWeights.from_bytes(b"ab")))
    port, jax = _both(tmp_path, data, **kw)
    assert open(port, "rb").read() == open(jax, "rb").read()
    _check_round_trips(tmp_path, port, data)


@pytest.mark.parametrize("opts", [
    {"check": False},
    {"chunk_bytes": 1 << 16, "block_len": 4096},
    {"block_len": 256, "max_code_len": 32},
    {"block_len": 1000, "max_code_len": 11, "chunk_bytes": 50_000},
    {"hist_sample": 4, "chunk_bytes": 1 << 16, "block_len": 512},
])
def test_host_writer_options_byte_identical(tmp_path, opts):
    data = _textlike(400_003, 3)
    port, jax = _both(tmp_path, data, canonical=False, **opts)
    assert open(port, "rb").read() == open(jax, "rb").read()
    read_opts = {k: v for k, v in opts.items() if k in ("chunk_bytes", "check")}
    _check_round_trips(tmp_path, port, data, **read_opts)


def test_host_writer_fib_length_limited(tmp_path):
    """Fibonacci at the device writer's settings: 32-bit codes, and the
    port's device reader (its plain decoder on the CPU) reads it too."""
    data = _fib()
    port, jax = _both(tmp_path, data, block_len=256, max_code_len=32,
                      canonical=False)
    assert open(port, "rb").read() == open(jax, "rb").read()
    out = str(tmp_path / "d.out")
    read_decompress_write_hf2(port, out, device="cpu")
    assert open(out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("check", [True, False])
def test_host_reader_corruption(tmp_path, check):
    data = _textlike(200_000, 4)
    port, _ = _both(tmp_path, data, block_len=4096)
    raw = bytearray(open(port, "rb").read())
    raw[-3000] ^= 0x04
    open(port, "wb").write(bytes(raw))
    out = str(tmp_path / "c.out")
    if check:
        with pytest.raises(StreamError) as err:
            read_decompress_write_hf2_host(port, out, check=True)
        assert err.value.kind in ("CorruptData", "InvalidHeaderInfo")
    else:
        try:  # unchecked: wrong bytes, or a typed error, never a crash
            read_decompress_write_hf2_host(port, out, check=False)
        except StreamError as e:
            assert e.kind == "InvalidHeaderInfo"
        else:
            assert open(out, "rb").read() != data.tobytes()


def test_host_reader_rejects_bad_header(tmp_path):
    bad = tmp_path / "bad.hf2"
    bad.write_bytes(b"HF2\x02\x00\x05" + b"\x00" * 40)
    with pytest.raises(StreamError) as err:
        read_decompress_write_hf2_host(str(bad), str(tmp_path / "o"))
    assert err.value.kind == "InvalidHeaderInfo"


@pytest.mark.parametrize("opts", [
    {},
    {"block_len": 4096, "chunk_bytes": 1 << 16},
    {"block_len": 1000, "chunk_bytes": 50_000, "check": False},
])
def test_host_writer_collect_hist(tmp_path, opts):
    """Config 4's ``collect_hist``: the histogram counted during pass 2 is
    exact and equal to the JAX host writer's, and the bytes do not move."""
    data = _textlike(400_003, 5)
    src = tmp_path / "src.bin"
    src.write_bytes(data.tobytes())
    port, jax, plain = (str(tmp_path / f"{k}.hf2") for k in "pjq")
    hist = read_compress_write_hf2_host(str(src), port, collect_hist=True,
                                        **opts)
    jhist = jax_writer_host(str(src), jax, collect_hist=True, **opts)
    assert np.array_equal(hist, np.bincount(data, minlength=256))
    assert np.array_equal(hist, jhist)
    assert read_compress_write_hf2_host(str(src), plain, **opts) is None
    assert open(port, "rb").read() == open(jax, "rb").read()
    assert open(port, "rb").read() == open(plain, "rb").read()


def test_pass1_samples_as_the_jax_writers(tmp_path):
    """A 257 MiB file with ``chunk_bytes=512 MiB, hist_sample=8``: pass 1
    reads pieces of at most 256 MiB, as both JAX writers do, and counts
    the first eighth of each: ``[0, 32 MiB)`` and ``[256, 256.125 MiB)``.
    Sampling the whole 512 MiB step would count ``[0, 32.125 MiB)``."""
    mib = 1 << 20
    size = 257 * mib
    path = tmp_path / "big.bin"
    with open(path, "wb") as fp:  # sparse: zeros cost no writes
        fp.truncate(size)
        fp.seek(32 * mib)
        fp.write(b"\x01" * (mib // 8))  # sampled only by the whole step
        fp.seek(256 * mib)
        fp.write(b"\x02" * (mib // 8))  # sampled only per 256 MiB piece
    step = _chunk_step(256, 512 << 20, True)[0]
    assert step == 512 << 20
    data = np.memmap(path, dtype=np.uint8, mode="r")
    want = np.zeros(256, dtype=np.int64)  # the JAX rule
    for off in range(0, size, 256 * mib):
        piece = data[off: off + 256 * mib]
        want += np.bincount(piece[: max(1, piece.size // 8)], minlength=256)
    whole_step = np.bincount(data[: size // 8], minlength=256)
    assert not np.array_equal(want, whole_step)
    got = np.zeros(256, dtype=np.int64)
    with open(path, "rb") as fp:
        for piece in _sampled_pieces(fp, size, step, 8):
            got += np.bincount(np.frombuffer(piece, dtype=np.uint8),
                               minlength=256)
    del data
    path.unlink()
    assert np.array_equal(got, want)
