"""tpuhuff_torch histogram (plain version, CPU) against the JAX Pallas
histogram in interpret mode and numpy, at sizes that are not multiples of
the Pallas kernel's 128 KiB cell."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuhuff.kernels.pallas_histogram import CELL_BYTES, histogram_pallas

from tpuhuff_torch.kernels import histogram, histogram_reference


@pytest.mark.parametrize("n", [1, 1000, CELL_BYTES + 7, 2 * CELL_BYTES + 40001])
def test_histogram_matches_pallas_and_numpy(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    data[: n // 2] = 101  # skewed, like text
    got = histogram(torch.from_numpy(data))
    assert got.dtype == torch.int64 and got.shape == (256,)
    want = np.bincount(data, minlength=256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          np.asarray(histogram_pallas(jnp.asarray(data),
                                                      interpret=True)))


def test_histogram_empty_and_shapes():
    assert not histogram(torch.zeros(0, dtype=torch.uint8)).any()
    two_d = torch.arange(512, dtype=torch.int64).remainder(256).to(torch.uint8)
    assert torch.equal(histogram(two_d.reshape(8, 64)),
                       torch.full((256,), 2, dtype=torch.int64))
    with pytest.raises(TypeError):
        histogram(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("pieces", [1, 2, 5])
@pytest.mark.parametrize("reference", [False, True])
def test_histogram_out_accumulates(pieces, reference):
    """``out=`` over several calls equals one call over the whole input,
    starting from counts already there, and returns ``out`` itself."""
    fn = histogram_reference if reference else histogram
    rng = np.random.default_rng(pieces)
    data = rng.zipf(1.3, 10_007).clip(0, 255).astype(np.uint8)
    out = torch.arange(256, dtype=torch.int64)
    start = out.clone()
    for part in np.array_split(data, pieces):
        assert fn(torch.from_numpy(part), out=out) is out
    assert torch.equal(out - start, histogram(torch.from_numpy(data)))
    assert np.array_equal((out - start).numpy(),
                          np.bincount(data, minlength=256))


@pytest.mark.parametrize("bad", ["dtype int32", "dtype float64", "shape",
                                 "device", "strided"])
@pytest.mark.parametrize("reference", [False, True])
def test_histogram_out_rejects_wrong_tensors(bad, reference):
    fn = histogram_reference if reference else histogram
    out = {"dtype int32": torch.zeros(256, dtype=torch.int32),
           "dtype float64": torch.zeros(256, dtype=torch.float64),
           "shape": torch.zeros(257, dtype=torch.int64),
           "device": torch.zeros(256, dtype=torch.int64, device="meta"),
           "strided": torch.zeros(512, dtype=torch.int64)[::2]}[bad]
    with pytest.raises((TypeError, ValueError)):
        fn(torch.zeros(10, dtype=torch.uint8), out=out)


@pytest.mark.parametrize("hist_sample", [1, 3])
def test_pass1_counts_as_the_jax_writer(tmp_path, monkeypatch, hist_sample):
    """Pass 1 of the port's ``.hf2`` writer over several pieces: one
    histogram call per piece, each adding into the running counts
    (``out=``), and the counts that reach the tree build equal the JAX
    device writer's, with and without sampling."""
    from tpuhuff.core import canonical as jax_canonical
    from tpuhuff.io import stream as jax_stream

    from tpuhuff_torch.io import read_compress_write_hf2
    from tpuhuff_torch.io import stream as port_stream
    from tpuhuff_torch.io.host import _chunk_step

    rng = np.random.default_rng(hist_sample)
    data = rng.zipf(1.2, 300_001).clip(0, 255).astype(np.uint8)
    src = tmp_path / "src.bin"
    src.write_bytes(data.tobytes())
    chunk = 64 * 1024
    pieces = -(-data.size // _chunk_step(256, chunk, True)[0])
    assert pieces > 1
    seen = {}

    def recorder(key, build):
        def wrapped(weights, *args, **kw):
            seen[key] = np.asarray(weights.counts, dtype=np.int64).copy()
            return build(weights, *args, **kw)
        return wrapped

    outs = []

    def counted(piece, out=None):
        outs.append(out)
        return histogram(piece, out=out)

    monkeypatch.setattr(port_stream, "build_tree_for_device",
                        recorder("port", port_stream.build_tree_for_device))
    monkeypatch.setattr(jax_canonical, "build_tree_for_device",
                        recorder("jax", jax_canonical.build_tree_for_device))
    monkeypatch.setattr(port_stream, "histogram", counted)
    kw = {"block_len": 256, "chunk_bytes": chunk, "hist_sample": hist_sample}
    read_compress_write_hf2(str(src), str(tmp_path / "p.hf2"), device="cpu",
                            **kw)
    jax_stream.read_compress_write_hf2(str(src), str(tmp_path / "j.hf2"),
                                       device=True, **kw)
    assert len(outs) == pieces
    assert all(o is outs[0] and o is not None for o in outs)
    assert np.array_equal(seen["port"], seen["jax"])
    if hist_sample == 1:
        assert np.array_equal(seen["port"], np.bincount(data, minlength=256))
    assert (tmp_path / "p.hf2").read_bytes() == (tmp_path / "j.hf2").read_bytes()
