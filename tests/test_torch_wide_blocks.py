"""``.hf2`` containers of wide blocks (config 2's published 64 KiB) through
the port's device reader, on the CPU.

``io.stream._decode_groups`` (the reader's device branch) runs here on the
kernels' plain versions: S2's twin, then K2's (canonical codes) or K4's
(any other tree), at 4096 and 65536 bytes a block, three blocks with the
last one short.  Each result is held against the benchmark's plain
reference decoder (``benchmark/reference.py``, canonical containers) and
the JAX package's host decoder.  The rules pinned besides: which device
decodes which block length (:func:`io.stream._host_route`), how many
blocks a decode group takes (:func:`io.stream._group_blocks`), and the
counters that say which route a call and a launch took.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from tpuhuff.io import stream as jax_stream

from tpuhuff_torch import profiling
from tpuhuff_torch.io import read_decompress_write_hf2
from tpuhuff_torch.io import stream as port_stream
from tpuhuff_torch.io.host import (
    HOST_HF2_BLOCK,
    StreamError,
    _read_header,
    read_compress_write_hf2_host,
)
from tpuhuff_torch.kernels import decode as port_decode
from tpuhuff_torch.kernels import decoder_for, decode_rows, decode_rows_general
from tpuhuff_torch.profiling import StageTimer, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _reference():
    """``benchmark/reference.py``, loaded by path (it imports nothing of
    the program)."""
    spec = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(ROOT, "benchmark", "reference.py"))
    mod = sys.modules.setdefault(spec.name,
                                 importlib.util.module_from_spec(spec))
    if not hasattr(mod, "decode"):
        spec.loader.exec_module(mod)  # a dataclass looks its module up
    return mod


def _text(n, seed):
    """English-like bytes with 1/32 random ones: a tree of ~10-14 bits."""
    rng = np.random.default_rng(seed)
    words = (b"the of and to in is was that for on with as by at from "
             b"<page> <title> </text> [[link]] 1987 ").split(b" ")
    picks = rng.integers(0, len(words), n // 3)
    base = np.frombuffer(b" ".join(words[k] for k in picks)[:n],
                         dtype=np.uint8).copy()
    idx = rng.integers(0, n, n // 32)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


def _container(tmp_path, block_len, canonical, seed=0):
    """Three blocks of ``block_len``, the last a fifth and 7 bytes short,
    written by the port's host writer (the CLI's ``--hf2 --device
    host``)."""
    data = _text(3 * block_len - block_len // 5 - 7, seed + block_len)
    src, dst = tmp_path / "src.bin", tmp_path / "c.hf2"
    data.tofile(src)
    read_compress_write_hf2_host(str(src), str(dst), block_len=block_len,
                                 canonical=canonical, max_code_len=32)
    return data, str(dst)


def _device_branch(path, out, chunk=64 << 20):
    """``_decode_groups`` on the CPU, as ``read_decompress_write_hf2``
    calls it on a CUDA device."""
    with open(path, "rb") as src, open(out, "wb") as dst:
        hdr = _read_header(src, path)
        assert hdr.num_blocks == 3
        port_stream._decode_groups(hdr, src, dst, path, CPU, chunk, True)
    return hdr


@pytest.mark.parametrize("block_len", [4096, 65536])
@pytest.mark.parametrize("canonical", [True, False])
def test_wide_blocks_through_the_device_branch(tmp_path, block_len,
                                               canonical):
    data, path = _container(tmp_path, block_len, canonical)
    out = str(tmp_path / "port.out")
    hdr = _device_branch(path, out)
    decode, _ = decoder_for(hdr.tree)
    assert decode is (decode_rows if canonical else decode_rows_general)
    got = np.fromfile(out, dtype=np.uint8)
    assert np.array_equal(got, data)
    jax_out = str(tmp_path / "jax.out")
    jax_stream.read_decompress_write_hf2(path, jax_out, device=False)
    assert np.array_equal(got, np.fromfile(jax_out, dtype=np.uint8))
    # the benchmark's containers are the reference's: the same bytes
    reference = _reference()
    ref = reference.encode(data, block_len=block_len, canonical=canonical)
    assert ref.prelude + ref.payload.tobytes() == open(path, "rb").read()
    if canonical:  # ~45 s of this file at 65536: a step per position
        assert np.array_equal(
            got, reference.decode(np.fromfile(path, dtype=np.uint8)))


def test_wide_blocks_flipped_payload_byte_is_corrupt(tmp_path):
    _, path = _container(tmp_path, 4096, True, seed=1)
    raw = bytearray(open(path, "rb").read())
    raw[-3000] ^= 0x20  # inside the last blocks' codes
    open(path, "wb").write(bytes(raw))
    with pytest.raises(StreamError) as err:
        _device_branch(path, str(tmp_path / "bad.out"))
    assert err.value.kind == "CorruptData"


def test_wide_block_flipped_byte_caught_before_it_is_written(tmp_path):
    """At 64 KiB blocks (one short block: the plain decoders step once a
    position of the row, ~9 s) a flipped payload byte raises
    ``CorruptData`` from the CRCs taken of the decoded group, and no byte
    of it is written."""
    data = _text(5000, 2)
    src, path = tmp_path / "src.bin", str(tmp_path / "c.hf2")
    data.tofile(src)
    read_compress_write_hf2_host(str(src), path, block_len=65536,
                                 canonical=True, max_code_len=32)
    raw = bytearray(open(path, "rb").read())
    raw[-1500] ^= 0x20
    open(path, "wb").write(bytes(raw))
    out = str(tmp_path / "bad.out")
    with open(path, "rb") as fp, open(out, "wb") as dst:
        hdr = _read_header(fp, path)
        assert (hdr.block_len, hdr.num_blocks, hdr.crc_every) == (65536, 1, 1)
        with pytest.raises(StreamError) as err:
            port_stream._decode_groups(hdr, fp, dst, path, CPU, 64 << 20, True)
    assert err.value.kind == "CorruptData"
    assert os.path.getsize(out) == 0


@pytest.mark.parametrize("block_len,chunk,blocks", [
    (256, 64 << 20, 262_144),
    (65536, 64 << 20, 1024),
    (1 << 20, 64 << 20, 64),
    (65536, 1 << 20, 16),
    (65536, 1000, 1),
    (1 << 20, 1 << 30, 1024),
])
def test_decode_group_rule(block_len, chunk, blocks):
    """``max(1024, chunk // block_len)`` blocks up to 2048 bytes a block,
    else ``max(1, chunk // block_len)``: 262,144 at 256 B (the 256-byte
    cell's launches), 1024 at 64 KiB, 64 at 1 MiB under the default 64 MiB
    chunk."""
    assert port_stream._group_blocks(block_len, chunk) == blocks


@pytest.mark.parametrize("chunk", [1, 4096, 1 << 20, 64 << 20, 1 << 30])
def test_decode_group_rule_keeps_small_blocks(chunk):
    """Blocks of at most 2048 bytes take ``max(1024, chunk // block_len)``
    a group wherever those rows fit one S2 launch (1-byte blocks in 1 GiB
    groups do not: 2^30 rows of 4 words)."""
    for block_len in (1, 100, 255, 256, 1000, 1024, 2047, 2048):
        want = max(1024, chunk // block_len)
        got = port_stream._group_blocks(block_len, chunk)
        if want * (block_len + 3) < 1 << 31:
            assert got == want
        else:
            assert got * (block_len + 3) < 1 << 31 <= (got + 1) * (
                block_len + 3)


def test_decode_group_rule_keeps_rows_in_one_launch():
    """A group's rows, of at most ``block_len + 3`` words each, stay under
    S2's 2^31 words a launch, whatever ``chunk_bytes`` asks for."""
    for block_len, chunk in ((65536, 16 << 30), (1 << 20, 64 << 30),
                             (1 << 24, 1 << 34)):
        n = port_stream._group_blocks(block_len, chunk)
        assert 1 <= n and n * (block_len + 3) < 1 << 31


def _header(block_len, orig_len=1000, leaf=False):
    tree = types.SimpleNamespace(root=0, is_leaf=lambda node: leaf)
    return types.SimpleNamespace(block_len=block_len, orig_len=orig_len,
                                 tree=tree)


@pytest.mark.parametrize("block_len", [1, 256, 2048, 2049, HOST_HF2_BLOCK,
                                       1 << 20, 1 << 24])
def test_decode_route_rule_per_device(block_len):
    """A CUDA device decodes every block length on the card; the CPU
    device hands blocks over 2048 bytes to the host decoder; an empty
    file and a one-letter tree go to the host on both."""
    cuda, cpu = torch.device("cuda", 0), CPU
    assert not port_stream._host_route(_header(block_len), cuda)
    assert port_stream._host_route(_header(block_len), cpu) == (
        block_len > port_stream.DEVICE_DECODE_MAX_BLOCK)
    for dev in (cuda, cpu):
        assert port_stream._host_route(_header(block_len, orig_len=0), dev)
        assert port_stream._host_route(_header(block_len, leaf=True), dev)


@pytest.mark.parametrize("block_len,host", [(2048, False), (4096, True)])
def test_host_route_bytes_counts_the_calls_handed_to_the_host(
        tmp_path, block_len, host):
    data, path = _container(tmp_path, block_len, True, seed=2)
    out = str(tmp_path / "o")
    t = StageTimer()
    with tracing(t):
        read_decompress_write_hf2(path, out, device="cpu")
    assert np.array_equal(np.fromfile(out, dtype=np.uint8), data)
    rec, = t.records
    got = rec.counters.get("host_route_bytes")
    if host:
        assert got.n == data.size and got.calls == 1
    else:
        assert got is None


@pytest.mark.parametrize("name", ["decode_rows", "decode_rows_general"])
def test_wrapper_block_counters(monkeypatch, name):
    """A launch adds its blocks to ``blocks``; on the global-rows route
    also to ``global_launches``, ``global_blocks`` and the tracer's
    ``global_rows_blocks``.  The counts land on the function as defined
    even while a wrapper from outside stands in its module name."""
    fn = getattr(port_decode, name)
    own = port_decode._K2 if name == "decode_rows" else port_decode._K4
    assert own is fn
    attrs = ("launches", "global_launches", "blocks", "global_blocks")
    for a in attrs:
        monkeypatch.setattr(fn, a, 0)

    def outside(*args, **kw):
        return fn(*args, **kw)

    outside.__dict__.update(fn.__dict__)
    monkeypatch.setattr(port_decode, name, outside)
    t = StageTimer()
    with tracing(t):
        with profiling.call("decompress"):
            port_decode._counted(own, 1024, 1)
            port_decode._counted(own, 7, 0)
    assert tuple(getattr(fn, a) for a in attrs) == (2, 1, 1031, 1024)
    assert tuple(getattr(outside, a) for a in attrs) == (0, 0, 0, 0)
    rec, = t.records
    c = rec.counters["global_rows_blocks"]
    assert (c.n, c.calls) == (1024, 1)
    port_decode._counted(own, 5, 1)  # no tracer: the attributes alone
    assert (fn.global_blocks, fn.blocks) == (1029, 1036)
