"""tpuhuff_torch ``.hf2`` file codec on the CPU against the JAX device route.

The port's writer (``device="cpu"``: the kernels' plain versions) must be
byte-identical to ``tpuhuff.io.stream.read_compress_write_hf2(device=True)``
and to the host C++ writer, and each package must read the other's files.
"""

import os

import numpy as np
import pytest
import torch

from tpuhuff.core.canonical import canonicalize
from tpuhuff.core.tree import HuffTree
from tpuhuff.core.weights import ByteWeights
from tpuhuff.io import stream as jax_stream

from tpuhuff_torch.core import canonical as port_canonical
from tpuhuff_torch.core.format import CompressError
from tpuhuff_torch.core.tree import HuffTree as PortTree
from tpuhuff_torch.core.weights import ByteWeights as PortWeights
from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2
from tpuhuff_torch.io.host import StreamError, _chunk_step
from tpuhuff_torch.profiling import StageTimer, tracing


def _data(n, seed):
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox jumps over the lazy dog 0123456789 "
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, n, n // 32)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


def _src(tmp_path, n, seed=0):
    data = _data(n, seed + n)
    src = tmp_path / f"s{n}.bin"
    src.write_bytes(data.tobytes())
    return str(src), data


@pytest.mark.parametrize("n", [1, 255, 257, 4109, 300_000])
def test_port_writer_byte_identical(tmp_path, n):
    src, data = _src(tmp_path, n)
    port, dev, host = (str(tmp_path / f"{k}.hf2") for k in ("p", "d", "h"))
    read_compress_write_hf2(src, port, device="cpu", block_len=256)
    jax_stream.read_compress_write_hf2(src, dev, device=True, block_len=256)
    jax_stream.read_compress_write_hf2(src, host, device=False, block_len=256,
                                       max_code_len=32)
    got = open(port, "rb").read()
    assert got == open(dev, "rb").read()
    assert got == open(host, "rb").read()
    out = str(tmp_path / "p.out")
    read_decompress_write_hf2(port, out, device="cpu")
    assert open(out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("opts", [
    {"chunk_bytes": 64 * 1024},
    {"chunk_bytes": 64 * 1024, "hist_sample": 4},
    {"block_len": 1000, "check": False},
    {"block_len": 4096, "max_code_len": 11},
    {"canonical": False},
])
def test_port_writer_options_byte_identical(tmp_path, opts):
    src, data = _src(tmp_path, 300_000, seed=1)
    port, dev = str(tmp_path / "p.hf2"), str(tmp_path / "d.hf2")
    kw = {"block_len": 256, **opts}
    read_compress_write_hf2(src, port, device="cpu", **kw)
    jax_stream.read_compress_write_hf2(src, dev, device=True, **kw)
    assert open(port, "rb").read() == open(dev, "rb").read()
    out = str(tmp_path / "p.out")
    read_decompress_write_hf2(port, out, device="cpu", chunk_bytes=64 * 1024)
    assert open(out, "rb").read() == data.tobytes()
    if not opts.get("canonical", True):
        # the general-tree decoder (K4) on a non-canonical tree: the same
        # bytes as the JAX device route's decode of the same file
        jax_out = str(tmp_path / "d.out")
        jax_stream.read_decompress_write_hf2(dev, jax_out, device=True)
        assert open(out, "rb").read() == open(jax_out, "rb").read()


def test_port_writer_given_tree(tmp_path):
    src, data = _src(tmp_path, 50_000, seed=2)
    counts = np.bincount(data, minlength=256) + 1  # covers every byte
    tree = canonicalize(HuffTree.from_weights(ByteWeights(counts)))
    port_tree = port_canonical.canonicalize(
        PortTree.from_weights(PortWeights(counts)))
    port, dev = str(tmp_path / "p.hf2"), str(tmp_path / "d.hf2")
    read_compress_write_hf2(src, port, device="cpu", tree=port_tree,
                            chunk_bytes=16 * 1024)
    jax_stream.read_compress_write_hf2(src, dev, device=True, tree=tree,
                                       chunk_bytes=16 * 1024)
    assert open(port, "rb").read() == open(dev, "rb").read()


def test_port_writer_missing_letter_raises(tmp_path):
    src, data = _src(tmp_path, 20_000, seed=3)
    present = np.bincount(data, minlength=256)
    present[int(data[-1])] = 0  # a tree that has no code for this byte
    tree = PortTree.from_weights(PortWeights(present))
    with pytest.raises(CompressError):
        read_compress_write_hf2(src, str(tmp_path / "p.hf2"), device="cpu",
                                tree=tree)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port",
                                       "port_to_port"])
def test_cross_round_trips(tmp_path, direction):
    src, data = _src(tmp_path, 70_001, seed=4)
    hf2, out = str(tmp_path / "x.hf2"), str(tmp_path / "x.out")
    if direction == "jax_to_port":
        jax_stream.read_compress_write_hf2(src, hf2, device=True)
    else:
        read_compress_write_hf2(src, hf2, device="cpu")
    if direction == "port_to_jax":
        jax_stream.read_decompress_write_hf2(hf2, out, device=True)
    else:
        read_decompress_write_hf2(hf2, out, device="cpu", chunk_bytes=32 * 1024)
    assert open(out, "rb").read() == data.tobytes()


def test_port_reader_detects_corruption(tmp_path):
    src, data = _src(tmp_path, 40_000, seed=5)
    hf2 = tmp_path / "c.hf2"
    read_compress_write_hf2(src, str(hf2), device="cpu")
    raw = bytearray(hf2.read_bytes())
    raw[-2000] ^= 0x10
    hf2.write_bytes(bytes(raw))
    with pytest.raises(StreamError) as err:
        read_decompress_write_hf2(str(hf2), str(tmp_path / "c.out"), device="cpu")
    assert err.value.kind == "CorruptData"


def test_port_rejects_unknown_device(tmp_path):
    src, _ = _src(tmp_path, 100)
    with pytest.raises(ValueError):
        read_compress_write_hf2(src, str(tmp_path / "p.hf2"), device="meta")


# -- chunks whose boundaries fall inside a byte: the device stitch's carry --

def _boundary_carries(path, step_blocks):
    """The bits carried across each chunk boundary of a ``.hf2`` written in
    chunks of ``step_blocks`` blocks (each chunk's end bit mod 8)."""
    from tpuhuff_torch.io.hff import read_hf2_header

    with open(path, "rb") as fp:
        ends = read_hf2_header(fp).end_bits.astype(np.int64)
    return {int(ends[k - 1]) % 8 for k in range(step_blocks, ends.size,
                                                 step_blocks)}


@pytest.mark.parametrize("n,opts", [
    (300_000, {"block_len": 256, "check": False, "chunk_bytes": 5 * 256}),
    (300_000, {"block_len": 1000, "check": False, "chunk_bytes": 3000}),
    (600_001, {"block_len": 256, "check": True, "chunk_bytes": 64 * 1024}),
])
def test_hf2_small_chunks_carry_bits_across_boundaries(tmp_path, n, opts):
    """The port's writer in small chunks, every chunk's stitch behind the
    bits the one before left on the device: the JAX device writer's bytes
    (written in one chunk: the chunking never changes the bytes), and the
    reader, in small groups, restores the source."""
    src, data = _src(tmp_path, n, seed=6)
    port, dev = str(tmp_path / "p.hf2"), str(tmp_path / "d.hf2")
    read_compress_write_hf2(src, port, device="cpu", **opts)
    kw = {k: v for k, v in opts.items() if k != "chunk_bytes"}
    jax_stream.read_compress_write_hf2(src, dev, device=True, **kw)
    assert open(port, "rb").read() == open(dev, "rb").read()
    step = max(1, opts["chunk_bytes"] // opts["block_len"])
    if not opts["check"]:
        assert _boundary_carries(port, step) >= set(range(1, 8))
    else:
        assert len(_boundary_carries(port, step) - {0}) >= 1
    out = str(tmp_path / "p.out")
    read_decompress_write_hf2(port, out, device="cpu", chunk_bytes=4096)
    assert open(out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("n,opts", [
    (4109, {"block_len": 256, "collect_hist": True}),
    (300_000, {"block_len": 256, "check": False, "chunk_bytes": 5 * 256}),
    (300_000, {"block_len": 1000, "check": False, "chunk_bytes": 3000}),
    (600_001, {"block_len": 256, "check": True, "chunk_bytes": 64 * 1024}),
    (300_001, {"block_len": 1000, "check": True, "chunk_bytes": 3000}),
    (300_000, {"block_len": 256, "canonical": False,
               "chunk_bytes": 64 * 1024}),
])
def test_hf2_resident_route_byte_identical(tmp_path, monkeypatch, n, opts):
    """The route that reads the file once and encodes from its device
    copy, forced on the CPU: one chunk with a partial last block, small
    chunks with and without the CRC column (a partial last chunk, bits
    carried across each boundary), non-canonical codes.  The two-pass
    route's bytes and the JAX device writer's, and the reader restores
    the source."""
    from tpuhuff_torch.io import stream as port_stream

    src, data = _src(tmp_path, n, seed=9)
    two, res, dev = (str(tmp_path / f"{k}.hf2") for k in ("t", "r", "d"))
    hist_two = read_compress_write_hf2(src, two, device="cpu", **opts)
    monkeypatch.setattr(port_stream, "_resident", lambda *a: True)
    t = StageTimer()
    with tracing(t):
        hist = read_compress_write_hf2(src, res, device="cpu", **opts)
    if opts.get("collect_hist"):  # the last block's padding is not counted
        assert (hist == hist_two).all()
        assert (hist == np.bincount(data, minlength=256)).all()
    rec, = t.records
    assert rec.counters["resident_bytes"].n == n
    assert rec.spans["read"].bytes == n  # pass 1 alone reads the file
    kw = {k: v for k, v in opts.items() if k != "chunk_bytes"}
    jax_stream.read_compress_write_hf2(src, dev, device=True, **kw)
    got = open(res, "rb").read()
    assert got == open(two, "rb").read()
    assert got == open(dev, "rb").read()
    step = _chunk_step(opts["block_len"], opts.get("chunk_bytes"),
                       opts.get("check", True))[0] // opts["block_len"]
    carries = _boundary_carries(res, step)
    if "chunk_bytes" in opts and not opts.get("check", True):
        assert carries >= set(range(1, 8))
    elif "chunk_bytes" in opts:
        assert len(carries - {0}) >= 1
    else:
        assert carries == set()  # one chunk
    out = str(tmp_path / "r.out")
    read_decompress_write_hf2(res, out, device="cpu", chunk_bytes=4096)
    assert open(out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("case", ["tree", "sampled", "cpu", "over_budget",
                                  "at_budget"])
def test_hf2_route_choice(tmp_path, monkeypatch, case):
    """The two-pass route runs, with ``resident_bytes`` at 0, when a tree
    is given, when pass 1 samples, on the CPU (no free device memory),
    and when the padded file takes more than half the free memory; at
    half, the file is kept on the device and each byte is read once."""
    from tpuhuff_torch.io import stream as port_stream

    n, block = 70_001, 256
    src, data = _src(tmp_path, n, seed=10)
    padded = -(-n // block) * block
    free = {"tree": 1 << 40, "sampled": 1 << 40, "cpu": None,
            "over_budget": 2 * padded - 1, "at_budget": 2 * padded}[case]
    if free is not None:
        monkeypatch.setattr(port_stream, "_device_free_bytes",
                            lambda dev: free)
    kw = {"block_len": block, "chunk_bytes": 16 * 1024}
    if case == "tree":
        counts = np.bincount(data, minlength=256) + 1
        kw["tree"] = PortTree.from_weights(PortWeights(counts))
    if case == "sampled":
        kw["hist_sample"] = 4
    if case != "sampled":  # pass 1 over every byte reads into the slots
        monkeypatch.setattr(port_stream, "_sampled_pieces", None)
    port, plain = str(tmp_path / "p.hf2"), str(tmp_path / "plain.hf2")
    t = StageTimer()
    with tracing(t):
        read_compress_write_hf2(src, port, device="cpu", **kw)
    rec, = t.records
    resident = rec.counters.get("resident_bytes")
    if case == "at_budget":
        assert resident.n == n and rec.spans["read"].bytes == n
    else:
        assert resident is None or resident.n == 0
        assert rec.spans["read"].bytes == (n if case == "tree" else 2 * n)
    monkeypatch.undo()
    read_compress_write_hf2(src, plain, device="cpu", **kw)
    assert open(port, "rb").read() == open(plain, "rb").read()


def test_hf2_route_budget_counts_the_allocators_cache(monkeypatch):
    """A resident call's device copy stays reserved in PyTorch's caching
    allocator after the call; the budget counts it as free, so a second
    call of the same size keeps the route (patched readings of a card)."""
    from tpuhuff_torch.io import stream as port_stream

    dev, padded = torch.device("cuda", 0), 1 << 30
    card = {"free": 2 * padded + 4096, "reserved": 3 << 20,
            "allocated": 1 << 20}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (card["free"], 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda d=None: card["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: card["allocated"])
    assert port_stream._resident(dev, padded, padded, None, 1)
    # the first call's copy, freed into the cache: the card reads it used
    card["free"] -= padded
    card["reserved"] += padded
    assert card["free"] // 2 < padded
    assert port_stream._resident(dev, padded, padded, None, 1)
    card["allocated"] += padded  # held by a live tensor: not free
    assert not port_stream._resident(dev, padded, padded, None, 1)


@pytest.mark.parametrize("resident", [False, True])
def test_hf2_pass1_raises_on_a_file_shorter_than_its_size(
        tmp_path, monkeypatch, resident):
    """A file that ends before the size read at the call's start: pass 1
    over every byte raises on both routes."""
    from tpuhuff_torch.io import stream as port_stream

    src, data = _src(tmp_path, 10_000, seed=11)
    real = os.path.getsize
    monkeypatch.setattr(port_stream.os.path, "getsize",
                        lambda p: real(p) + (512 if p == src else 0))
    monkeypatch.setattr(port_stream, "_resident", lambda *a: resident)
    with pytest.raises(StreamError, match="ended before"):
        read_compress_write_hf2(src, str(tmp_path / "c.hf2"), device="cpu",
                                block_len=256, chunk_bytes=4096)


@pytest.mark.parametrize("via", ["src.read", "read(n, slot)"])
@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_pipeline_submits_ahead_in_alternate_slots(n, via):
    """The file calls' one loop over ``n`` pieces of :func:`_pieces`:
    piece k+1 is read and submitted before piece k is collected, slots
    alternate 0, 1 (the slot a piece is read into too), every handle is
    collected once, in order, and nothing is read after the last piece."""
    from tpuhuff_torch.io.host import _pieces, _pipeline

    step, events = 3, []

    class Src:
        k = 0

        def read(self, m):
            events.append(("read", self.k))
            self.k += 1
            return bytes([self.k]) * m

    src = Src()

    def read(m, slot):
        assert slot == src.k % 2
        return np.frombuffer(src.read(m), dtype=np.uint8)

    def submit(piece, slot):
        assert piece.size == step
        events.append(("submit", int(piece[0]) - 1, slot))
        return int(piece[0]) - 1

    pieces = _pieces(src, n * step, step,
                     read if via == "read(n, slot)" else None)
    _pipeline(pieces, submit, lambda k: events.append(("collect", k)))
    want = []
    for k in range(n):
        want += [("read", k), ("submit", k, k % 2)]
        want += [("collect", k - 1)] if k else []
    want += [("collect", n - 1)] if n else []
    assert events == want


def test_hff_small_pieces_carry_bits_across_boundaries(tmp_path):
    """The ``.hff`` device writer in 1000-byte pieces (lanes of 256 bytes,
    the last ragged): the JAX device writer's and the host writer's bytes,
    and the host reader restores the source."""
    from tpuhuff_torch.io import read_compress_write, read_decompress_write
    from tpuhuff_torch.io.host import read_compress_write_host

    src, data = _src(tmp_path, 120_007, seed=7)
    port, dev, host = (str(tmp_path / f"{k}.hff") for k in ("p", "d", "h"))
    read_compress_write(src, port, block_size=1000, device="cpu")
    jax_stream.read_compress_write(src, dev, device=True)
    read_compress_write_host(src, host)
    got = open(port, "rb").read()
    assert got == open(dev, "rb").read() == open(host, "rb").read()
    out = str(tmp_path / "p.out")
    read_decompress_write(port, out)
    assert open(out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("adaptive", [False, True])
def test_dataset_small_chunks_carry_bits_across_boundaries(tmp_path,
                                                           monkeypatch,
                                                           adaptive):
    """Config 4's shards written by the port in 1280-byte chunks: the JAX
    package's containers (shared and adaptive trees), restored."""
    from tpuhuff.io import dataset as jax_dataset

    from tpuhuff_torch.io import compress_dataset, decompress_dataset
    from tpuhuff_torch.io import host as port_host

    srcs = []
    for k in range(3):
        path, _ = _src(tmp_path, 40_000 + 777 * k, seed=8 + k)
        srcs.append(path)
    kw = {"block_len": 256, "check": False, "hist_sample": 1,
          "adaptive": adaptive}
    jouts = jax_dataset.compress_dataset(srcs, out_dir=str(tmp_path / "j"),
                                         device=True, **kw)
    monkeypatch.setattr(port_host, "_CHUNK", 5 * 256)
    outs = compress_dataset(srcs, out_dir=str(tmp_path / "p"), device="cpu",
                            **kw)
    carries = set()
    for p, j in zip(outs, jouts):
        assert open(p, "rb").read() == open(j, "rb").read()
        carries |= _boundary_carries(p, 5)
    assert carries >= set(range(1, 8))
    decs = decompress_dataset(outs, out_dir=str(tmp_path / "dec"), device="cpu")
    for src, dec in zip(srcs, decs):
        assert open(dec, "rb").read() == open(src, "rb").read()


# -- the CRC column, taken on the device (C1's plain version here) --

def _flip_in_block(path, block, bit=0x20):
    """Flip one bit of a byte in the middle of ``block``'s payload."""
    from tpuhuff_torch.io.hff import read_hf2_header

    with open(path, "rb") as fp:
        hdr = read_hf2_header(fp)
    ends = hdr.end_bits.astype(np.int64)
    start = int(ends[block - 1]) if block else 0
    raw = bytearray(open(path, "rb").read())
    raw[hdr.payload_offset + (start + int(ends[block])) // 16] ^= bit
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("route", ["two_pass", "resident"])
def test_hf2_crc_column_taken_on_the_device(tmp_path, monkeypatch, route):
    """With the host runtime's ``crc32_blocks`` made to raise, the device
    writer on both routes still writes the JAX device writer's and the
    port's host writer's bytes, and the reader restores the source; the
    tracer's ``crc_device_bytes`` is the file's bytes in each call."""
    from tpuhuff_torch import native
    from tpuhuff_torch.io import stream as port_stream
    from tpuhuff_torch.io.host import read_compress_write_hf2_host

    n = 300_001
    src, data = _src(tmp_path, n, seed=12)
    port, dev, host = (str(tmp_path / f"{k}.hf2") for k in ("p", "d", "h"))
    jax_stream.read_compress_write_hf2(src, dev, device=True, block_len=256)
    read_compress_write_hf2_host(src, host, block_len=256, max_code_len=32)

    def host_crc(*a, **k):
        raise AssertionError("the host CRC ran in a device call")

    monkeypatch.setattr(native, "crc32_blocks", host_crc)
    monkeypatch.setattr(port_stream, "_resident",
                        lambda *a: route == "resident")
    out = str(tmp_path / "p.out")
    t = StageTimer()
    with tracing(t):
        read_compress_write_hf2(src, port, device="cpu", block_len=256,
                                chunk_bytes=64 * 1024)
        read_decompress_write_hf2(port, out, device="cpu",
                                  chunk_bytes=64 * 1024)
    got = open(port, "rb").read()
    assert got == open(dev, "rb").read() == open(host, "rb").read()
    assert open(out, "rb").read() == data.tobytes()
    comp, dec = t.records
    assert comp.counters["crc_device_bytes"].n == n
    assert dec.counters["crc_device_bytes"].n == n
    assert ("resident_bytes" in comp.counters) == (route == "resident")


def test_hf2_check_off_takes_no_crc(tmp_path, monkeypatch):
    """``check=False``: no C1 call in either direction, and no
    ``crc_device_bytes``; with the check on, one a chunk and a group."""
    from tpuhuff_torch.io import stream as port_stream

    calls = []
    real = port_stream.crc32_spans
    monkeypatch.setattr(port_stream, "crc32_spans",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    src, data = _src(tmp_path, 200_000, seed=13)
    for check in (False, True):
        cont, out = str(tmp_path / f"{check}.hf2"), str(tmp_path / "o")
        t = StageTimer()
        with tracing(t):
            read_compress_write_hf2(src, cont, device="cpu", check=check,
                                    chunk_bytes=64 * 1024)
            read_decompress_write_hf2(cont, out, device="cpu", check=check,
                                      chunk_bytes=64 * 1024)
        assert open(out, "rb").read() == data.tobytes()
        if not check:
            assert calls == []
            assert all("crc_device_bytes" not in r.counters
                       for r in t.records)
    # 4 compress chunks of 64 KiB, the last short; 1 decode group
    assert calls == [65536, 65536, 65536, 200_000 - 3 * 65536, 200_000]


@pytest.mark.parametrize("case", ["blocks_256", "straddle"])
def test_hf2_flipped_byte_caught_before_its_group_is_written(tmp_path, case):
    """A flipped payload byte in the second decode group raises
    ``CorruptData``, and the output holds the first group alone.  At 256 B
    blocks the groups end on span boundaries; at 384 B (host writer, spans
    of 170 blocks) the group boundary cuts a span, whose head the second
    group's CRC is folded onto."""
    from tpuhuff_torch.io import stream as port_stream
    from tpuhuff_torch.io.host import read_compress_write_hf2_host

    block = 256 if case == "blocks_256" else 384
    n = 700_000 if case == "blocks_256" else 900_000
    src, data = _src(tmp_path, n, seed=14)
    cont = str(tmp_path / "c.hf2")
    if case == "blocks_256":
        read_compress_write_hf2(src, cont, device="cpu", block_len=block)
    else:
        read_compress_write_hf2_host(src, cont, block_len=block,
                                     max_code_len=32)
    chunk = 64 * 1024
    group = port_stream._group_blocks(block, chunk) * block
    span = (65536 // block) * block
    assert (group % span != 0) == (case == "straddle")
    out = str(tmp_path / "o")
    read_decompress_write_hf2(cont, out, device="cpu", chunk_bytes=chunk)
    assert open(out, "rb").read() == data.tobytes()  # no false alarm
    _flip_in_block(cont, group // block + 3)
    with pytest.raises(StreamError) as err:
        read_decompress_write_hf2(cont, out, device="cpu", chunk_bytes=chunk)
    assert err.value.kind == "CorruptData"
    assert open(out, "rb").read() == data[:group].tobytes()
