"""The port's tracer inside the ``.hf2`` file path: off by default, the
spans, counters and per-call records of a round trip when on, own time
under nesting, and the profiler ranges on the device trace's clock.

The cases marked ``cuda`` hold the bus counters to the copies' sizes on
the card and skip without one.  This file imports nothing of JAX or of
the JAX package, so it runs where JAX is not installed.
"""

import json

import numpy as np
import pytest
import torch

from tpuhuff_torch import profiling
from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2
from tpuhuff_torch.io.host import StreamError, read_compress_write_host
from tpuhuff_torch.io.hff import read_hf2_header
from tpuhuff_torch.io.stream import read_compress_write
from tpuhuff_torch.kernels import decoder_for
from tpuhuff_torch.profiling import StageTimer, tracing

# spans that every CPU round trip records; the card adds launch, pin_alloc,
# sync.fetch and (past two chunks) sync.slot
COMPRESS_SPANS = {"compress", "pass1", "tree", "prelude", "tables", "read",
                  "write", "pin_copy", "submit", "sync.result", "sync.counts",
                  "collect", "sink", "crc"}
DECOMPRESS_SPANS = {"decompress", "header", "tables", "read", "write",
                    "pin_copy", "submit", "sync.result", "collect", "crc"}
CUDA_SPANS = {"launch", "pin_alloc", "sync.fetch"}


def _data(n, seed=3):
    rng = np.random.default_rng(seed)
    text = b"spans and counters of the file path, 0123456789 "
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, n, n // 40)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


def _files(tmp_path, n):
    data = _data(n)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    return str(src), str(tmp_path / "c.hf2"), str(tmp_path / "out.bin"), data


def _round_trip(src, cont, out, device="cpu", **kw):
    read_compress_write_hf2(src, cont, device=device, **kw)
    read_decompress_write_hf2(cont, out, device=device, **kw)


def _header(path):
    """A container's header and the bytes of its block table and CRC
    column (the prelude writes both as zeros; each chunk then writes its
    slice of them again)."""
    with open(path, "rb") as fp:
        width = fp.read(6)[5]
        fp.seek(0)
        hdr = read_hf2_header(fp)
    crcs = 0 if hdr.crcs is None else 4 * hdr.crcs.size
    return hdr, width * hdr.num_blocks + crcs


def test_off_by_default_reads_no_clock_and_makes_no_range(tmp_path,
                                                          monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the tracer ran with no tracer active")

    monkeypatch.setattr(profiling, "_clock", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert profiling.active() is None
    src, cont, out, data = _files(tmp_path, 70_000)
    _round_trip(src, cont, out, chunk_bytes=1 << 15)
    assert open(out, "rb").read() == data.tobytes()
    hff = str(tmp_path / "c.hff")
    read_compress_write(src, hff, device="cpu")
    read_compress_write_host(src, str(tmp_path / "h.hff"))
    assert open(hff, "rb").read() == open(tmp_path / "h.hff", "rb").read()


@pytest.mark.parametrize("n,chunk", [(5_000, None), (70_000, 1 << 15),
                                     (300_000, None)])
def test_a_traced_round_trip(tmp_path, n, chunk):
    src, cont, out, data = _files(tmp_path, n)
    t = StageTimer()
    with tracing(t):
        _round_trip(src, cont, out, chunk_bytes=chunk)
    assert profiling.active() is None
    assert open(out, "rb").read() == data.tobytes()
    comp, dec = t.records
    assert (comp.id, comp.op, dec.id, dec.op) == (0, "compress",
                                                  1, "decompress")
    assert COMPRESS_SPANS <= set(comp.spans) <= COMPRESS_SPANS | CUDA_SPANS
    assert DECOMPRESS_SPANS <= set(dec.spans) <= DECOMPRESS_SPANS | CUDA_SPANS
    for rec in (comp, dec):
        assert rec.error is None
        own = sum(s.seconds for s in rec.spans.values())
        assert own == pytest.approx(rec.wall_s, abs=1e-3)
        assert all(s.seconds >= 0 for s in rec.spans.values())
    size = len(data)
    _, tables = _header(cont)
    assert comp.spans["read"].bytes == 2 * size  # pass 1, then pass 2
    container = (tmp_path / "c.hf2").stat().st_size
    assert comp.spans["write"].bytes == container + tables
    assert dec.spans["write"].bytes == size
    assert dec.spans["read"].bytes >= container
    # the syncs: the counts once, and one result wait a chunk or a group
    chunks = comp.spans["submit"].calls
    assert comp.spans["sync.counts"].calls == 1
    assert comp.spans["sync.result"].calls == chunks
    assert dec.spans["sync.result"].calls == dec.spans["submit"].calls
    assert comp.spans["tree"].calls == 2  # the length-limited tree, canonical
    # the timer's totals are the records' sums
    for name, s in t.stages.items():
        assert s.calls == sum(r.spans[name].calls for r in t.records
                              if name in r.spans)


def test_a_span_closes_when_its_body_raises(tmp_path):
    src, cont, out, _ = _files(tmp_path, 70_000)
    read_compress_write_hf2(src, cont, device="cpu")
    raw = bytearray(open(cont, "rb").read())
    raw[-100] ^= 0x20
    bad = tmp_path / "bad.hf2"
    bad.write_bytes(bytes(raw))
    t = StageTimer()
    with tracing(t), pytest.raises(StreamError) as err:
        read_decompress_write_hf2(str(bad), out, device="cpu")
    assert err.value.kind == "CorruptData"
    (rec,) = t.records
    assert rec.op == "decompress" and rec.error == "StreamError"
    assert rec.spans["crc"].calls >= 1
    assert t._inner == [] and t._call is None
    assert sum(s.seconds for s in rec.spans.values()) == pytest.approx(
        rec.wall_s, abs=1e-3)


def test_own_time_excludes_the_children(monkeypatch):
    # the clock's readings, in the order the spans below read it
    ticks = iter([0.0, 1.0, 2.0, 5.0, 6.0, 6.5, 7.0, 10.0])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    t = StageTimer()
    with t.stage("parent", 7):      # 0 .. 10
        with t.stage("child"):      # 1 .. 2
            pass
        with t.stage("child"):      # 5 .. 7
            with t.stage("leaf"):   # 6 .. 6.5
                pass
    assert t.stages["leaf"].seconds == pytest.approx(0.5)
    assert t.stages["child"].seconds == pytest.approx(1.0 + 1.5)
    assert t.stages["parent"].seconds == pytest.approx(10.0 - 1.0 - 2.0)
    assert (t.stages["parent"].bytes, t.stages["child"].calls) == (7, 2)
    assert t.order == ["child", "leaf", "parent"]
    assert t.records == []  # spans outside a call make no record


def test_counters_outside_a_call_and_nested_calls():
    t = StageTimer()
    t.count("h2d_bytes", 5)
    with t.call("compress"):
        t.count("h2d_bytes", 7)
        with t.call("decompress"):  # a file call inside another: a span
            t.count("d2h_bytes", 2)
    assert (t.counters["h2d_bytes"].n, t.counters["h2d_bytes"].calls) == (12, 2)
    (rec,) = t.records
    assert rec.op == "compress" and set(rec.spans) == {"compress",
                                                       "decompress"}
    assert {k: c.n for k, c in rec.counters.items()} == {"h2d_bytes": 7,
                                                         "d2h_bytes": 2}


def test_tracing_is_per_thread_and_restores():
    import threading

    t, seen = StageTimer(), []
    with tracing(t):
        th = threading.Thread(target=lambda: seen.append(profiling.active()))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with tracing(None):
            assert profiling.active() is None
        assert profiling.active() is t
    assert seen == [None] and profiling.active() is None


def test_ranges_share_the_profilers_clock(tmp_path):
    src, cont, out, _ = _files(tmp_path, 20_000)
    t = StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing(t):
            _round_trip(src, cont, out)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(
                  profiling.RANGE_PREFIX)]
    spans = {}
    for e in events:
        spans.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    (root,) = spans["tpuhuff:compress"]
    reads = [r for r in spans["tpuhuff:read"] if root[0] <= r[0] < root[1]]
    assert reads and all(hi <= root[1] for _, hi in reads)
    assert {"tpuhuff:" + n for n in COMPRESS_SPANS | DECOMPRESS_SPANS} \
        <= set(spans)


def test_no_range_while_no_profiler_records(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a range was made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    src, cont, out, data = _files(tmp_path, 20_000)
    t = StageTimer()
    with tracing(t):
        _round_trip(src, cont, out)
    assert open(out, "rb").read() == data.tobytes()
    assert [r.op for r in t.records] == ["compress", "decompress"]


def test_the_hff_writers_timer_records_its_stages(tmp_path):
    src, _, _, _ = _files(tmp_path, 50_000)
    t = StageTimer()
    read_compress_write(src, str(tmp_path / "c.hff"), device="cpu", timer=t)
    assert {"compress", "histogram", "tree", "prelude", "tables", "pack",
            "sink", "write", "read"} <= set(t.stages)
    assert [r.op for r in t.records] == ["compress"]
    assert profiling.active() is None
    host = StageTimer()
    read_compress_write_host(src, str(tmp_path / "h.hff"), timer=host)
    assert host.order == ["histogram", "write"]


# ------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the bus counters are read on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _table_tensor_bytes(tables):
    return sum(v.numel() * v.element_size() for v in vars(tables).values()
               if isinstance(v, torch.Tensor))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident", "two_pass"])
def test_bus_counters_match_the_copies(tmp_path, card, monkeypatch, route):
    from tpuhuff_torch.io import stream as port_stream

    if route == "two_pass":  # no room on the card: pass 2 reads again
        monkeypatch.setattr(port_stream, "_device_free_bytes", lambda dev: 0)
    n, block = 1_000_003, 256  # one chunk, one decode group
    src, cont, out, data = _files(tmp_path, n)
    t = StageTimer()
    with tracing(t):
        _round_trip(src, cont, out, device=card)
    assert open(out, "rb").read() == data.tobytes()
    comp, dec = t.records
    assert CUDA_SPANS <= set(comp.spans) and "launch" in dec.spans
    hdr, _ = _header(cont)
    B = hdr.num_blocks
    padded = B * block
    payload = -(-int(hdr.end_bits[-1]) // 8)
    enc_tables = 2 * 256 * 4  # lens and acodes, int32
    if route == "resident":
        # the file fits on the card: pass 1 copies it there once, and
        # pass 2 encodes from that copy, so no padded lanes cross the bus
        # a second time; then the encode tables
        assert comp.counters["resident_bytes"].n == n
        assert comp.counters["h2d_bytes"].n == n + enc_tables
        # pass 1's piece passes through a pinned buffer allocated anew
        assert comp.spans["pin_alloc"].bytes >= n
    else:
        # pass 1's piece, pass 2's padded lanes, the encode tables
        assert "resident_bytes" not in comp.counters
        assert comp.counters["h2d_bytes"].n == n + padded + enc_tables
        # pass 2's lanes pass through a pinned buffer allocated anew
        assert comp.spans["pin_alloc"].bytes >= padded
    spans = -(-n // 65536)  # the CRC column's spans, one uint32 each
    # block bit sums (int64), the missing count, the payload, the counts,
    # the CRCs
    assert comp.counters["d2h_bytes"].n == (8 * B + 8 + payload + 256 * 8
                                            + 4 * spans)
    _, tables = decoder_for(hdr.tree)
    # the payload, the blocks' bit counts (int32) and start bits (int64),
    # the decode tables
    assert dec.counters["h2d_bytes"].n == (payload + 4 * B + 8 * B
                                           + _table_tensor_bytes(tables))
    assert dec.counters["d2h_bytes"].n == B * block + 4 * spans
    # launches: K3, K1, S1, C1 in compress; S2, K2, C1 in decompress
    assert comp.spans["launch"].calls == 4
    assert dec.spans["launch"].calls == 3
    # the card took every byte's CRC, and no host CRC ran
    assert comp.counters["crc_device_bytes"].n == n
    assert dec.counters["crc_device_bytes"].n == n
    # the decoded output passes through a pinned buffer allocated anew
    assert dec.spans["pin_alloc"].bytes >= B * block


@pytest.mark.cuda
def test_traced_and_untraced_containers_are_identical(tmp_path, card):
    src, cont, out, data = _files(tmp_path, 3_000_000)
    plain = str(tmp_path / "plain.hf2")
    read_compress_write_hf2(src, plain, device=card, chunk_bytes=1 << 20)
    t = StageTimer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]), tracing(t):
        _round_trip(src, cont, out, device=card, chunk_bytes=1 << 20)
    assert open(cont, "rb").read() == open(plain, "rb").read()
    assert open(out, "rb").read() == data.tobytes()
    comp, dec = t.records
    # past two chunks, slots are reused: the host waits for their copies
    assert comp.spans["sync.slot"].calls > 0
    assert comp.spans["sync.fetch"].calls == comp.spans["submit"].calls
