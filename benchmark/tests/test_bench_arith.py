"""The metric arithmetic on hand-made samples."""

import math
import struct

import pytest

import devtrace
import harness


def _run(calls, window_s=2.0, trace=None, kind="NVIDIA H100 80GB HBM3"):
    cell = harness.Cell("c", 1, {}, {"op": "compress"}, [], [])
    run = harness.Run(cell, "cuda", calls=calls, window_s=window_s)
    run.trace, run.traced_calls, run.device_kind = trace, calls, kind
    return run


def test_window_rate_and_ratio():
    calls = [harness.Call("compress", 0, 0.0, 0.5, 10**9, 6 * 10**8),
             harness.Call("compress", 1, 0.5, 2.0, 10**9, 5 * 10**8)]
    run = _run(calls, window_s=2.0)
    assert harness.load_metric("compress_GBps").value(run) == pytest.approx(1.0)
    assert harness.load_metric("stored_ratio").value(run) == pytest.approx(0.55)


def test_p95_nearest_rank_and_count():
    calls = []
    for i in range(1, 101):  # object i takes i ms to compress and 1 ms back
        calls.append(harness.Call("compress", i, 0, i / 1e3, 1, 1))
        calls.append(harness.Call("decompress", i, 0, 1 / 1e3, 1, 1))
    run = _run(calls)
    assert harness.load_metric("roundtrip_p95_ms").value(run) == pytest.approx(96)
    assert run.notes == ["roundtrip samples: 100"]
    p50 = harness.load_metric("roundtrip_p50_ms.roundtrip").value(run)
    assert p50 == pytest.approx(51)
    assert harness.percentile([5.0], 95) == 5.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_union_and_idle_gaps():
    events = [
        _ev("user_annotation", "bench:window", 0, 100),
        _ev("user_annotation", "bench:read", 0, 30),
        _ev("user_annotation", "bench:write", 60, 30),
        _ev("kernel", "void hist256_kernel(unsigned char const*, long)", 30, 10),
        _ev("kernel", "void ns::encode_tiles<4>(Params)", 35, 10),   # overlaps
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 50, 5),
        _ev("kernel", "void decode_rows_kernel<Ladder, 1>(Params)", 200, 5),
    ]
    tr = devtrace.read(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(20e-6)   # [30, 45) and [50, 55)
    assert tr.kernel_s == pytest.approx({"hist256_kernel": 10e-6,
                                         "encode_tiles": 10e-6})
    assert tr.ops["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(5e-6)
    # idle: [0, 30) in read, [45, 50) and [55, 60) in the window alone,
    # [60, 90) in write, [90, 100) in the window alone
    assert tr.gaps == pytest.approx({"read": 30e-6, "write": 30e-6,
                                     "harness, between calls": 20e-6})
    assert devtrace.top(tr.gaps, 2) == [["read", 30e-6], ["write", 30e-6]]


def test_no_device_events_reads_nothing():
    tr = devtrace.read([_ev("user_annotation", "bench:window", 0, 100)])
    assert tr.busy_s is None
    run = _run([], trace=tr)
    assert harness.idle_pct(run) is None
    assert "no device time" in run.nulls["_"]
    assert devtrace.read([]) is None


def test_rooflines_count_bytes_from_sizes():
    gib = 1 << 30
    calls = [harness.Call("compress", 0, 0, 1, gib, gib // 2,
                          payload_bytes=gib // 2 - 1000, table_bytes=1000)]
    tr = devtrace.Trace(window_s=1.0, busy_s=0.01,
                        kernel_s={"hist256_kernel": 1e-3, "encode_tiles": 2e-3,
                                  "stitch_kernel": 1e-3})
    run = _run(calls, trace=tr)
    hist = harness.load_metric("hist_roofline.compress").value(run)
    enc = harness.load_metric("encode_roofline.compress").value(run)
    assert hist == pytest.approx(100 * gib / 3.35e12 / 1e-3)
    assert enc == pytest.approx(100 * (gib + gib // 2) / 3.35e12 / 3e-3)
    assert harness.load_metric("device_idle_pct.compress").value(run) == \
        pytest.approx(99.0)


def test_roofline_is_null_without_its_kernels_or_peak():
    calls = [harness.Call("compress", 0, 0, 1, 100, 50)]
    tr = devtrace.Trace(window_s=1.0, busy_s=0.5, kernel_s={"other": 1.0})
    run = _run(calls, trace=tr)
    assert harness.load_metric("hist_roofline.compress").value(run) is None
    assert "hist256_kernel" in run.nulls["_"]
    tr.kernel_s = {"hist256_kernel": 1.0}
    run = _run(calls, trace=tr, kind="some other card")
    assert harness.load_metric("hist_roofline.compress").value(run) is None


def test_prelude_bytes():
    head = (b"HF2\x02" + bytes([3, 2]) + struct.pack(">IBQII", 40, 3, 1000,
                                                       256, 4)
            + struct.pack(">I", 256))
    assert harness.prelude_bytes(head) == (31 + 2 * 4 + 4 * 1 + 40, 8)
    assert math.isclose(harness.GIB, 2**30)
