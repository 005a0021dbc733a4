"""The CRC32 kernel C1 (``kernels.crc32_spans``, ``csrc/crc32.cu``) on the
CPU: its plain version against ``zlib.crc32`` and the host runtime's
``native.crc32_blocks``, its fold against ``io.crc.crc32_combine``, and
the kernel's body (``csrc/crc32_common.cuh``) built with ``g++`` and run
block by block, every thread's piece and the shuffle tree emulated in
order, against ``zlib.crc32``.

Shapes: span lengths 1, 255, 256, 300, 64 KiB and 1 MiB (whole pieces,
ragged pieces, pieces of one byte); valid lengths 0, 1, S - 1, S, S + 1
and 3 S + 7; heads 0, 1 and S - 1.  Tolerance: none, equal CRCs.  This
file imports nothing of JAX or of the JAX package.
"""

import ctypes
import re
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhuff_torch import native, profiling
from tpuhuff_torch.io.crc import crc32_combine
from tpuhuff_torch.kernels import crc as crc_mod
from tpuhuff_torch.kernels import crc32_spans, crc32_spans_reference

CSRC = Path(__file__).parent.parent / "tpuhuff_torch" / "csrc"
SPANS = [1, 255, 256, 300, 65536, 1 << 20]


def _shapes():
    for S in SPANS:
        for n in sorted({0, 1, S - 1, S, S + 1, 3 * S + 7}):
            for h in sorted({0, 1, S - 1}):
                if h <= n:
                    yield S, n, h


SHAPES = list(_shapes())


def _want(data: np.ndarray, n: int, span: int, head: int) -> np.ndarray:
    """zlib's CRCs of the head, then of each span."""
    out = [zlib.crc32(data[:head].tobytes())] if head else []
    out += [zlib.crc32(data[p:min(p + span, n)].tobytes())
            for p in range(head, n, span)]
    return np.array(out, dtype=np.uint32)


def _bytes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("span,n,head", SHAPES)
def test_plain_version_is_zlib_and_the_host_runtime(span, n, head):
    """Every segment's CRC is zlib's and, past the head, the host
    runtime's ``crc32_blocks`` over the same spans; bytes past ``n`` are
    not read."""
    data = _bytes(n + 9, span + n + head)
    got = crc32_spans(torch.from_numpy(data), n, span, head)
    assert got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    assert got.size == crc_mod.crc32_segments(n, span, head)
    assert np.array_equal(got, _want(data, n, span, head))
    body = native.crc32_blocks(data[head:n], span)
    assert np.array_equal(got[1 if head else 0:], body)


def _shift(v, nbytes):
    t = crc_mod.shift_tables(nbytes)
    v = np.asarray(v, dtype=np.uint32)
    return (t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF] ^ t[2][(v >> 16) & 0xFF]
            ^ t[3][v >> 24])


@pytest.mark.parametrize("length", [1, 255, 256, 300, 4096, 65280, 65536,
                                    1 << 20, 123_456_789])
def test_shift_tables_fold_as_crc32_combine(length):
    """The map of ``L`` zero bytes (the operator each fold level applies)
    on ``c1``, xor ``c2``, is ``crc32_combine(c1, c2, L)`` on random
    pairs, and joins two buffers' zlib CRCs."""
    rng = np.random.default_rng(length)
    c1, c2 = rng.integers(0, 1 << 32, (2, 16), dtype=np.uint64)
    got = _shift(c1, length) ^ c2.astype(np.uint32)
    want = [crc32_combine(int(a), int(b), length) for a, b in zip(c1, c2)]
    assert got.tolist() == want
    a, b = _bytes(length % 5000 + 1, 1), _bytes(length % 777 + 1, 2)
    assert (int(_shift(zlib.crc32(a.tobytes()), b.size))
            ^ zlib.crc32(b.tobytes())) == zlib.crc32((a.tobytes()
                                                      + b.tobytes()))


@pytest.mark.parametrize("block_len,blocks,last", [(256, 300, 17),
                                                   (65536, 3, 1000),
                                                   (384, 700, 383)])
def test_rows_with_a_short_last_block(block_len, blocks, last):
    """A decoder's (B, block_len) output, the last row short, read flat up
    to its valid bytes, at the span a ``.hf2`` container gives it."""
    span = max(1, 65536 // block_len) * block_len
    data = _bytes(blocks * block_len, block_len)
    rows = torch.from_numpy(data.copy()).view(blocks, block_len)
    n = (blocks - 1) * block_len + last
    got = crc32_spans(rows, n, span).numpy().view(np.uint32)
    assert np.array_equal(got, _want(data, n, span, 0))


@pytest.mark.parametrize("case", ["dtype", "strided", "head_past_span",
                                  "head_past_n", "n_past_tensor", "span"])
def test_arguments_are_checked(case):
    data = torch.zeros(1000, dtype=torch.uint8)
    args = {"dtype": (data.to(torch.int32), 10, 8, 0),
            "strided": (data.view(100, 10)[:, :5], 10, 8, 0),
            "head_past_span": (data, 100, 8, 9),
            "head_past_n": (data, 5, 8, 6),
            "n_past_tensor": (data, 1001, 8, 0),
            "span": (data, 10, 0, 0)}[case]
    with pytest.raises((TypeError, ValueError)):
        crc32_spans(*args)


def test_device_bytes_counted_and_no_launch_on_the_cpu():
    """The tracer counts the bytes in ``crc_device_bytes``; a CPU tensor
    runs the plain version and launches nothing."""
    before = (crc32_spans.launches, crc32_spans.bytes)
    t = profiling.StageTimer()
    with profiling.tracing(t):
        with profiling.call("decompress"):
            crc32_spans(torch.from_numpy(_bytes(5000, 3)), 4999, 1000, 7)
    assert t.records[0].counters["crc_device_bytes"].n == 4999
    assert (crc32_spans.launches, crc32_spans.bytes) == before


def test_source_note_and_counters():
    """C1's source says that it replaces no TPU kernel and why it exists,
    and the wrapper counts its launches and bytes."""
    text = " ".join(open(CSRC / "crc32.cu", encoding="utf-8").read().split())
    assert re.search(r"__global__", text)
    assert "Replaces no TPU kernel" in text
    assert isinstance(crc32_spans.launches, int)
    assert isinstance(crc32_spans.bytes, int)


def test_tables_match_the_kernel_constants():
    """The Python side's piece count and levels are the header's."""
    text = open(CSRC / "crc32_common.cuh", encoding="utf-8").read()
    assert f"kPieces = {crc_mod.PIECES};" in text
    assert f"kLevels = {crc_mod.LEVELS};" in text
    assert crc_mod.PIECES == 1 << crc_mod.LEVELS


HARNESS = r"""
#include <cstdint>
#include <vector>

#include "crc32_common.cuh"

using namespace tpuhuff_crc;

// The kernel, block by block: every thread's piece, then the shuffle tree
// (__shfl_down_sync: a lane past the warp's end reads its own value),
// levels 0-4 in each warp, 5-7 in the first warp over the warps' values.
static void shfl_level(std::vector<uint32_t>& v, int lanes, int delta,
                       const Args& a, int k) {
  std::vector<uint32_t> right(lanes);
  for (int l = 0; l < lanes; ++l) right[l] = (l % 32) + delta < 32 ? v[l + delta] : v[l];
  for (int l = 0; l < lanes; ++l) v[l] = shift(a.fold, k, v[l]) ^ right[l];
}

extern "C" int run_crc(const uint8_t* data, int64_t n, int64_t span, int64_t head,
                       int64_t piece, int nseg, uint32_t k_span, uint32_t k_head,
                       uint32_t k_last, const uint32_t* slices, const uint32_t* fold,
                       uint32_t* out) {
  Args a{data, n, span, head, piece, nseg, k_span, k_head, k_last, fold, out};
  for (int j = 0; j < nseg; ++j) {
    int64_t start = 0, len = 0;
    segment(a, j, start, len);
    std::vector<uint32_t> v(kPieces);
    for (int t = 0; t < kPieces; ++t) v[t] = piece_crc(a, start, len, t, slices);
    for (int w = 0; w < kPieces / 32; ++w) {
      std::vector<uint32_t> lane(v.begin() + 32 * w, v.begin() + 32 * w + 32);
      for (int k = 0; k < 5; ++k) shfl_level(lane, 32, 1 << k, a, k);
      v[w] = lane[0];
    }
    std::vector<uint32_t> lane(32, 0u);
    for (int w = 0; w < kPieces / 32; ++w) lane[w] = v[w];
    for (int k = 5; k < kLevels; ++k) shfl_level(lane, 32, 1 << (k - 5), a, k);
    out[j] = lane[0] ^ zeros_crc(a, j, len);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    """``run(data, n, span, head) -> CRCs`` of the kernel's body built
    with g++ (under UBSan where it builds and loads), or a skip without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernel's body is built with it")
    d = tmp_path_factory.mktemp("crc_body")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = None
    for k, extra in enumerate((["-fsanitize=undefined",
                                "-fno-sanitize-recover=undefined"], [])):
        lib = d / f"libcrc{k}.so"
        proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                               *extra, f"-I{CSRC}", str(src), "-o", str(lib)],
                              capture_output=True, text=True)
        try:
            if proc.returncode == 0:
                so = ctypes.CDLL(str(lib))
                break
        except OSError:
            continue
    assert so is not None, proc.stderr
    fn = so.run_crc
    P, L, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [P, L, L, L, L, I, U, U, U, P, P, P]
    slices = np.ascontiguousarray(crc_mod.slice_tables())

    def run(data: np.ndarray, n: int, span: int, head: int) -> np.ndarray:
        flat, nseg, piece, consts = crc_mod._plan(torch.from_numpy(data), n,
                                                  span, head)
        fold = np.ascontiguousarray(crc_mod._fold_tables(piece))
        out = np.zeros(max(nseg, 1), dtype=np.uint32)
        fn(data.ctypes.data, n, span, head, piece, nseg, *consts,
           slices.ctypes.data, fold.ctypes.data, out.ctypes.data)
        return out[:nseg]

    return run


@pytest.mark.parametrize("span,n,head", [s for s in SHAPES
                                         if s[0] < (1 << 20)])
@pytest.mark.parametrize("offset", [0, 5])
def test_kernel_body_is_zlib(body, span, n, head, offset):
    """The body at every shape but the 1 MiB spans, on data at a 16-byte
    boundary and 5 bytes past one (the unaligned head of a piece)."""
    buf = _bytes(n + offset + 16, n + span + head)
    data = buf[offset:offset + n + 1]
    got = body(data, n, span, head)
    assert np.array_equal(got, _want(data, n, span, head))


def test_kernel_body_at_the_cells_shape(body):
    """Four 64 KiB spans and a short fifth, the cells' span, the twin's
    result too."""
    data = _bytes(4 * 65536 + 12_345, 77)
    got = body(data, data.size, 65536, 0)
    assert np.array_equal(got, native.crc32_blocks(data, 65536))
    twin = crc32_spans_reference(torch.from_numpy(data), data.size, 65536)
    assert np.array_equal(twin.numpy().view(np.uint32), got)
