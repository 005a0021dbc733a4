"""The encode kernel's per-lane arithmetic (``csrc/encode_common.cuh``) on
the CPU, against the plain PyTorch version.

The header's lane body is compiled with ``g++`` (CUDA's qualifiers defined
away) into a small library that runs it for the 32 threads of a warp, one
``std::thread`` each, with the warp's shuffles emulated over a barrier and
CUDA's ``width`` segments: the same code the kernel runs, lookup, scan,
packing and the edge words' ORs, lane by lane as
K1 and K5 take them (P bytes per thread, 32 * P / N lanes to a warp), into
rows that start zeroed as the kernel's output tile does.  It is built at
the header's bytes per thread and at the other values
``experiments/encode_sweep.py`` builds.  The kernel's tiles, copies and launch, and that it writes every
word, are checked on the card only (``tests/test_torch_cuda.py``).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.kernels import encode_blocks_reference, make_encode_tables
from tpuhuff_torch.kernels.encode import as_u32, out_words

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "tpuhuff_torch",
                    "csrc")

HARNESS = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "encode_common.cuh"

#include <algorithm>
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>

using namespace tpuhuff_encode;

// The warp's shuffles: each thread publishes its value, all wait, each
// reads its source lane's, all wait again.  sync() is a barrier, and the
// shared atomicOr an atomic fetch_or.
struct Exchange {
  std::barrier<> bar{32};
  uint32_t v[32];
};

struct HostWarp {
  Exchange* x;
  int lane;   // 0..31 in the warp
  int width;  // segment of the shuffles, as CUDA's width argument
  uint32_t get(uint32_t v, int src) const {
    x->v[lane] = v;
    x->bar.arrive_and_wait();
    const uint32_t r = x->v[src];
    x->bar.arrive_and_wait();
    return r;
  }
  int base() const { return lane & ~(width - 1); }
  int rel() const { return lane & (width - 1); }
  uint32_t up(uint32_t v, int d) const {
    const int r = rel() - d;
    return get(v, r >= 0 ? base() + r : lane);
  }
  uint32_t idx(uint32_t v, int src) const {
    return get(v, base() + (src & (width - 1)));
  }
  void sync() const { x->bar.arrive_and_wait(); }
  void or_into(uint32_t* p, uint32_t v) const {
    std::atomic_ref<uint32_t>(*p).fetch_or(v);
  }
};

template <int P>
void run(const uint8_t* data, const int32_t* valid, const Table& table,
         uint32_t* words, int32_t* bits, int32_t* miss, int B, int N, int R,
         int64_t n_hist, int64_t* hist) {
  const int S = N / P;
  const int G = 32 / S;
  // the rows start zeroed, as the kernel's output tile does
  std::fill(words, words + static_cast<int64_t>(B) * R, 0u);
  Exchange x;
  std::vector<std::vector<int64_t>> counts(32, std::vector<int64_t>(256));
  std::vector<std::thread> threads;
  for (int t = 0; t < 32; ++t) {
    threads.emplace_back([&, t] {
      const HostWarp warp{&x, t, S};
      const int s = t & (S - 1), g = t / S;
      for (int base = 0; base < B; base += G) {  // one warp step per G lanes
        const int lane = base + g;
        const bool active = lane < B;
        Bytes<P> b{};
        int nvalid = 0;
        if (active) {
          const uint8_t* src = data + static_cast<int64_t>(lane) * N + s * P;
          for (int i = 0; i < P; ++i) b.w[i >> 2] |= uint32_t(src[i]) << (8 * (i & 3));
          const int left = valid[lane] - s * P;
          nvalid = left < 0 ? 0 : left > P ? P : left;
          count_held<P>(b, static_cast<int64_t>(lane) * N + s * P, n_hist,
                        [&](uint32_t v) { ++counts[t][v]; });
        }
        uint32_t total, nmiss;
        encode_lane<P>(warp, s, S, b, nvalid, table,
                       words + static_cast<int64_t>(active ? lane : 0) * R,
                       active, total, nmiss);
        if (active && s == 0) {
          bits[lane] = static_cast<int32_t>(total);
          miss[lane] = static_cast<int32_t>(nmiss);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < 32; ++t)
    for (int v = 0; v < 256; ++v) hist[v] += counts[t][v];
}

extern "C" int encode_lanes_emulated(const uint8_t* data, const int32_t* valid,
                                     const int32_t* lens, const uint32_t* acodes,
                                     uint32_t* words, int32_t* bits, int32_t* miss,
                                     int B, int N, int R, long long n_hist,
                                     int64_t* hist) {
  // both layouts, as the kernel builds them; the narrow one where it fits
  Code wide[kTableEntries];
  uint32_t narrow[kTableEntries];
  bool is_wide = false;
  for (int i = 0; i < 256; ++i) {
    const uint32_t len = static_cast<uint32_t>(lens[i]);
    const uint32_t acode = len ? acodes[i] : 0u;
    wide[i] = Code{acode, len};
    narrow[i] = narrow_entry(acode, len);
    is_wide |= len > kNarrowMaxLen;
  }
  wide[kNoByte] = Code{0u, 0u};
  narrow[kNoByte] = kNarrowNoByte;
  const Table table{narrow, wide, is_wide};
  switch (bytes_per_thread(N)) {
    case 1: run<1>(data, valid, table, words, bits, miss, B, N, R, n_hist, hist); return 0;
    case 2: run<2>(data, valid, table, words, bits, miss, B, N, R, n_hist, hist); return 0;
    case 4: run<4>(data, valid, table, words, bits, miss, B, N, R, n_hist, hist); return 0;
    case 8: run<8>(data, valid, table, words, bits, miss, B, N, R, n_hist, hist); return 0;
    case 16: run<16>(data, valid, table, words, bits, miss, B, N, R, n_hist, hist); return 0;
    case 32: run<32>(data, valid, table, words, bits, miss, B, N, R, n_hist, hist); return 0;
  }
  return 1;
}
"""


@pytest.fixture(scope="module", params=["default", 8, 32])
def emulated(request, tmp_path_factory):
    """The lane body built for the CPU at one number of bytes per thread,
    or a skip where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the lane body cannot be built")
    tmp = tmp_path_factory.mktemp("encode_pack")
    src, lib = tmp / "harness.cpp", tmp / "harness.so"
    src.write_text(HARNESS)
    per_thread = ([] if request.param == "default" else
                  [f"-DTPUHUFF_ENCODE_BYTES_PER_THREAD={request.param}"])
    subprocess.run([gxx, "-std=c++20", "-O1", "-g", "-fPIC", "-shared",
                    "-pthread", "-Wall", "-Wno-unknown-pragmas", "-Werror",
                    *per_thread, "-I", CSRC, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).encode_lanes_emulated
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fib_counts():
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    return counts


def _case(tree_kind, N, rng):
    """(lanes, valid, tables) for B lanes of N bytes under one tree."""
    B = max(8, 3000 // N)
    B += 1 if N < 32 else 0  # a warp step with lanes past the last
    if tree_kind == "textlike":
        data = (rng.zipf(1.3, (B, N)) % 90 + 30).astype(np.uint8)
        counts = np.bincount(data.reshape(-1), minlength=256)
    elif tree_kind == "one_bit":  # two letters: every code is 1 bit
        data = rng.integers(97, 99, (B, N), dtype=np.uint8)
        counts = np.bincount(data.reshape(-1), minlength=256)
    elif tree_kind == "fib32":  # 32-bit codes (the wide table), and missing
        data = rng.integers(0, 12, (B, N), dtype=np.uint8)
        data[::3] = 0  # the 32-bit codes
        data[1::4, : max(1, N // 3)] = 200  # no code
        counts = _fib_counts()
    else:  # missing letters: runs of bytes the tree has no code for
        data = rng.integers(97, 99, (B, N), dtype=np.uint8)
        counts = np.bincount(data.reshape(-1), minlength=256)
        data[::2, N // 4: N // 2] = 250
        data[1::3, : max(1, N // 8)] = 251
    tree = canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])
    tables = make_encode_tables(*tree.encode_tables())
    valid = rng.integers(0, N + 1, B).astype(np.int32)
    valid[0], valid[1], valid[-1] = N, 0, max(1, N // 2)
    return data, valid, tables


@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32, 256, 1024])
@pytest.mark.parametrize("tree_kind", ["textlike", "one_bit", "fib32", "missing"])
def test_lane_body_matches_plain(emulated, tree_kind, N):
    """Words, bit counts and missing counts of the kernel's lane body equal
    the plain version's, on ragged lanes; K5's count of the bytes held
    equals ``np.bincount`` of an odd-length prefix of the lanes."""
    rng = np.random.default_rng(N * 11 + len(tree_kind))
    data, valid, tables = _case(tree_kind, N, rng)
    B = data.shape[0]
    R = out_words(N, tables.max_len)
    if tree_kind == "fib32":
        assert tables.max_len == 32
    if tree_kind == "one_bit":
        assert tables.max_len == 1
    words = np.full((B, R), 0xFFFFFFFF, dtype=np.uint32)
    bits = np.full(B, -1, dtype=np.int32)
    miss = np.full(B, -1, dtype=np.int32)
    hist = np.zeros(256, dtype=np.int64)
    n_hist = (B * N - N // 2 - 1) | 1  # odd, and short of the lanes' end
    lens = tables.lens.numpy()
    acodes = tables.acodes.numpy()
    err = emulated(data.ctypes.data, valid.ctypes.data, lens.ctypes.data,
                   acodes.ctypes.data, words.ctypes.data, bits.ctypes.data,
                   miss.ctypes.data, B, N, R, n_hist, hist.ctypes.data)
    assert err == 0
    want_words, want_bits, want_miss = encode_blocks_reference(
        torch.from_numpy(data), torch.from_numpy(valid), tables)
    assert np.array_equal(words, as_u32(want_words))
    assert np.array_equal(bits, want_bits.numpy())
    assert np.array_equal(miss, want_miss.numpy())
    assert (miss.sum() > 0) == (tree_kind in ("missing", "fib32"))
    assert np.array_equal(hist, np.bincount(data.reshape(-1)[:n_hist],
                                            minlength=256))
