"""The device row gather S2 (``kernels.lane_rows``, ``csrc/lane_rows.cu``)
on the CPU, against the JAX package's host gather.

``lane_rows_reference`` (what ``lane_rows`` runs on CPU tensors) must give
the rows and ``bit0`` of :func:`tpuhuff.kernels.decode.payload_to_lane_words`
on the same payload and block offsets: blocks at unaligned bit offsets,
payloads of every length mod 4, the last block ending at the payload's end
(its slack words read as 0), and blocks of 0 bits.  The kernel's body
(``csrc/lane_rows_common.cuh``) is compiled with ``g++`` (CUDA's
qualifiers defined away) and run on ``std::thread``s, each a CUDA thread
of the kernel's grid-stride loop, on an aligned payload and on one a byte
off (the body's byte-wise route), and must equal the plain version.
Tolerance: none, equal words.  The JAX package is imported where it is
used, so that the card's tests (``tests/test_torch_cuda.py``) can import
the cases.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhuff_torch.kernels import lane_rows, lane_rows_reference, row_width

CSRC = Path(__file__).parent.parent / "tpuhuff_torch" / "csrc"

HARNESS = r"""
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
#include "lane_rows_common.cuh"

using namespace tpuhuff_rows;

// The kernel's grid as T threads of its grid-stride loop.
extern "C" int run_rows(const uint8_t* payload, long long n, const int64_t* start_bits,
                        uint32_t* rows, int32_t* bit0, int B, int W, int T) {
  const Args a{payload, n, start_bits, rows, bit0, B, W,
               reinterpret_cast<uintptr_t>(payload) % 4 == 0};
  const uint32_t total = static_cast<uint32_t>(B) * static_cast<uint32_t>(W);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t)
    threads.emplace_back([&, t] {
      for (uint32_t i = t; i < total; i += T) row_word(a, i);
    });
  for (auto& th : threads) th.join();
  return 0;
}
"""

THREADS = [1, 5, 32]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """``run(payload, start_bits, end_bits, T, offset) -> (rows, bit0)`` of
    the body built with g++ (the payload placed ``offset`` bytes past a
    16-byte boundary), or a skip where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the row body cannot be built")
    tmp = tmp_path_factory.mktemp("lane_rows")
    src, lib = tmp / "harness.cpp", tmp / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-Wall", "-Werror", "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.run_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    so.run_rows.restype = ctypes.c_int

    def run(payload, start_bits, end_bits, T, offset=0):
        starts = np.asarray(start_bits, dtype=np.int64)
        ends = np.asarray(end_bits, dtype=np.int64)
        W = int(np.max((ends + 31) // 32 - starts // 32 + 1, initial=1)) + 1
        raw = np.asarray(payload, dtype=np.uint8)
        store = np.zeros(raw.size + 32, dtype=np.uint8)
        base = (-store.ctypes.data) % 16 + offset
        store[base: base + raw.size] = raw
        view = store[base: base + raw.size]
        rows = np.full((starts.size, W), 0xA5A5A5A5, dtype=np.uint32)
        bit0 = np.full(starts.size, -1, dtype=np.int32)
        assert so.run_rows(view.ctypes.data, raw.size, starts.ctypes.data,
                           rows.ctypes.data, bit0.ctypes.data, starts.size,
                           W, T) == 0
        return rows, bit0

    return run


def blocks_case(n_bytes: int, seed: int):
    """``(payload, start_bits, end_bits)``: blocks of random bit lengths
    (some 0) that tile the payload's bits, the last ending at its end."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    total = 8 * n_bytes - int(rng.integers(0, 8)) if n_bytes else 0
    lens = rng.integers(0, 300, 400)
    lens[::11] = 0
    ends = np.minimum(np.cumsum(lens), total)
    ends = ends[: int(np.searchsorted(ends, total)) + 1]
    ends[-1] = total
    starts = np.concatenate([[0], ends[:-1]])
    return payload, starts.astype(np.int64), ends.astype(np.int64)


CASES = [(n, seed) for seed, n in enumerate([1, 2, 3, 4, 5, 6, 7, 4096,
                                             4097, 4098, 4099, 3001])]


@pytest.mark.parametrize("n_bytes,seed", CASES)
def test_reference_equals_payload_to_lane_words(n_bytes, seed):
    from tpuhuff.kernels.decode import payload_to_lane_words as jax_lane_words

    payload, starts, ends = blocks_case(n_bytes, seed)
    want_rows, want_bit0 = jax_lane_words(payload, starts, ends, 256)
    width = row_width(starts, ends)
    rows, bit0 = lane_rows_reference(torch.from_numpy(payload),
                                     torch.from_numpy(starts), width)
    assert rows.numpy().view(np.uint32).shape == want_rows.shape
    assert np.array_equal(rows.numpy().view(np.uint32), want_rows)
    assert np.array_equal(bit0.numpy(), want_bit0)
    # the CPU wrapper
    got = lane_rows(torch.from_numpy(payload), torch.from_numpy(starts),
                    width)
    assert got[0].equal(rows) and got[1].equal(bit0)


def test_offsets_inside_a_larger_payload():
    """Blocks that cover only the middle of the payload: rows past the
    last block read the payload's words that follow, as the host gather's
    do, and the slack words past its end read 0."""
    from tpuhuff.kernels.decode import payload_to_lane_words as jax_lane_words

    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 1001, dtype=np.uint8)
    starts = np.array([13, 77, 4000, 7990], dtype=np.int64)
    ends = np.array([77, 700, 4001, 8008], dtype=np.int64)
    want_rows, want_bit0 = jax_lane_words(payload, starts, ends, 256)
    rows, bit0 = lane_rows_reference(torch.from_numpy(payload),
                                     torch.from_numpy(starts),
                                     row_width(starts, ends))
    assert np.array_equal(rows.numpy().view(np.uint32), want_rows)
    assert np.array_equal(bit0.numpy(), want_bit0)


def test_starts_on_another_device_than_the_payload_are_refused():
    """The kernel reads the starts where the payload lies: starts on
    another device raise, and so do starts of another dtype."""
    payload = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        lane_rows(payload, torch.zeros(1, dtype=torch.int64, device="meta"), 2)
    with pytest.raises(TypeError):
        lane_rows(payload, torch.zeros(1, dtype=torch.int32), 2)


@pytest.mark.parametrize("start_bits,end_bits", [
    ([0, 5], [5]),    # one end short
    ([-1], [7]),      # a negative offset
])
def test_row_width_refuses_bad_offsets(start_bits, end_bits):
    with pytest.raises(ValueError):
        row_width(np.array(start_bits), np.array(end_bits))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("T", THREADS)
def test_body_under_gxx_equals_reference(harness, T, offset):
    for n_bytes, seed in CASES:
        payload, starts, ends = blocks_case(n_bytes, seed + 50)
        rows, bit0 = harness(payload, starts, ends, T, offset)
        want_rows, want_bit0 = lane_rows_reference(
            torch.from_numpy(payload), torch.from_numpy(starts),
            row_width(starts, ends))
        assert np.array_equal(rows, want_rows.numpy().view(np.uint32)), n_bytes
        assert np.array_equal(bit0, want_bit0.numpy()), n_bytes
