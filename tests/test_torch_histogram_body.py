"""The histogram kernel's body (``csrc/histogram_common.cuh``) on the CPU,
against ``numpy.bincount`` and the JAX package's histograms.

The header's block body (the counters cleared, each thread's share of the
16-byte vectors loaded a step ahead and counted into its column of
``uint16_t`` counters, the unaligned head and the ragged tail one byte per
thread, the folds into per-block totals) is compiled with ``g++`` (CUDA's
qualifiers defined away) into a small library that runs a launch's thread
blocks one after another on ``kThreads`` ``std::thread``s, one per CUDA
thread, with a ``std::barrier`` for ``__syncthreads`` (and
``std::atomic_ref`` for the shared ``atomicAdd``), and adds each
block's totals into the counts as the kernel's epilogue does.  The grid is
the kernel's rule (``grid_for`` in ``csrc/histogram.cu``) for a card that
holds ``RESIDENT`` blocks at once.  The launch itself, its shared memory
and its atomics are checked on the card only (``tests/test_torch_cuda.py``).
Tolerance: none, counts are integers and must be equal.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import HIST_KINDS, make_hist_input
from tpuhuff.kernels.histogram import histogram as jax_histogram
from tpuhuff.kernels.pallas_histogram import histogram_pallas

from tpuhuff_torch.kernels import histogram

CSRC = Path(__file__).parent.parent / "tpuhuff_torch" / "csrc"
RESIDENT = 2  # blocks the emulated card holds at once


def _constant(name: str) -> int:
    text = (CSRC / "histogram_common.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


THREADS = _constant("kThreads")
VECS = _constant("kVecsPerStep")
STEP = 16 * VECS * THREADS  # bytes of one step of a block
FOLD = STEP * ((65535 - 2) // (16 * VECS))  # bytes of a block between folds
# sizes at the edges of the body's periods, each +-1: 255 bytes per
# thread, one step of each block of a resident grid, one fold of one
# block (the most a counter may take between folds) and one fold of each
# block of a resident grid
SIZES = [1, 15, 16, 17] + [e + d for e in (
    255 * THREADS, RESIDENT * STEP, FOLD, RESIDENT * FOLD) for d in (-1, 0, 1)]

HARNESS = r"""
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
#include "histogram_common.cuh"

using namespace tpuhuff_hist;

struct HostBlock {
  int tid;
  std::barrier<>* bar;
  void sync() const { bar->arrive_and_wait(); }
};

extern "C" void hist_columns(uint32_t* out) {
  for (int t = 0; t < kThreads; ++t) out[t] = column(t);
}

extern "C" void hist_constants(int* c) {
  c[0] = kThreads;
  c[1] = kVecsPerStep;
  c[2] = Counters::kFoldSteps;
  c[3] = Counters::kSmemBytes;
}

// Blocks 0 .. grid-1 of a launch over data[0:n], one after another (each
// with its own shared memory); out[v] += each block's count of v.
extern "C" void hist_emulated(const uint8_t* data, long long n, int grid,
                              uint64_t* out) {
  std::vector<std::unique_ptr<Vec16[]>> smem;
  for (int b = 0; b < grid; ++b)
    smem.emplace_back(new Vec16[Counters::kSmemBytes / 16]);
  std::vector<uint64_t> totals(static_cast<size_t>(grid) * kThreads);
  std::barrier<> bar(kThreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([&, t] {
      const HostBlock blk{t, &bar};
      for (int b = 0; b < grid; ++b)
        totals[static_cast<size_t>(b) * kThreads + t] = count_block(
            data, n, b, grid, reinterpret_cast<uint8_t*>(smem[b].get()), blk);
    });
  }
  for (auto& th : threads) th.join();
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < kThreads; ++t) out[t] += totals[static_cast<size_t>(b) * kThreads + t];
}
"""


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    """The body built for the CPU: (hist_emulated, (threads, vectors per
    step, steps per fold, shared bytes), each thread's column), or a skip
    where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the body cannot be built")
    tmp = tmp_path_factory.mktemp("histogram_body")
    src, lib = tmp / "harness.cpp", tmp / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-g", "-fPIC", "-shared",
                    "-pthread", "-fno-strict-aliasing", "-Wall",
                    "-Wno-unknown-pragmas", "-Werror", "-I", str(CSRC),
                    "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(lib))
    handle.hist_emulated.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]
    handle.hist_emulated.restype = None
    consts = (ctypes.c_int * 4)()
    handle.hist_constants(consts)
    columns = np.zeros(consts[0], dtype=np.uint32)
    handle.hist_columns(ctypes.c_void_p(columns.ctypes.data))
    return handle.hist_emulated, tuple(consts), columns


def run(body, data: np.ndarray, offset: int) -> np.ndarray:
    """The emulated launch over ``data`` placed ``offset`` bytes past a
    16-byte boundary, with the kernel's grid rule."""
    fn = body[0]
    buf = np.zeros(data.size + 32, dtype=np.uint8)
    start = (-buf.ctypes.data) % 16 + offset
    view = buf[start: start + data.size]
    view[:] = data
    assert view.ctypes.data % 16 == offset
    grid = min(RESIDENT, max(1, -(-data.size // STEP)))
    out = np.zeros(256, dtype=np.uint64)
    fn(view.ctypes.data, data.size, grid, out.ctypes.data)
    return out.astype(np.int64)


def test_constants_as_built(body):
    threads, vecs, fold_steps, smem = body[1]
    assert (threads, 16 * vecs * threads, 16 * vecs * threads * fold_steps,
            smem) == (THREADS, STEP, FOLD, 2 * 256 * THREADS)
    assert len(set(SIZES)) == len(SIZES)


def test_columns_are_conflict_free(body):
    """Every thread owns its own half-word of each bin's row, and the 32
    threads of a warp reach 32 distinct banks (4-byte words modulo 32) in
    any row, whatever bins they count (a row is 2 * THREADS bytes, a
    multiple of 128); the two threads of a word are in two warps."""
    columns = body[2].astype(np.int64)
    assert sorted(columns) == list(range(THREADS))
    assert (2 * THREADS) % 128 == 0
    for warp in columns.reshape(-1, 32):
        assert len(set((warp // 2) % 32)) == 32
    warps = np.arange(THREADS) // 32
    for word in range(THREADS // 2):
        a, b = np.flatnonzero(columns // 2 == word)
        assert warps[a] != warps[b]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", HIST_KINDS)
def test_body_matches_bincount_and_jax(body, kind, n):
    """Every size at the periods' edges, every input kind, at a start 3
    bytes past a 16-byte boundary (and at 0 for the larger sizes)."""
    data = make_hist_input(kind, n, np, seed=n)
    want = np.bincount(data, minlength=256)
    for offset in ((3, 0) if 4096 < n < FOLD else (3,)):
        assert np.array_equal(run(body, data, offset), want)
    assert np.array_equal(np.asarray(jax_histogram(jnp.asarray(data))), want)


@pytest.mark.parametrize("offset", range(16))
def test_body_unaligned_heads(body, offset):
    """Every start offset, every kind: heads of 0-15 bytes, with tails of
    every length among them."""
    n = RESIDENT * STEP + 37 + offset
    for kind in HIST_KINDS:
        data = make_hist_input(kind, n, np, seed=offset)
        assert np.array_equal(run(body, data, offset),
                              np.bincount(data, minlength=256)), kind


def test_body_matches_pallas_interpret(body):
    """One size against the Pallas kernel in interpret mode and the
    port's plain version."""
    n = RESIDENT * FOLD + 12345
    data = make_hist_input("geometric", n, np, seed=9)
    got = run(body, data, 5)
    assert np.array_equal(got, np.asarray(histogram_pallas(jnp.asarray(data),
                                                           interpret=True)))
    assert np.array_equal(got, histogram(torch.from_numpy(data)).numpy())


def test_fold_period_keeps_counters_from_wrapping(body):
    """The one-byte run is where a counter that wrapped would show: one
    thread's share between two folds, plus the head and tail bytes, is at
    most 65535, and a run longer than two folds of every block is
    exact."""
    assert FOLD // THREADS + 2 <= 65535 < FOLD // THREADS + 2 + 16 * VECS
    n = 2 * RESIDENT * FOLD + 5 * STEP + 15
    for byte in (0, 255):
        data = np.full(n, byte, dtype=np.uint8)
        got = run(body, data, 1)
        assert got[byte] == n and got.sum() == n
