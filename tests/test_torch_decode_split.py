"""The decoders' global-rows route (``csrc/decode_split.cuh``) on the CPU,
against the plain PyTorch versions and the JAX package.

The header's split body (subsequences, the sync to a fixed point, the
block-wide scan and the writing pass) and the two rules of
``csrc/decode_rules.cuh`` are compiled with ``g++`` (CUDA's qualifiers
defined away) into a small library that runs one Huffman block at a time on
T threads, one ``std::thread`` per CUDA thread: ``__syncthreads`` and
``__syncthreads_or`` are a ``std::barrier`` (whose completion publishes the
vote), and each warp's ``__shfl_up_sync`` an exchange over a barrier of the
warp's threads.  The table lookup, the rules' escape, the cursor and the
output writes are the kernel's own code; the launch, the shared-memory
staging of the output and its 16-byte stores are checked on the card only
(``tests/test_torch_cuda.py``, which takes its cases from here).
Tolerance: none, every output is a byte and must equal the plain version's,
zeros included.  The JAX package is imported inside the one test that uses
it, so that the card's tests, where JAX is not installed, can import the
cases.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhuff_torch import native
from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
from tpuhuff_torch.core.tree import HuffTree
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.kernels import (
    GeneralDecodeTables,
    decode_rows_general_reference,
    decode_rows_reference,
    make_canonical_decode_tables,
    make_decode_tables,
    payload_to_lane_words,
)
from tpuhuff_torch.kernels.encode import as_i32

CSRC = Path(__file__).parent.parent / "tpuhuff_torch" / "csrc"

HARNESS = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
#include "decode_rules.cuh"
#include "decode_split.cuh"

using namespace tpuhuff_decode;

// One warp's shuffles: each thread publishes its value, all wait, each
// reads its source lane's, all wait again.
struct Warp {
  explicit Warp(int n) : bar(n) {}
  std::barrier<> bar;
  uint32_t v[32];
};

// One thread block: a barrier whose completion publishes the vote of
// __syncthreads_or, and its warps.
struct Shared {
  struct Done {
    Shared* s;
    void operator()() noexcept { s->vote = s->pending.exchange(false); }
  };
  explicit Shared(int T) : bar(T, Done{this}) {
    for (int w = 0; 32 * w < T; ++w)
      warps.emplace_back(std::make_unique<Warp>(std::min(32, T - 32 * w)));
  }
  std::barrier<Done> bar;
  std::atomic<bool> pending{false};
  bool vote = false;
  std::vector<std::unique_ptr<Warp>> warps;
};

struct HostBlock {
  Shared* s;
  int tid, nt;
  void sync() const { s->bar.arrive_and_wait(); }
  bool any(bool v) const {
    if (v) s->pending.store(true);
    s->bar.arrive_and_wait();
    return s->vote;
  }
  uint32_t up(uint32_t v, int d) const {
    Warp& w = *s->warps[tid >> 5];
    const int lane = tid & 31;
    w.v[lane] = v;
    w.bar.arrive_and_wait();
    const uint32_t r = lane >= d ? w.v[lane - d] : v;
    w.bar.arrive_and_wait();
    return r;
  }
};

// The blocks one after another on T threads, as one thread block of the
// kernel takes them (with the output written straight to its rows).
template <class Rule>
void run(const Rule& rule, const uint32_t* rows, const int32_t* bit0,
         const int32_t* nbits, const uint16_t* lut, uint8_t* out, int B, int W,
         int block_len, int T, int32_t* rounds) {
  Shared shared(T);
  std::vector<int> s_pos(T);
  uint32_t s_warp[32];
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t] {
      const HostBlock blk{&shared, t, T};
      for (int b = 0; b < B; ++b) {
        const int r = split_block(blk, rows + static_cast<int64_t>(b) * W, W,
                                  bit0[b], nbits[b], block_len, lut, rule,
                                  s_pos.data(), s_warp,
                                  out + static_cast<int64_t>(b) * block_len);
        if (t == 0) rounds[b] = r;
      }
    });
  }
  for (auto& th : threads) th.join();
}

// general 0: K2's ladder (a0 ub, a1 dd, a2 perm, max_len); 1: K4's search
// (a0 thr, a1 sym, a2 len)
extern "C" int split_decode(int general, const uint32_t* rows, const int32_t* bit0,
                            const int32_t* nbits, const uint16_t* lut,
                            const void* a0, const void* a1, const void* a2,
                            int max_len, uint8_t* out, int B, int W,
                            int block_len, int T, int32_t* rounds) {
  alignas(16) uint8_t smem[2048];
  if (general) {
    const Search::Args a{static_cast<const uint32_t*>(a0),
                         static_cast<const uint8_t*>(a1),
                         static_cast<const uint8_t*>(a2)};
    run(Search::load(smem, a, 0, 1), rows, bit0, nbits, lut, out, B, W,
        block_len, T, rounds);
  } else {
    const Ladder::Args a{static_cast<const uint32_t*>(a0),
                         static_cast<const int32_t*>(a1),
                         static_cast<const uint8_t*>(a2), max_len};
    run(Ladder::load(smem, a, 0, 1), rows, bit0, nbits, lut, out, B, W,
        block_len, T, rounds);
  }
  return 0;
}

extern "C" int harness_split_threads(int W) { return split_threads(W); }
extern "C" int harness_split_len(int nbits, int T) { return split_len(nbits, T); }
"""

THREADS = [1, 32, 64, 1024]


def build_harness(gxx: str, tmp: Path):
    """The split body built for the CPU with ``gxx`` in ``tmp``:
    ``run(rows, bit0, nbits, tables, block_len, T) -> (out, rounds)``, with
    ``rounds`` each block's sync rounds (also used by
    ``experiments/decode_split_crossover.py``)."""
    src, lib = tmp / "harness.cpp", tmp / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-g", "-fPIC", "-shared",
                    "-pthread", "-Wall", "-Wno-unknown-pragmas", "-Werror",
                    "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.split_decode.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.split_decode.restype = ctypes.c_int

    def run(rows, bit0, nbits, tables, block_len, T):
        B, W = rows.shape
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        bit0 = np.ascontiguousarray(bit0, dtype=np.int32)
        nbits = np.ascontiguousarray(nbits, dtype=np.int32)
        lut = tables.lut.numpy()
        general = isinstance(tables, GeneralDecodeTables)
        ops = ([tables.thr, tables.sym, tables.len] if general
               else [tables.ub, tables.dd, tables.perm])
        ops = [t.contiguous().numpy() for t in ops]
        out = np.full((B, block_len), 0xA5, dtype=np.uint8)  # every byte written
        rounds = np.full(B, -1, dtype=np.int32)
        err = so.split_decode(int(general), rows.ctypes.data, bit0.ctypes.data,
                              nbits.ctypes.data, lut.ctypes.data,
                              *(o.ctypes.data for o in ops),
                              0 if general else tables.max_len,
                              out.ctypes.data, B, W, block_len, T,
                              rounds.ctypes.data)
        assert err == 0
        return out, rounds

    run.split_threads = so.harness_split_threads
    run.split_len = so.harness_split_len
    return run


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """:func:`build_harness`, or a skip where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the split body cannot be built")
    return build_harness(gxx, tmp_path_factory.mktemp("decode_split"))


def _fib_counts():
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    return counts


def _mirror(tree):
    """The same tree with every code's bits inverted: not canonical."""
    return HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                    tree.root)


def _tree(counts, rule):
    """The device tree of ``counts``: canonical for K2, mirrored for K4."""
    tree = canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])
    return tree if rule == "K2" else _mirror(tree)


def _tables(tree, rule):
    if rule == "K2":
        return make_canonical_decode_tables(tree)
    assert make_canonical_decode_tables(tree) is None
    return make_decode_tables(tree)


def _encode(data, block_len, tree):
    """(rows, bit0, nbits) of ``data`` cut into blocks of ``block_len``."""
    payload, _, bit_lens = native.encode_blocks_host(data, block_len,
                                                     *tree.encode_tables())
    ends = np.cumsum(bit_lens.astype(np.int64))
    starts = ends - bit_lens.astype(np.int64)
    rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
    return rows, bit0, (ends - starts).astype(np.int32)


def _textlike(rng, n):
    return (rng.zipf(1.3, n) % 90 + 30).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def split_case(name, rule):
    """``(rows, bit0, nbits, tables, block_len, data)`` of one case; data is
    the source of whole blocks, or None where the rows are not all codes."""
    rng = np.random.default_rng(len(name) * 31 + len(rule))
    if name.startswith("fib"):  # a few blocks of one band of code lengths
        lo, hi = (25, 32) if name == "fib 25-32" else (15, 24)
        tree = _tree(_fib_counts(), rule)
        lens = tree.encode_tables()[0]
        letters = np.flatnonzero((lens >= lo) & (lens <= hi)).astype(np.uint8)
        block_len = 4096
        data = letters[rng.integers(0, letters.size, 3 * block_len)]
    elif name == "uniform 8-bit":
        tree = _tree(np.ones(256, dtype=np.int64), rule)
        block_len = 4096
        data = rng.integers(0, 256, 3 * block_len, dtype=np.uint8)
    elif name == "3-bit":  # 8 letters: codes that never fall into step
        tree = _tree(np.r_[np.ones(8, np.int64), np.zeros(248, np.int64)], rule)
        block_len = 2500
        data = rng.integers(0, 8, 3 * block_len, dtype=np.uint8)
    elif name == "2-leaf":
        tree = _tree(np.r_[np.zeros(97, np.int64), 5, 3,
                           np.zeros(157, np.int64)], rule)
        block_len = 4096
        data = np.where(rng.random(3 * block_len) < 0.6, 97, 98).astype(np.uint8)
    else:  # the textlike tree: random words, nbits edges, bit0 > 0
        text = _textlike(rng, 1 << 16)
        tree = _tree(np.bincount(text, minlength=256), rule)
        block_len = 4096
        data = text[: 7 * block_len]
    rows, bit0, nbits = _encode(data, block_len, tree)
    if name == "random words":  # not codes: every window is garbage; more
        # bits than block_len codes can take (the subsequences cover fewer)
        block_len = 300
        B, W = 4, 3000
        rows = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
        bit0 = rng.integers(0, 32, B).astype(np.int32)
        nbits = rng.integers(0, 32 * (W - 1), B).astype(np.int32)
        data = None
    elif name == "nbits edges":
        lens = tree.encode_tables()[0][data].astype(np.int64)
        inside = int(np.cumsum(lens[: 1000])[-1]) - 1  # the last code, cut
        assert lens[999] >= 2
        W = rows.shape[1]
        # stopped, empty, a code cut by the end, an end past the row's W
        # words (they read as 0), fewer bits than the threads' subsequences,
        # a sub-word end, and whole: decoded at block_len 3000, fewer than
        # the codes of every whole block
        nbits = np.array([-5, 0, inside, 32 * W + 5000, 40, 33, nbits[6]],
                         dtype=np.int32)
        block_len = 3000
        data = None
    elif name == "bit0 > 0":  # each row moved right by 0..5 random words
        B, W = rows.shape
        shift = rng.integers(0, 6, B)
        moved = rng.integers(0, 1 << 32, (B, W + 5), dtype=np.uint64
                             ).astype(np.uint32)
        for b in range(B):
            moved[b, shift[b]: shift[b] + W] = rows[b]
        rows, bit0 = moved, (bit0 + 32 * shift).astype(np.int32)
        assert bit0.max() >= 32
    tables = _tables(tree, rule)
    return rows, bit0, nbits, tables, block_len, data


@functools.lru_cache(maxsize=None)
def _plain(name, rule):
    rows, bit0, nbits, tables, block_len, _ = split_case(name, rule)
    plain = (decode_rows_reference if rule == "K2"
             else decode_rows_general_reference)
    return plain(as_i32(rows), torch.from_numpy(bit0), torch.from_numpy(nbits),
                 tables, block_len).numpy()


CASES = ["fib 25-32", "fib 15-24", "random words", "uniform 8-bit", "3-bit",
         "2-leaf", "nbits edges", "bit0 > 0"]


@pytest.mark.parametrize("T", THREADS)
@pytest.mark.parametrize("rule", ["K2", "K4"])
@pytest.mark.parametrize("name", CASES)
def test_split_body_matches_plain(harness, name, rule, T):
    """Byte-exact against the plain version on T threads, zeros included;
    whole blocks restore their source; 3-bit codes out of step need more
    than one sync round (every round fixes one more thread), and codes of
    a length that divides the subsequences need none."""
    rows, bit0, nbits, tables, block_len, data = split_case(name, rule)
    out, rounds = harness(rows, bit0, nbits, tables, block_len, T)
    assert np.array_equal(out, _plain(name, rule))
    if data is not None:
        assert np.array_equal(out.reshape(-1), data)
    if T == 1:
        assert not rounds.any()
    elif name == "3-bit":
        assert rounds.min() > 1
    elif name in ("uniform 8-bit", "2-leaf"):
        assert not rounds.any()


@pytest.mark.parametrize("T", THREADS)
def test_split_body_zero_length_leaf(harness, T):
    """A K4 table with a leaf of 0 bits (foreign tables may hold one): its
    code never moves the cursor, so the plain version emits it at every
    later position; the split body caps each thread's count at block_len
    and agrees."""
    rows, bit0, nbits, tables, block_len, _ = split_case("bit0 > 0", "K4")
    lens = tables.len.clone()
    lens[5] = 0
    zero = GeneralDecodeTables(tables.thr, tables.sym, lens)
    out, _ = harness(rows, bit0, nbits, zero, block_len, T)
    want = decode_rows_general_reference(as_i32(rows), torch.from_numpy(bit0),
                                         torch.from_numpy(nbits), zero,
                                         block_len).numpy()
    assert np.array_equal(out, want)
    assert (out == int(zero.sym[5])).all(axis=1).sum() < out.shape[0]
    assert (out[:, -1] == int(zero.sym[5])).any()


@pytest.mark.parametrize("rule", ["K2", "K4"])
def test_split_body_matches_jax(harness, rule, monkeypatch):
    """On codes of 25 to 32 bits: the JAX package's XLA route
    (``decode_rows_device`` with ``TPUHUFF_DECODER=xla``) under the JAX
    package's own tree of the same counts gives the split body's bytes."""
    from tpuhuff.core import canonical as jax_canonical
    from tpuhuff.core.weights import ByteWeights as JaxWeights
    from tpuhuff.kernels import decode as jax_decode

    rows, bit0, nbits, tables, block_len, data = split_case("fib 25-32", rule)
    jtree = jax_canonical.canonicalize(jax_canonical.build_tree_for_device(
        JaxWeights(_fib_counts()), 32)[0])
    if rule == "K4":
        jtree = type(jtree)(jtree.right, jtree.left, jtree.letters,
                            jtree.weights, jtree.root)
    assert all(np.array_equal(a, b) for a, b in zip(
        jtree.encode_tables(), _tree(_fib_counts(), rule).encode_tables()))
    monkeypatch.setenv("TPUHUFF_DECODER", "xla")
    want = np.asarray(jax_decode.decode_rows_device(rows, bit0, nbits, jtree,
                                                    block_len))
    out, _ = harness(rows, bit0, nbits, tables, block_len, 64)
    assert np.array_equal(out, want)
    assert np.array_equal(out.reshape(-1), data)


def test_split_sizes(harness):
    """The launch's threads per thread block and the blocks' subsequence
    lengths: about 512 bits a thread, whole words, 32 to 1024 threads."""
    assert harness.split_threads(59_205) == 1024  # phase 7b's 64 KiB rows
    assert harness.split_threads(3722) == 256  # 4 KiB blocks of long codes
    assert harness.split_threads(1) == 32
    assert harness.split_len(1_894_000, 928) == 2048
    assert harness.split_len(0, 928) == 32
    assert harness.split_len(-7, 32) == 32
    assert harness.split_len(100, 1) == 128
