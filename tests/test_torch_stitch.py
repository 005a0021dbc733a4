"""The device stitch S1 (``kernels.stitch_lanes``, ``csrc/stitch.cu``) on
the CPU, against the JAX package's host stitch.

``stitch_lanes_reference`` (what ``stitch_lanes`` runs on CPU tensors) must
give the bytes of :func:`tpuhuff.dist.stitch_words` over the same lanes,
behind every carry of 0-7 bits, and a chain of chunks, each stitched
behind the carry the one before left, must give the bytes of one
``stitch_words`` over all their lanes.  The kernel's body
(``csrc/stitch_common.cuh``) is compiled with ``g++`` (CUDA's qualifiers
defined away) and run on ``std::thread``s, each a CUDA thread of the
kernel's grid-stride loop, with ``std::atomic_ref`` for the OR, and must
equal the plain version.  Inputs: K1's own words (the plain encoder on
seeded bytes, with lanes of 0 valid bytes), random words masked to their
lanes' counts, and 32-bit codes of the Fibonacci tree.  Tolerance: none,
equal bytes.  The JAX package is imported where it is used, so that the
card's tests (``tests/test_torch_cuda.py``), where JAX is not installed,
can import the cases.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
from tpuhuff_torch.core.weights import ByteWeights
from tpuhuff_torch.kernels import (
    encode_blocks_reference,
    make_encode_tables,
    new_carry,
    stitch_capacity,
    stitch_lanes,
    stitch_lanes_reference,
)

CSRC = Path(__file__).parent.parent / "tpuhuff_torch" / "csrc"

HARNESS = r"""
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
#include "stitch_common.cuh"

using namespace tpuhuff_stitch;

// The kernel's grid as T threads of its grid-stride loop, the head on
// thread 0, then (the second launch) the carry out.
extern "C" int run_stitch(const uint32_t* words, const int32_t* bits,
                          const int64_t* ends, const int32_t* carry,
                          uint32_t* out, int32_t* carry_out, int B, int R, int T) {
  Args a{words, bits, ends, out, static_cast<int64_t>(B) * R + 2, B, R, carry[1] & 7};
  const uint32_t n = static_cast<uint32_t>(B) * static_cast<uint32_t>(R);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t)
    threads.emplace_back([&, t] {
      for (uint32_t i = t; i < n; i += T) stitch_pair(a, i);
      if (t == 0) stitch_head(a, static_cast<uint32_t>(carry[0]));
    });
  for (auto& th : threads) th.join();
  stitch_tail(a, carry_out);
  return 0;
}
"""

THREADS = [1, 7, 64]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """``run(words, bits, carry, T) -> (payload, carry_out)`` of the body
    built with g++, or a skip where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the stitch body cannot be built")
    tmp = tmp_path_factory.mktemp("stitch")
    src, lib = tmp / "harness.cpp", tmp / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    "-Wall", "-Werror", "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.run_stitch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    so.run_stitch.restype = ctypes.c_int

    def run(words, bits, carry, T):
        B, R = words.shape
        w = np.ascontiguousarray(words.numpy())
        b = np.ascontiguousarray(bits.numpy())
        ends = np.cumsum(b.astype(np.int64))
        c = np.ascontiguousarray(carry.numpy())
        out = np.zeros(B * R + 2, dtype=np.uint32)
        c_out = np.full(2, -1, dtype=np.int32)
        assert so.run_stitch(w.ctypes.data, b.ctypes.data, ends.ctypes.data,
                             c.ctypes.data, out.ctypes.data, c_out.ctypes.data,
                             B, R, T) == 0
        return torch.from_numpy(out.view(np.uint8)), torch.from_numpy(c_out)

    return run


def _tree(counts):
    return canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])


def _fib_counts():
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    return counts


def lanes_case(kind: str, seed: int = 0):
    """``(words (B, R) int32, bits (B,) int32)`` of one input kind."""
    rng = np.random.default_rng(seed)
    if kind == "random words":
        B, R = 97, 6
        bits = rng.integers(0, 32 * R + 1, B)
        bits[::5] = 0
        words = rng.integers(0, 1 << 32, (B, R), dtype=np.uint64)
        left = bits[:, None] - 32 * np.arange(R)[None, :]
        keep = (np.uint64(0xFFFFFFFF) << (32 - np.clip(left, 0, 32)).astype(
            np.uint64)) & np.uint64(0xFFFFFFFF)
        words = (words & keep).astype(np.uint32)
        return (torch.from_numpy(words.view(np.int32)),
                torch.from_numpy(bits.astype(np.int32)))
    N = 64
    if kind == "fib32":
        data = rng.choice(34, (60, N), p=_fib_counts()[:34] / _fib_counts().sum())
        data[:, ::9] = rng.integers(0, 4, data[:, ::9].shape)  # 29-32-bit codes
        tree = _tree(_fib_counts())
    else:  # K1 on text-like bytes under their own tree
        data = (rng.zipf(1.3, (60, N)) % 90 + 30)
        tree = _tree(np.bincount(data.reshape(-1), minlength=256))
    lanes = torch.from_numpy(data.astype(np.uint8))
    valid = torch.from_numpy(rng.integers(0, N + 1, 60).astype(np.int32))
    valid[::7] = 0  # lanes of no bits
    tables = make_encode_tables(*tree.encode_tables())
    words, bits, miss = encode_blocks_reference(lanes, valid, tables)
    assert int(miss.sum()) == 0
    if kind == "fib32":
        assert tables.max_len == 32
    return words, bits


KINDS = ["K1 words", "random words", "fib32"]


def _carry(n: int, seed: int) -> tuple[torch.Tensor, int]:
    """A carry of ``n`` random bits (the byte's other bits random too: the
    stitch must ignore them) and the byte those bits make."""
    byte = int(np.random.default_rng(100 + seed).integers(0, 256))
    kept = byte & (0xFF00 >> n) & 0xFF
    return torch.tensor([byte, n], dtype=torch.int32), kept


def _host(words, bits, carry_bits=0, carry_byte=0):
    """``stitch_words`` of the lanes behind ``carry_bits`` bits of
    ``carry_byte``, as one more lane in front: (bytes, total bits)."""
    from tpuhuff.dist import stitch_words

    w = words.numpy().view(np.uint32)
    b = bits.numpy().astype(np.uint64)
    head = np.zeros((1, w.shape[1]), dtype=np.uint32)
    head[0, 0] = carry_byte << 24
    w = np.concatenate([head, w])
    b = np.concatenate([np.uint64([carry_bits]), b])
    payload, _ = stitch_words(w, b)
    return payload, int(b.sum())


def _stream(payload: torch.Tensor, total: int) -> bytes:
    return payload.numpy()[: (total + 7) // 8].tobytes()


@pytest.mark.parametrize("n", range(8))
@pytest.mark.parametrize("kind", KINDS)
def test_reference_equals_stitch_words_behind_every_carry(kind, n):
    words, bits = lanes_case(kind)
    carry, kept = _carry(n, n)
    got, carry_out = stitch_lanes_reference(words, bits, carry)
    want, total = _host(words, bits, n, kept)
    assert got.numel() == stitch_capacity(*words.shape)
    assert _stream(got, total) == want
    assert not got.numpy()[(total + 7) // 8:].any()  # zero past the stream
    rem = total % 8
    assert carry_out.tolist() == [want[-1] if rem else 0, rem]
    assert stitch_lanes(words, bits, carry)[0].equal(got)  # the CPU wrapper


@pytest.mark.parametrize("kind", KINDS)
def test_chain_of_chunks_equals_one_stitch(kind):
    """Chunks of lanes (one empty, one of a lane of 0 bits) stitched one
    after another, each behind the carry the last left, with each chunk's
    whole bytes written and its partial byte carried: one stitch of every
    lane, every chunk boundary at some bit offset."""
    words, bits = lanes_case(kind, seed=3)
    B = words.shape[0]
    cuts = [0, 0, 1, 9, 10, 33, 34, B]
    carry = new_carry()
    out, carried = b"", 0
    offsets = set()
    for lo, hi in zip(cuts, cuts[1:]):
        payload, carry = stitch_lanes_reference(words[lo:hi], bits[lo:hi],
                                                carry)
        total = carried + int(bits[lo:hi].sum())
        out += payload.numpy()[: total // 8].tobytes()
        carried = total % 8
        offsets.add(carried)
        assert carry.tolist()[1] == carried
    if carried:
        out += bytes([int(carry[0])])
    want, _ = _host(words, bits)
    assert out == want
    assert len(offsets) > 2  # the boundaries fell at several bit offsets


def test_empty_and_short_chunks():
    """No lanes: the carry passes through; a chunk of fewer than 8 bits
    completes no byte."""
    words = torch.zeros((0, 3), dtype=torch.int32)
    bits = torch.zeros(0, dtype=torch.int32)
    carry, kept = _carry(5, 1)
    payload, out = stitch_lanes_reference(words, bits, carry)
    assert out.tolist() == [kept, 5]
    assert payload.numpy()[0] == kept and not payload.numpy()[1:].any()
    words = torch.tensor([[-(1 << 30)]], dtype=torch.int32)  # 0xC0000000
    bits = torch.tensor([2], dtype=torch.int32)  # the bits 11
    payload, out = stitch_lanes_reference(words, bits, carry)
    assert out.tolist() == [kept | 0b11 << 1, 7]


@pytest.mark.parametrize("T", THREADS)
@pytest.mark.parametrize("kind", KINDS)
def test_body_under_gxx_equals_reference(harness, kind, T):
    """The kernel's body, every carry and a chain, against the plain
    version byte for byte (capacity included)."""
    words, bits = lanes_case(kind, seed=T)
    for n in range(8):
        carry, _ = _carry(n, n + T)
        got = harness(words, bits, carry, T)
        want = stitch_lanes_reference(words, bits, carry)
        assert got[0].equal(want[0]), (kind, n)
        assert got[1].equal(want[1]), (kind, n)
    carry_g = carry_r = new_carry()
    for lo, hi in ((0, 5), (5, 5), (5, 17), (17, words.shape[0])):
        pg, carry_g = harness(words[lo:hi].contiguous(), bits[lo:hi].contiguous(),
                              carry_g, T)
        pr, carry_r = stitch_lanes_reference(words[lo:hi], bits[lo:hi], carry_r)
        assert pg.equal(pr) and carry_g.equal(carry_r)
