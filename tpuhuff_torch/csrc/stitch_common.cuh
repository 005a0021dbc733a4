// The body of the device stitch S1 (stitch.cu): the lanes' MSB-first
// bitstreams concatenated into one payload of big-endian bytes, behind the
// bits carried from the chunk before.
//
// Contract (per launch): lane b of B holds bits[b] bits in words[b, 0:R],
// u32 patterns MSB-first (K1's output: only the first ceil(bits[b] / 32)
// words hold bits); ends[b] is the inclusive prefix sum of bits; carry is
// {byte, n}: the previous chunk's last n (0-7) bits, in the high bits of
// byte.  out, zeroed by the caller, receives the stream as bytes: the n
// carried bits, then lane 0's bits, lane 1's, ...  Its words are stored
// byte-swapped, so that memory holds the bytes in stream order.  After
// every pair has run (the next launch), carry_out = {the stream's last
// partial byte, total % 8}: what the next chunk's stitch takes as carry.
//
// What bounds it on an H100: bytes.  A lane's words that hold bits are
// read once (about 38 MB of a 64 MiB chunk of text at 14-bit codes, of the
// 117 MB K1 writes) and the payload is written once.  The design: one
// thread per (lane, word) pair, neighbouring threads on neighbouring words
// of a lane (coalesced reads; a thread past its lane's bits reads nothing).
// Word j of lane b starts at stream bit p = n + ends[b] - bits[b] + 32 j;
// it is ORed as (w >> s) into out word p / 32 and (w << (32 - s)) into the
// next, s = p % 32 (nothing goes to the next where s is 0: a shift by 32
// is undefined in C++).  Lanes own disjoint bit ranges, so the ORs never
// meet on a bit and their order does not matter; they are atomic because
// two lanes (or a lane and the carry) may share a word.  The byteswap
// commutes with OR, so each value is swapped before it is ORed and no pass
// over the payload swaps it afterwards.  The last word of a lane is masked
// to its bits, so a lane's bits past its count cannot reach the next lane.
// Counts past what the rows can hold (more than 32 R bits a lane) are not
// K1's and write nothing outside out.
//
// Everything here compiles with g++ as well, with CUDA's qualifiers
// defined away, so that a CPU test runs the same code on std::threads with
// std::atomic_ref for the OR (tests/test_torch_stitch.py).

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#include <atomic>
#endif

namespace tpuhuff_stitch {

// the body's two primitives: a byteswap and an atomic OR into a word
__host__ __device__ __forceinline__ uint32_t bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0u, 0x0123u);
#else
  return __builtin_bswap32(x);
#endif
}

__host__ __device__ __forceinline__ void or_word(uint32_t* p, uint32_t v) {
#if defined(__CUDA_ARCH__)
  atomicOr(p, v);
#elif defined(__CUDACC__)
  __atomic_fetch_or(p, v, __ATOMIC_RELAXED);  // nvcc's host pass: never called
#else
  std::atomic_ref<uint32_t>(*p).fetch_or(v, std::memory_order_relaxed);
#endif
}

struct Args {
  const uint32_t* words;  // (B, R)
  const int32_t* bits;    // (B,)
  const int64_t* ends;    // (B,) inclusive prefix sums of bits
  uint32_t* out;          // zeroed; cap words
  int64_t cap;            // B * R + 2: room for every bit the words hold
  int32_t B;
  int32_t R;
  int32_t carry_bits;     // n, 0-7
};

// Pair i = b * R + j of [0, B * R): word j of lane b into the stream.
__host__ __device__ __forceinline__ void stitch_pair(const Args& a, uint32_t i) {
  const uint32_t b = i / static_cast<uint32_t>(a.R);
  const int32_t j = static_cast<int32_t>(i - b * static_cast<uint32_t>(a.R));
  const int32_t nb = a.bits[b];
  const int32_t left = nb - 32 * j;  // the lane's bits from this word on
  if (left <= 0) return;
  uint32_t w = a.words[i];
  if (left < 32) w &= ~0u << (32 - left);
  if (w == 0) return;
  const int64_t p = a.carry_bits + a.ends[b] - nb + 32 * static_cast<int64_t>(j);
  const int64_t d = p >> 5;
  if (d < 0 || d + 1 >= a.cap) return;  // bits past 32 R: not K1's words
  const int s = static_cast<int>(p & 31);
  or_word(a.out + d, bswap32(w >> s));
  if (s != 0) {
    const uint32_t spill = w << (32 - s);
    if (spill != 0) or_word(a.out + d + 1, bswap32(spill));
  }
}

// The carried bits at the head of the stream (once per launch).
__host__ __device__ __forceinline__ void stitch_head(const Args& a, uint32_t carry_byte) {
  if (a.carry_bits == 0) return;
  const uint32_t kept = carry_byte & (0xFF00u >> a.carry_bits) & 0xFFu;
  if (kept != 0) or_word(a.out, bswap32(kept << 24));
}

// The next chunk's carry: the stream's last partial byte and its bit
// count; run after every pair (and the head) is in out.
__host__ __device__ __forceinline__ void stitch_tail(const Args& a, int32_t* carry_out) {
  const int64_t total = a.carry_bits + (a.B > 0 ? a.ends[a.B - 1] : 0);
  const int32_t rem = static_cast<int32_t>(total & 7);
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(a.out);
  carry_out[0] = rem != 0 && (total >> 5) < a.cap ? bytes[total >> 3] : 0;
  carry_out[1] = rem;
}

}  // namespace tpuhuff_stitch
