// The per-lane body of the encode kernels K1 and K5 (csrc/encode.cu): the
// codes of one lane of N bytes, packed MSB-first into u32 words by the
// S = N / P threads of a segment of one warp, P bytes each; a warp holds
// 32 / S lanes.
//
// Thread s of a lane holds its P bytes [s*P, (s+1)*P) in registers (P
// below).  It looks each one up once in a table of (left-aligned code,
// length) pairs and keeps the pairs in registers; its bit count and its
// count of bytes without a code go into one sum (the latter from bit 16),
// so one scan over the lane's threads gives every thread its first bit
// `pos` and the lane's totals.
// The thread then packs its codes into a register `hi` that starts at the
// in-word offset pos & 31: each code is ORed in shifted right by the
// number of bits already there, the bits that do not fit (a funnel shift)
// start the next word, and each word that fills is stored whole, with no
// branch.  The output row starts zeroed (the kernel zeroes its output
// tile), so what is left is where a thread's bits meet its neighbours':
// after the warp's stores, the thread ORs the last word it does not fill
// into the row, or, where all its bits lie inside one word it did not
// start, those bits (a shared atomicOr; at most one per thread).  The word
// such a thread starts inside is the one a neighbour stored whole or left
// unfilled: the OR lands after the store.  So every word below ceil(bits /
// 32) gets its bits, and the zeros after them stay.
//
// Everything here compiles with g++ as well, with CUDA's qualifiers
// defined away, so that a CPU test can run the same code for the threads
// of a warp (tests/test_torch_encode_pack.py); the warp's shuffles, its
// sync and the shared atomicOr come from a Warp policy: DeviceWarp below,
// or the test's emulation.

#pragma once

#include <stdint.h>

namespace tpuhuff_encode {

// The code table, in one of two layouts.  Narrow, where every code has at
// most kNarrowMaxLen bits: one word per byte value, the left-aligned code
// with its length in the low bits it leaves free (0 for a byte without a
// code), so that a warp's lookups are 4-byte shared loads.  Wide, for
// codes of up to 32 bits: an 8-byte (code, length) pair.  Entry kNoByte
// (past the 256 byte values) is what a byte at or past the lane's valid
// count looks up: no bits, not missing (narrow: kNarrowNoByte, a nonzero
// word whose length and code fields are 0).
struct alignas(8) Code {
  uint32_t bits;  // left-aligned to bit 31, zero past the length
  uint32_t len;
};
constexpr int kNarrowMaxLen = 26;
constexpr int kNoByte = 256;
constexpr int kTableEntries = 257;
constexpr uint32_t kNarrowNoByte = 32u;
constexpr uint32_t kMissShift = 16;  // bits <= 32 * 1024 < 1 << kMissShift

struct Table {
  const uint32_t* narrow;  // kTableEntries words, or
  const Code* wide;        // kTableEntries pairs
  bool is_wide;
};

// The narrow entry of a byte with code `acode` (left-aligned, zero past
// its length) of `len` <= kNarrowMaxLen bits (0: no code).
__host__ __device__ __forceinline__ uint32_t narrow_entry(uint32_t acode, uint32_t len) {
  return acode | len;
}

// Bytes per thread: a lane of N bytes takes S = N / P threads, so a warp
// holds 32 / S lanes.  P is kBytesPerThread, or N where the lane is
// shorter (a thread per lane), or N / 32 where it is longer (a warp per
// lane).  -D overrides the constant for experiments/encode_sweep.py.
#ifndef TPUHUFF_ENCODE_BYTES_PER_THREAD
#define TPUHUFF_ENCODE_BYTES_PER_THREAD 16
#endif
constexpr int kBytesPerThread = TPUHUFF_ENCODE_BYTES_PER_THREAD;
static_assert(kBytesPerThread >= 1 && kBytesPerThread <= 32 &&
                  (kBytesPerThread & (kBytesPerThread - 1)) == 0,
              "a power of two up to 32 bytes per thread");
__host__ __device__ constexpr int bytes_per_thread(int N) {
  return N <= kBytesPerThread ? N : N / 32 > kBytesPerThread ? N / 32 : kBytesPerThread;
}

// A thread's P bytes as little-endian words (byte i is bits 8*(i%4).. of
// word i/4), as one vector load from the input tile gives them.
template <int P>
struct Bytes {
  uint32_t w[(P + 3) / 4];
  __host__ __device__ __forceinline__ uint32_t operator[](int i) const {
    return (w[i >> 2] >> ((i & 3) * 8)) & 255u;
  }
  // byte i times 4: its entry's offset in the narrow table
  __host__ __device__ __forceinline__ uint32_t offset4(int i) const {
    return (i & 3) == 0 ? (w[i >> 2] << 2) & 0x3fcu
                        : (w[i >> 2] >> ((i & 3) * 8 - 2)) & 0x3fcu;
  }
};

// Pass 1: the code and length of each of the thread's bytes (bytes at or
// past nvalid: none).  Returns the thread's bit count plus its valid bytes
// without a code times 1 << kMissShift, the sum that the lane's scan adds.
// A byte without a code is the only entry 0 (narrow) or of length 0 at a
// valid byte (wide), so the count runs only where the least entry is 0.
template <int P>
__host__ __device__ __forceinline__ uint32_t lookup(const Bytes<P>& b,
                                                    int nvalid,
                                                    const Table& table,
                                                    uint32_t (&code)[P],
                                                    uint32_t (&len)[P]) {
  uint32_t bits = 0, least = ~0u;
  if (!table.is_wide) {
    const char* base = reinterpret_cast<const char*>(table.narrow);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const uint32_t off = nvalid >= P || i < nvalid ? b.offset4(i) : 4u * kNoByte;
      const uint32_t e = *reinterpret_cast<const uint32_t*>(base + off);
      code[i] = e & ~63u;
      len[i] = e & 31u;
      bits += len[i];
      least = e < least ? e : least;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const Code e = table.wide[i < nvalid ? static_cast<int>(b[i]) : kNoByte];
      code[i] = e.bits;
      len[i] = e.len;
      bits += e.len;
      least = e.len < least ? e.len : least;
    }
  }
  uint32_t miss = 0;
  if (least == 0u) {
#pragma unroll
    for (int i = 0; i < P; ++i) miss += i < nvalid && len[i] == 0u;
  }
  return bits + (miss << kMissShift);
}

// A funnel shift: the low word of (hi:lo) >> n, n < 32.
__host__ __device__ __forceinline__ uint32_t shr64_lo(uint32_t hi, uint32_t lo,
                                                      uint32_t n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, n);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> n);
#endif
}

// Where a thread's bits end: `bits` go into the word at `word` with an OR
// after the warp's stores (zero bits: nothing to OR).
struct Edge {
  uint32_t* word;
  uint32_t bits;
};

// Pass 2: pack the codes from bit `pos` of the lane into `row` (zeroed),
// storing each word that fills whole; returns the word to OR.
template <int P>
__host__ __device__ __forceinline__ Edge pack(const uint32_t (&code)[P],
                                              const uint32_t (&len)[P],
                                              uint32_t pos, uint32_t* row) {
  uint32_t* dst = row + (pos >> 5);
  uint32_t n = pos & 31u;  // bits of the current word before hi's first
  uint32_t hi = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const uint32_t spill = shr64_lo(code[i], 0u, n);  // what does not fit
    hi |= code[i] >> n;
    n += len[i];
    if (n >= 32u) {
      *dst++ = hi;
      hi = spill;
      n -= 32u;
    }
  }
  // hi holds the thread's bits of the word it has not stored: the word it
  // left unfilled, or the one word it started inside; it is zero where the
  // last word filled exactly (a code is zero past its length)
  return Edge{dst, hi};
}

// K5's count of the bytes a thread holds: those whose index in the lanes'
// storage, first + i, lies below n (the operand may be a shorter prefix).
template <int P, class Add>
__host__ __device__ __forceinline__ void count_held(const Bytes<P>& b,
                                                    int64_t first, int64_t n,
                                                    Add add) {
  if (first + P <= n) {
#pragma unroll
    for (int i = 0; i < P; ++i) add(b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (first + i < n) add(b[i]);
    }
  }
}

// One lane on its S threads (S = N / P, a power of two; s is this
// thread's index among them) into `row`, which holds zeros.  Every thread
// of the warp calls it with the same S: the shuffles are warp-wide.  An
// inactive segment (a lane past the tile's last, where a warp holds several
// lanes) holds no valid byte and writes nothing.  Returns the lane's bit
// and missing counts (the same on all S threads).
template <int P, class Warp>
__host__ __device__ __forceinline__ void encode_lane(
    const Warp& warp, int s, int S, const Bytes<P>& b, int nvalid,
    const Table& table, uint32_t* row, bool active, uint32_t& total,
    uint32_t& nmiss) {
  uint32_t code[P], len[P];
  const uint32_t mine = lookup<P>(b, active ? nvalid : 0, table, code, len);
  uint32_t incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d < S) {  // the same on the whole warp
      const uint32_t v = warp.up(incl, d);
      if (s >= d) incl += v;
    }
  }
  const uint32_t sums = S > 1 ? warp.idx(incl, S - 1) : incl;
  constexpr uint32_t kBits = (1u << kMissShift) - 1u;
  total = sums & kBits;
  nmiss = sums >> kMissShift;
  const Edge e = pack<P>(code, len, (incl - mine) & kBits, row);
  warp.sync();  // every whole word is stored before the ORs
  if (e.bits != 0u) warp.or_into(e.word, e.bits);
}

#ifdef __CUDACC__
// Shuffles within segments of `width` lanes of the warp.  Declared for the
// host too, as encode_lane is, but only device code calls them.
struct DeviceWarp {
  int width;
  template <class V>
  __host__ __device__ __forceinline__ V up(V v, int d) const {
#ifdef __CUDA_ARCH__
    v = __shfl_up_sync(0xffffffffu, v, d, width);
#endif
    return v;
  }
  template <class V>
  __host__ __device__ __forceinline__ V idx(V v, int src) const {
#ifdef __CUDA_ARCH__
    v = __shfl_sync(0xffffffffu, v, src, width);
#endif
    return v;
  }
  __host__ __device__ __forceinline__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  __host__ __device__ __forceinline__ void or_into(uint32_t* p, uint32_t v) const {
#ifdef __CUDA_ARCH__
    atomicOr(p, v);
#endif
  }
};
#endif

}  // namespace tpuhuff_encode
