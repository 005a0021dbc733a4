// The body of the device row gather S2 (lane_rows.cu): each block's rows
// of big-endian u32 words cut out of the payload, the decoders' operand.
//
// Contract (per launch): payload holds n bytes; block b starts at bit
// start_bits[b] of it.  rows (B, W) u32 gets rows[b, j] = the big-endian
// word start_bits[b] / 32 + j of the payload, whose bytes past n read as 0
// (the slack words), and bit0[b] = start_bits[b] % 32: the layout of
// tpuhuff.kernels.decode.payload_to_lane_words, with W computed as that
// function computes it (the caller's).
//
// What bounds it on an H100: bytes, the payload read once and the rows
// written once.  The design: one thread per output word, neighbouring
// threads on neighbouring words of a row (coalesced loads and stores).
// Where the payload's base is 4-byte aligned and the word lies inside it,
// the thread loads it as one u32 and swaps its bytes with __byte_perm;
// else (the payload's end, an unaligned view) it loads the bytes that
// exist one by one.  The thread of word 0 of a row also writes the row's
// bit0.
//
// Everything here compiles with g++ as well, with CUDA's qualifiers
// defined away, so that a CPU test runs the same code on std::threads
// (tests/test_torch_lane_rows.py).

#pragma once

#include <stdint.h>

namespace tpuhuff_rows {

__host__ __device__ __forceinline__ uint32_t bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0u, 0x0123u);
#else
  return __builtin_bswap32(x);
#endif
}

struct Args {
  const uint8_t* payload;
  int64_t n;                  // payload bytes
  const int64_t* start_bits;  // (B,)
  uint32_t* rows;             // (B, W)
  int32_t* bit0;              // (B,)
  int32_t B;
  int32_t W;
  bool aligned;               // payload's base is 4-byte aligned
};

// Output word i = b * W + j of [0, B * W).
__host__ __device__ __forceinline__ void row_word(const Args& a, uint32_t i) {
  const uint32_t b = i / static_cast<uint32_t>(a.W);
  const uint32_t j = i - b * static_cast<uint32_t>(a.W);
  const int64_t start = a.start_bits[b];
  const int64_t off = 4 * ((start >> 5) + j);  // the word's first byte
  uint32_t v = 0;
  if (a.aligned && off + 4 <= a.n) {
    v = bswap32(*reinterpret_cast<const uint32_t*>(a.payload + off));
  } else {
    for (int k = 0; k < 4; ++k)
      if (off + k < a.n) v |= static_cast<uint32_t>(a.payload[off + k]) << (24 - 8 * k);
  }
  a.rows[i] = v;
  if (j == 0) a.bit0[b] = static_cast<int32_t>(start & 31);
}

}  // namespace tpuhuff_rows
