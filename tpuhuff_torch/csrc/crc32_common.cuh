// The body of the CRC32 kernel C1 (crc32.cu): zlib CRC32s of the spans of
// a byte buffer, one thread block to a span at a time.
//
// Contract (per launch): data[0:n] is cut into segments: [0, head) where
// head > 0, then spans of `span` bytes from head on, the last one short.
// out[j] receives zlib.crc32 of segment j (init and final xor 0xFFFFFFFF).
// head <= span, so that every segment fits one window (below).
//
// The arithmetic.  Let r(M) be the CRC register after M from a register of
// 0 with no final xor (the "raw" CRC).  r is linear over GF(2), and
//   r(A || B) = Z^|B| r(A) xor r(B)   and   r(0^k || M) = r(M),
// where Z^L is the 32x32 GF(2) map of L zero bytes on the register: zero
// bytes leave a zero register at zero.  zlib's value is
//   crc32(M) = r(M) xor crc32(0^|M|),
// so the constant crc32(0^len) of each segment's length comes from the host
// (one for a whole span, one for the head, one for the short last span).
//
// The design.  A segment is put at the END of a window of kPieces * L bytes
// (L = ceil(span / kPieces)), the window's head being virtual zeros that
// cost nothing (the second identity), so every segment, whole, short or the
// head, takes the same fold.  Thread t of the block takes the raw CRC of the
// window's bytes [t L, (t + 1) L) alone: the real bytes among them, read
// with 16-byte loads (four in flight) and folded into the register by
// slicing-by-16 from tables in shared memory (16 table lookups and no
// dependent chain inside a 16-byte step).  Then the pieces are folded in a
// tree: at level k the left half's value is shifted by the right half's L
// 2^k bytes and xored with it, levels 0-4 by warp shuffles and 5-7 by the
// first warp after one exchange in shared memory.  Each shift Z^(L 2^k) is
// applied as four byte-indexed tables of 256 words (32 KiB for the eight
// levels, built on the host for the launch's L), read through the
// read-only cache: four lookups a level.  So the bytes are read once, with
// no host pass, no scan across blocks and no serial chain longer than L.
//
// What bounds it on an H100: the n bytes read once (0.020 ms for a 64 MiB
// chunk at 3.35 TB/s) and the table lookups, one a byte, which shared
// memory serves at about 32 a cycle per SM less its bank conflicts.
//
// Everything here compiles with g++ as well, with CUDA's qualifiers defined
// away, so that a CPU test runs the same pieces and the same fold.

#pragma once

#include <stdint.h>

#include <cstring>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tpuhuff_crc {

constexpr int kPieces = 256;     // the window's pieces: one a thread
constexpr int kLevels = 8;       // log2(kPieces): the fold's levels
constexpr int kSlices = 16;      // slicing-by-16: tables of 256 words
constexpr int kFoldWords = kLevels * 4 * 256;

struct Args {
  const uint8_t* data;
  int64_t n;          // valid bytes of data
  int64_t span;       // bytes of a whole span
  int64_t head;       // bytes of the head segment; 0 for none
  int64_t piece;      // L: bytes of a window's piece
  int nseg;           // segments: (head > 0) + ceil((n - head) / span)
  uint32_t k_span;    // crc32 of `span` zero bytes
  uint32_t k_head;    // ... of `head` zero bytes
  uint32_t k_last;    // ... of the last segment's length in zero bytes
  const uint32_t* fold;  // kLevels x 4 x 256: level k applies Z^(L 2^k)
  uint32_t* out;      // nseg CRCs
};

struct W4 {
  uint32_t x, y, z, w;
};

__host__ __device__ __forceinline__ W4 load16(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return W4{v.x, v.y, v.z, v.w};
#else
  W4 v;
  std::memcpy(&v, p, 16);
  return v;
#endif
}

__host__ __device__ __forceinline__ uint32_t load_ro(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// segment j of the launch: its start in data and its length
__host__ __device__ __forceinline__ void segment(const Args& a, int j,
                                                 int64_t& start, int64_t& len) {
  if (a.head > 0 && j == 0) {
    start = 0;
    len = a.head;
    return;
  }
  start = (a.head > 0 ? a.head + int64_t(j - 1) * a.span : int64_t(j) * a.span);
  const int64_t left = a.n - start;
  len = left < a.span ? left : a.span;
}

// crc32(0^len) of segment j, from the host's three constants
__host__ __device__ __forceinline__ uint32_t zeros_crc(const Args& a, int j,
                                                       int64_t len) {
  if (a.head > 0 && j == 0) return a.k_head;
  return len == a.span ? a.k_span : a.k_last;
}

// one byte into the register; T is table 0 (the byte table)
__host__ __device__ __forceinline__ uint32_t step1(uint32_t s, uint32_t b,
                                                   const uint32_t* T) {
  return T[(s ^ b) & 0xFFu] ^ (s >> 8);
}

// sixteen bytes into the register: table k holds the raw CRC of a byte
// followed by k zero bytes
__host__ __device__ __forceinline__ uint32_t step16(uint32_t s, W4 v,
                                                    const uint32_t* T) {
  const uint32_t x = v.x ^ s;
  return T[15 * 256 + (x & 0xFFu)] ^ T[14 * 256 + ((x >> 8) & 0xFFu)] ^
         T[13 * 256 + ((x >> 16) & 0xFFu)] ^ T[12 * 256 + (x >> 24)] ^
         T[11 * 256 + (v.y & 0xFFu)] ^ T[10 * 256 + ((v.y >> 8) & 0xFFu)] ^
         T[9 * 256 + ((v.y >> 16) & 0xFFu)] ^ T[8 * 256 + (v.y >> 24)] ^
         T[7 * 256 + (v.z & 0xFFu)] ^ T[6 * 256 + ((v.z >> 8) & 0xFFu)] ^
         T[5 * 256 + ((v.z >> 16) & 0xFFu)] ^ T[4 * 256 + (v.z >> 24)] ^
         T[3 * 256 + (v.w & 0xFFu)] ^ T[2 * 256 + ((v.w >> 8) & 0xFFu)] ^
         T[1 * 256 + ((v.w >> 16) & 0xFFu)] ^ T[0 * 256 + (v.w >> 24)];
}

// the raw CRC of p[0:len]: bytes up to a 16-byte boundary, 16-byte words
// (four loads in flight), then the last bytes
__host__ __device__ inline uint32_t raw_crc(const uint8_t* p, int64_t len,
                                            const uint32_t* T) {
  uint32_t s = 0;
  while (len > 0 && (reinterpret_cast<uintptr_t>(p) & 15u)) {
    s = step1(s, *p++, T);
    --len;
  }
  int64_t words = len >> 4;
  for (; words >= 4; words -= 4, p += 64) {
    const W4 a = load16(p), b = load16(p + 16), c = load16(p + 32),
             d = load16(p + 48);
    s = step16(s, a, T);
    s = step16(s, b, T);
    s = step16(s, c, T);
    s = step16(s, d, T);
  }
  for (; words > 0; --words, p += 16) s = step16(s, load16(p), T);
  for (len &= 15; len > 0; --len) s = step1(s, *p++, T);
  return s;
}

// the raw CRC of piece t of segment [start, start + len) put at the end of
// its window: only the real bytes, as the zeros before them add nothing
__host__ __device__ __forceinline__ uint32_t piece_crc(const Args& a, int64_t start,
                                                       int64_t len, int t,
                                                       const uint32_t* T) {
  const int64_t pad = a.piece * kPieces - len;
  int64_t lo = int64_t(t) * a.piece - pad;
  int64_t hi = lo + a.piece;
  lo = lo < 0 ? 0 : lo;
  if (hi <= lo) return 0;
  return raw_crc(a.data + start + lo, hi - lo, T);
}

// Z^(L 2^k) v: level k's four byte tables
__host__ __device__ __forceinline__ uint32_t shift(const uint32_t* fold, int k,
                                                   uint32_t v) {
  const uint32_t* F = fold + k * 1024;
  return load_ro(F + (v & 0xFFu)) ^ load_ro(F + 256 + ((v >> 8) & 0xFFu)) ^
         load_ro(F + 512 + ((v >> 16) & 0xFFu)) ^ load_ro(F + 768 + (v >> 24));
}

}  // namespace tpuhuff_crc
