// The per-code step of the decoders K2 (decode.cu) and K4
// (decode_general.cu), and the body of their route for rows in device
// memory: one thread block per Huffman block, the block's code stream split
// across the thread block's T threads by self-synchronisation (Weissenberger
// & Schmidt, "Massively Parallel Huffman Decoding on GPUs", ICPP 2018).
//
// Per block (row of W words, start bit bit0, nbits bits; the contract of
// decode_common.cuh), with offsets counted in bits from bit0:
//   * subsequences: thread t owns the offsets [t*S, (t+1)*S), S a multiple
//     of 32 (split_len: about span / T), so codes whose lengths divide 32
//     start in step; span is nbits, or less where block_len codes of the
//     rule's longest length take fewer bits (the codes past block_len are
//     never written); threads whose subsequence starts at or past span
//     take no part (but thread 0 always does).  The last active thread
//     owns everything from its start on;
//   * pass A: thread t starts a cursor at its guess g_t (at first t*S, and
//     g_0 = 0 is exact) and decodes while the cursor is before its
//     subsequence's end and each code fits (cursor + len <= nbits, the
//     contract's rule), at most block_len codes; it records n_t, the codes
//     it emitted, and p_t, where it stopped: the first code start at or
//     past its end, or the start of the code that did not fit;
//   * sync: g_{t+1} = p_t; every thread whose guess changed decodes again,
//     until no guess changes (a block-wide vote).  From g_0 = 0 by
//     induction the fixed point is the true chain of code starts, so the
//     result never depends on the codes synchronising, only the number of
//     rounds does (at most T).  A code that did not fit stops every later
//     thread at the same start: the contract emits nothing after it;
//   * scan: the exclusive prefix sum of n_t over the thread block
//     (saturating at block_len) is thread t's first output position o_t;
//   * pass B: thread t decodes min(n_t, block_len - o_t) codes from g_t
//     again and writes them at o_t on; positions from min(sum n_t,
//     block_len) on are written 0.
// The count is capped at block_len because a code may be 0 bits long (a
// foreign K4 table): such a code never moves the cursor, and the contract
// emits it at every later position.  A thread that emits block_len codes
// leaves its successors' guesses as they are: whatever they hold, their
// first output position is block_len, so they write nothing (and the
// threads before it still converge as above).
//
// Everything here compiles with g++ as well, with CUDA's qualifiers
// defined away, so that a CPU test runs the same code on one std::thread
// per CUDA thread (tests/test_torch_decode_split.py); the block's barrier
// and vote and the warp's shuffles come from a Block policy: DeviceBlock
// below, or the test's emulation.

#pragma once

#include <stdint.h>

namespace tpuhuff_decode {

// k of the first-level table: 2^k entries of 16 bits in shared memory;
// -D overrides it for experiments/decode_lut_sweep.py.  kernels/decode.py
// builds the table with the same k (LUT_BITS).
#ifndef TPUHUFF_DECODE_LUT_BITS
#define TPUHUFF_DECODE_LUT_BITS 14
#endif
constexpr int kLutBits = TPUHUFF_DECODE_LUT_BITS;
static_assert(kLutBits >= 1 && kLutBits <= 14, "the table must fit in shared memory");

// The bits of one subsequence that a launch of the split route sizes its
// thread blocks for (split_threads): 512 measured fastest of 256 to 2048
// (experiments/decode_split_crossover.py, whose -D overrides it).
#ifndef TPUHUFF_DECODE_SPLIT_BITS
#define TPUHUFF_DECODE_SPLIT_BITS 512
#endif
constexpr int kSplitBits = TPUHUFF_DECODE_SPLIT_BITS;
constexpr int kSplitMaxThreads = 1024;
static_assert(kSplitBits >= 32, "a subsequence of at least one word");

#ifdef __CUDACC__
#define TPUHUFF_NOINLINE __noinline__
#else
#define TPUHUFF_NOINLINE __attribute__((noinline))
#endif

// The rule's (symbol | length << 8) of a window: the table's escape path,
// out of line so that the unrolled symbol loop stays small.
template <class Rule>
__device__ TPUHUFF_NOINLINE uint32_t escape(const Rule rule, uint32_t window) {
  uint32_t sym, len;
  rule.resolve(window, sym, len);
  return sym | (len << 8);
}

// One block's cursor: its bits at the cursor in a register buffer, fed
// from its row (shared memory on the staged route, device memory on the
// split route).
struct Cursor {
  const uint32_t* row;
  int W;
  uint64_t bb;     // the next bits, MSB-aligned
  int nv;          // valid bits in bb, >= 32 at every window
  int nq;          // index of `next` in the row
  uint32_t next;   // the word the next refill takes
  int rem;         // bits the block may still consume; -1 once stopped

  // at bit `bit` of the row, with `rem` bits to consume (< 0: stopped)
  __device__ __forceinline__ void start(const uint32_t* r, int w, int64_t bit,
                                        int rem_bits) {
    row = r;
    W = w;
    nq = static_cast<int>(bit >> 5);
    const int sh = static_cast<int>(bit & 31);
    const uint32_t w0 = nq < W ? row[nq] : 0u;
    const uint32_t w1 = nq + 1 < W ? row[nq + 1] : 0u;
    bb = ((static_cast<uint64_t>(w0) << 32) | w1) << sh;
    nv = 64 - sh;
    nq += 2;
    next = nq < W ? row[nq] : 0u;
    rem = rem_bits < 0 ? -1 : rem_bits;
  }

  // drop n <= 32 bits, then refill to >= 32 valid bits
  __device__ __forceinline__ void consume(uint32_t n) {
    bb <<= n;
    nv -= static_cast<int>(n);
    if (nv < 32) {
      bb |= static_cast<uint64_t>(next) << (32 - nv);
      nv += 32;
      ++nq;
      next = nq < W ? row[nq] : 0u;
    }
  }

  // The code at the cursor, (symbol | length << 8): one load of the
  // first-level table, or, where its entry is 0, the rule.  A rule may
  // give lengths past 32 bits: whole words are skipped first, while the
  // code fits in rem (so a code that does not fit leaves the cursor at
  // its start).  The caller emits the code if its length fits in rem, and
  // then drops it (rem -= len; consume(len)), written out at each call:
  // the staged route's unrolled loop compiled to more instructions and
  // fewer registers with that step behind a function returning a bool.
  template <class Rule>
  __device__ __forceinline__ uint32_t step(const uint16_t* lut, const Rule& rule) {
    const uint32_t window = static_cast<uint32_t>(bb >> 32);
    uint32_t e = lut[window >> (32 - kLutBits)];
    if (e < 256u) {  // length 0: the table escapes
      e = escape(rule, window);
      for (; (e >> 8) > 32u && static_cast<int>(e >> 8) <= rem; e -= 32u << 8) {
        rem -= 32;
        consume(32u);
      }
    }
    return e;
  }
};

// The split route's subsequence length S for a block of nbits bits over T
// threads: nbits / T rounded up to whole words, at least one word.
__host__ __device__ inline int split_len(int nbits, int T) {
  const int64_t per = (static_cast<int64_t>(nbits > 0 ? nbits : 0) + T - 1) / T;
  return per <= 32 ? 32 : static_cast<int>((per + 31) & ~int64_t(31));
}

// Threads of the split route's thread blocks for rows of W words: one
// subsequence of about kSplitBits bits each for the widest block a row can
// hold, a multiple of 32, from 32 to kSplitMaxThreads.
__host__ __device__ inline int split_threads(int W) {
  const int64_t t = (static_cast<int64_t>(W) * 32 + kSplitBits - 1) / kSplitBits;
  const int64_t r = (t + 31) & ~int64_t(31);
  return r < 32 ? 32 : r > kSplitMaxThreads ? kSplitMaxThreads : static_cast<int>(r);
}

// Pass A from the guess g: codes emitted while rem > lim (the cursor before
// the subsequence's end) and each fits, at most cap; p gets where the
// cursor stopped (bits from bit0).
template <class Rule>
__device__ __forceinline__ int count_codes(const uint32_t* row, int W, int bit0,
                                           int nbits, int g, int lim, int cap,
                                           const uint16_t* lut, const Rule& rule,
                                           int& p) {
  Cursor c;
  c.start(row, W, static_cast<int64_t>(bit0) + g, nbits - g);
  int n = 0;
#pragma unroll 1
  for (; c.rem > lim && n < cap; ++n) {
    const uint32_t len = c.step(lut, rule) >> 8;
    if (static_cast<int>(len) > c.rem) break;
    c.rem -= static_cast<int>(len);
    c.consume(len);
  }
  p = nbits - c.rem;
  return n;
}

// Exclusive prefix sum of v <= cap over the thread block, saturating at
// cap (< 2^31): warp shuffles, then one warp over the warps' sums in
// s_warp (32 words).  total gets the saturated sum over all threads.
template <class Block>
__device__ __forceinline__ uint32_t scan_exclusive(const Block& blk, uint32_t v,
                                                   uint32_t cap, uint32_t* s_warp,
                                                   uint32_t& total) {
  const int lane = blk.tid & 31;
  const int warp = blk.tid >> 5;
  const int nw = (blk.nt + 31) >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = blk.up(incl, d);
    if (lane >= d) incl = incl + u < cap ? incl + u : cap;
  }
  uint32_t excl = blk.up(incl, 1);
  if (lane == 0) excl = 0u;
  if (lane == 31 || blk.tid == blk.nt - 1) s_warp[warp] = incl;
  blk.sync();
  if (warp == 0) {
    uint32_t w = lane < nw ? s_warp[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t u = blk.up(w, d);
      if (lane >= d) w = w + u < cap ? w + u : cap;
    }
    if (lane < nw) s_warp[lane] = w;  // inclusive over warps
  }
  blk.sync();
  total = s_warp[nw - 1];
  const uint32_t o = (warp ? s_warp[warp - 1] : 0u) + excl;
  return o < cap ? o : cap;
}

// One Huffman block on the blk.nt threads of a thread block (the header's
// comment): row (W words, words past W read as 0), bit0, nbits; its
// block_len output bytes go to out (shared or device memory).  s_pos holds
// blk.nt ints and s_warp 32 words.  Returns the number of sync rounds in
// which some guess changed.  Every thread calls it; it ends with the
// output written by this thread, not with a barrier.
template <class Rule, class Block>
__device__ __forceinline__ int split_block(const Block& blk, const uint32_t* row,
                                           int W, int bit0, int nbits,
                                           int block_len, const uint16_t* lut,
                                           const Rule& rule, int* s_pos,
                                           uint32_t* s_warp, uint8_t* out) {
  const int tid = blk.tid;
  // the bits the subsequences cover: the block_len codes that are written
  // lie in the first block_len * kMaxLen bits
  const int64_t need = static_cast<int64_t>(block_len) * Rule::kMaxLen;
  const int span = nbits < need ? nbits : static_cast<int>(need);
  const int S = split_len(span, blk.nt);
  // threads whose subsequence starts before span (thread 0 at span 0)
  const int64_t starts = nbits < 0 ? 0 : (static_cast<int64_t>(span) + S - 1) / S;
  const int active = nbits < 0 ? 0 : starts < 1 ? 1 : static_cast<int>(starts);
  const bool mine = tid < active;
  // decode while rem > lim: before the subsequence's end, or (the last
  // active thread) while anything fits
  const int lim = tid + 1 < active
                      ? static_cast<int>(nbits - static_cast<int64_t>(tid + 1) * S)
                      : -1;
  int g = mine ? tid * S : 0;
  int p = g, n = 0;
  if (mine) n = count_codes(row, W, bit0, nbits, g, lim, block_len, lut, rule, p);
  int rounds = 0;
  for (;;) {
    if (mine) s_pos[tid] = n < block_len ? p : -1;  // -1: block_len codes
    blk.sync();
    const int want = tid == 0 || !mine ? g : s_pos[tid - 1];
    const bool changed = want >= 0 && want != g;
    if (!blk.any(changed)) break;  // also: every read of s_pos is done
    ++rounds;
    if (changed) {
      g = want;
      n = count_codes(row, W, bit0, nbits, g, lim, block_len, lut, rule, p);
    }
  }
  uint32_t total;
  const uint32_t cap = static_cast<uint32_t>(block_len);
  const int o = static_cast<int>(
      scan_exclusive(blk, static_cast<uint32_t>(n), cap, s_warp, total));
  const int k = n < block_len - o ? n : block_len - o;
  if (k > 0) {
    Cursor c;
    c.start(row, W, static_cast<int64_t>(bit0) + g, nbits - g);
#pragma unroll 1
    for (int i = 0; i < k; ++i) {
      const uint32_t e = c.step(lut, rule);  // fits: pass A counted it
      c.rem -= static_cast<int>(e >> 8);
      c.consume(e >> 8);
      out[o + i] = static_cast<uint8_t>(e & 255u);
    }
  }
  for (int i = static_cast<int>(total) + tid; i < block_len; i += blk.nt) out[i] = 0;
  return rounds;
}

#ifdef __CUDACC__
// The thread block's barrier, vote and warp shuffles (blockDim.x a
// multiple of 32).
struct DeviceBlock {
  int tid, nt;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ bool any(bool v) const { return __syncthreads_or(v) != 0; }
  __device__ __forceinline__ uint32_t up(uint32_t v, int d) const {
    return __shfl_up_sync(0xffffffffu, v, d);
  }
};
#endif

}  // namespace tpuhuff_decode
