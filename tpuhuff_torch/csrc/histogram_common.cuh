// The body of the histogram kernel K3 (histogram.cu): one thread block's
// exact 256-bin byte counts of its share of data[0:n].
//
// What bounds it on an H100: reading n bytes once from device memory
// (64 MiB is ~20 us at 3.35 TB/s) against counting each byte in shared
// memory, which must not slow down when the bytes are skewed (text, runs
// of one byte, zero padding).  Counting costs at least one shared-memory
// instruction per byte, and the card runs few of them: on an H100 80GB
// HBM3 at 700 W, 64 MiB took 0.039 ms with a load and a store per byte,
// 0.030 ms with one shared atomicAdd per byte, and 0.026 ms for the loads
// alone (experiments/hist_sweep.py; PERF.md).  The design:
//   * counters no byte value can serialise: each of the kThreads threads
//     owns a column of 256 uint16_t counters in dynamic shared memory, laid
//     out bin-major, cnt[bin * kThreads + column(t)].  column() places the
//     32 threads of a warp in 32 distinct banks (lane l at word l of the
//     warp's 128-byte slice of a row; the 2 threads that share a word are
//     in 2 different warps), so a warp's increments never conflict and
//     never meet on one address, whatever the bytes: a run of one byte
//     costs what random bytes cost.  A byte is one shared atomicAdd of
//     1 << 16 * (column % 2) into the word that holds the thread's counter:
//     one instruction where a 16-bit load and store would be two; the
//     word's other half, a thread's of another warp, stays intact.
//   * folds before a counter can wrap: a thread counts at most
//     Counters::kFoldSteps * kVecsPerStep * 16 bytes of the vector loop
//     plus one head and one tail byte between two folds, so no counter
//     passes 65535.  At a fold thread t sums the kThreads counters of bin t
//     (16-byte shared loads, staggered so that a warp's rows spread over
//     the banks), adds the sum to its per-block total and clears them.
//     The per-block totals are uint64_t (one register pair per thread,
//     thread t holding bin t), so they cannot wrap for any n: a resident
//     grid of one block to an SM gives a block gigabytes of a large input.
//   * loads that hide latency: the grid is resident (launch() sizes it to
//     the SMs times the blocks an SM holds: 128 KiB of counters allow one),
//     and block b owns the contiguous vectors [b * nvec / grid,
//     (b + 1) * nvec / grid) of the 16-byte-aligned part of data.  A step
//     is kVecsPerStep vectors per thread, neighbouring threads on
//     neighbouring vectors; the next step's vectors are loaded into
//     registers before the current ones are counted.  The unaligned head
//     and the ragged tail (at most 15 bytes each) are counted one byte per
//     thread by the last block; no padding is read.
//   * the merge: each thread adds its bin's per-block total to out with one
//     global 64-bit atomicAdd (the kernel's epilogue), at most one per bin
//     per resident block.
//
// Everything here compiles with g++ as well, with CUDA's qualifiers
// defined away, so that a CPU test runs the same code on one std::thread
// per CUDA thread (tests/test_torch_histogram_body.py); the block's
// barrier comes from a Block policy (DeviceBlock in histogram.cu, or the
// test's emulation).  The counters are one struct, Counters, that
// experiments/hist_sweep.py replaces with other designs to time them.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#include <atomic>
#endif

namespace tpuhuff_hist {

constexpr int kThreads = 256;      // one thread per bin at the folds
constexpr int kVecsPerStep = 5;    // 16-byte vectors per thread per step

#ifdef __CUDACC__
using Vec16 = uint4;
__device__ __forceinline__ Vec16 load16(const Vec16* p) { return __ldg(p); }
__device__ __forceinline__ void shared_add(uint32_t* p, uint32_t v) { atomicAdd(p, v); }
#else
struct Vec16 {
  uint32_t x, y, z, w;
};
inline Vec16 load16(const Vec16* p) { return *p; }
inline void shared_add(uint32_t* p, uint32_t v) {
  std::atomic_ref<uint32_t>(*p).fetch_add(v, std::memory_order_relaxed);
}
#endif

// This thread's half-word in each bin's row of counters.
__device__ __forceinline__ uint32_t column(int t) {
  return static_cast<uint32_t>((t & ~63) | ((t & 31) << 1) | ((t >> 5) & 1));
}

// counters: begin (experiments/hist_sweep.py replaces this struct)
struct Counters {
  static constexpr int kSmemBytes = 2 * 256 * kThreads;  // 128 KiB
  static constexpr int kFoldSteps = (65535 - 2) / (16 * kVecsPerStep);

  uint16_t* cnt;
  uint32_t col;
  int t;

  __device__ __forceinline__ Counters(uint8_t* smem, int tid)
      : cnt(reinterpret_cast<uint16_t*>(smem)), col(column(tid)), t(tid) {}

  // Every thread of the block, then a barrier.
  __device__ __forceinline__ void clear() {
    Vec16* v = reinterpret_cast<Vec16*>(cnt);
    for (int i = t; i < kSmemBytes / 16; i += kThreads) v[i] = Vec16{0u, 0u, 0u, 0u};
  }
  __device__ __forceinline__ void add(uint32_t byte) {
    shared_add(reinterpret_cast<uint32_t*>(cnt + ((byte << 8) | (col & ~1u))),
               1u << (16 * (col & 1u)));
  }
  __device__ __forceinline__ void add4(uint32_t w) {
    add(w & 255u);
    add((w >> 8) & 255u);
    add((w >> 16) & 255u);
    add(w >> 24);
  }
  // Between two barriers: bin t's count since the last fold; its counters
  // are cleared.  Row t is 32 vectors; thread t starts at vector t % 32.
  __device__ __forceinline__ uint32_t fold() {
    Vec16* row = reinterpret_cast<Vec16*>(cnt + t * kThreads);
    uint32_t sum = 0;
#pragma unroll 4
    for (int j = 0; j < kThreads / 8; ++j) {
      Vec16* p = row + ((j + t) & (kThreads / 8 - 1));
      const Vec16 v = *p;
      sum += (v.x & 0xFFFFu) + (v.x >> 16) + (v.y & 0xFFFFu) + (v.y >> 16) +
             (v.z & 0xFFFFu) + (v.z >> 16) + (v.w & 0xFFFFu) + (v.w >> 16);
      *p = Vec16{0u, 0u, 0u, 0u};
    }
    return sum;
  }
};
static_assert(Counters::kFoldSteps * kVecsPerStep * 16 + 2 <= 65535,
              "a uint16_t counter could wrap between two folds");
// counters: end

// Count the 16-byte vectors [base, base + kVecsPerStep * kThreads) of vec
// below hi that are thread t's (base + j * kThreads + t).
__device__ __forceinline__ void count_step(Counters& c, const Vec16 (&v)[kVecsPerStep],
                                           int64_t base, int64_t hi, int t) {
#pragma unroll
  for (int j = 0; j < kVecsPerStep; ++j) {
    if (base + j * kThreads + t < hi) {
      c.add4(v[j].x);
      c.add4(v[j].y);
      c.add4(v[j].z);
      c.add4(v[j].w);
    }
  }
}

__device__ __forceinline__ void load_step(const Vec16* vec, Vec16 (&v)[kVecsPerStep],
                                          int64_t base, int64_t hi, int t) {
#pragma unroll
  for (int j = 0; j < kVecsPerStep; ++j) {
    const int64_t i = base + j * kThreads + t;
    if (i < hi) v[j] = load16(vec + i);
  }
}

// Block `block` of `grid`: returns the count of bin blk.tid in this block's
// share of data[0:n].  smem holds Counters::kSmemBytes, 16-byte aligned.
// Every thread of the block calls it (it holds barriers).
template <class Block>
__device__ __forceinline__ uint64_t count_block(const uint8_t* data, int64_t n,
                                                int64_t block, int64_t grid,
                                                uint8_t* smem, const Block& blk) {
  const int t = blk.tid;
  Counters c(smem, t);
  c.clear();
  blk.sync();

  const uint64_t addr = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(data));
  const int64_t align = static_cast<int64_t>((16 - (addr & 15)) & 15);
  const int64_t head = align < n ? align : n;
  const int64_t nvec = (n - head) / 16;
  const int64_t tail0 = head + nvec * 16;
  if (block == grid - 1) {
    if (t < head) c.add(data[t]);
    if (t < n - tail0) c.add(data[tail0 + t]);
  }

  const Vec16* vec = reinterpret_cast<const Vec16*>(data + head);
  const int64_t lo = block * nvec / grid;
  const int64_t hi = (block + 1) * nvec / grid;
  constexpr int64_t kStep = static_cast<int64_t>(kVecsPerStep) * kThreads;
  uint64_t total = 0;
  Vec16 next[kVecsPerStep] = {};
  load_step(vec, next, lo, hi, t);
  int since_fold = 0;
  for (int64_t base = lo; base < hi; base += kStep) {  // the same trips in every thread
    Vec16 cur[kVecsPerStep];
#pragma unroll
    for (int j = 0; j < kVecsPerStep; ++j) cur[j] = next[j];
    load_step(vec, next, base + kStep, hi, t);
    count_step(c, cur, base, hi, t);
    if (++since_fold == Counters::kFoldSteps || base + kStep >= hi) {
      since_fold = 0;
      blk.sync();
      total += c.fold();
      blk.sync();
    }
  }
  if (lo >= hi) {  // no vectors: the head and the tail only
    blk.sync();
    total += c.fold();
  }
  return total;
}

}  // namespace tpuhuff_hist
