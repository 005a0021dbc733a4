// The decode body shared by K2 (decode.cu, canonical ladder) and K4
// (decode_general.cu, interval search): prefix-code decode of independent
// blocks, on one of two routes chosen at launch from the row width: rows
// staged through shared memory, one thread per block, or rows read from
// device memory, one thread block per block (decode_split.cuh).
//
// Contract, per block b (row b of `rows`, W u32 words, MSB-first values):
//   the cursor starts at bit bit0[b]; the next 32 bits (MSB-aligned, words
//   past W read as 0) give (symbol, length) by the decoder's rule; the
//   symbol is emitted while consumed + length <= nbits[b], and every later
//   position of the block's block_len outputs is 0.
//
// What bounds it on an H100: the serial chain of one block, each symbol's
// length deciding where the next window starts; the bytes (the rows' words
// read once, block_len bytes written per block) are ~0.03 ms at the main
// path's shape.  So the time is the chain's latency over the number of
// chains in flight, and the design keeps the chain short and off device
// memory and keeps as many chains in flight as it can:
//   * first-level table: the window's top k bits index 2^k 16-bit entries
//     (sym | len << 8, built on the host) in shared memory, so a code of at
//     most k bits costs one shared load; an entry of 0 escapes to the
//     decoder's own rule (Rule::resolve, out of line), which defines the
//     result on every window, codes or not (Cursor::step, decode_split.cuh,
//     the one per-code step of both routes);
//   * register bit buffer: 64 bits per thread, refilled with one word of
//     the row (prefetched one ahead) whenever fewer than 32 remain;
//   * staged route, input tile: a thread block takes tile_rows consecutive
//     blocks, whose rows are one contiguous span of tile_rows * W words;
//     the span is copied to shared memory with 16-byte cp.async (the head
//     and tail word by word, since rows may be any 4-byte aligned view).
//     One buffer, not two with the next tile's copy in flight: the shared
//     memory a second buffer takes holds more blocks in flight, which
//     measured faster (experiments/decode_lut_sweep.py);
//   * staged route, output pieces: each thread gathers 16 output bytes in
//     registers and stores them to its row of a shared piece of kPiece
//     bytes per block (rows padded to an odd number of 16-byte units: no
//     bank conflicts), zero fill included; between two barriers the piece
//     leaves with stores of 16 bytes (8, 4 or 1 where block_len is not a
//     multiple), consecutive threads on consecutive addresses of each
//     block's row.  Pieces, not whole rows, keep the shared memory per
//     block small, so more blocks are in flight;
//   * a persistent grid: as many thread blocks as fit on the card at once,
//     each looping over tiles (or blocks), so the table is loaded once per
//     thread block;
//   * rows too wide for shared memory (one row's words beside the table and
//     the output piece: from about 49,500 words, e.g. 64 KiB blocks of
//     32-bit codes) take the global-rows route (kGlobalRows): one thread
//     block per Huffman block, its bits split into subsequences that the
//     threads decode side by side and synchronise to a fixed point, then a
//     block-wide scan and a second pass that writes the bytes
//     (decode_split.cuh).  The rows stay in device memory (L2 holds a
//     launch's); the output is staged in shared memory where block_len
//     fits beside the table, and leaves with the staged route's stores.
//     Rows that the staged route fits fewer than kSplitBelow (32) to a
//     thread block take it too: at staged fits of 1 to 28 it measured 3.8x
//     to 155x faster than the staged route's few chains per SM
//     (experiments/decode_split_crossover.py).  The launch reports which
//     route it took.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace tpuhuff_decode {

// The most Huffman blocks a thread block of the staged route takes, and
// the staged fit below which a launch takes the global-rows route; -D
// overrides them for experiments/decode_lut_sweep.py and
// experiments/decode_split_crossover.py.
#ifndef TPUHUFF_DECODE_TILE_ROWS
#define TPUHUFF_DECODE_TILE_ROWS 768
#endif
#ifndef TPUHUFF_DECODE_SPLIT_BELOW
#define TPUHUFF_DECODE_SPLIT_BELOW 32
#endif

constexpr int kMaxThreads = 1024;  // rows per tile, at most
constexpr int kTileRows = TPUHUFF_DECODE_TILE_ROWS;
constexpr int kSplitBelow = TPUHUFF_DECODE_SPLIT_BELOW;
constexpr int kPiece = 64;         // output bytes per block between flushes
constexpr int kPieceStride = 80;   // its shared row: 5 units of 16 bytes
static_assert(kTileRows >= 1 && kTileRows <= kMaxThreads, "one thread per row");
static_assert(kSplitBelow >= 1, "rows that do not fit take the global-rows route");
static_assert(kSplitMaxThreads <= kMaxThreads, "the kernels' launch bounds");

// The two routes of a launch.
enum Route { kStaged, kGlobalRows };

struct Params {
  const uint32_t* rows;
  const int32_t* bit0;
  const int32_t* nbits;
  const uint16_t* lut;
  uint8_t* out;
  int B, W, block_len;
  int tile_rows, n_tiles;
  int rule_off, in_off, out_off;  // byte offsets in dynamic shared memory
  int stage_out;  // global-rows route: the output staged in shared memory
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared memory layout of the staged route: [lut][rule tables][input
// span][output piece].  Returns the bytes for `rows` rows per tile and
// fills p's layout fields.
__host__ inline size_t layout(Params& p, int rows, int rule_bytes) {
  const size_t lut_bytes = round16((1 << kLutBits) * 2);
  // the span and a 3-word head slack (see span_head), rounded to 16 bytes
  const size_t in_words = (static_cast<size_t>(rows) * p.W + 3 + 3) & ~size_t(3);
  p.tile_rows = rows;
  p.rule_off = static_cast<int>(lut_bytes);
  p.in_off = static_cast<int>(lut_bytes + round16(rule_bytes));
  p.out_off = static_cast<int>(p.in_off + in_words * 4);
  p.stage_out = 0;
  return static_cast<size_t>(p.out_off) + static_cast<size_t>(rows) * kPieceStride;
}

// Shared memory layout of the global-rows route: [lut][rule tables][the
// threads' stop positions and the scan's warp sums][output row, if
// staged].  Returns the bytes and fills p's layout fields.
__host__ inline size_t split_layout(Params& p, int rule_bytes, bool stage_out) {
  const size_t lut_bytes = round16((1 << kLutBits) * 2);
  p.rule_off = static_cast<int>(lut_bytes);
  p.in_off = static_cast<int>(lut_bytes + round16(rule_bytes));
  p.out_off = p.in_off + (kMaxThreads + 32) * 4;
  p.stage_out = stage_out ? 1 : 0;
  return static_cast<size_t>(p.out_off) +
         (stage_out ? static_cast<size_t>(round16(p.block_len)) : 0);
}

// The most rows (<= kTileRows, a multiple of 32 from 32 up) whose tile fits
// in max_smem bytes, or 0 if not even one row fits.
__host__ inline int choose_rows(Params& p, int rule_bytes, size_t max_smem) {
  int rows = kTileRows >= 32 ? kTileRows - kTileRows % 32 : kTileRows;
  for (; rows >= 1; rows = rows > 32 ? rows - 32 : rows - 1) {
    if (layout(p, rows, rule_bytes) <= max_smem) return rows;
  }
  return 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows of the tile that starts at block b0 (the last tile may be short).
__device__ __forceinline__ int tile_rows_at(const Params& p, int64_t b0) {
  const int64_t left = p.B - b0;
  return left < p.tile_rows ? static_cast<int>(left) : p.tile_rows;
}

// Word offset, modulo 16 bytes, of the span that starts at block b0: span
// word j lives at buf[h0 + j], so that global and shared addresses are
// 16-byte aligned together.
__device__ __forceinline__ int span_head(const Params& p, int64_t b0) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p.rows + b0 * p.W) >> 2) & 3);
}

// Copy the tile's span of row words into `buf` (16-byte cp.async, the
// unaligned head and the ragged tail word by word); the caller waits for
// the copies before a barrier.
__device__ __forceinline__ void stage_tile(const Params& p, int tile,
                                           uint32_t* buf, int tid, int nt) {
  const int64_t b0 = static_cast<int64_t>(tile) * p.tile_rows;
  const uint32_t* src = p.rows + b0 * p.W;
  const int n = tile_rows_at(p, b0) * p.W;
  const int h0 = span_head(p, b0);
  uint32_t* dst = buf + h0;
  const int a0 = min((4 - h0) & 3, n);  // words before the first 16-byte unit
  const int nvec = (n - a0) / 4;
  const int a1 = a0 + nvec * 4;
  for (int v = tid; v < nvec; v += nt) cp_async16(dst + a0 + 4 * v, src + a0 + 4 * v);
  if (tid < a0) dst[tid] = src[tid];
  if (a1 + tid < n) dst[a1 + tid] = src[a1 + tid];  // < 4 words
}

// Decode the next 16 positions of cur's block (with kTail, only the first
// lim) into the 16 bytes at o (shared, 16-aligned); positions past the
// block's last whole code are 0.  Once a code would pass nbits, rem is -1
// and no later code fits.
template <bool kTail, class Rule>
__device__ __forceinline__ void decode_group(Cursor& cur, uint8_t* o, int lim,
                                             const uint16_t* lut, const Rule& rule) {
  uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
  if (cur.rem >= 0) {
#pragma unroll 1
    for (int w = 0; w < 16; w += 4) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!kTail || w + j < lim) {
          const uint32_t e = cur.step(lut, rule);
          const uint32_t len = e >> 8;
          if (static_cast<int>(len) <= cur.rem) {
            word |= (e & 255u) << (8 * j);
            cur.rem -= static_cast<int>(len);
            cur.consume(len);
          } else {
            cur.rem = -1;
          }
        }
      }
      a0 = a1;
      a1 = a2;
      a2 = a3;
      a3 = word;
    }
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(a0, a1, a2, a3);
}

// Copy one piece of every row of the tile to the output: row r's bytes
// [c0, c0 + len) leave from s_out + r * kPieceStride, in units of V bytes
// (V divides block_len and the output's alignment), consecutive threads on
// consecutive units of a row.
template <int V>
__device__ __forceinline__ void store_piece(const Params& p, const uint8_t* s_out,
                                            int64_t b0, int rows, int c0,
                                            int len, int tid, int nt) {
  const int units = len / V;  // V divides block_len, hence len
  uint8_t* base = p.out + b0 * p.block_len + c0;
  for (int u = tid; u < rows * units; u += nt) {
    const int r = u / units;
    const int c = (u - r * units) * V;
    uint8_t* dst = base + static_cast<int64_t>(r) * p.block_len + c;
    const uint8_t* src = s_out + r * kPieceStride + c;
    if constexpr (V == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    } else {
      *dst = *src;
    }
  }
}

// The widest store unit, in bytes, that divides block_len and the
// output's alignment.
__device__ __forceinline__ int store_unit(const Params& p) {
  const int align = static_cast<int>(reinterpret_cast<uintptr_t>(p.out) | p.block_len);
  return align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 1;
}

// store_piece in units of V = store_unit(p) bytes.
__device__ __forceinline__ void store(int V, const Params& p, const uint8_t* s_out,
                                      int64_t b0, int rows, int c0, int len,
                                      int tid, int nt) {
  if (V == 16) {
    store_piece<16>(p, s_out, b0, rows, c0, len, tid, nt);
  } else if (V == 8) {
    store_piece<8>(p, s_out, b0, rows, c0, len, tid, nt);
  } else if (V == 4) {
    store_piece<4>(p, s_out, b0, rows, c0, len, tid, nt);
  } else {
    store_piece<1>(p, s_out, b0, rows, c0, len, tid, nt);
  }
}

// The staged route's body: a persistent loop over tiles.
template <class Rule>
__device__ __forceinline__ void decode_tiles(const Params& p,
                                             const typename Rule::Args& args) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_in = reinterpret_cast<uint32_t*>(smem + p.in_off);
  uint8_t* s_out = smem + p.out_off;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int BL = p.block_len;
  const int V = store_unit(p);

  for (int i = tid; i < (1 << kLutBits); i += nt) s_lut[i] = p.lut[i];
  const Rule rule = Rule::load(smem + p.rule_off, args, tid, nt);

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    stage_tile(p, tile, s_in, tid, nt);
    cp_async_wait_all();
    __syncthreads();  // the span, and at the first tile the tables

    const int64_t b0 = static_cast<int64_t>(tile) * p.tile_rows;
    const int rows = tile_rows_at(p, b0);
    Cursor cur;
    cur.rem = -1;
    if (tid < rows) {
      cur.start(s_in + span_head(p, b0) + tid * p.W, p.W, p.bit0[b0 + tid],
                p.nbits[b0 + tid]);
    }
    uint8_t* mine = s_out + tid * kPieceStride;
    for (int c0 = 0; c0 < BL; c0 += kPiece) {
      const int len = BL - c0 < kPiece ? BL - c0 : kPiece;
      if (tid < rows) {
#pragma unroll 1
        for (int g = 0; g < len; g += 16) {
          if (len - g >= 16) {
            decode_group<false>(cur, mine + g, 16, s_lut, rule);
          } else {
            decode_group<true>(cur, mine + g, len - g, s_lut, rule);
          }
        }
      }
      __syncthreads();
      store(V, p, s_out, b0, rows, c0, len, tid, nt);
      __syncthreads();  // the piece has left before the next one is written
    }                   // (and, at the last piece, the span was read)
  }
}

// The global-rows route's body: a persistent loop over Huffman blocks, one
// at a time on all the thread block's threads (decode_split.cuh).
template <class Rule>
__device__ __forceinline__ void decode_split(const Params& p,
                                             const typename Rule::Args& args) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  int* s_pos = reinterpret_cast<int*>(smem + p.in_off);
  uint32_t* s_warp = reinterpret_cast<uint32_t*>(s_pos + kMaxThreads);
  uint8_t* s_out = smem + p.out_off;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int BL = p.block_len;
  const int V = store_unit(p);

  for (int i = tid; i < (1 << kLutBits); i += nt) s_lut[i] = p.lut[i];
  const Rule rule = Rule::load(smem + p.rule_off, args, tid, nt);
  __syncthreads();  // the tables
  const DeviceBlock blk{tid, nt};

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    uint8_t* out = p.stage_out ? s_out : p.out + static_cast<int64_t>(b) * BL;
    // the previous block's output has left: split_block's first barrier
    // comes before its first write to out
    split_block(blk, p.rows + static_cast<int64_t>(b) * p.W, p.W, p.bit0[b],
                p.nbits[b], BL, s_lut, rule, s_pos, s_warp, out);
    if (p.stage_out) {
      __syncthreads();
      store(V, p, s_out, b, 1, 0, BL, tid, nt);
    }
  }
}

template <class Rule, Route kRoute>
__device__ __forceinline__ void decode_body(const Params& p,
                                            const typename Rule::Args& args) {
  if constexpr (kRoute == kStaged) {
    decode_tiles<Rule>(p, args);
  } else {
    decode_split<Rule>(p, args);
  }
}

// Host side.  The staged route's tile: the most rows that fit in shared
// memory (at most kTileRows), then as few as still take the same number of
// waves of resident thread blocks, so that the last wave is full and a
// small launch spreads over more SMs.  The grid: as many thread blocks as
// are resident at once (a persistent loop over tiles).  A row of which
// fewer than kSplitBelow fit in one tile (at least: none) takes the
// global-rows route (out.global_rows): split_threads(W) threads, one
// thread block per Huffman block, the output staged in shared memory where
// it fits.
struct Plan {
  int rows, threads, grid;
  size_t smem;
  bool global_rows;
};

template <class Args>
using Kernel = void (*)(Params, Args);

template <class Args>
cudaError_t plan(Kernel<Args> staged, Kernel<Args> global, Params& p,
                 int rule_bytes, Plan& out) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t max_bytes = static_cast<size_t>(max_smem);
  const int fit = choose_rows(p, rule_bytes, max_bytes);
  out.global_rows = fit < kSplitBelow;
  const Kernel<Args> kernel = out.global_rows ? global : staged;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess)  // all of L1 that shared memory may take
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if (out.global_rows) {
    out.rows = 1;
    out.threads = split_threads(p.W);
    out.smem = split_layout(p, rule_bytes, true);
    if (out.smem > max_bytes) out.smem = split_layout(p, rule_bytes, false);
    if (out.smem > max_bytes) return cudaErrorInvalidValue;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, out.threads,
                                                        out.smem);
    if (err != cudaSuccess) return err;
    p.n_tiles = p.B;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, (fit + 31) & ~31, layout(p, fit, rule_bytes));
    if (err != cudaSuccess) return err;
    const int64_t slots = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
    const int64_t waves = (p.B + slots * fit - 1) / (slots * fit);
    const int64_t even = (p.B + slots * waves - 1) / (slots * waves);
    out.rows = static_cast<int>(even < fit ? ((even + 31) & ~int64_t(31)) : fit);
    if (out.rows > fit) out.rows = fit;
    out.threads = (out.rows + 31) & ~31;
    out.smem = layout(p, out.rows, rule_bytes);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, out.threads,
                                                        out.smem);
    if (err != cudaSuccess) return err;
    p.n_tiles = static_cast<int>((static_cast<int64_t>(p.B) + out.rows - 1) / out.rows);
  }
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  out.grid = static_cast<int>(resident < p.n_tiles ? resident : p.n_tiles);
  return cudaSuccess;
}

// Sets *global_rows (where not null) to 1 if the launch took the
// global-rows route, else 0.
template <class Args>
int launch(Kernel<Args> staged, Kernel<Args> global, Params p, const Args& args,
           int rule_bytes, int* global_rows, cudaStream_t stream) {
  if (global_rows) *global_rows = 0;
  if (p.B <= 0) return 0;
  Plan pl;
  const cudaError_t err = plan(staged, global, p, rule_bytes, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (global_rows) *global_rows = pl.global_rows ? 1 : 0;
  (pl.global_rows ? global : staged)<<<pl.grid, pl.threads, pl.smem, stream>>>(p, args);
  return static_cast<int>(cudaGetLastError());
}

// Rows per tile that launch() takes for B blocks of rows of W words on the
// current device, staged through shared memory (0: the launch takes the
// global-rows route; -1: a CUDA error).
template <class Args>
int tile_rows(Kernel<Args> staged, Kernel<Args> global, int rule_bytes, int B,
              int W, int block_len) {
  Params p{};
  p.B = B > 0 ? B : 1;
  p.W = W;
  p.block_len = block_len;
  Plan pl;
  const cudaError_t err = plan(staged, global, p, rule_bytes, pl);
  if (err != cudaSuccess) return -1;
  return pl.global_rows ? 0 : pl.rows;
}

}  // namespace tpuhuff_decode
