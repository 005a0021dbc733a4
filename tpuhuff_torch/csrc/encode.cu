// Encode kernel (K1) and fused encode + histogram kernel (K5): pack byte
// lanes into MSB-first Huffman bitstreams, and with a histogram also count
// the bytes of an operand.
//
// Replaces tpuhuff/kernels/pallas_encode2.py::_encode_kernel_fused (the
// fused canonical-ladder + doubling bit-merge Pallas kernel, K1, and its
// with_hist=True form, K5, whose int8 one-hot MXU histogram is at :314-332)
// on the paths tpuhuff_torch.io.stream.read_compress_write_hf2 and
// read_compress_write -> kernels.encode_blocks.  The same kernel also
// serves the function of pallas_encode2.py::_encode_kernel (:169) behind
// the flat (_encode_call, :400) and cell-major (_encode_call_cells, :577)
// layouts, which the TPU took for lanes of N < 16 bytes or N % 4 != 0 and
// for A/B runs: here any power-of-two N <= 1024 takes this one kernel.
//
// Contract, per lane of N input bytes (N a power of two <= 1024):
//   * byte i < valid[lane] with code (len, left-aligned acode) appends its
//     len bits; bytes at i >= valid[lane] emit nothing;
//   * words[lane, :R] are numeric MSB-first u32 words, zero past the bits
//     (every one of the R words is written: `words` may come uninitialised);
//   * bits[lane] is the exact bit count, miss[lane] the number of valid
//     bytes whose LUT length is 0 (a byte the tree has no code for).
// With a histogram: hist_out[v] += the number of bytes equal to v in
// hist[0:n_hist] (n_hist <= B * N); hist_out is 256 unsigned 64-bit
// counters that the caller zeroes.  The pointers pick the route: where
// hist is the lanes' own storage from their first byte (hist == data), the
// kernel counts the bytes it holds for the encode; any other operand (any
// alignment) is read apart.
//
// What bounds it on an H100: device memory traffic.  A lane reads N bytes
// and writes R = ceil(max_len * N / 32) words: at the main path's shape
// (262,144 lanes of 256 B, 14-bit codes, R = 112) that is 187,697,152 B,
// 0.0560 ms at 3.35 TB/s.  The TPU kernel's select-tree LUTs, perm-matmul
// layout and MXU transposes existed because the TPU has no fast gather:
// here the (code, length) table sits in shared memory, which also lifts
// the TPU route's 2*max_len <= 32 and N <= 1024 bounds, and the TPU's
// nibble one-hot histogram becomes shared-memory atomics.  Next to the
// bytes, the work is some fifteen integer instructions per byte, whose
// issue time is of the same order as the bytes' time: so the design keeps
// every access wide, keeps the next tile's bytes in flight, and spends as
// few instructions per byte and per lane as it can:
//   * a persistent grid: as many thread blocks as are resident at once,
//     each walking over tiles of T consecutive lanes, whose input (T*N
//     bytes) and output (T*R words) are each one contiguous span; the
//     table is loaded and K5's per-warp bins are merged (one 64-bit global
//     atomicAdd per non-empty bin) once per thread block;
//   * the next tile in flight: a ring of kStages input tiles in shared
//     memory, filled with 16-byte cp.async (the tile's valid counts with
//     4-byte ones) while the current tile is encoded; a lanes view that is
//     not 16-byte aligned, and the ragged tail of a last tile of lanes
//     under 16 bytes, are copied byte by byte;
//   * each byte read once: a thread takes its P bytes of a lane with one
//     vector load from the tile and looks each up once; the codes are
//     packed in registers and each word is stored whole to the shared
//     output tile, which starts zeroed (csrc/encode_common.cuh: a scan of
//     the bit counts over the lane's N/P threads, a branch-free packing
//     loop, at most one shared atomicOr per thread for the words it shares
//     with a neighbour).  P (kBytesPerThread, or N or N/32 at the ends)
//     trades the scan's cost per lane against registers: a warp holds
//     32*P/N lanes.  Where every code has at most 26 bits (the common
//     case) the table is one word per byte value, code and length
//     together, and two words otherwise;
//   * the output tile leaves with 16-byte stores, consecutive threads on
//     consecutive addresses, and is zeroed as it is read; the lanes' bit
//     and missing counts leave with it;
//   * K5 counts from the registers the encode already holds where the
//     operand is the lanes (the adaptive path's only call), and otherwise
//     reads its tile's slice of the operand with 16-byte loads inside the
//     same loop.
// kStages, the tile's input bytes and kBytesPerThread are compile-time
// constants; -D overrides them for experiments/encode_sweep.py, which
// chose them (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_common.cuh"

namespace {

using tpuhuff_encode::Bytes;
using tpuhuff_encode::Code;
using tpuhuff_encode::DeviceWarp;

#ifndef TPUHUFF_ENCODE_TILE_BYTES
#define TPUHUFF_ENCODE_TILE_BYTES 8192
#endif
#ifndef TPUHUFF_ENCODE_STAGES
#define TPUHUFF_ENCODE_STAGES 2
#endif
constexpr int kWarps = 8;  // warps per thread block
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = TPUHUFF_ENCODE_TILE_BYTES;  // input bytes per tile
constexpr int kStages = TPUHUFF_ENCODE_STAGES;         // input tiles in the ring
static_assert(kStages >= 1 && kStages <= 4, "one to four input stages");

enum Route : int { kNone = 0, kInLanes = 1, kDistinct = 2 };

struct Params {
  const uint8_t* data;
  const int32_t* valid;
  const int32_t* lens;
  const uint32_t* acodes;
  uint32_t* words;
  int32_t* bits;
  int32_t* miss;
  int B, N, R;
  int T, n_tiles;  // lanes per tile, tiles
  int aligned;     // data is 16-byte aligned: tiles go by cp.async
  const uint8_t* hist;
  int64_t n_hist;
  unsigned long long* hist_out;
  int valid_off, counts_off, in_off, out_off;  // offsets in shared memory
};

constexpr int kWideBytes = (tpuhuff_encode::kTableEntries * sizeof(Code) + 15) & ~15;
constexpr int kNarrowBytes = (tpuhuff_encode::kTableEntries * 4 + 15) & ~15;
constexpr int kTableBytes = kWideBytes + kNarrowBytes;
constexpr int kBinBytes = kWarps * 256 * 4;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared memory: [wide table][narrow table][bins, with a histogram][valid
// ring][the tile's bits and miss][input ring][output tile].  Returns the
// bytes and fills p's offsets.
__host__ inline size_t layout(Params& p, int T, int route) {
  int off = kTableBytes + (route != kNone ? kBinBytes : 0);
  p.valid_off = off;
  off += round16(kStages * T * 4);
  p.counts_off = off;
  off += round16(2 * T * 4);
  p.in_off = off;
  off += kStages * T * p.N;  // T*N is a multiple of 16 (T % 16 == 0)
  p.out_off = off;
  return static_cast<size_t>(off) + static_cast<size_t>(T) * p.R * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ int tile_rows(const Params& p, int tile) {
  const int64_t left = p.B - static_cast<int64_t>(tile) * p.T;
  return left < p.T ? static_cast<int>(left) : p.T;
}

// Start copying tile `tile`'s lanes and valid counts into ring slot `slot`
// (nothing past the last tile); the caller commits the group.
__device__ __forceinline__ void stage(const Params& p, int tile, int slot,
                                      uint8_t* s_in, int32_t* s_valid, int tid) {
  if (tile >= p.n_tiles) return;
  const int64_t lane0 = static_cast<int64_t>(tile) * p.T;
  const int rows = tile_rows(p, tile);
  const int n = rows * p.N;
  const uint8_t* src = p.data + lane0 * p.N;
  uint8_t* dst = s_in + slot * p.T * p.N;
  int i = 0;
  if (p.aligned) {
    const int nvec = n >> 4;
    for (int v = tid; v < nvec; v += kThreads) cp_async16(dst + 16 * v, src + 16 * v);
    i = nvec << 4;  // a last tile's tail of < 16 bytes
  }
  for (i += tid; i < n; i += kThreads) dst[i] = src[i];
  int32_t* vd = s_valid + slot * p.T;
  for (int r = tid; r < rows; r += kThreads) cp_async4(vd + r, p.valid + lane0 + r);
}

template <int P>
__device__ __forceinline__ Bytes<P> load_bytes(const uint8_t* src) {
  Bytes<P> b;
  if constexpr (P == 1) {
    b.w[0] = *src;
  } else if constexpr (P == 2) {
    b.w[0] = *reinterpret_cast<const uint16_t*>(src);
  } else if constexpr (P == 4) {
    b.w[0] = *reinterpret_cast<const uint32_t*>(src);
  } else if constexpr (P == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    b.w[0] = x.x;
    b.w[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < P / 16; ++j) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[j];
      b.w[4 * j] = x.x;
      b.w[4 * j + 1] = x.y;
      b.w[4 * j + 2] = x.z;
      b.w[4 * j + 3] = x.w;
    }
  }
  return b;
}

// One count in a warp's shared-memory bins.
struct SharedCount {
  uint32_t* bins;
  __host__ __device__ __forceinline__ void operator()(uint32_t v) const {
#ifdef __CUDA_ARCH__
    atomicAdd(&bins[v], 1u);
#endif
  }
};

__device__ __forceinline__ void count4(uint32_t* bins, uint32_t w) {
  atomicAdd(&bins[w & 255u], 1u);
  atomicAdd(&bins[(w >> 8) & 255u], 1u);
  atomicAdd(&bins[(w >> 16) & 255u], 1u);
  atomicAdd(&bins[w >> 24], 1u);
}

// kDistinct: count the operand's bytes under tile `tile`'s lanes,
// [tile*T*N, (tile+1)*T*N) clipped to n_hist, from device memory: 16-byte
// loads, the unaligned head and the ragged tail one byte per thread.
__device__ __forceinline__ void count_slice(const Params& p, int tile,
                                            uint32_t* bins, int tid) {
  const int64_t span = static_cast<int64_t>(p.T) * p.N;
  const int64_t s0 = static_cast<int64_t>(tile) * span;
  const int64_t s1 = s0 + span < p.n_hist ? s0 + span : p.n_hist;
  if (s0 >= s1) return;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.hist + s0);
  const int64_t head = static_cast<int64_t>((16 - (addr & 15)) & 15);
  const int64_t a0 = s0 + head < s1 ? s0 + head : s1;
  const int64_t nvec = (s1 - a0) / 16;
  const int64_t a1 = a0 + nvec * 16;
  const uint4* vec = reinterpret_cast<const uint4*>(p.hist + a0);
  for (int64_t v = tid; v < nvec; v += kThreads) {
    const uint4 x = __ldg(vec + v);
    count4(bins, x.x);
    count4(bins, x.y);
    count4(bins, x.z);
    count4(bins, x.w);
  }
  if (s0 + tid < a0) atomicAdd(&bins[p.hist[s0 + tid]], 1u);  // < 16 B
  if (a1 + tid < s1) atomicAdd(&bins[p.hist[a1 + tid]], 1u);  // < 16 B
}

// The kernel: a persistent loop over tiles of T lanes, P bytes per thread.
template <int P, int kRoute>
__global__ void __launch_bounds__(kThreads) encode_tiles(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  Code* s_wide = reinterpret_cast<Code*>(smem);
  uint32_t* s_narrow = reinterpret_cast<uint32_t*>(smem + kWideBytes);
  uint32_t* s_bins = reinterpret_cast<uint32_t*>(smem + kTableBytes);
  int32_t* s_valid = reinterpret_cast<int32_t*>(smem + p.valid_off);
  uint32_t* s_counts = reinterpret_cast<uint32_t*>(smem + p.counts_off);  // bits, miss
  uint8_t* s_in = smem + p.in_off;
  uint32_t* s_out = reinterpret_cast<uint32_t*>(smem + p.out_off);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // both layouts of the table; the narrow one serves where every code
  // fits it (the same choice on every thread block)
  static_assert(kThreads >= 256, "one thread per byte value");
  const uint32_t my_len = tid < 256 ? static_cast<uint32_t>(p.lens[tid]) : 0u;
  if (tid < 256) {
    const uint32_t acode = my_len ? p.acodes[tid] : 0u;
    s_wide[tid] = Code{acode, my_len};
    s_narrow[tid] = tpuhuff_encode::narrow_entry(acode, my_len);
  }
  if (tid == 0) {
    s_wide[tpuhuff_encode::kNoByte] = Code{0u, 0u};
    s_narrow[tpuhuff_encode::kNoByte] = tpuhuff_encode::kNarrowNoByte;
  }
  if constexpr (kRoute != kNone) {
    for (int i = tid; i < kWarps * 256; i += kThreads) s_bins[i] = 0u;
  }
  uint32_t* bins = s_bins + warp * 256;
  const int out_vec = p.T * p.R / 4;  // T*R % 4 == 0
  uint4* s_out4 = reinterpret_cast<uint4*>(s_out);
  for (int v = tid; v < out_vec; v += kThreads) s_out4[v] = make_uint4(0u, 0u, 0u, 0u);
  // the tables, the bins (before kDistinct's first count) and the tile
  const tpuhuff_encode::Table table{
      s_narrow, s_wide,
      __syncthreads_or(my_len > tpuhuff_encode::kNarrowMaxLen) != 0};

  // a lane takes S = N/P threads, P bytes each; G = 32/S lanes to a warp
  const int N = p.N;
  const int S = N / P;
  const int G = 32 / S;
  const int s = (tid & 31) & (S - 1);
  const int g = (tid & 31) / S;
  const DeviceWarp wp{S};

  for (int j = 0; j < kStages - 1; ++j) {
    stage(p, blockIdx.x + j * gridDim.x, j, s_in, s_valid, tid);
    cp_async_commit();
  }
  int k = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++k) {
    // the tile kStages - 1 ahead goes to the slot the last tile freed
    stage(p, tile + (kStages - 1) * gridDim.x, (k + kStages - 1) % kStages,
          s_in, s_valid, tid);
    cp_async_commit();
    if constexpr (kRoute == kDistinct) count_slice(p, tile, bins, tid);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this tile's bytes

    const int64_t lane0 = static_cast<int64_t>(tile) * p.T;
    const int rows = tile_rows(p, tile);
    const uint8_t* in = s_in + (k % kStages) * p.T * N;
    const int32_t* vin = s_valid + (k % kStages) * p.T;
    for (int base = warp * G; base < rows; base += kWarps * G) {
      const int l = base + g;
      const bool active = l < rows;
      Bytes<P> b{};
      int nvalid = 0;
      if (active) {
        b = load_bytes<P>(in + l * N + s * P);
        const int left = vin[l] - s * P;
        nvalid = left < 0 ? 0 : left > P ? P : left;
        if constexpr (kRoute == kInLanes) {
          tpuhuff_encode::count_held<P>(b, (lane0 + l) * N + s * P, p.n_hist,
                                        SharedCount{bins});
        }
      }
      uint32_t total, nmiss;
      tpuhuff_encode::encode_lane<P>(wp, s, S, b, nvalid, table,
                                     s_out + l * p.R, active, total, nmiss);
      if (active && s == 0) {
        s_counts[l] = total;
        s_counts[p.T + l] = nmiss;
      }
    }
    __syncthreads();  // the output tile is whole; the input slot is free

    // the tile's rows*R words are contiguous in `words`, 16-byte aligned
    // (words is, and T*R % 4 == 0); each unit read is zeroed for the next
    // tile (its first barrier orders this before the lanes' writes)
    uint32_t* dst = p.words + lane0 * p.R;
    const int n = rows * p.R;
    const int nvec = n >> 2;
    for (int v = tid; v < nvec; v += kThreads) {
      reinterpret_cast<uint4*>(dst)[v] = s_out4[v];
      s_out4[v] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = (nvec << 2) + tid; i < n; i += kThreads) {
      dst[i] = s_out[i];
      s_out[i] = 0u;
    }
    for (int r = tid; r < rows; r += kThreads) {
      p.bits[lane0 + r] = static_cast<int32_t>(s_counts[r]);
      p.miss[lane0 + r] = static_cast<int32_t>(s_counts[p.T + r]);
    }
  }
  cp_async_wait<0>();  // only empty groups can remain

  if constexpr (kRoute != kNone) {
    __syncthreads();
    for (int bin = tid; bin < 256; bin += kThreads) {
      uint32_t sum = 0;
#pragma unroll
      for (int c = 0; c < kWarps; ++c) sum += s_bins[c * 256 + bin];
      if (sum) atomicAdd(&p.hist_out[bin], static_cast<unsigned long long>(sum));
    }
  }
}

// Host side.  T: the tile's input bytes over N, a multiple of 16 (and of
// the lanes a warp holds), no more than B needs, and small enough for
// shared memory.  The grid: as many thread blocks as are resident at once.
struct Plan {
  void (*kernel)(Params);
  int grid;
  int per_sm;  // resident thread blocks per SM
  size_t smem;
};

template <int P, int kRoute>
cudaError_t plan_p(Params& p, Plan& out) {
  auto kernel = encode_tiles<P, kRoute>;
  out.kernel = kernel;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess)  // all of L1 that shared memory may take
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  const int per_warp = 32 * P / p.N;  // lanes a warp holds
  const int gran = per_warp > 16 ? per_warp : 16;
  int T = kTileBytes / p.N / gran * gran;
  const int64_t need = (static_cast<int64_t>(p.B) + gran - 1) / gran * gran;
  if (T > need) T = static_cast<int>(need);
  if (T < gran) T = gran;
  while (T > gran && layout(p, T, kRoute) > static_cast<size_t>(max_smem)) T -= gran;
  out.smem = layout(p, T, kRoute);
  if (out.smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  p.T = T;
  p.n_tiles = static_cast<int>((static_cast<int64_t>(p.B) + T - 1) / T);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, out.smem);
  if (err != cudaSuccess) return err;
  out.per_sm = per_sm > 0 ? per_sm : 1;
  const int64_t resident = static_cast<int64_t>(out.per_sm) * sms;
  out.grid = static_cast<int>(resident < p.n_tiles ? resident : p.n_tiles);
  return cudaSuccess;
}

template <int kRoute>
cudaError_t plan_route(Params& p, Plan& out) {
  switch (tpuhuff_encode::bytes_per_thread(p.N)) {
    case 1: return plan_p<1, kRoute>(p, out);
    case 2: return plan_p<2, kRoute>(p, out);
    case 4: return plan_p<4, kRoute>(p, out);
    case 8: return plan_p<8, kRoute>(p, out);
    case 16: return plan_p<16, kRoute>(p, out);
    case 32: return plan_p<32, kRoute>(p, out);
    default: return cudaErrorInvalidValue;
  }
}

// p.B, p.N (a power of two <= 1024) and p.R set: the kernel, its tile
// (p.T, p.n_tiles), grid and shared memory.
cudaError_t plan(Params& p, int route, Plan& out) {
  if (p.N < 1 || p.N > 1024 || (p.N & (p.N - 1)) || p.R < 1) return cudaErrorInvalidValue;
  switch (route) {
    case kNone: return plan_route<kNone>(p, out);
    case kInLanes: return plan_route<kInLanes>(p, out);
    case kDistinct: return plan_route<kDistinct>(p, out);
    default: return cudaErrorInvalidValue;
  }
}

int launch(const void* data, const void* valid, const void* lens,
           const void* acodes, void* words, void* bits, void* miss, int B,
           int N, int R, const void* hist, long long n_hist, int route,
           void* hist_out, void* stream) {
  if (reinterpret_cast<uintptr_t>(words) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (B <= 0) return 0;
  Params p{};
  p.data = static_cast<const uint8_t*>(data);
  p.valid = static_cast<const int32_t*>(valid);
  p.lens = static_cast<const int32_t*>(lens);
  p.acodes = static_cast<const uint32_t*>(acodes);
  p.words = static_cast<uint32_t*>(words);
  p.bits = static_cast<int32_t*>(bits);
  p.miss = static_cast<int32_t*>(miss);
  p.B = B;
  p.N = N;
  p.R = R;
  p.aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  p.hist = static_cast<const uint8_t*>(hist);
  p.n_hist = static_cast<int64_t>(n_hist);
  p.hist_out = static_cast<unsigned long long*>(hist_out);
  Plan pl;
  const cudaError_t err = plan(p, route, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.kernel<<<pl.grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpuhuff_encode_lanes(const void* data, const void* valid,
                                    const void* lens, const void* acodes,
                                    void* words, void* bits, void* miss, int B,
                                    int N, int R, void* stream) {
  return launch(data, valid, lens, acodes, words, bits, miss, B, N, R, nullptr,
                0, kNone, nullptr, stream);
}

// n_hist <= B * N.  The route comes from the pointers: the lanes' own
// storage from their first byte is counted from the bytes the encode holds.
extern "C" int tpuhuff_encode_lanes_hist(const void* data, const void* valid,
                                         const void* lens, const void* acodes,
                                         void* words, void* bits, void* miss,
                                         int B, int N, int R, const void* hist,
                                         long long n_hist, void* hist_out,
                                         void* stream) {
  const int route = hist == data && n_hist > 0 ? kInLanes : kDistinct;
  return launch(data, valid, lens, acodes, words, bits, miss, B, N, R, hist,
                n_hist, route, hist_out, stream);
}

// For experiments/encode_sweep.py: what a launch takes for B lanes of N
// bytes and R words on the current device, with a histogram where hist is
// nonzero: out[0..4] = lanes per tile, thread blocks, bytes of shared
// memory per thread block, thread blocks resident per SM, bytes per thread.
extern "C" int tpuhuff_encode_plan(int B, int N, int R, int hist, void* out) {
  Params p{};
  p.B = B > 0 ? B : 1;
  p.N = N;
  p.R = R;
  Plan pl;
  const cudaError_t err = plan(p, hist ? kInLanes : kNone, pl);
  if (err == cudaSuccess) {
    int32_t* o = static_cast<int32_t*>(out);
    o[0] = p.T;
    o[1] = pl.grid;
    o[2] = static_cast<int32_t>(pl.smem);
    o[3] = pl.per_sm;
    o[4] = tpuhuff_encode::bytes_per_thread(N);
  }
  return static_cast<int>(err);
}

extern "C" const char* tpuhuff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
