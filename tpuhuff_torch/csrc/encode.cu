// Encode kernel (K1) and fused encode + histogram kernel (K5): pack byte
// lanes into MSB-first Huffman bitstreams, and with kHist also count the
// bytes of a second operand.
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
//   * words[lane, :R] are numeric MSB-first u32 words, zero past the bits;
//   * bits[lane] is the exact bit count, miss[lane] the number of valid
//     bytes whose LUT length is 0 (a byte the tree has no code for).
// With kHist: hist_out[v] += the number of bytes equal to v in
// hist[0:n_hist] (n_hist <= B * N, any alignment); hist_out is 256
// unsigned 64-bit counters that the caller zeroes.
//
// What bounds it on an H100: device memory traffic.  A lane reads N bytes
// and writes R = ceil(max_len * N / 32) words (1.75x the input at 14-bit
// codes), about 3 bytes moved per input byte, so 100 MiB is ~0.1 ms of
// HBM time at 3.35 TB/s; the LUT lookups and shifts are a few integer ops
// per byte.  The TPU kernel's select-tree LUTs, perm-matmul layout and MXU
// transposes existed only because the TPU has no fast gather: here the
// 256-entry (len, code) LUT sits in shared memory and is gathered directly,
// which also lifts the TPU route's 2*max_len <= 32 and N <= 1024 bounds.
// Likewise the TPU's histogram built nibble one-hots for an int8 matmul
// because it has no scatter; here bytes are counted with shared-memory
// atomics, as in histogram.cu.
//
// Design: one warp per lane at a time, kLanesPerWarp lanes in turn, so a
// thread block of kWarps warps covers kLanes = kWarps * kLanesPerWarp
// lanes.  Thread t owns bytes [t*N/32, (t+1)*N/32) of a lane; it sums its
// code lengths, a warp scan (__shfl_up_sync) gives its bit offset, and it
// ORs its codes into the warp's shared-memory word buffer (64-bit shifts:
// a code may straddle two words, and no shift is by 32).  The buffer is
// then stored to device memory with consecutive threads on consecutive
// words.
// K5 first counts the slice of hist that covers its own lanes' byte range,
// [blockIdx.x * kLanes * N, (blockIdx.x + 1) * kLanes * N) clipped to
// n_hist, into one 256-bin u32 copy per warp (16-byte loads, the unaligned
// head and the ragged tail one byte per thread), and merges the copies
// with one 64-bit atomicAdd per non-empty bin.  Where the operand is the
// lanes themselves (adaptive dataset compression), those bytes are then in
// L1/L2 when the encode reads them.  The global atomics all land on one
// 2 KiB array, so their number is what kLanesPerWarp trades against the
// count of thread blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 4 lanes per warp: at 262,144 lanes of 256 B on an H100 (700 W), K5 took
// 0.33 ms at 1, 0.20 at 2, 0.18 at 4 and 8, and K1 0.18 ms at 1 and 0.16
// at 2 to 8 (experiments/k5_lanes_per_warp.py, which sets this macro)
#ifndef TPUHUFF_LANES_PER_WARP
#define TPUHUFF_LANES_PER_WARP 4
#endif
constexpr int kWarps = 8;  // warps per thread block
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerWarp = TPUHUFF_LANES_PER_WARP;
constexpr int kLanes = kWarps * kLanesPerWarp;  // lanes per thread block

__device__ __forceinline__ void count4(uint32_t* bins, uint32_t w) {
  atomicAdd(&bins[w & 255u], 1u);
  atomicAdd(&bins[(w >> 8) & 255u], 1u);
  atomicAdd(&bins[(w >> 16) & 255u], 1u);
  atomicAdd(&bins[w >> 24], 1u);
}

// One lane on one warp: thread t encodes bytes [first, end) of src.
__device__ __forceinline__ void encode_lane(
    const uint8_t* __restrict__ src, int end, int first, int t,
    const uint8_t* s_len, const uint32_t* s_code, uint32_t* buf,
    uint32_t* __restrict__ dst, int R, int32_t* __restrict__ bits,
    int32_t* __restrict__ miss) {
  uint32_t mine = 0;
  int nmiss = 0;
  for (int i = first; i < end; ++i) {
    const uint32_t l = s_len[src[i]];
    mine += l;
    nmiss += (l == 0);
  }
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (t >= o) incl += v;
  }
  const uint32_t total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) nmiss += __shfl_xor_sync(0xffffffffu, nmiss, o);

  uint32_t pos = incl - mine;
  for (int i = first; i < end; ++i) {
    const uint8_t b = src[i];
    const uint32_t l = s_len[b];
    if (l == 0) continue;
    const uint32_t w = pos >> 5;
    // left-aligned code moved right by the in-word offset; the low half
    // is what spills into the next word (never a shift by 32)
    const uint64_t v = (static_cast<uint64_t>(s_code[b]) << 32) >> (pos & 31);
    atomicOr(&buf[w], static_cast<uint32_t>(v >> 32));
    const uint32_t spill = static_cast<uint32_t>(v);
    if (spill) atomicOr(&buf[w + 1], spill);
    pos += l;
  }
  __syncwarp();

  for (int i = t; i < R; i += 32) dst[i] = buf[i];
  if (t == 0) {
    *bits = static_cast<int32_t>(total);
    *miss = nmiss;
  }
}

template <bool kHist>
__global__ void __launch_bounds__(kThreads)
encode_lanes_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ lens_g,
                    const uint32_t* __restrict__ acodes_g,
                    uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                    int32_t* __restrict__ miss, int B, int N, int R,
                    const uint8_t* __restrict__ hist, int64_t n_hist,
                    unsigned long long* __restrict__ hist_out) {
  __shared__ uint32_t s_code[256];
  __shared__ uint8_t s_len[256];
  __shared__ uint32_t s_bins[kHist ? kWarps : 1][256];
  extern __shared__ uint32_t s_words[];  // kWarps * R

  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) {
    s_code[i] = acodes_g[i];
    s_len[i] = static_cast<uint8_t>(lens_g[i]);
  }
  const int warp = tid >> 5;
  const int t = tid & 31;
  uint32_t* buf = s_words + warp * R;
  if constexpr (kHist) {
    for (int i = tid; i < kWarps * 256; i += kThreads) (&s_bins[0][0])[i] = 0u;
  }
  __syncthreads();

  if constexpr (kHist) {
    uint32_t* bins = s_bins[warp];
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kLanes * N;
    const int64_t s1 = min(s0 + static_cast<int64_t>(kLanes) * N, n_hist);
    if (s0 < s1) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(hist + s0);
      const int64_t a0 =
          min(s0 + static_cast<int64_t>((16 - (addr & 15)) & 15), s1);
      const int64_t nvec = (s1 - a0) / 16;
      const int64_t a1 = a0 + nvec * 16;
      const uint4* vec = reinterpret_cast<const uint4*>(hist + a0);
      for (int64_t v = tid; v < nvec; v += kThreads) {
        const uint4 x = vec[v];
        count4(bins, x.x);
        count4(bins, x.y);
        count4(bins, x.z);
        count4(bins, x.w);
      }
      if (s0 + tid < a0) atomicAdd(&bins[hist[s0 + tid]], 1u);  // < 16 B
      if (a1 + tid < s1) atomicAdd(&bins[hist[a1 + tid]], 1u);  // < 16 B
    }
    __syncthreads();
    for (int bin = tid; bin < 256; bin += kThreads) {
      uint32_t sum = 0;
#pragma unroll
      for (int c = 0; c < kWarps; ++c) sum += s_bins[c][bin];
      if (sum) atomicAdd(&hist_out[bin], static_cast<unsigned long long>(sum));
    }
  }

  const int per = N >= 32 ? N / 32 : 1;
  const int first = t * per;
  for (int j = 0; j < kLanesPerWarp; ++j) {
    const int64_t lane =
        static_cast<int64_t>(blockIdx.x) * kLanes + j * kWarps + warp;
    if (lane >= B) break;  // whole warp leaves together; no barrier follows
    for (int i = t; i < R; i += 32) buf[i] = 0u;
    __syncwarp();
    encode_lane(data + lane * N, min(min(first + per, N), valid[lane]), first,
                t, s_len, s_code, buf, words + lane * R, R, bits + lane,
                miss + lane);
    __syncwarp();  // the store has read buf before the next lane zeroes it
  }
}

template <bool kHist>
int launch_encode(const void* data, const void* valid, const void* lens,
                  const void* acodes, void* words, void* bits, void* miss,
                  int B, int N, int R, const void* hist, long long n_hist,
                  void* hist_out, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + kLanes - 1) / kLanes);
  const size_t smem = static_cast<size_t>(kWarps) * R * sizeof(uint32_t);
  encode_lanes_kernel<kHist><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(valid),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(acodes),
      static_cast<uint32_t*>(words), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(miss), B, N, R,
      static_cast<const uint8_t*>(hist), static_cast<int64_t>(n_hist),
      static_cast<unsigned long long*>(hist_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpuhuff_encode_lanes(const void* data, const void* valid,
                                    const void* lens, const void* acodes,
                                    void* words, void* bits, void* miss, int B,
                                    int N, int R, void* stream) {
  return launch_encode<false>(data, valid, lens, acodes, words, bits, miss, B,
                              N, R, nullptr, 0, nullptr, stream);
}

extern "C" int tpuhuff_encode_lanes_hist(const void* data, const void* valid,
                                         const void* lens, const void* acodes,
                                         void* words, void* bits, void* miss,
                                         int B, int N, int R, const void* hist,
                                         long long n_hist, void* hist_out,
                                         void* stream) {
  return launch_encode<true>(data, valid, lens, acodes, words, bits, miss, B,
                             N, R, hist, n_hist, hist_out, stream);
}

extern "C" const char* tpuhuff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
