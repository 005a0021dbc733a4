// Histogram kernel (K3): exact 256-bin byte histogram.
//
// Replaces tpuhuff/kernels/pallas_histogram.py::_hist_kernel (with
// hist_slab_update and the _finalize diagonal extraction) on the path
// tpuhuff_torch.io.stream.read_compress_write_hf2 (pass 1)
// -> kernels.histogram.
//
// Contract: out[v] += number of bytes equal to v in data[0:n]; `out` is 256
// unsigned 64-bit counters that the caller zeroes, so no count can wrap and
// no host flush rule is needed.
//
// What bounds it on an H100: reading n bytes once (100 MiB is ~31 us of
// HBM time at 3.35 TB/s) against shared-memory atomic throughput, which
// suffers when text is skewed (many threads hitting the same bin).  The TPU
// built nibble one-hots for an int8 MXU matmul because it has no scatter;
// here each warp owns a private 256-bin copy in shared memory (fewer
// same-address collisions than one copy per block), bytes arrive as 16-byte
// vector loads in a grid-stride loop, the unaligned head and the ragged
// tail are counted one byte per thread, and each block merges its copies
// into the global counters with one atomicAdd per non-empty bin.  No
// padding is read, so no bin-0 correction is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopies = kThreads / 32;  // one bin copy per warp
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ void count4(uint32_t* bins, uint32_t w) {
  atomicAdd(&bins[w & 255u], 1u);
  atomicAdd(&bins[(w >> 8) & 255u], 1u);
  atomicAdd(&bins[(w >> 16) & 255u], 1u);
  atomicAdd(&bins[w >> 24], 1u);
}

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ data, int64_t n,
               unsigned long long* __restrict__ out) {
  __shared__ uint32_t s_bins[kCopies][256];
  for (int i = threadIdx.x; i < kCopies * 256; i += kThreads)
    (&s_bins[0][0])[i] = 0u;
  __syncthreads();
  uint32_t* bins = s_bins[threadIdx.x >> 5];

  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const int64_t head = min(static_cast<int64_t>((16 - (addr & 15)) & 15), n);
  const int64_t nvec = (n - head) / 16;
  const int64_t tail0 = head + nvec * 16;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  for (int64_t v = g; v < nvec; v += stride) {
    const uint4 x = vec[v];
    count4(bins, x.x);
    count4(bins, x.y);
    count4(bins, x.z);
    count4(bins, x.w);
  }
  if (g < head) atomicAdd(&bins[data[g]], 1u);
  if (g < n - tail0) atomicAdd(&bins[data[tail0 + g]], 1u);
  __syncthreads();

  for (int bin = threadIdx.x; bin < 256; bin += kThreads) {
    uint32_t sum = 0;
#pragma unroll
    for (int c = 0; c < kCopies; ++c) sum += s_bins[c][bin];
    if (sum) atomicAdd(&out[bin], static_cast<unsigned long long>(sum));
  }
}

}  // namespace

extern "C" int tpuhuff_hist256(const void* data, long long n, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads * 16 - 1) / (kThreads * 16);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hist256_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<int64_t>(n),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
