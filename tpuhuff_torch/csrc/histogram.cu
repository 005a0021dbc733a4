// Histogram kernel (K3): exact 256-bin byte histogram.
//
// Replaces tpuhuff/kernels/pallas_histogram.py::_hist_kernel (with
// hist_slab_update and the _finalize diagonal extraction) on the path
// tpuhuff_torch.io.stream.read_compress_write_hf2 (pass 1)
// -> kernels.histogram.
//
// Contract: out[v] += number of bytes equal to v in data[0:n]; `out` is 256
// unsigned 64-bit counters that the caller owns (pass 1 passes its running
// sum), so no count can wrap and no host flush rule is needed.
//
// The TPU built nibble one-hots for an int8 MXU matmul because it has no
// scatter.  Here the body (histogram_common.cuh, where the design is set
// out) counts into per-thread uint16_t columns in shared memory that no
// byte value can serialise, folded into per-block uint64_t totals; this
// file holds the kernel, its launch on a resident grid and the C entries.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "histogram_common.cuh"

namespace {

using tpuhuff_hist::Counters;
using tpuhuff_hist::kThreads;

struct DeviceBlock {
  int tid;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// one block of 256 threads and 128 KiB of counters to an SM
__global__ void __launch_bounds__(kThreads, 1)
hist256_kernel(const uint8_t* __restrict__ data, int64_t n,
               unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t s_cnt[];
  const DeviceBlock blk{static_cast<int>(threadIdx.x)};
  const uint64_t total = tpuhuff_hist::count_block(data, n, blockIdx.x, gridDim.x,
                                                   s_cnt, blk);
  if (total) atomicAdd(out + threadIdx.x, static_cast<unsigned long long>(total));
}

constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices];  // per device: 0 until first asked

// The blocks of hist256_kernel that the current device holds at once; the
// first call on a device raises its shared-memory limit for the kernel.
cudaError_t resident_blocks(int& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (out = g_resident[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(hist256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Counters::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hist256_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist256_kernel, kThreads,
                                                        Counters::kSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  out = per_sm * sms;
  if (dev < kMaxDevices) g_resident[dev].store(out, std::memory_order_relaxed);
  return cudaSuccess;
}

// The grid of a launch over n bytes: the resident blocks, or fewer where
// the aligned vectors make less than one step per block.
cudaError_t grid_for(int64_t n, int& grid) {
  int resident = 0;
  const cudaError_t err = resident_blocks(resident);
  if (err != cudaSuccess) return err;
  constexpr int64_t kStepBytes = int64_t{16} * tpuhuff_hist::kVecsPerStep * kThreads;
  const int64_t steps = (n + kStepBytes - 1) / kStepBytes;
  grid = static_cast<int>(steps < resident ? (steps > 0 ? steps : 1) : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" int tpuhuff_hist256(const void* data, long long n, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  int grid = 0;
  const cudaError_t err = grid_for(n, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist256_kernel<<<grid, kThreads, Counters::kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<int64_t>(n),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The grid tpuhuff_hist256 launches for n bytes on the current device (a
// negative CUDA error code if it cannot tell), and the blocks per SM.
extern "C" int tpuhuff_hist256_grid(long long n, int* per_sm) {
  int grid = 0, resident = 0, sms = 0, dev = 0;
  cudaError_t err = grid_for(n, grid);
  if (err == cudaSuccess) err = resident_blocks(resident);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *per_sm = resident / sms;
  return grid;
}
