// CRC32 kernel (C1): the zlib CRC32 of each span of a byte buffer on the
// device, the .hf2 container's CRC column.
//
// Replaces no TPU kernel: the JAX package computes the column on the host
// (tpuhuff/io/stream.py, the threaded C++ crc32_blocks), as the port did up
// to here.  It was added because every byte the column covers is already
// on the card: the file-to-file writer keeps the input there (the resident
// route) or copies each chunk there to encode it, and the decoder produces
// each decoded group there.  So the host's pass over every byte, the
// largest host stage that the file itself does not set, leaves both paths:
// tpuhuff_torch.io.stream.read_compress_write_hf2 (each chunk's lanes) and
// read_decompress_write_hf2 (each decoded group, checked on the host
// against the stored column before the group is written)
// -> kernels.crc32_spans.
//
// The body, its contract and its design are in crc32_common.cuh.  One
// launch on the caller's stream: a resident grid of blocks of kPieces
// threads, each block taking segments blockIdx.x, + gridDim.x, ...; the
// slicing tables are copied into shared memory once a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "crc32_common.cuh"

namespace {

using tpuhuff_crc::Args;
using tpuhuff_crc::kPieces;

__global__ void __launch_bounds__(kPieces)
crc32_spans_kernel(Args a, const uint32_t* __restrict__ slices) {
  __shared__ __align__(16) uint32_t T[tpuhuff_crc::kSlices * 256];
  __shared__ uint32_t warp_crc[kPieces / 32];
  constexpr int kVecs = tpuhuff_crc::kSlices * 256 / 4;
  for (int i = threadIdx.x; i < kVecs; i += kPieces)
    reinterpret_cast<uint4*>(T)[i] = __ldg(reinterpret_cast<const uint4*>(slices) + i);
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = blockIdx.x; j < a.nseg; j += gridDim.x) {
    int64_t start = 0, len = 0;
    tpuhuff_crc::segment(a, j, start, len);
    uint32_t v = tpuhuff_crc::piece_crc(a, start, len, t, T);
    // levels 0-4: lane l (a multiple of 2^(k+1)) takes lane l + 2^k's value;
    // the other lanes' results are read by no one
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, v, 1 << k);
      v = tpuhuff_crc::shift(a.fold, k, v) ^ right;
    }
    if (lane == 0) warp_crc[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = lane < kPieces / 32 ? warp_crc[lane] : 0u;
#pragma unroll
      for (int k = 5; k < tpuhuff_crc::kLevels; ++k) {
        const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, v, 1 << (k - 5));
        v = tpuhuff_crc::shift(a.fold, k, v) ^ right;
      }
      if (lane == 0) a.out[j] = v ^ tpuhuff_crc::zeros_crc(a, j, len);
    }
    __syncthreads();  // warp_crc is the next segment's
  }
}

constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices];  // per device: 0 until first asked

cudaError_t resident_blocks(int& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (out = g_resident[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32_spans_kernel,
                                                        kPieces, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  out = per_sm * sms;
  if (dev < kMaxDevices) g_resident[dev].store(out, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// data (n bytes), slices (16 x 256 u32), fold (8 x 4 x 256 u32), out (nseg
// u32); head <= span, piece = ceil(span / 256), nseg as Args says.
extern "C" int tpuhuff_crc32_spans(const void* data, long long n, long long span,
                                   long long head, long long piece, int nseg,
                                   unsigned k_span, unsigned k_head, unsigned k_last,
                                   const void* slices, const void* fold, void* out,
                                   void* stream) {
  if (nseg <= 0) return 0;
  int resident = 0;
  const cudaError_t err = resident_blocks(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const uint8_t*>(data), static_cast<int64_t>(n),
         static_cast<int64_t>(span), static_cast<int64_t>(head),
         static_cast<int64_t>(piece), nseg, k_span, k_head, k_last,
         static_cast<const uint32_t*>(fold), static_cast<uint32_t*>(out)};
  const int grid = nseg < resident ? nseg : resident;
  crc32_spans_kernel<<<grid, kPieces, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(slices));
  return static_cast<int>(cudaGetLastError());
}
