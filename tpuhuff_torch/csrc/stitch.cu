// Device stitch (S1): K1's lane words concatenated at the bit level into
// the chunk's payload of big-endian bytes, with the previous chunk's
// partial byte carried in at the head and this chunk's carried out.
//
// Replaces tpuhuff/dist/__init__.py::stitch_words (the host's byteswap to
// ">u4" and bit-carry concatenation of per-lane word rows; no Pallas
// kernel computes it, since a TPU kernel cannot write at arbitrary bit
// offsets in HBM) on the path tpuhuff_torch.io.stream.read_compress_write_hf2
// and read_compress_write (pass 2) -> kernels.stitch_lanes.  The host then
// copies back the payload's bytes alone, not the lanes' padded rows.
//
// The body, its contract and its design are in stitch_common.cuh.  Two
// launches on the caller's stream: the pairs (a grid-stride loop over
// B * R), then one thread that reads the last partial byte into carry_out,
// which the next chunk's stitch, enqueued after it on the same stream,
// reads as its carry, so the chain needs no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stitch_common.cuh"

namespace {

using tpuhuff_stitch::Args;

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 16;  // a few waves of the H100's SMs

__global__ void __launch_bounds__(kThreads)
stitch_kernel(Args a, const int32_t* __restrict__ carry, uint32_t n) {
  a.carry_bits = carry[1] & 7;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    tpuhuff_stitch::stitch_pair(a, i);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    tpuhuff_stitch::stitch_head(a, static_cast<uint32_t>(carry[0]));
}

__global__ void stitch_carry_kernel(Args a, const int32_t* __restrict__ carry,
                                    int32_t* __restrict__ carry_out) {
  a.carry_bits = carry[1] & 7;
  tpuhuff_stitch::stitch_tail(a, carry_out);
}

}  // namespace

// words (B, R) u32, bits (B,) int32, ends (B,) int64, carry (2,) int32,
// out (B * R + 2) u32 zeroed, carry_out (2,) int32; B * R < 2^31.
extern "C" int tpuhuff_stitch_lanes(const void* words, const void* bits,
                                    const void* ends, const void* carry,
                                    void* out, void* carry_out, int B, int R,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const uint32_t*>(words), static_cast<const int32_t*>(bits),
         static_cast<const int64_t*>(ends), static_cast<uint32_t*>(out),
         static_cast<int64_t>(B) * R + 2, B, R, 0};
  const uint32_t n = static_cast<uint32_t>(B) * static_cast<uint32_t>(R);
  const uint32_t blocks = (n + kThreads - 1) / kThreads;
  const int grid = blocks < 1 ? 1 : (blocks > kMaxGrid ? kMaxGrid : static_cast<int>(blocks));
  const int32_t* c = static_cast<const int32_t*>(carry);
  stitch_kernel<<<grid, kThreads, 0, s>>>(a, c, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stitch_carry_kernel<<<1, 1, 0, s>>>(a, c, static_cast<int32_t*>(carry_out));
  return static_cast<int>(cudaGetLastError());
}
