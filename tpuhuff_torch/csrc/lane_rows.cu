// Device row gather (S2): each block's rows of big-endian u32 words cut
// out of the payload on the card, the operand of the decoders K2 and K4.
//
// Replaces tpuhuff/kernels/decode.py::payload_to_lane_words (the host's
// widening of the payload to ">u4" and its row gather; no Pallas kernel
// computes it, since the TPU has no fast gather) on the path
// tpuhuff_torch.io.stream.read_decompress_write_hf2 -> kernels.lane_rows.
// The host copies the payload's bytes to the card, not the rows.
//
// The body, its contract and its design are in lane_rows_common.cuh: one
// thread per output word (a grid-stride loop over B * W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_rows_common.cuh"

namespace {

using tpuhuff_rows::Args;

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 16;  // a few waves of the H100's SMs

__global__ void __launch_bounds__(kThreads) lane_rows_kernel(Args a, uint32_t n) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    tpuhuff_rows::row_word(a, i);
}

}  // namespace

// payload (n,) u8, start_bits (B,) int64, rows (B, W) u32, bit0 (B,) int32;
// B * W < 2^31.
extern "C" int tpuhuff_lane_rows(const void* payload, long long n,
                                 const void* start_bits, void* rows, void* bit0,
                                 int B, int W, void* stream) {
  const uint32_t total = static_cast<uint32_t>(B) * static_cast<uint32_t>(W);
  if (total == 0) return 0;
  const Args a{static_cast<const uint8_t*>(payload), static_cast<int64_t>(n),
               static_cast<const int64_t*>(start_bits), static_cast<uint32_t*>(rows),
               static_cast<int32_t*>(bit0), B, W,
               reinterpret_cast<uintptr_t>(payload) % 4 == 0};
  const uint32_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = blocks > kMaxGrid ? kMaxGrid : static_cast<int>(blocks);
  lane_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, total);
  return static_cast<int>(cudaGetLastError());
}
