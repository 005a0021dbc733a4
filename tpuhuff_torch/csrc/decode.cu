// Decode kernel (K2): canonical prefix-code decode, one block per thread.
//
// Replaces tpuhuff/kernels/pallas_decode.py::_decode_kernel (body
// _decode_body) on the path tpuhuff_torch.io.stream.read_decompress_write_hf2
// -> kernels.decode_rows.
//
// Contract, per block b (row b of `rows`, W u32 words, MSB-first values):
//   the cursor starts at bit bit0[b]; the next 32 bits (MSB-aligned, words
//   past W read as 0) give the code length len = 1 + #{L : window >= ub[L-1]}
//   over L < max_len and the canonical index
//   idx = ((window >> (32 - len)) + dd[0] + sum ind_L * dd[L]) & 255;
//   the symbol perm[idx] is emitted while consumed + len <= nbits[b], and
//   every later position of the block's block_len outputs is 0.
//
// What bounds it on an H100: the serial dependency of each symbol on the
// previous code length (the cursor), not bandwidth: a block reads its
// ~block_len * 14 / 8 payload bytes and writes block_len bytes.  Parallelism
// comes from blocks: 100 MiB at block 256 is 409,600 independent threads,
// enough to fill every SM many times over and hide the load latency.
// The TPU kernel's 8x128 cells, buffer rolls, select trees and MXU
// transposes existed because the TPU has no per-lane gather; here a thread
// reads its two window words directly, and the tables (ub, dd, perm) sit in
// shared memory.  Once a block's next code would pass nbits the cursor can
// never move again, so the rest of the block is zero-filled at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
decode_rows_kernel(const uint32_t* __restrict__ rows,
                   const int32_t* __restrict__ bit0,
                   const int32_t* __restrict__ nbits,
                   const uint32_t* __restrict__ ub_g,
                   const int32_t* __restrict__ dd_g,
                   const uint8_t* __restrict__ perm_g,
                   uint8_t* __restrict__ out, int B, int W, int block_len,
                   int max_len) {
  __shared__ uint32_t s_ub[32];
  __shared__ int32_t s_dd[32];
  __shared__ uint8_t s_perm[256];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += blockDim.x) s_perm[i] = perm_g[i];
  if (tid < 32) {
    s_ub[tid] = ub_g[tid];
    s_dd[tid] = dd_g[tid];
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  if (b >= B) return;
  const uint32_t* row = rows + b * W;
  uint8_t* o = out + b * block_len;
  const int64_t nb = nbits[b];
  int64_t cur = bit0[b];
  int64_t consumed = 0;
  int i = 0;
  for (; i < block_len; ++i) {
    const int64_t q = cur >> 5;
    const uint32_t rr = static_cast<uint32_t>(cur & 31);
    const uint32_t w0 = q < W ? row[q] : 0u;
    const uint32_t w1 = q + 1 < W ? row[q + 1] : 0u;
    const uint32_t window = rr ? (w0 << rr) | (w1 >> (32u - rr)) : w0;
    int len = 1;
    int32_t delta = s_dd[0];
    for (int L = 1; L < max_len; ++L) {
      const int ind = window >= s_ub[L - 1];
      len += ind;
      delta += ind * s_dd[L];
    }
    if (consumed + len > nb) break;
    // len in [1, 32], so the shift is in [0, 31]
    const uint32_t idx =
        ((window >> (32 - len)) + static_cast<uint32_t>(delta)) & 255u;
    o[i] = s_perm[idx];
    cur += len;
    consumed += len;
  }
  for (; i < block_len; ++i) o[i] = 0;
}

}  // namespace

extern "C" int tpuhuff_decode_rows(const void* rows, const void* bit0,
                                   const void* nbits, const void* ub,
                                   const void* dd, const void* perm, void* out,
                                   int B, int W, int block_len, int max_len,
                                   void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads);
  decode_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(bit0),
      static_cast<const int32_t*>(nbits), static_cast<const uint32_t*>(ub),
      static_cast<const int32_t*>(dd), static_cast<const uint8_t*>(perm),
      static_cast<uint8_t*>(out), B, W, block_len, max_len);
  return static_cast<int>(cudaGetLastError());
}
