// General-tree decode kernel (K4): prefix-code decode of any tree, one
// block per thread.
//
// Replaces tpuhuff/kernels/pallas_decode.py::_decode_kernel_general (body
// _decode_body) on the path tpuhuff_torch.io.stream.read_decompress_write_hf2
// -> kernels.decode_rows_general, taken for every tree whose codes are not
// canonical (a writer's canonical=False, or a foreign container).
//
// Contract, per block b (row b of `rows`, W u32 words, MSB-first values) —
// that of K2 (decode.cu) with another window -> (symbol, length) step:
//   the cursor starts at bit bit0[b]; the next 32 bits (MSB-aligned, words
//   past W read as 0) select the leaf idx = #{k : thr[k] <= window} - 1
//   (clamped at 0) over the 256 ascending left-aligned leaf codes `thr`;
//   the symbol sym[idx] of length len[idx] is emitted while
//   consumed + len <= nbits[b], and every later position of the block's
//   block_len outputs is 0.  The tables repeat the last leaf past the leaf
//   count, so searching all 256 entries lands on the same (sym, len) as the
//   TPU kernel's search over the low 2^levels entries.
//
// What bounds it on an H100: the serial cursor, as in K2, plus the search:
// each symbol costs 8 dependent shared-memory loads (a branch-free halving
// search over 256 entries) where K2 pays max_len - 1 independent compares.
// A block reads its ~block_len * avg_len / 8 payload bytes and writes
// block_len bytes, far below the card's memory rate.  Parallelism comes from
// blocks (409,600 threads at 100 MiB, block 256).  The TPU kernel's 8x128
// cells, buffer roll, select trees, packed store and MXU de-interleave
// existed for want of a per-lane gather; here a thread reads its two window
// words directly and the tables (thr, sym, len: 1.5 KiB) sit in shared
// memory.  Once a block's next code would pass nbits the cursor can never
// move again, so the rest of the block is zero-filled at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
decode_rows_general_kernel(const uint32_t* __restrict__ rows,
                           const int32_t* __restrict__ bit0,
                           const int32_t* __restrict__ nbits,
                           const uint32_t* __restrict__ thr_g,
                           const uint8_t* __restrict__ sym_g,
                           const uint8_t* __restrict__ len_g,
                           uint8_t* __restrict__ out, int B, int W,
                           int block_len) {
  __shared__ uint32_t s_thr[256];
  __shared__ uint8_t s_sym[256];
  __shared__ uint8_t s_len[256];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += blockDim.x) {
    s_thr[i] = thr_g[i];
    s_sym[i] = sym_g[i];
    s_len[i] = len_g[i];
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
    // the largest idx with thr[idx] <= window (0 if none): thr ascends
    int idx = 0;
#pragma unroll
    for (int step = 128; step >= 1; step >>= 1) {
      idx += (s_thr[idx + step] <= window) ? step : 0;
    }
    const int len = s_len[idx];
    if (consumed + len > nb) break;
    o[i] = s_sym[idx];
    cur += len;
    consumed += len;
  }
  for (; i < block_len; ++i) o[i] = 0;
}

}  // namespace

extern "C" int tpuhuff_decode_rows_general(const void* rows, const void* bit0,
                                           const void* nbits, const void* thr,
                                           const void* sym, const void* len,
                                           void* out, int B, int W,
                                           int block_len, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads);
  decode_rows_general_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(bit0),
      static_cast<const int32_t*>(nbits), static_cast<const uint32_t*>(thr),
      static_cast<const uint8_t*>(sym), static_cast<const uint8_t*>(len),
      static_cast<uint8_t*>(out), B, W, block_len);
  return static_cast<int>(cudaGetLastError());
}
