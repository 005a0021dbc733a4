// Decode kernel (K2): canonical prefix-code decode of independent blocks.
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
// What bounds it on an H100, and the design: decode_common.cuh, the body
// this kernel shares with K4 (decode_general.cu), on two routes: rows
// staged in shared memory, one thread per block, and rows of which it holds
// fewer than 32, read from device memory, one thread block per block, its
// bits split into
// self-synchronising subsequences (decode_split.cuh).  The first-level
// table `lut` (kernels.decode.first_level_table) resolves every window
// whose top k bits fix (symbol, length) with length <= k; any other window
// runs the ladder above (Ladder, decode_rules.cuh), so the result equals
// the plain version on every window, codes or not.  The TPU kernel's 8x128
// cells, buffer rolls, select trees and MXU transposes existed because the
// TPU has no per-lane gather; here the table, the ladder (ub, dd) and perm
// sit in shared memory.

#include "decode_common.cuh"
#include "decode_rules.cuh"

namespace {

using tpuhuff_decode::Params;
using tpuhuff_decode::Ladder;
using tpuhuff_decode::kGlobalRows;
using tpuhuff_decode::kStaged;

// kRoute: rows staged in shared memory, or the global-rows route
// (decode_common.cuh, decode_split.cuh)
template <tpuhuff_decode::Route kRoute>
__global__ void __launch_bounds__(tpuhuff_decode::kMaxThreads)
decode_rows_kernel(Params p, Ladder::Args a) {
  tpuhuff_decode::decode_body<Ladder, kRoute>(p, a);
}

}  // namespace

extern "C" int tpuhuff_decode_rows(const void* rows, const void* bit0,
                                   const void* nbits, const void* ub,
                                   const void* dd, const void* perm,
                                   const void* lut, void* out, int B, int W,
                                   int block_len, int max_len,
                                   int* global_rows, void* stream) {
  Params p{};
  p.rows = static_cast<const uint32_t*>(rows);
  p.bit0 = static_cast<const int32_t*>(bit0);
  p.nbits = static_cast<const int32_t*>(nbits);
  p.lut = static_cast<const uint16_t*>(lut);
  p.out = static_cast<uint8_t*>(out);
  p.B = B;
  p.W = W;
  p.block_len = block_len;
  const Ladder::Args a{static_cast<const uint32_t*>(ub),
                       static_cast<const int32_t*>(dd),
                       static_cast<const uint8_t*>(perm), max_len};
  return tpuhuff_decode::launch<Ladder::Args>(
      decode_rows_kernel<kStaged>, decode_rows_kernel<kGlobalRows>, p, a,
      Ladder::kSmemBytes, global_rows, static_cast<cudaStream_t>(stream));
}

// Blocks per thread block that tpuhuff_decode_rows takes through shared
// memory; 0: the global-rows route (decode_common.cuh).
extern "C" int tpuhuff_decode_rows_tile(int B, int W, int block_len) {
  return tpuhuff_decode::tile_rows<Ladder::Args>(
      decode_rows_kernel<kStaged>, decode_rows_kernel<kGlobalRows>,
      Ladder::kSmemBytes, B, W, block_len);
}
