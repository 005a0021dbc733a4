// General-tree decode kernel (K4): prefix-code decode of any tree, of
// independent blocks.
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
// What bounds it on an H100, and the design: decode_common.cuh, the body
// this kernel shares with K2, on two routes: rows staged in shared memory,
// one thread per block, and rows of which it holds fewer than 32, read
// from device memory, one thread block per block, its bits split into
// self-synchronising
// subsequences (decode_split.cuh).  A window whose top k bits fix (symbol,
// length) with length <= k costs one load of `lut`
// (kernels.decode.first_level_table); only the others run the 8-step
// halving search (Search, decode_rules.cuh), so the result equals the
// plain version on every window, codes or not.  The TPU kernel's 8x128
// cells, buffer roll, select trees, packed store and MXU de-interleave
// existed for want of a per-lane gather; here the tables (thr, sym, len:
// 1.5 KiB, and lut) sit in shared memory.

#include "decode_common.cuh"
#include "decode_rules.cuh"

namespace {

using tpuhuff_decode::Params;
using tpuhuff_decode::Search;
using tpuhuff_decode::kGlobalRows;
using tpuhuff_decode::kStaged;

// kRoute: rows staged in shared memory, or the global-rows route
// (decode_common.cuh, decode_split.cuh)
template <tpuhuff_decode::Route kRoute>
__global__ void __launch_bounds__(tpuhuff_decode::kMaxThreads)
decode_rows_general_kernel(Params p, Search::Args a) {
  tpuhuff_decode::decode_body<Search, kRoute>(p, a);
}

}  // namespace

extern "C" int tpuhuff_decode_rows_general(const void* rows, const void* bit0,
                                           const void* nbits, const void* thr,
                                           const void* sym, const void* len,
                                           const void* lut, void* out, int B,
                                           int W, int block_len,
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
  const Search::Args a{static_cast<const uint32_t*>(thr),
                       static_cast<const uint8_t*>(sym),
                       static_cast<const uint8_t*>(len)};
  return tpuhuff_decode::launch<Search::Args>(
      decode_rows_general_kernel<kStaged>, decode_rows_general_kernel<kGlobalRows>, p,
      a, Search::kSmemBytes, global_rows, static_cast<cudaStream_t>(stream));
}

// Blocks per thread block that tpuhuff_decode_rows_general takes through
// shared memory; 0: the global-rows route.
extern "C" int tpuhuff_decode_rows_general_tile(int B, int W, int block_len) {
  return tpuhuff_decode::tile_rows<Search::Args>(
      decode_rows_general_kernel<kStaged>, decode_rows_general_kernel<kGlobalRows>,
      Search::kSmemBytes, B, W, block_len);
}
