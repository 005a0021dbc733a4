// Encode kernel (K1): pack byte lanes into MSB-first Huffman bitstreams.
//
// Replaces tpuhuff/kernels/pallas_encode2.py::_encode_kernel_fused (the
// fused canonical-ladder + doubling bit-merge Pallas kernel) on the path
// tpuhuff_torch.io.stream.read_compress_write_hf2 -> kernels.encode_blocks.
//
// Contract, per lane of N input bytes (N a power of two <= 1024):
//   * byte i < valid[lane] with code (len, left-aligned acode) appends its
//     len bits; bytes at i >= valid[lane] emit nothing;
//   * words[lane, :R] are numeric MSB-first u32 words, zero past the bits;
//   * bits[lane] is the exact bit count, miss[lane] the number of valid
//     bytes whose LUT length is 0 (a byte the tree has no code for).
//
// What bounds it on an H100: device memory traffic.  A lane reads N bytes
// and writes R = ceil(max_len * N / 32) words (1.75x the input at 14-bit
// codes), about 3 bytes moved per input byte, so 100 MiB is ~0.1 ms of
// HBM time at 3.35 TB/s; the LUT lookups and shifts are a few integer ops
// per byte.  The TPU kernel's select-tree LUTs, perm-matmul layout and MXU
// transposes existed only because the TPU has no fast gather: here the
// 256-entry (len, code) LUT sits in shared memory and is gathered directly,
// which also lifts the TPU route's 2*max_len <= 32 and N <= 1024 bounds.
//
// Design: one warp per lane.  Thread t owns bytes [t*N/32, (t+1)*N/32);
// it sums its code lengths, a warp scan (__shfl_up_sync) gives its bit
// offset, and it ORs its codes into the warp's shared-memory word buffer
// (64-bit shifts: a code may straddle two words, and no shift is by 32).
// The buffer is then stored to device memory with consecutive threads on
// consecutive words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // lanes per thread block

__global__ void __launch_bounds__(kWarps * 32)
encode_lanes_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ lens_g,
                    const uint32_t* __restrict__ acodes_g,
                    uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                    int32_t* __restrict__ miss, int B, int N, int R) {
  __shared__ uint32_t s_code[256];
  __shared__ uint8_t s_len[256];
  extern __shared__ uint32_t s_words[];  // kWarps * R

  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += blockDim.x) {
    s_code[i] = acodes_g[i];
    s_len[i] = static_cast<uint8_t>(lens_g[i]);
  }
  const int warp = tid >> 5;
  const int t = tid & 31;
  uint32_t* buf = s_words + warp * R;
  for (int i = t; i < R; i += 32) buf[i] = 0u;
  __syncthreads();

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (lane >= B) return;  // whole warp leaves together; no barrier follows

  const int per = N >= 32 ? N / 32 : 1;
  const int first = t * per;
  const int end = min(min(first + per, N), valid[lane]);
  const uint8_t* src = data + lane * N;

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

  uint32_t* dst = words + lane * R;
  for (int i = t; i < R; i += 32) dst[i] = buf[i];
  if (t == 0) {
    bits[lane] = static_cast<int32_t>(total);
    miss[lane] = nmiss;
  }
}

}  // namespace

extern "C" int tpuhuff_encode_lanes(const void* data, const void* valid,
                                    const void* lens, const void* acodes,
                                    void* words, void* bits, void* miss, int B,
                                    int N, int R, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * R * sizeof(uint32_t);
  encode_lanes_kernel<<<grid, kWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(valid),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(acodes),
      static_cast<uint32_t*>(words), static_cast<int32_t*>(bits),
      static_cast<int32_t*>(miss), B, N, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuhuff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
