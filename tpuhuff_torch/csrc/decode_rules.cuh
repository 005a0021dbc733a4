// The two decoders' rules, window -> (symbol, length), on any 32-bit window:
// K2's canonical ladder (decode.cu) and K4's interval search
// (decode_general.cu).  Each loads its tables into a thread block's shared
// memory (load) and resolves the windows that escape the first-level table
// (resolve, called through decode_split.cuh's escape).
//
// Everything here compiles with g++ as well, CUDA's qualifiers defined
// away, so that tests/test_torch_decode_split.py runs the kernels' own rules.

#pragma once

#include <stdint.h>

namespace tpuhuff_decode {

// K2: len = 1 + #{L < max_len : window >= ub[L-1]}, and the symbol
// perm[((window >> (32 - len)) + dd[0] + sum ind_L * dd[L]) & 255].
struct Ladder {
  struct Args {
    const uint32_t* ub;
    const int32_t* dd;
    const uint8_t* perm;
    int max_len;
  };
  static constexpr int kSmemBytes = 32 * 4 + 32 * 4 + 256;  // ub, dd, perm
  static constexpr int kMaxLen = 32;  // the longest code, in bits

  const uint32_t* ub;
  const int32_t* dd;
  const uint8_t* perm;
  int max_len;

  __device__ static Ladder load(uint8_t* s, const Args& a, int tid, int nt) {
    uint32_t* ub = reinterpret_cast<uint32_t*>(s);
    int32_t* dd = reinterpret_cast<int32_t*>(s + 128);
    uint8_t* perm = s + 256;
    for (int i = tid; i < 256; i += nt) perm[i] = a.perm[i];
    for (int i = tid; i < 32; i += nt) {
      ub[i] = a.ub[i];
      dd[i] = a.dd[i];
    }
    return {ub, dd, perm, a.max_len};
  }

  // the ladder of the contract, on any window
  __device__ __forceinline__ void resolve(uint32_t window, uint32_t& sym,
                                          uint32_t& len) const {
    int l = 1;
    uint32_t delta = static_cast<uint32_t>(dd[0]);  // wraps, as the index does
    for (int L = 1; L < max_len; ++L) {
      const uint32_t ind = window >= ub[L - 1];
      l += static_cast<int>(ind);
      delta += ind * static_cast<uint32_t>(dd[L]);
    }
    // l in [1, 32], so the shift is in [0, 31]
    sym = perm[((window >> (32 - l)) + delta) & 255u];
    len = static_cast<uint32_t>(l);
  }
};

// K4: the leaf idx = #{k : thr[k] <= window} - 1 (clamped at 0) over the
// 256 ascending left-aligned leaf codes, and its (sym[idx], len[idx]).
struct Search {
  struct Args {
    const uint32_t* thr;
    const uint8_t* sym;
    const uint8_t* len;
  };
  static constexpr int kSmemBytes = 256 * 4 + 256 + 256;  // thr, sym, len
  static constexpr int kMaxLen = 255;  // the longest code a len entry holds

  const uint32_t* thr;
  const uint8_t* sym;
  const uint8_t* len;

  __device__ static Search load(uint8_t* s, const Args& a, int tid, int nt) {
    uint32_t* thr = reinterpret_cast<uint32_t*>(s);
    uint8_t* sym = s + 1024;
    uint8_t* len = s + 1280;
    for (int i = tid; i < 256; i += nt) {
      thr[i] = a.thr[i];
      sym[i] = a.sym[i];
      len[i] = a.len[i];
    }
    return {thr, sym, len};
  }

  // the largest idx with thr[idx] <= window (0 if none): thr ascends
  __device__ __forceinline__ void resolve(uint32_t window, uint32_t& s,
                                          uint32_t& l) const {
    int idx = 0;
#pragma unroll
    for (int step = 128; step >= 1; step >>= 1) {
      idx += (thr[idx + step] <= window) ? step : 0;
    }
    s = sym[idx];
    l = len[idx];
  }
};

}  // namespace tpuhuff_decode
