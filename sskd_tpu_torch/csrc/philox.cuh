// philox.cuh: the dropout keep-mask of the training attention kernels.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
// SC'11; the round and key schedule of Random123) keyed by (seed, b*h) with the
// counter (col / 4, row, 0, 0). Element (row, col) of head b*h takes word
// col % 4 and is kept when its top 24 bits over 2^24 are >= p, the rule of
// _uniform_bits in sskd_tpu/ops/attention.py. The mask is a pure function of
// (seed, b*h, row, col): the forward, the backward and a recompute of the
// forward all regenerate it, whatever the tiling or launch order.
// sskd_tpu_torch/ops/attention.py (philox4x32, dropout_uniform) computes the
// same bits in plain torch.

#pragma once
#include <stdint.h>

namespace sskd {

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t k0,
                                                  uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    // one 32 x 32 -> 64-bit multiply (IMAD.WIDE) gives both halves
    const uint64_t p0 = (uint64_t)c0 * 0xD2511F53u, p1 = (uint64_t)c2 * 0xCD9E8D57u;
    const uint32_t lo0 = (uint32_t)p0, hi0 = (uint32_t)(p0 >> 32);
    const uint32_t lo1 = (uint32_t)p1, hi1 = (uint32_t)(p1 >> 32);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// the uniform of one word: top 24 bits over 2^24, exact in f32
__device__ __forceinline__ float philox_uniform(uint32_t word) {
  return (float)(word >> 8) * (1.0f / 16777216.0f);
}

// The keep bits of keys key0 .. key0 + 3 (key0 a multiple of 4) of row `row`
// of head bh, bit j for key key0 + j: the four words of one Philox call.
__device__ __forceinline__ uint32_t keep_bits4(uint32_t seed, uint32_t bh, int row, int key0,
                                               float p) {
  const Philox4 w = philox4x32_10((uint32_t)(key0 >> 2), (uint32_t)row, seed, bh);
  uint32_t keep = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) keep |= (philox_uniform(w.w[j]) >= p ? 1u : 0u) << j;
  return keep;
}

// keep decision for (row, col) of head bh (one Philox call per element)
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh, int row, int col,
                                             float p) {
  const Philox4 r = philox4x32_10((uint32_t)(col >> 2), (uint32_t)row, seed, bh);
  return philox_uniform(r.w[col & 3]) >= p;
}

}  // namespace sskd
