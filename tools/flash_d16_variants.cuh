// flash_d16_variants.cuh: what tools/probe_flash16.py and chip_smoke.py time
// beside the bf16 flash at head dim 16 (csrc/flash_attn.cu
// flash_fwd_tc2_kernel<16, FT16_MT, FT16_MINB>); the port does not build this
// file and no route reaches it.
//
// - flash_fwd_kernel<T, D, KT>: the CUDA-core kernel that bf16 at head dim 16
//   launched before the tensor-core route (one block of 128 threads per
//   (b*h, 128-query tile), a thread per query row, K and V tiles converted
//   to f32 in shared memory and read as broadcasts, p = expf(s - m) rounded
//   to bf16 before p.v), kept here as it was so that a probe can time it in
//   the same call as its successor;
// - probe_flash16(variant, ...): a C entry over it (variant 0) and over the
//   other schedules of the tensor-core kernel, flash_fwd_tc2_kernel<16, MT,
//   MINB> (FLASH16_VARIANTS: m-tiles a warp, blocks an SM), which compute the
//   route's bits.
//
// Include after flash_attn.cu.

#pragma once

#include "attn_common.cuh"

namespace sskd {

constexpr int FC_QB = 128;  // queries per block == threads per block

template <typename T, int D, int KT>
__global__ void __launch_bounds__(FC_QB) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, T* __restrict__ out, int h, int L, int n_qt, float sm_scale) {
  constexpr int VE = 16 / sizeof(T);
  __shared__ __align__(16) float s_k[KT * D];
  __shared__ __align__(16) float s_v[KT * D];
  __shared__ int s_keep[KT];  // 1 keep, 0 masked, -1 past L

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_qt;
  const int qi = (blockIdx.x % n_qt) * FC_QB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;
  const bool has_q = qi < L;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) { qr[c] = 0.f; acc[c] = 0.f; }
  if (has_q) {
#pragma unroll
    for (int c = 0; c < D; c += VE) load_vec<T>(qr + c, q + head_off + (long)qi * D + c);
  }
  float m_i = FA_NEG, l_i = 0.f;

  for (int k0 = 0; k0 < L; k0 += KT) {
    __syncthreads();  // previous tile consumed
    for (int i = tid; i < KT * D / VE; i += FC_QB) {
      const int r = i / (D / VE), c = (i % (D / VE)) * VE;
      const int kr = k0 + r;
      if (kr < L) {
        load_vec<T>(s_k + r * D + c, k + head_off + (long)kr * D + c);
        load_vec<T>(s_v + r * D + c, v + head_off + (long)kr * D + c);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) { s_k[r * D + c + e] = 0.f; s_v[r * D + c + e] = 0.f; }
      }
    }
    for (int r = tid; r < KT; r += FC_QB) {
      const int kr = k0 + r;
      s_keep[r] = kr < L ? (mask[b * L + kr] != 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    float s[KT];
    float mx = FA_NEG;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(s_k + j * D + c);
        dot = fmaf(qr[c], kv.x, dot);
        dot = fmaf(qr[c + 1], kv.y, dot);
        dot = fmaf(qr[c + 2], kv.z, dot);
        dot = fmaf(qr[c + 3], kv.w, dot);
      }
      const int keep = s_keep[j];
      s[j] = keep > 0 ? dot * sm_scale : (keep == 0 ? FA_NEG : -INFINITY);
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float pr = round_as(p, (const T*)nullptr);
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(s_v + j * D + c);
        acc[c] = fmaf(pr, vv.x, acc[c]);
        acc[c + 1] = fmaf(pr, vv.y, acc[c + 1]);
        acc[c + 2] = fmaf(pr, vv.z, acc[c + 2]);
        acc[c + 3] = fmaf(pr, vv.w, acc[c + 3]);
      }
    }
    l_i = alpha * l_i + psum;
    m_i = m_new;
  }

  if (has_q) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* o = out + head_off + (long)qi * D;
#pragma unroll
    for (int c = 0; c < D; ++c) store_as(o + c, acc[c] / denom);
  }
}

}  // namespace sskd

// (MT, MINB) of variants 1..: the route's schedule first, then the others
#define FLASH16_VARIANTS(X) \
  X(1, FT16_MT, FT16_MINB)  \
  X(2, 1, 1)                \
  X(3, 1, 4)                \
  X(4, 1, 8)                \
  X(5, 2, 2)                \
  X(6, 2, 3)                \
  X(7, 2, 5)                \
  X(8, 4, 1)

// bf16 q, k, v, out [B, h, L, 16], mask [B, L] int32; variant 0 the CUDA-core
// kernel (sm_scale), the others flash_fwd_tc2_kernel<16, MT, MINB>
// (scale_log2). Returns cudaGetLastError() after the launch.
extern "C" int probe_flash16(int variant, const void* q, const void* k, const void* v,
                             const int* mask, void* out, int B, int h, int L, float sm_scale,
                             float scale_log2, void* stream) {
  using namespace sskd;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* bq = (const __nv_bfloat16*)q;
  const __nv_bfloat16* bk = (const __nv_bfloat16*)k;
  const __nv_bfloat16* bv = (const __nv_bfloat16*)v;
  __nv_bfloat16* bo = (__nv_bfloat16*)out;
  if (B <= 0 || h <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  int rc = 0;
  switch (variant) {
    case 0: {
      const int n_qt = (L + FC_QB - 1) / FC_QB;
      flash_fwd_kernel<__nv_bfloat16, 16, 64><<<(unsigned)((long)B * h * n_qt), FC_QB, 0, s>>>(
          bq, bk, bv, mask, bo, h, L, n_qt, sm_scale);
      break;
    }
#define FLASH16_CASE(n, mt, minb) \
    case n: rc = launch_tc2<16, mt, minb>(bq, bk, bv, mask, bo, B, h, L, scale_log2, s); break;
    FLASH16_VARIANTS(FLASH16_CASE)
#undef FLASH16_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}
