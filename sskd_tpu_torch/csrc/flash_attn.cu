// flash_attn_fwd: attention forward with an online softmax, for the encoder.
//
// Replaces: sskd_tpu/ops/attention.py _flash_kernel (reached through
// flash_attention and its pallas_call).
//
// Computes out = softmax(q k^T / sqrt(d), keep-mask) v for q, k, v [B, h, L, d]
// (bf16 or f32) and a key keep-mask [B, L] (nonzero = attend). Masked keys score
// finfo(f32).min / 2, as in the TPU kernel, so a row whose keys are all masked
// averages v over its L keys exactly as the reference does; key slots past L
// (the ragged last tile) score -inf and drop out. Scores, the running max and
// the running sum are f32; p is rounded to the input type before the p.v product,
// as the TPU kernel does, and the sum of p is taken before that rounding.
//
// Bound on the H100: at the e5 encode shape [256, 12, 512, 32] bf16 the bytes
// (q, k, v and out, 4 x 101 MB, ~120 us at 3.35 TB/s) and the operations
// (4 * B*h*L^2*d = 103 GFLOP, ~104 us at the bf16 tensor-core peak) are close;
// at head dim 32 the bytes bound it by a little.
//
// Design (a first, simple kernel on CUDA cores, well above that bound): one
// block of 128 threads per (batch*head, 128-query tile); each thread owns one
// query row, holding q and its f32 accumulator in registers. K and V tiles of
// KT keys are converted to f32 into shared memory and read as broadcasts; the
// KT scores of a tile stay in registers, so no [L, L] score matrix exists
// anywhere. The next step is mma.sync / wgmma on bf16 tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <float.h>
#include <math.h>

#include "attn_common.cuh"

namespace sskd {

constexpr int FA_QB = 128;  // queries per block == threads per block
constexpr float FA_NEG = -FLT_MAX / 2;

template <typename T, int D, int KT>
__global__ void __launch_bounds__(FA_QB) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, T* __restrict__ out, int h, int L, int n_qt, float sm_scale) {
  constexpr int VE = 16 / sizeof(T);
  __shared__ __align__(16) float s_k[KT * D];
  __shared__ __align__(16) float s_v[KT * D];
  __shared__ int s_keep[KT];  // 1 keep, 0 masked, -1 past L

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_qt;
  const int qi = (blockIdx.x % n_qt) * FA_QB + tid;
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
    for (int i = tid; i < KT * D / VE; i += FA_QB) {
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
    for (int r = tid; r < KT; r += FA_QB) {
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

template <typename T, int D, int KT>
static void launch(const void* q, const void* k, const void* v, const int* mask, void* out,
                   int B, int h, int L, float sm_scale, cudaStream_t stream) {
  const int n_qt = (L + FA_QB - 1) / FA_QB;
  const unsigned grid = (unsigned)((long)B * h * n_qt);
  flash_fwd_kernel<T, D, KT><<<grid, FA_QB, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, h, L, n_qt, sm_scale);
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, const int* mask, void* out,
                    int B, int h, int L, int d, float sm_scale, cudaStream_t stream) {
  if (d == 16) launch<T, 16, 64>(q, k, v, mask, out, B, h, L, sm_scale, stream);
  else if (d == 32) launch<T, 32, 64>(q, k, v, mask, out, B, h, L, sm_scale, stream);
  else if (d == 64) launch<T, 64, 32>(q, k, v, mask, out, B, h, L, sm_scale, stream);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype: 0 f32, 1 bf16. q, k, v, out: [B, h, L, d] contiguous. mask: [B, L] int32.
//   d in {16, 32, 64}.
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                   const int* mask, void* out, int B, int h, int L, int d,
                                   float sm_scale, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) rc = launch_d<float>(q, k, v, mask, out, B, h, L, d, sm_scale, s);
  else if (dtype == 1) rc = launch_d<__nv_bfloat16>(q, k, v, mask, out, B, h, L, d, sm_scale, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
