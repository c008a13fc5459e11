// dropattn_fwd: training attention forward with dropout on the probabilities.
//
// Replaces: sskd_tpu/ops/attention.py _dropattn_fwd_kernel (reached through
// dropout_attention, _fused_dropout_attention and _dropattn_fwd_call).
//
// Computes, for q, k, v [B*h, L, d] (bf16 or f32), an additive key bias [B, L]
// (f32) and a seed:
//   s     = q k^T * (1 / sqrt(d)) + bias          (f32; products of T values)
//   probs = exp(s - max) / sum(exp(s - max))      (f32)
//   pd    = keep ? probs / (1 - p) : 0            (keep from philox.cuh)
//   out   = round_T(pd) v                         (f32 sums, rounded to T)
// and lse = max + log(sum) per row (f32), which the backward uses to recompute
// probs without a second reduction. The TPU kernel holds one head's [L, L]
// scores in VMEM; no [L, L] tensor exists here, in device memory or on chip.
//
// Bound on the H100 at the training shape [256*12, 192, 32] bf16: the bytes
// (q, k, v and out, 4 x 37.7 MB, plus the bias: 151.2 MB, 0.0451 ms at
// 3.35 TB/s; the lse this kernel saves is not part of the function) against
// 4 * B*h*L^2*d = 14.5 GFLOP (0.015 ms at the bf16 tensor-core peak): the
// bytes bound it.
//
// Design (a first, simple kernel on CUDA cores, far above that bound): one
// block of 64 threads per (b*h, 64-query tile), each thread owning one query
// row with q and its f32 accumulator in registers. The head's whole K, V (in T)
// and bias row sit in shared memory (L = 512, d = 32, bf16: 66 KB) and are read
// as broadcasts. Two passes over the keys: the first takes the row max and sum
// online, the second forms each probability exactly as the reference does
// (exp(s - max) / sum), applies the mask and accumulates pd v. One Philox call
// gives the mask of four neighbouring keys. The next step is mma.sync / wgmma
// on bf16 tiles, with the score tile in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "attn_common.cuh"
#include "philox.cuh"

namespace sskd {

constexpr int DF_QB = 64;  // query rows per block == threads per block

template <typename T, int D>
__global__ void __launch_bounds__(DF_QB) dropattn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse, int h,
    int L, int n_qt, float sm_scale, uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + (size_t)L * D;
  float* s_bias = reinterpret_cast<float*>(s_v + (size_t)L * D);

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_qt;
  const int qi = (blockIdx.x % n_qt) * DF_QB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;

  copy_rows<T, D>(s_k, k + head_off, L, tid, DF_QB);
  copy_rows<T, D>(s_v, v + head_off, L, tid, DF_QB);
  for (int j = tid; j < L; j += DF_QB) s_bias[j] = bias[b * L + j];
  __syncthreads();
  if (qi >= L) return;

  float qr[D];
  load_row<T, D>(qr, q + head_off + (long)qi * D);

  // pass 1: row max and sum, online
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < L; ++j) {
    const float s = dot_row<T, D>(qr, s_k + (long)j * D) * sm_scale + s_bias[j];
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }

  // pass 2: exact probabilities, mask, pd v
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < L; j0 += 4) {
    Philox4 r = {};
    if (p > 0.f) r = philox4x32_10((uint32_t)(j0 >> 2), (uint32_t)qi, seed, (uint32_t)bh);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      if (j >= L) break;
      const float s = dot_row<T, D>(qr, s_k + (long)j * D) * sm_scale + s_bias[j];
      const float prob = expf(s - m) / l;
      float pd = prob;
      if (p > 0.f) pd = philox_uniform(r.w[jj]) >= p ? prob * inv : 0.f;
      axpy_row<T, D>(acc, round_as(pd, (const T*)nullptr), s_v + (long)j * D);
    }
  }
  T* o = out + head_off + (long)qi * D;
#pragma unroll
  for (int c = 0; c < D; ++c) store_as(o + c, acc[c]);
  lse[bh * L + qi] = m + logf(l);
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* lse, int B, int h, int L, float sm_scale, uint32_t seed, float p,
                  float inv, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)L * D * sizeof(T) + (size_t)L * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dropattn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (L + DF_QB - 1) / DF_QB;
  const unsigned grid = (unsigned)((long)B * h * n_qt);
  dropattn_fwd_kernel<T, D><<<grid, DF_QB, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, lse, h, L, n_qt, sm_scale, seed, p, inv);
  return 0;
}

// The keep-mask as the kernels draw it, one byte per element, for checks.
__global__ void keep_mask_kernel(uint8_t* out, long BH, int L, uint32_t seed, float p) {
  const int L4 = (L + 3) / 4;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BH * L * L4) return;
  const int c4 = (int)(idx % L4);
  const int row = (int)((idx / L4) % L);
  const long bh = idx / ((long)L4 * L);
  const Philox4 r = philox4x32_10((uint32_t)c4, (uint32_t)row, seed, (uint32_t)bh);
  for (int jj = 0; jj < 4; ++jj) {
    const int col = c4 * 4 + jj;
    if (col < L) out[(bh * L + row) * L + col] = philox_uniform(r.w[jj]) >= p ? 1 : 0;
  }
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype: 0 f32, 1 bf16. q, k, v, out: [B, h, L, d] contiguous; bias: [B, L]
//   f32; lse: [B, h, L] f32 (written). d = 32 only (the head dim of the models
//   the port trains; others are refused); 0 <= p < 1 and inv = 1 / (1 - p),
//   rounded to f32 by the caller as the plain version rounds it.
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_dropattn_fwd(int dtype, const void* q, const void* k, const void* v,
                                 const float* bias, void* out, float* lse, int B, int h, int L,
                                 int d, float sm_scale, uint32_t seed, float p, float inv,
                                 void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || d != 32 || !(p >= 0.f && p < 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0)
    rc = launch<float, 32>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16, 32>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

//   out: [BH, L, L] uint8 (1 = keep).
extern "C" int sskd_dropattn_keep_mask(uint8_t* out, int BH, int L, uint32_t seed, float p,
                                       void* stream) {
  using namespace sskd;
  if (BH <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long n = (long)BH * L * ((L + 3) / 4);
  keep_mask_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      out, BH, L, seed, p);
  return (int)cudaGetLastError();
}
