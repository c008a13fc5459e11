// dropattn_bwd: backward of the training attention with dropout.
//
// Replaces: sskd_tpu/ops/attention.py _dropattn_bwd_kernel (reached through
// the custom VJP of _fused_dropout_attention, _dropattn_bwd_call).
//
// For q, k, v, g [B*h, L, d] (bf16 or f32), the key bias [B, L], the seed and
// the forward's lse [B*h, L], recomputes probs = exp(s - lse) and the same
// keep-mask (philox.cuh), then
//   dv     = round_T(pd)^T g                       pd = keep ? probs / (1 - p) : 0
//   dprobs = keep ? (g v^T) / (1 - p) : 0
//   D      = rowsum(dprobs * probs)
//   ds     = probs * (dprobs - D) / sqrt(d)
//   dq     = round_T(ds) k,   dk = round_T(ds)^T q
// with f32 sums, each output rounded to T once. D is recomputed from the
// scores as the TPU kernel does, not taken from rowsum(g * out), so no bf16
// rounding of the forward's output enters the gradient.
//
// Bound on the H100 at the training shape [256*12, 192, 32] bf16: the bytes
// (q, k, v, g read, dq, dk, dv written: 7 x 37.7 MB, plus the bias: 264.4 MB,
// 0.0789 ms at 3.35 TB/s; the saved lse is not part of the function) against
// 10 * B*h*L^2*d = 36 GFLOP for the five products (0.037 ms at the bf16
// tensor-core peak): the bytes bound it.
//
// Design (a first, simple kernel pair on CUDA cores): dq needs sums along each
// query row and dk, dv sums down each key column, so two kernels, neither with
// atomics.
//   dq kernel: one block of 64 threads per (b*h, 64-query tile), a thread per
//     query row holding q, g and its dq accumulator in registers, K, V and the
//     bias row of the head in shared memory. Pass 1 sums D over the keys, pass
//     2 accumulates round(ds) k; D is written out for the other kernel.
//   dkv kernel: one block of 64 threads per (b*h, 64-key tile), a thread per key
//     row holding k, v and its dk, dv accumulators, Q, G, lse and D of the head
//     in shared memory; one pass over the queries.
// The dkv kernel draws the mask one element at a time (a thread walks down a
// column, and one Philox call covers four columns of one row); the dq kernel
// draws four keys per call. The next steps are tensor-core tiles (mma.sync /
// wgmma) and one fused kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "attn_common.cuh"
#include "philox.cuh"

namespace sskd {

constexpr int DB_TB = 64;  // rows per block == threads per block

template <typename T, int D>
__global__ void __launch_bounds__(DB_TB) dropattn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ dsum, T* __restrict__ dq, int h, int L, int n_t, float sm_scale,
    uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + (size_t)L * D;
  float* s_bias = reinterpret_cast<float*>(s_v + (size_t)L * D);

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_t;
  const int qi = (blockIdx.x % n_t) * DB_TB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;

  copy_rows<T, D>(s_k, k + head_off, L, tid, DB_TB);
  copy_rows<T, D>(s_v, v + head_off, L, tid, DB_TB);
  for (int j = tid; j < L; j += DB_TB) s_bias[j] = bias[b * L + j];
  __syncthreads();
  if (qi >= L) return;

  float qr[D], gr[D];
  load_row<T, D>(qr, q + head_off + (long)qi * D);
  load_row<T, D>(gr, g + head_off + (long)qi * D);
  const float lse_i = lse[bh * L + qi];

  // pass 1: D = <dprobs, probs>
  float dsum_i = 0.f;
  for (int j0 = 0; j0 < L; j0 += 4) {
    Philox4 r = {};
    if (p > 0.f) r = philox4x32_10((uint32_t)(j0 >> 2), (uint32_t)qi, seed, (uint32_t)bh);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      if (j >= L) break;
      const float s = dot_row<T, D>(qr, s_k + (long)j * D) * sm_scale + s_bias[j];
      const float prob = expf(s - lse_i);
      float dprobs = dot_row<T, D>(gr, s_v + (long)j * D);
      if (p > 0.f) dprobs = philox_uniform(r.w[jj]) >= p ? dprobs * inv : 0.f;
      dsum_i = fmaf(dprobs, prob, dsum_i);
    }
  }

  // pass 2: dq = round(ds) k
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
      const float prob = expf(s - lse_i);
      float dprobs = dot_row<T, D>(gr, s_v + (long)j * D);
      if (p > 0.f) dprobs = philox_uniform(r.w[jj]) >= p ? dprobs * inv : 0.f;
      const float ds = prob * (dprobs - dsum_i) * sm_scale;
      axpy_row<T, D>(acc, round_as(ds, (const T*)nullptr), s_k + (long)j * D);
    }
  }
  T* o = dq + head_off + (long)qi * D;
#pragma unroll
  for (int c = 0; c < D; ++c) store_as(o + c, acc[c]);
  dsum[bh * L + qi] = dsum_i;
}

template <typename T, int D>
__global__ void __launch_bounds__(DB_TB) dropattn_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int h, int L,
    int n_t, float sm_scale, uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_g = s_q + (size_t)L * D;
  float* s_lse = reinterpret_cast<float*>(s_g + (size_t)L * D);
  float* s_dsum = s_lse + L;

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_t;
  const int kj = (blockIdx.x % n_t) * DB_TB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;

  copy_rows<T, D>(s_q, q + head_off, L, tid, DB_TB);
  copy_rows<T, D>(s_g, g + head_off, L, tid, DB_TB);
  for (int i = tid; i < L; i += DB_TB) {
    s_lse[i] = lse[bh * L + i];
    s_dsum[i] = dsum[bh * L + i];
  }
  __syncthreads();
  if (kj >= L) return;

  float kr[D], vr[D], acc_k[D], acc_v[D];
  load_row<T, D>(kr, k + head_off + (long)kj * D);
  load_row<T, D>(vr, v + head_off + (long)kj * D);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    acc_k[c] = 0.f;
    acc_v[c] = 0.f;
  }
  const float bias_j = bias[b * L + kj];
  const bool drop = p > 0.f;
  for (int i = 0; i < L; ++i) {
    const T* q_i = s_q + (long)i * D;
    const T* g_i = s_g + (long)i * D;
    const float s = dot_row<T, D>(kr, q_i) * sm_scale + bias_j;
    const float prob = expf(s - s_lse[i]);
    const bool keep = !drop || dropout_keep(seed, (uint32_t)bh, i, kj, p);
    const float pd = drop ? (keep ? prob * inv : 0.f) : prob;
    axpy_row<T, D>(acc_v, round_as(pd, (const T*)nullptr), g_i);
    float dprobs = dot_row<T, D>(vr, g_i);
    if (drop) dprobs = keep ? dprobs * inv : 0.f;
    const float ds = prob * (dprobs - s_dsum[i]) * sm_scale;
    axpy_row<T, D>(acc_k, round_as(ds, (const T*)nullptr), q_i);
  }
  T* ok = dk + head_off + (long)kj * D;
  T* ov = dv + head_off + (long)kj * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    store_as(ok + c, acc_k[c]);
    store_as(ov + c, acc_v[c]);
  }
}

template <typename Kern>
static int allow_smem(Kern kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const float* bias, const void* g,
                  const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int h,
                  int L, float sm_scale, uint32_t seed, float p, float inv, cudaStream_t stream) {
  const size_t smem_dq = 2 * (size_t)L * D * sizeof(T) + (size_t)L * sizeof(float);
  const size_t smem_dkv = 2 * (size_t)L * D * sizeof(T) + 2 * (size_t)L * sizeof(float);
  int rc = allow_smem(dropattn_bwd_dq_kernel<T, D>, smem_dq);
  if (rc == 0) rc = allow_smem(dropattn_bwd_dkv_kernel<T, D>, smem_dkv);
  if (rc != 0) return rc;
  const int n_t = (L + DB_TB - 1) / DB_TB;
  const unsigned grid = (unsigned)((long)B * h * n_t);
  dropattn_bwd_dq_kernel<T, D><<<grid, DB_TB, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)g, lse, dsum, (T*)dq, h, L, n_t,
      sm_scale, seed, p, inv);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dropattn_bwd_dkv_kernel<T, D><<<grid, DB_TB, smem_dkv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)g, lse, dsum, (T*)dk, (T*)dv, h,
      L, n_t, sm_scale, seed, p, inv);
  return 0;
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype: 0 f32, 1 bf16. q, k, v, g, dq, dk, dv: [B, h, L, d] contiguous;
//   bias: [B, L] f32; lse: [B, h, L] f32 from the forward; dsum: [B, h, L] f32
//   scratch. d = 32 only (others are refused); 0 <= p < 1, inv = 1 / (1 - p)
//   rounded to f32.
// Launches the dq kernel, then the dk/dv kernel, on one stream.
// Returns cudaGetLastError() after the launches.
extern "C" int sskd_dropattn_bwd(int dtype, const void* q, const void* k, const void* v,
                                 const float* bias, const void* g, const float* lse,
                                 float* dsum, void* dq, void* dk, void* dv, int B, int h, int L,
                                 int d, float sm_scale, uint32_t seed, float p, float inv,
                                 void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || d != 32 || !(p >= 0.f && p < 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0)
    rc = launch<float, 32>(q, k, v, bias, g, lse, dsum, dq, dk, dv, B, h, L, sm_scale, seed, p,
                           inv, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16, 32>(q, k, v, bias, g, lse, dsum, dq, dk, dv, B, h, L, sm_scale,
                                   seed, p, inv, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
