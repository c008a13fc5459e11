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
// Bound on the H100 at the e5 encode shape [256, 12, 512, 32] bf16: the bytes
// (q, k, v and out, 4 x 101 MB, plus the mask: 0.120 ms at 3.35 TB/s) and the
// operations (4 * B*h*L^2*d = 103 GFLOP, 0.104 ms at the bf16 tensor-core peak)
// are close. A third floor sits above both at head dim 32: one exp per score,
// B*h*L^2 = 805 M of them, at 16 per clock per SM on the special-function unit
// (132 SMs, ~1.98 GHz) is ~0.19 ms.
//
// Two routes, chosen by the wrapper (ops/attention.py) from (dtype, d):
//
// 1. bf16, d = 32: flash_fwd_tc_kernel, on the tensor cores (FlashAttention-2
//    shape). A block of 4 warps owns 64 query rows, 16 per warp, whose q stays
//    in registers as mma A fragments. K and V tiles of 64 keys are
//    double-buffered in shared memory by cp.async (rows padded to 80 bytes, so
//    ldmatrix reads them without bank conflicts). Per tile a warp computes
//    S = q k^T with mma.sync m16n8k16 (f32 sums), runs the online softmax on
//    the accumulator fragments, and feeds p, rounded to bf16, straight from
//    registers as the A operand of p.v (V through ldmatrix.trans). Exactly one
//    exp per score: the scale and log2(e) are folded into the scores, so each
//    exp is one ex2.approx, and on a tile whose 64 keys are all live (every
//    tile of a full row) its exponent is one fma of the raw sum, with no mask
//    applied; ops/attention.py flash_error_bound derives what that and the
//    tensor cores' f32 sums add to the error.
// 2. f32, or d in {16, 64} (the teacher's head dim): flash_fwd_kernel, the
//    first kernel on CUDA cores: one block of 128 threads per (b*h, 128-query
//    tile), a thread per query row, K and V tiles converted to f32 in shared
//    memory and read as broadcasts. The f32 instantiation rounds nothing, so
//    it holds the masking and the tiling to summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <float.h>
#include <math.h>

#include "attn_common.cuh"
#include "mma_common.cuh"

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


// ---------------------------------------------------------------------------
// Route 1: bf16, d = 32, tensor cores
// ---------------------------------------------------------------------------

constexpr int FT_QB = 64;  // query rows per block: 4 warps x 16
constexpr int FT_THREADS = FT_QB * 2;  // a warp per 16 query rows
constexpr int FT_KB = 64;  // keys per tile
constexpr int FT_LD = 40;  // shared row stride in bf16 (80 bytes)

__global__ void __launch_bounds__(FT_THREADS) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int h, int L, int n_qt, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 s_q[FT_QB * FT_LD];
  __shared__ __align__(16) __nv_bfloat16 s_k[2][FT_KB * FT_LD];
  __shared__ __align__(16) __nv_bfloat16 s_v[2][FT_KB * FT_LD];
  __shared__ float s_keep[2][FT_KB];  // 1 keep, 0 masked, -1 past L

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * FT_QB;
  const long head_off = bh * (long)L * 32;
  const __nv_bfloat16* qh = q + head_off;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;
  const int* mrow = mask + (bh / h) * L;

  // rows past L are copied as zeros (cp.async with 0 source bytes)
  for (int i = tid; i < FT_QB * 4; i += FT_THREADS) {
    const int r = i >> 2, c = (i & 3) * 8, qr = q0 + r;
    cp_async16(s_q + r * FT_LD + c, qh + (long)min(qr, L - 1) * 32 + c, qr < L ? 16 : 0);
  }
  auto load_tile = [&](int stage, int k0) {
    for (int i = tid; i < FT_KB * 8; i += FT_THREADS) {
      const int which = i >> 8, j = i & 255;  // 256 chunks of K, then 256 of V
      const int r = j >> 2, c = (j & 3) * 8, kr = k0 + r;
      const __nv_bfloat16* src = (which ? vh : kh) + (long)min(kr, L - 1) * 32 + c;
      __nv_bfloat16* dst = (which ? s_v[stage] : s_k[stage]) + r * FT_LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < FT_KB) {
      const int kr = k0 + tid;
      s_keep[stage][tid] = kr < L ? (mrow[kr] != 0 ? 1.f : 0.f) : -1.f;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qa[2][4];  // A fragments of the warp's 16 query rows, d 0-15 and 16-31
  float o[4][4];      // 16 rows x 32 d, f32
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m2[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};  // rows grp and grp + 8

  const int n_kt = (L + FT_KB - 1) / FT_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FT_KB);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(qa[ks], s_q + (warp * 16 + mr + (mi & 1) * 8) * FT_LD + ks * 16 + (mi >> 1) * 8);
    }
    const __nv_bfloat16* sk = s_k[t & 1];
    const __nv_bfloat16* sv = s_v[t & 1];
    const float* keep = s_keep[t & 1];

    // S = q k^T, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      uint32_t kb[4];
      ldmatrix_x4(kb, sk + (nt * 8 + mr) * FT_LD + mi * 8);
      mma_bf16(s[nt], qa[0], kb[0], kb[1]);
      mma_bf16(s[nt], qa[1], kb[2], kb[3]);
    }
    // The row max in log2 units. A tile whose 64 keys are all live (every
    // tile of a full row) needs no mask: its max is the max of the raw sums
    // times the scale (the rounded product is monotone), and each exponent
    // below is one fma. Otherwise each score is scaled or replaced by its
    // sentinel first.
    const bool live = __all_sync(0xffffffffu, keep[lane] > 0.f && keep[lane + 32] > 0.f);
    float mx[2] = {m2[0], m2[1]};
    if (live) {
      float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) raw[e >> 1] = fmaxf(raw[e >> 1], s[nt][e]);
      mx[0] = fmaxf(mx[0], raw[0] * scale_log2);
      mx[1] = fmaxf(mx[1], raw[1] * scale_log2);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kf = keep[nt * 8 + 2 * tig + (e & 1)];
          const float x = kf > 0.f ? s[nt][e] * scale_log2 : (kf == 0.f ? FA_NEG : -INFINITY);
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m2[r] - mx[r]);
      m2[r] = mx[r];
      l[r] *= alpha[r];
    }
    // the exponent of each p: s * scale - m in one fma on a live tile
    const float a_mul = live ? scale_log2 : 1.f;
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    // p = 2^(s - m): summed unrounded, then packed as bf16 A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2_approx(fmaf(s[nt][0], a_mul, -m2[0]));
      const float p1 = exp2_approx(fmaf(s[nt][1], a_mul, -m2[0]));
      const float p2 = exp2_approx(fmaf(s[nt][2], a_mul, -m2[1]));
      const float p3 = exp2_approx(fmaf(s[nt][3], a_mul, -m2[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // o += p v over the tile's 4 steps of 16 keys
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv + (ks * 16 + mr + (mi & 1) * 8) * FT_LD + half * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * half], pa[ks], vb[0], vb[1]);
        mma_bf16(o[2 * half + 1], pa[ks], vb[2], vb[3]);
      }
    }
    __syncthreads();  // the tile's buffers are free for tile t + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + grp + 8 * r;
    if (row < L) {
      const float denom = fmaxf(l[r], 1e-30f);
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + head_off + (long)row * 32 + 2 * tig);
#pragma unroll
      for (int dn = 0; dn < 4; ++dn)
        dst[dn * 4] = pack_bf16(o[dn][2 * r] / denom, o[dn][2 * r + 1] / denom);
    }
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

//   The tensor-core route: bf16 only, d = 32; q, k, v, out [B, h, L, 32]
//   contiguous, mask [B, L] int32; scale_log2 = log2(e) / sqrt(d) in f32.
extern "C" int sskd_flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                      const int* mask, void* out, int B, int h, int L,
                                      float scale_log2, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int n_qt = (L + FT_QB - 1) / FT_QB;
  flash_fwd_tc_kernel<<<(unsigned)((long)B * h * n_qt), FT_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, mask,
      (__nv_bfloat16*)out, h, L, n_qt, scale_log2);
  return (int)cudaGetLastError();
}
