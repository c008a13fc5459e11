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
// Bound on the H100 at the training shape [256*12, 192, 32] bf16, p 0.1: the
// bytes (q, k, v and out, 4 x 37.7 MB, plus the bias: 151.2 MB, 0.0451 ms at
// 3.35 TB/s; the lse this kernel saves is not part of the function) against
// 4 * B*h*L^2*d = 14.5 GFLOP (0.015 ms at the bf16 tensor-core peak): the
// bytes bound it. Two floors sit above that bound: the exps, one per score in
// each of two passes, 2 x 113 M at 16 a clock an SM (132 SMs, ~1.98 GHz),
// ~0.054 ms; and the keep-mask, 28.3 M Philox4x32-10 calls of ~100 integer
// instructions, ~0.18 ms (0.192 ms measured between p 0.1 and p 0 in the
// backward, which draws the same mask once).
//
// Two routes, chosen by the wrapper (ops/attention.py dropattn_fwd_route)
// from (dtype, d, L):
//
// 1. bf16, d = 32 and L <= 1024 (the student's training lengths are 64 and
//    192):
//    dropattn_fwd_tc_kernel on the tensor cores. A block of 8 warps owns 128
//    query rows, 16 a warp, whose q stays in registers as mma A fragments; the
//    head's whole K and V (rows padded to 80 bytes, so ldmatrix reads them
//    without bank conflicts) and its bias row times log2(e) sit in shared
//    memory, brought by cp.async (L = 192: 41.7 KB a block; 128 rows share
//    one copy, which at L = 512 was 1.5x faster than 64). Products are
//    mma.sync m16n8k16 on bf16 with f32 sums.
//    - Pass 1, per chunk of 16 keys: S = q k^T, and each thread's own running
//      max and sum of 2^(s * scale * log2(e) + bias * log2(e) - max) over the
//      keys it holds (one ex2 a score and one a rescale, no shuffle); the four
//      threads of a row merge theirs at the end, which gives lse.
//    - Pass 2 recomputes S and takes each normalised probability as one ex2,
//      2^(s * scale * log2(e) + (bias - lse) * log2(e)), as the tensor-core
//      backward does; applies the keep bits; rounds pd to bf16 and feeds it
//      from registers as the A fragment of pd v (V through ldmatrix.trans).
//    So pd is normalised before it is rounded, as in the reference, and the
//    output needs no division. The mask is drawn once per element, in pass 2,
//    one Philox call per four neighbouring keys of a row: the keys of a
//    16-key chunk enter the mma in the order 0 1 4 5 8 9 12 13 | 2 3 6 7 ...
//    (the backward's order), so each thread's score fragment holds exactly
//    the four keys of its call, and V's rows follow the same order through
//    ldmatrix's per-lane addresses. ops/attention.py dropattn_fwd_error_bound
//    derives what the folded exponent and the truncating sums add.
// 2. f32, d = 64 (the teacher's head dim, bf16 too), or bf16 at L > 1024:
//    dropattn_fwd_kernel, the first kernel on CUDA cores, at d = 32 and 64:
//    one block of 64 threads per (b*h, 64-query tile), each thread owning one
//    query row with q and its f32 accumulator in registers, the head's K, V
//    (in T) and bias row in shared memory read as broadcasts; two passes over
//    the keys, the first for the row max and sum online, the second forming
//    each probability as the reference does (exp(s - max) / sum), applying the
//    mask and accumulating pd v. When the head's K, V and bias do not fit a
//    block's 227 KB (2 L d sizeof(T) + 4 L bytes: at d = 64 in f32 above L =
//    450, in bf16 above L = 894) both passes stream them through shared memory
//    in chunks of 128 keys; the mask is a function of (row, col) and each
//    row's sums run over the keys in the same order, so chunking changes no
//    bit of the result, and any L is taken. The f32 instantiation rounds
//    nothing, which keeps the f32 checks to summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "attn_common.cuh"
#include "mma_common.cuh"
#include "philox.cuh"

namespace sskd {

constexpr int DF_QB = 64;  // query rows per block == threads per block
constexpr size_t DF_SMEM_MAX = 227 * 1024;  // shared memory a block may hold
constexpr int DF_KC = 128;  // keys a chunk when the head does not fit DF_SMEM_MAX

// Keys a block of the CUDA-core kernel holds in shared memory at once: the
// head's L when its K and V rows and bias fit DF_SMEM_MAX, else DF_KC (a
// multiple of 4, so each chunk starts a Philox group).
template <typename T, int D>
static int df_chunk_keys(int L) {
  const size_t per_key = 2 * (size_t)D * sizeof(T) + sizeof(float);
  return (size_t)L * per_key <= DF_SMEM_MAX ? L : DF_KC;
}

template <typename T, int D>
__global__ void __launch_bounds__(DF_QB) dropattn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse, int h,
    int L, int n_qt, int kc, float sm_scale, uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + (size_t)kc * D;
  float* s_bias = reinterpret_cast<float*>(s_v + (size_t)kc * D);

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_qt;
  const int qi = (blockIdx.x % n_qt) * DF_QB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;
  // rows past L take part in every chunk's barriers and compute nothing
  const bool live = qi < L;
  // the whole head in one chunk: staged once, for both passes
  const bool resident = kc >= L;

  // keys j0 .. j0 + n - 1 (and their v rows when with_v) into shared memory
  auto stage = [&](int j0, bool with_v) {
    const int n = min(kc, L - j0);
    __syncthreads();  // every thread is done with the chunk before
    copy_rows<T, D>(s_k, k + head_off + (long)j0 * D, n, tid, DF_QB);
    if (with_v) copy_rows<T, D>(s_v, v + head_off + (long)j0 * D, n, tid, DF_QB);
    for (int j = tid; j < n; j += DF_QB) s_bias[j] = bias[b * L + j0 + j];
    __syncthreads();
    return n;
  };

  float qr[D];
  if (live) load_row<T, D>(qr, q + head_off + (long)qi * D);

  // pass 1: row max and sum, online
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += kc) {
    const int n = stage(j0, resident);
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float s = dot_row<T, D>(qr, s_k + (long)j * D) * sm_scale + s_bias[j];
      if (s > m) {
        l = l * expf(m - s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
  }

  // pass 2: exact probabilities, mask, pd v
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < L; j0 += kc) {
    const int n = resident ? L : stage(j0, true);
    if (!live) continue;
    for (int c4 = 0; c4 < n; c4 += 4) {
      Philox4 r = {};
      if (p > 0.f)
        r = philox4x32_10((uint32_t)((j0 + c4) >> 2), (uint32_t)qi, seed, (uint32_t)bh);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = c4 + jj;
        if (j >= n) break;
        const float s = dot_row<T, D>(qr, s_k + (long)j * D) * sm_scale + s_bias[j];
        const float prob = expf(s - m) / l;
        float pd = prob;
        if (p > 0.f) pd = philox_uniform(r.w[jj]) >= p ? prob * inv : 0.f;
        axpy_row<T, D>(acc, round_as(pd, (const T*)nullptr), s_v + (long)j * D);
      }
    }
  }
  if (!live) return;
  T* o = out + head_off + (long)qi * D;
#pragma unroll
  for (int c = 0; c < D; ++c) store_as(o + c, acc[c]);
  lse[bh * L + qi] = m + logf(l);
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* lse, int B, int h, int L, float sm_scale, uint32_t seed, float p,
                  float inv, cudaStream_t stream) {
  const int kc = df_chunk_keys<T, D>(L);
  const size_t smem = 2 * (size_t)kc * D * sizeof(T) + (size_t)kc * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dropattn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (L + DF_QB - 1) / DF_QB;
  const unsigned grid = (unsigned)((long)B * h * n_qt);
  dropattn_fwd_kernel<T, D><<<grid, DF_QB, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, lse, h, L, n_qt, kc, sm_scale, seed,
      p, inv);
  return 0;
}

// ---------------------------------------------------------------------------
// Route 1: bf16, d = 32, L <= 1024, tensor cores
// ---------------------------------------------------------------------------

constexpr int DFT_QB = 128;               // query rows per block: 8 warps x 16
constexpr int DFT_THREADS = DFT_QB * 2;   // a warp per 16 query rows
constexpr int DFT_LD = 40;                // shared row stride of q, k, v in bf16 (80 bytes)
constexpr int DFT_MAX_L = 1024;           // 178 KB of shared memory at 1024

// Shared memory of a block at padded length Lp (a multiple of 16): q, k, v
// rows, then the bias row times log2(e).
__host__ __device__ constexpr size_t dft_smem_bytes(int Lp) {
  return (size_t)(DFT_QB + 2 * Lp) * DFT_LD * 2 + (size_t)Lp * 4;
}

// Row of key slot r (0..7) of ldmatrix matrix `second` (0 or 1) in a 16-key
// chunk, in the order in which each thread's fragment holds four neighbours
// (as csrc/dropattn_bwd.cu orders them).
__device__ __forceinline__ int fwd_perm_key(int r, int second) {
  return 4 * (r >> 1) + (r & 1) + 2 * second;
}

__global__ void __launch_bounds__(DFT_THREADS) dropattn_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int h, int L, int Lp, int n_qt,
    float scale_log2, uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + DFT_QB * DFT_LD;
  __nv_bfloat16* s_v = s_k + Lp * DFT_LD;
  float* s_bias2 = reinterpret_cast<float*>(s_v + Lp * DFT_LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * DFT_QB;
  const long head_off = bh * (long)L * 32;
  const bool drop = p > 0.f;

  // the block's q rows, then the head's k and v rows; rows past L as zeros
  for (int i = tid; i < (DFT_QB + 2 * Lp) * 4; i += DFT_THREADS) {
    const int r = i >> 2, c = (i & 3) * 8;
    const __nv_bfloat16* base;
    int row;
    if (r < DFT_QB) {
      base = q;
      row = q0 + r;
    } else if (r < DFT_QB + Lp) {
      base = k;
      row = r - DFT_QB;
    } else {
      base = v;
      row = r - DFT_QB - Lp;
    }
    cp_async16(s_q + r * DFT_LD + c, base + head_off + (long)min(row, L - 1) * 32 + c,
               row < L ? 16 : 0);
  }
  cp_async_commit();
  // padded keys score -inf: probability 0 in both passes
  for (int j = tid; j < Lp; j += DFT_THREADS)
    s_bias2[j] = j < L ? bias[(bh / h) * L + j] * LOG2E : -INFINITY;
  cp_async_wait<0>();
  __syncthreads();
  if (q0 + warp * 16 >= L) return;  // all of this warp's rows are padding

  uint32_t qa[2][4];  // A fragments of the warp's 16 query rows, d 0-15 and 16-31
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldmatrix_x4(qa[ks], s_q + (warp * 16 + mr + (mi & 1) * 8) * DFT_LD + ks * 16 + (mi >> 1) * 8);
  const int NC = Lp / 16;

  // S of a 16-key chunk in the permuted key order: element e of tile nt holds
  // row grp + 8 (e >> 1), key c16 + 4 tig + 2 nt + (e & 1)
  auto scores = [&](int c16, float (&s)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const int key = c16 + fwd_perm_key(mr, mi >> 1);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, s_k + key * DFT_LD + ks * 16 + (mi & 1) * 8);
      mma_bf16(s[0], qa[ks], kb[0], kb[1]);
      mma_bf16(s[1], qa[ks], kb[2], kb[3]);
    }
  };

  // ---- pass 1: each thread's max and sum over its keys, log2 units -------
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < NC; ++c) {
    float s[2][4];
    scores(c * 16, s);
    const float4 b4 = *reinterpret_cast<const float4*>(s_bias2 + c * 16 + 4 * tig);
    const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = fmaf(s[j >> 1][2 * rr + (j & 1)], scale_log2, bj[j]);
      const float mn = fmaxf(m2[rr], fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
      const float base = mn == -INFINITY ? 0.f : mn;  // no -inf - -inf
      l[rr] = l[rr] * exp2_approx(m2[rr] - base) + exp2_approx(x[0] - base) +
              exp2_approx(x[1] - base) + exp2_approx(x[2] - base) + exp2_approx(x[3] - base);
      m2[rr] = mn;
    }
  }
  // the four threads of a row merge their (max, sum); each ends with the same
  float lse2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m2[rr], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[rr], off);
      const float mn = fmaxf(m2[rr], mo);
      const float base = mn == -INFINITY ? 0.f : mn;
      l[rr] = l[rr] * exp2_approx(m2[rr] - base) + lo * exp2_approx(mo - base);
      m2[rr] = mn;
    }
    lse2[rr] = m2[rr] + log2f(l[rr]);
    const int row = q0 + warp * 16 + grp + 8 * rr;
    if (tig == 0 && row < L) lse[bh * L + row] = lse2[rr] * 0.6931471805599453f;
  }

  // ---- pass 2: normalised probabilities, the mask, pd v -------------------
  float o[4][4];  // 16 rows x 32 d, f32
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  for (int c = 0; c < NC; ++c) {
    float s[2][4];
    scores(c * 16, s);
    const int key0 = c * 16 + 4 * tig;
    const float4 b4 = *reinterpret_cast<const float4*>(s_bias2 + key0);
    const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
    uint32_t a[4];  // pd as the A fragment of a 16-deep product over the permuted keys
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = q0 + warp * 16 + grp + 8 * rr;
      uint32_t keep = 0xFu;
      if (drop) {
        const Philox4 w = philox4x32_10((uint32_t)(key0 >> 2), (uint32_t)row, seed, (uint32_t)bh);
        keep = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) keep |= (philox_uniform(w.w[j]) >= p ? 1u : 0u) << j;
      }
      float pd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float prob =
            exp2_approx(fmaf(s[j >> 1][2 * rr + (j & 1)], scale_log2, bj[j] - lse2[rr]));
        pd[j] = drop ? (((keep >> j) & 1u) ? __fmul_rn(prob, inv) : 0.f) : prob;
      }
      a[rr] = pack_bf16(pd[0], pd[1]);
      a[2 + rr] = pack_bf16(pd[2], pd[3]);
    }
    const int vkey = c * 16 + fwd_perm_key(mr, mi & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, s_v + vkey * DFT_LD + half * 16 + (mi >> 1) * 8);
      mma_bf16(o[2 * half], a, vb[0], vb[1]);
      mma_bf16(o[2 * half + 1], a, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + grp + 8 * rr;
    if (row >= L) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + head_off + (long)row * 32 + 2 * tig);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) dst[dn * 4] = pack_bf16(o[dn][2 * rr], o[dn][2 * rr + 1]);
  }
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
//   f32; lse: [B, h, L] f32 (written). d = 32 or 64 (the head dims of the
//   models the port trains: e5-small-v2's and bge-reranker-large's; others
//   are refused), any L; 0 <= p < 1 and inv = 1 / (1 - p), rounded to f32 by
//   the caller as the plain version rounds it.
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_dropattn_fwd(int dtype, const void* q, const void* k, const void* v,
                                 const float* bias, void* out, float* lse, int B, int h, int L,
                                 int d, float sm_scale, uint32_t seed, float p, float inv,
                                 void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || (d != 32 && d != 64) || !(p >= 0.f && p < 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0 && d == 32)
    rc = launch<float, 32>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else if (dtype == 0)
    rc = launch<float, 64>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else if (dtype == 1 && d == 32)
    rc = launch<__nv_bfloat16, 32>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16, 64>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

//   The tensor-core route: bf16, d = 32, L <= 1024 (others are refused); the
//   arguments as above without dtype and sm_scale; scale_log2 = log2(e) /
//   sqrt(d) in f32. Blocks of 8 warps, one per (b*h, 128-query tile).
extern "C" int sskd_dropattn_fwd_tc(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, float* lse, int B, int h,
                                    int L, int d, float scale_log2, uint32_t seed, float p,
                                    float inv, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || L > DFT_MAX_L || d != 32 || !(p >= 0.f && p < 1.f))
    return (int)cudaErrorInvalidValue;
  const int Lp = (L + 15) / 16 * 16;
  const size_t smem = dft_smem_bytes(Lp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dropattn_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (L + DFT_QB - 1) / DFT_QB;
  dropattn_fwd_tc_kernel<<<(unsigned)((long)B * h * n_qt), DFT_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
      (__nv_bfloat16*)out, lse, h, L, Lp, n_qt, scale_log2, seed, p, inv);
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
