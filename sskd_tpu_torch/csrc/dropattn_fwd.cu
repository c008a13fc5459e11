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
// Bound on the H100 at the student's training shape [256*12, 192, 32] bf16,
// p 0.1: the bytes (q, k, v and out, 4 x 37.7 MB, plus the bias: 151.2 MB,
// 0.0451 ms at 3.35 TB/s; the lse this kernel saves is not part of the
// function) against 4 * B*h*L^2*d = 14.5 GFLOP (0.015 ms at the bf16
// tensor-core peak): the bytes bound it. Two floors sit above that bound: the
// exps, one per score in each of two passes, 2 x 113 M at 16 a clock an SM
// (132 SMs, ~1.98 GHz), ~0.054 ms; and the keep-mask, 28.3 M Philox4x32-10
// calls of ~100 integer instructions, ~0.18 ms (0.192 ms measured between p
// 0.1 and p 0 in the backward, which draws the same mask once).
//
// At the teacher's head dim 64: [32*16, 64, 64] (its train shape) moves 4 x
// 8.39 MB in f32 plus the bias, 0.0100 ms (bf16 0.0050), for 4 * B*h*L^2*d =
// 0.537 GFLOP: 0.0011 ms at TF32's 495 TFLOP/s, 0.0033 as three TF32 passes,
// 0.0005 at bf16's 989; 524 K Philox calls. [8*16, 512, 64] moves 67.1 MB in
// f32, 0.0200 ms (bf16 0.0100), for 8.59 GFLOP: 0.0174 ms at TF32, 0.0521
// as three passes, 0.128 on the CUDA cores' FMA, 0.0087 at bf16's peak; 8.4 M
// Philox calls. The bytes bound both in bf16; in f32 the three passes bound
// the longer one.
//
// In f32 at the student's shape [256*12, 192, 32] (the demo pipeline's
// student computes in f32) the bytes are 302 MB, 0.090 ms, and the three
// TF32 passes 0.088 ms (0.216 ms on the FMA), under the keep-mask's 28.3 M
// Philox calls; at the tiny teacher's [32*4, 64, 16] the bytes, 2.1 MB, take
// 0.0006 ms: launch latency sets that shape's time.
//
// Three routes, chosen by the wrapper (ops/attention.py dropattn_fwd_route)
// from (dtype, d, L):
//
// 1. bf16 at d in {16, 32, 64} while the head's K and V fit a block (L <=
//    2256 at d = 16, 1344 at d = 32, 656 at d = 64; the student trains at 64
//    and 192, the pipeline's --tiny student at d = 16):
//    dropattn_fwd_tc_kernel<D, NW> on the tensor cores. A block of NW warps
//    owns 16 query rows a warp, whose q stays in registers as mma A
//    fragments (dft_warps: 8 warps, 128 rows, at d = 32; at d = 16 4 warps
//    while L <= 64 and 8 past that; at d = 64 4 warps while L <= 64 and 16,
//    256 rows, past that); the head's whole K and V (rows padded to D + 8
//    bf16, 48, 80 or 144 bytes, so ldmatrix reads them
//    without bank conflicts) and its bias row times log2(e) sit in shared
//    memory, brought by cp.async (L = 192 at d = 32: 41.7 KB a block; 128
//    rows share one copy, which at L = 512 was 1.5x faster than 64).
//    Products are mma.sync m16n8k16 on bf16 with f32 sums.
//    - Pass 1, per chunk of 16 keys: S = q k^T, and each thread's own running
//      max and sum of 2^(s * scale * log2(e) + bias * log2(e) - max) over the
//      keys it holds (one ex2 a score and one a rescale, no shuffle); the four
//      threads of a row merge theirs at the end, which gives lse.
//    - Pass 2 recomputes S and takes each normalised probability as one ex2,
//      2^(s * scale * log2(e) + (bias - lse) * log2(e)), as the tensor-core
//      backward does; applies the keep bits; rounds pd to bf16 and feeds it
//      from registers as the A fragment of pd v (V through ldmatrix.trans).
//    So pd is normalised before it is rounded, as in the reference (which
//    is why this route keeps two passes), and the output needs no division.
//    The mask is drawn once per element, in pass 2, one Philox call per four
//    neighbouring keys of a row: the keys of a 16-key chunk enter the mma in
//    the order of attn_common.cuh perm_key (the backward's), so each thread's
//    score fragment holds exactly the four keys of its call, and V's rows
//    follow the same order through ldmatrix's per-lane addresses.
//    ops/attention.py dropattn_fwd_error_bound derives what the folded
//    exponent and the truncating sums add.
// 2. f32 at d in {16, 32, 64} (the teacher computes in f32, and so do the
//    demo pipeline's student and the tiny teacher), any L:
//    dropattn_fwd_tc_tf32_kernel<D>, one online pass on the tensor cores, in
//    the shape of csrc/flash_attn.cu flash_fwd_tc_tf32_kernel: a block of 4
//    warps owns 64 query rows; K and V stream through shared memory in tiles
//    of 64 keys, double-buffered by cp.async where the head has two or more
//    (f32 rows padded to D + 4 floats, the stride at which the 32-bit
//    fragment reads hit distinct banks at 16, 32 and 64); each product is
//    mma.sync m16n8k8 on tf32 operands (D / 8 steps for S, D / 8 output
//    tiles for p v) as three products with the small ones in an accumulator
//    of their own (mma_common.cuh mma_3xtf32), which holds the f32 function
//    to 1e-5 of the plain version. The softmax is the CUDA-core kernel's in
//    natural units: s = qk * scale + bias, a running max, p = expf(s - max)
//    summed unmasked, the accumulator rescaled when the max moves, the kept p
//    times 1 / (1 - p) fed from registers as the A fragment of p v, and one
//    division by the sum at the end; lse = max + log(sum). One pass makes
//    two products where two passes make three (tools/probe_attention64.py
//    times both). K and V rows are stored in slot order (attn_common.cuh
//    key_slot), so each thread's score fragment of a 16-key chunk holds the
//    four keys of one Philox call, as in the f32 backward, and the keep bits
//    are those the tensor-core backward regenerates. Its shared memory is
//    46.6 KB at d = 32 and 26.1 KB at d = 16 with two stages. On an H100 at
//    [256, 12, 192, 32], p 0.1, this kernel (127 registers) took 0.49 ms in
//    tools/probe_attention_f32.py, against 0.51-0.54 ms with 4 or 8 warps, q
//    split once and S an 8-key tile at a time, 0.63-0.73 ms with each K and
//    V tile split into its TF32 terms once for the block (the same bits),
//    1.71 ms for the CUDA-core kernel it replaced and 1.13 ms for SDPA with
//    dropout.
// 3. bf16 past route 1's lengths: dropattn_fwd_kernel, the first kernel, on
//    CUDA cores: one block of 64 threads per (b*h, 64-query
//    tile), each thread owning one query row with q and its f32 accumulator
//    in registers, the head's K, V (in T) and bias row in shared memory read
//    as broadcasts; two passes over the keys, the first for the row max and
//    sum online, the second forming each probability as the reference does
//    (exp(s - max) / sum), applying the mask and accumulating pd v. When the
//    head's K, V and bias do not fit a block's 227 KB (2 L d sizeof(T) + 4 L
//    bytes: above L = 3418 at d = 16, 1760 at d = 32 and 894 at d = 64)
//    both passes stream them through shared memory in chunks of 128 keys; the
//    mask is a function of (row, col) and each row's sums run over the keys
//    in the same order, so chunking changes no bit of the result, and any L
//    is taken.

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
// Route 1: bf16, d in {16, 32, 64}, the head's K and V in shared memory
// ---------------------------------------------------------------------------

// The bf16 route's blocks: NW warps of 16 query rows each. D = 32: 8 warps
// (128 rows). D = 16: 4 warps while L <= 64 (the tiny models' lengths),
// where 128 rows would idle half the warps, 8 past that. D = 64: 4 warps
// (64 rows) while L <= 64, the teacher's train
// length, where a 128-row block would idle half its warps; 16 warps (256
// rows) past that, so that each copy of the head's K and V serves 256 rows
// with as many warps an SM as the block holds (at L = 512 this beat 8 warps
// of two 16-row tiles each: tools/probe_attention64.py).
template <int D>
__host__ __device__ constexpr int dft_warps(int L) {
  return D == 32 ? 8 : L <= 64 ? 4 : D == 16 ? 8 : 16;
}

// Shared memory of a block of QB rows at padded length Lp (a multiple of
// 16): q, k, v rows (padded to D + 8 bf16), then the bias row times log2(e).
// The route takes L while this fits DF_SMEM_MAX: up to 2256 at D = 16, 1344
// at 32, 656 at 64.
template <int D>
__host__ __device__ constexpr size_t dft_smem_bytes(int QB, int Lp) {
  return (size_t)(QB + 2 * Lp) * (D + 8) * 2 + (size_t)Lp * 4;
}

// The copy loop counts in unsigned ints, so that its divisions by the
// power-of-two chunks a row are shifts (signed, they slowed the templated
// flash kernel at D = 32: tools/probe_attention64.py).
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW) dropattn_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int h, int L, int Lp, int n_qt,
    float scale_log2, uint32_t seed, float p, float inv) {
  constexpr int QB = 16 * NW, THREADS = 32 * NW;
  constexpr int LD = D + 8;        // shared row stride in bf16
  constexpr unsigned CH = D / 8;   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + QB * LD;
  __nv_bfloat16* s_v = s_k + Lp * LD;
  float* s_bias2 = reinterpret_cast<float*>(s_v + Lp * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QB;
  const long head_off = bh * (long)L * D;
  const bool drop = p > 0.f;

  // the block's q rows, then the head's k and v rows; rows past L as zeros
  for (unsigned i = tid; i < (QB + 2 * Lp) * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const __nv_bfloat16* base;
    int row;
    if (r < QB) {
      base = q;
      row = q0 + r;
    } else if (r < QB + Lp) {
      base = k;
      row = r - QB;
    } else {
      base = v;
      row = r - QB - Lp;
    }
    cp_async16(s_q + r * LD + c, base + head_off + (long)min(row, L - 1) * D + c,
               row < L ? 16 : 0);
  }
  cp_async_commit();
  // padded keys score -inf: probability 0 in both passes
  for (int j = tid; j < Lp; j += THREADS)
    s_bias2[j] = j < L ? bias[(bh / h) * L + j] * LOG2E : -INFINITY;
  cp_async_wait<0>();
  __syncthreads();
  if (q0 + warp * 16 >= L) return;  // all of this warp's rows are padding

  uint32_t qa[D / 16][4];  // A fragments of the warp's 16 query rows, 16 d each
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qa[ks], s_q + (warp * 16 + mr + (mi & 1) * 8) * LD + ks * 16 + (mi >> 1) * 8);
  const int NC = Lp / 16;

  // S of a 16-key chunk in the permuted key order: element e of tile nt holds
  // row grp + 8 (e >> 1), key c16 + 4 tig + 2 nt + (e & 1)
  auto scores = [&](int c16, float (&s)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const int key = c16 + perm_key(mr, mi >> 1);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, s_k + key * LD + ks * 16 + (mi & 1) * 8);
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
  float o[D / 8][4];  // 16 rows x D, f32
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
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
      const uint32_t keep = drop ? keep_bits4(seed, (uint32_t)bh, row, key0, p) : 0xFu;
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
    const int vkey = c * 16 + perm_key(mr, mi & 1);
#pragma unroll
    for (int half = 0; half < D / 16; ++half) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, s_v + vkey * LD + half * 16 + (mi >> 1) * 8);
      mma_bf16(o[2 * half], a, vb[0], vb[1]);
      mma_bf16(o[2 * half + 1], a, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + grp + 8 * rr;
    if (row >= L) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + head_off + (long)row * D + 2 * tig);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) dst[dn * 4] = pack_bf16(o[dn][2 * rr], o[dn][2 * rr + 1]);
  }
}

// A launch of the bf16 route's kernel of NW warps.
template <int D, int NW>
static int launch_tc(const void* q, const void* k, const void* v, const float* bias, void* out,
                     float* lse, int B, int h, int L, float scale_log2, uint32_t seed, float p,
                     float inv, cudaStream_t stream) {
  constexpr int QB = 16 * NW;
  const int Lp = (L + 15) / 16 * 16;
  const size_t smem = dft_smem_bytes<D>(QB, Lp);
  if (smem > DF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dropattn_fwd_tc_kernel<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (L + QB - 1) / QB;
  dropattn_fwd_tc_kernel<D, NW><<<(unsigned)((long)B * h * n_qt), 32 * NW, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
      (__nv_bfloat16*)out, lse, h, L, Lp, n_qt, scale_log2, seed, p, inv);
  return 0;
}

// ---------------------------------------------------------------------------
// Route 2: f32, d in {16, 32, 64}, one online pass on the tensor cores
// (three TF32 products a product), K and V streamed in tiles of 64 keys
// ---------------------------------------------------------------------------

constexpr int DF32_QB = 64;              // query rows per block: 4 warps x 16
constexpr int DF32_THREADS = DF32_QB * 2;
constexpr int DF32_KB = 64;              // keys per tile

// Dynamic shared memory at n_stage (1 or 2) tiles in flight: q, then K, V
// and the bias of each stage (rows padded to D + 4 floats). 88 KB at D = 64
// with two stages (two blocks an SM), 52.5 KB with one (a head of one tile);
// 46.6 and 27.9 KB at D = 32, 26.1 and 15.6 KB at D = 16.
template <int D>
__host__ __device__ constexpr size_t df32_smem_bytes(int n_stage) {
  return ((size_t)(DF32_QB + 2 * n_stage * DF32_KB) * (D + 4) + (size_t)n_stage * DF32_KB) * 4;
}

// A score tile of 8 keys is the C fragment of S for 16 rows: element e holds
// row grp + 8 (e >> 1), column 2 tig + (e & 1); the columns of tiles 2c and
// 2c + 1 are the slots of the tile's 16-key chunk c, so with K and V rows in
// slot order element e of tile nt holds key 16 (nt >> 1) + 4 tig + 2 (nt & 1)
// + (e & 1): each thread's four keys of a chunk are one Philox call's. The
// tile is the A fragment of its 8-deep step of p v with column 2 tig taken as
// k = tig and 2 tig + 1 as k = tig + 4 (a0 = c0, a1 = c2, a2 = c1, a3 = c3),
// so B is V's shared rows nt * 8 + 2 tig and + 1 at d grp, the same slots.
template <int D>
__global__ void __launch_bounds__(DF32_THREADS) dropattn_fwd_tc_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ lse, int h,
    int L, int n_qt, int n_stage, float sm_scale, uint32_t seed, float p, float inv) {
  constexpr int LD = D + 4;         // shared row stride in floats (68 = 4 mod 32 at D = 64)
  constexpr unsigned CH = D / 4;    // 16-byte chunks a row
  constexpr int NT = DF32_KB / 8;   // 8-key tiles a tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + DF32_QB * LD;              // [n_stage][DF32_KB * LD]
  float* s_v = s_k + n_stage * DF32_KB * LD;    // [n_stage][DF32_KB * LD]
  float* s_bias = s_v + n_stage * DF32_KB * LD;  // [n_stage][DF32_KB], by key

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * DF32_QB;
  const long head_off = bh * (long)L * D;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const float* brow = bias + (bh / h) * L;
  const bool drop = p > 0.f;

  for (unsigned i = tid; i < DF32_QB * CH; i += DF32_THREADS) {
    const int r = i / CH, c = (i % CH) * 4, qr = q0 + r;
    cp_async16(s_q + r * LD + c, q + head_off + (long)min(qr, L - 1) * D + c, qr < L ? 16 : 0);
  }
  // the tile of keys k0 .. k0 + 63 into stage `stage`: K and V rows in slot
  // order (keys past L as zero rows), the bias by key (past L: -inf)
  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < DF32_KB * CH * 2; i += DF32_THREADS) {
      const int which = i / (DF32_KB * CH), j = i % (DF32_KB * CH);
      const int r = j / CH, c = (j % CH) * 4, kr = k0 + r;
      const float* src = (which ? vh : kh) + (long)min(kr, L - 1) * D + c;
      float* dst = (which ? s_v : s_k) + (stage * DF32_KB + slot_row(r)) * LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < DF32_KB) {
      const int kr = k0 + tid;
      s_bias[stage * DF32_KB + tid] = kr < L ? brow[kr] : -INFINITY;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  float qa[D / 8][4];  // q's A fragments, 8 d a step, split into hi and lo at each use
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // rows grp and grp + 8: the running max (natural units) and this thread's
  // part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + grp;

  const int n_kt = (L + DF32_KB - 1) / DF32_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * DF32_KB);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed
    __syncthreads();
    if (t == 0) {
      const float* qr = s_q + (warp * 16 + grp) * LD + tig;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        qa[ks][0] = qr[ks * 8];
        qa[ks][1] = qr[8 * LD + ks * 8];
        qa[ks][2] = qr[ks * 8 + 4];
        qa[ks][3] = qr[8 * LD + ks * 8 + 4];
      }
    }
    const float* sk = s_k + (t & 1) * DF32_KB * LD;
    const float* sv = s_v + (t & 1) * DF32_KB * LD;
    const float* sb = s_bias + (t & 1) * DF32_KB;

    // S = q k^T, NT tiles of 8 slots: B fragment b0 = K[slot grp][d tig], b1
    // at d tig + 4 (banks 4 grp + tig: no conflict)
    float s[NT][4], s_lo[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      uint32_t ah[4], al[4];
      split_tf32_a(qa[ks], ah, al);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kr = sk + (nt * 8 + grp) * LD + ks * 8 + tig;
        mma_3xtf32(s[nt], s_lo[nt], ah, al, kr[0], kr[4]);
      }
    }
    // the scores as the plain version forms them, qk * scale + bias
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      fold_lo(s[nt], s_lo[nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + (e & 1);
        const float x = __fadd_rn(__fmul_rn(s[nt][e], sm_scale), sb[key]);
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no -inf - -inf
      alpha[r] = expf(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    // p = exp(s - max) summed as it is, kept ones times 1 / (1 - p) into p v;
    // the tile's small terms fold into o at its end
    float o_lo[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_lo[dn][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      uint32_t keep[2] = {0xFu, 0xFu};  // rows grp, grp + 8: bit j for key 4 tig + j
      if (drop) {
        const int key0 = t * DF32_KB + 16 * c + 4 * tig;
        keep[0] = keep_bits4(seed, (uint32_t)bh, row0, key0, p);
        keep[1] = keep_bits4(seed, (uint32_t)bh, row0 + 8, key0, p);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * c + half;
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = expf(s[nt][e] - base[e >> 1]);
          l[e >> 1] += pv;
          pe[e] = drop ? (((keep[e >> 1] >> (2 * half + (e & 1))) & 1u) ? __fmul_rn(pv, inv)
                                                                      : 0.f)
                       : pv;
        }
        const float a[4] = {pe[0], pe[2], pe[1], pe[3]};
        uint32_t ah[4], al[4];
        split_tf32_a(a, ah, al);
        const float* vr = sv + (nt * 8 + 2 * tig) * LD + grp;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          mma_3xtf32(o[dn], o_lo[dn], ah, al, vr[dn * 8], vr[LD + dn * 8]);
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) fold_lo(o[dn], o_lo[dn]);
    __syncthreads();  // the tile's buffers are free for tile t + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + head_off + (long)row * D + 2 * tig;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
    if (tig == 0) lse[bh * L + row] = m[r] + logf(l[r]);
  }
}

// A launch of dropattn_fwd_tc_tf32_kernel<D>: one block of 4 warps per
// (b*h, 64-query tile). At d = 64 its shared memory passes 48 KB: the
// attribute is set once, on the first launch.
template <int D>
static int launch_tf32(const float* q, const float* k, const float* v, const float* bias,
                       float* out, float* lse, int B, int h, int L, float sm_scale, uint32_t seed,
                       float p, float inv, cudaStream_t s) {
  static const int attr = (int)cudaFuncSetAttribute(
      dropattn_fwd_tc_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)df32_smem_bytes<D>(2));
  if (attr != 0) return attr;
  const int n_stage = L > DF32_KB ? 2 : 1;
  const int n_qt = (L + DF32_QB - 1) / DF32_QB;
  dropattn_fwd_tc_tf32_kernel<D><<<(unsigned)((long)B * h * n_qt), DF32_THREADS,
                                   df32_smem_bytes<D>(n_stage), s>>>(
      q, k, v, bias, out, lse, h, L, n_qt, n_stage, sm_scale, seed, p, inv);
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
  const uint32_t keep = keep_bits4(seed, (uint32_t)bh, row, c4 * 4, p);
  for (int jj = 0; jj < 4; ++jj) {
    const int col = c4 * 4 + jj;
    if (col < L) out[(bh * L + row) * L + col] = (keep >> jj) & 1u;
  }
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype: 0 f32, 1 bf16. q, k, v, out: [B, h, L, d] contiguous; bias: [B, L]
//   f32; lse: [B, h, L] f32 (written). 0 <= p < 1 and inv = 1 / (1 - p),
//   rounded to f32 by the caller as the plain version rounds it.
// The CUDA-core route: bf16 at d = 16, 32 or 64 (the head dims of the
// models the port trains: e5-small-v2's, bge-reranker-large's and
// BertConfig.tiny's), any L; the wrapper sends it only the heads past the
// bf16 tensor-core route's lengths. f32 and other head dims are refused
// (f32 takes the tensor cores at every L).
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_dropattn_fwd(int dtype, const void* q, const void* k, const void* v,
                                 const float* bias, void* out, float* lse, int B, int h, int L,
                                 int d, float sm_scale, uint32_t seed, float p, float inv,
                                 void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || !(p >= 0.f && p < 1.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 1 && d == 16)
    rc = launch<__nv_bfloat16, 16>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else if (dtype == 1 && d == 32)
    rc = launch<__nv_bfloat16, 32>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else if (dtype == 1 && d == 64)
    rc = launch<__nv_bfloat16, 64>(q, k, v, bias, out, lse, B, h, L, sm_scale, seed, p, inv, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

//   The tensor-core routes: dtype 1 (bf16) at d = 16, 32 or 64 while
//   dft_smem_bytes fits a block (L <= 2256 at d = 16, 1344 at d = 32, 656 at
//   d = 64; a block
//   per (b*h, 16 dft_warps query rows)), dtype 0 (f32) at d = 16, 32 or 64 at
//   any L (a block of 4 warps per (b*h, 64-query tile)); others are refused.
//   The arguments as above; scale_log2 = log2(e) / sqrt(d) in f32 (the bf16
//   route's exponent), sm_scale = 1 / sqrt(d) (the f32 route's).
extern "C" int sskd_dropattn_fwd_tc(int dtype, const void* q, const void* k, const void* v,
                                    const float* bias, void* out, float* lse, int B, int h,
                                    int L, int d, float sm_scale, float scale_log2,
                                    uint32_t seed, float p, float inv, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || !(p >= 0.f && p < 1.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 1 && d == 16) {
    rc = dft_warps<16>(L) == 4
             ? launch_tc<16, 4>(q, k, v, bias, out, lse, B, h, L, scale_log2, seed, p, inv, s)
             : launch_tc<16, 8>(q, k, v, bias, out, lse, B, h, L, scale_log2, seed, p, inv, s);
  } else if (dtype == 1 && d == 32) {
    rc = launch_tc<32, 8>(q, k, v, bias, out, lse, B, h, L, scale_log2, seed, p, inv, s);
  } else if (dtype == 1 && d == 64) {
    rc = dft_warps<64>(L) == 4
             ? launch_tc<64, 4>(q, k, v, bias, out, lse, B, h, L, scale_log2, seed, p, inv, s)
             : launch_tc<64, 16>(q, k, v, bias, out, lse, B, h, L, scale_log2, seed, p, inv, s);
  } else if (dtype == 0 && (d == 16 || d == 32 || d == 64)) {
    const float* fq = (const float*)q;
    const float* fk = (const float*)k;
    const float* fv = (const float*)v;
    float* fo = (float*)out;
    rc = d == 64   ? launch_tf32<64>(fq, fk, fv, bias, fo, lse, B, h, L, sm_scale, seed, p, inv, s)
         : d == 32 ? launch_tf32<32>(fq, fk, fv, bias, fo, lse, B, h, L, sm_scale, seed, p, inv, s)
                   : launch_tf32<16>(fq, fk, fv, bias, fo, lse, B, h, L, sm_scale, seed, p, inv, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
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
