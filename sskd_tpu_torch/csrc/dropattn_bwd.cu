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
// tensor-core peak): the bytes bound it. A floor above both is the mask:
// one regeneration of the 113 M-element keep-mask (B*h*L^2) is 28.3 M
// Philox4x32-10 calls of ~100 integer instructions, ~0.18 ms at ~64 integer
// operations per clock per SM (132 SMs, ~1.9 GHz); the two exps per score
// (one per pass below) add ~0.06 ms on the special-function unit.
//
// At the teacher's train shape [32, 16, 64, 64] in f32 the bytes are 7 x
// 8.39 MB plus the bias (0.0175 ms) and the products 10 * B*h*L^2*d = 1.34
// GFLOP: 0.0027 ms at TF32's 495 TFLOP/s, 0.0081 as three TF32 passes, 0.020
// on the CUDA cores' FMA; the mask is B*h*L^2 / 4 = 524 K Philox calls. The
// bytes bound it.
//
// Two routes, chosen by the wrapper (ops/attention.py dropattn_bwd_route)
// from (dtype, d, L):
//
// 1. bf16 at d in {32, 64}, f32 at d = 64, while a whole head fits a
//    block's shared memory (L <= 256 in bf16 at d = 32, 208 at d = 64, 128
//    in f32; the student trains at 64 and 192, the teacher at 64):
//    dropattn_bwd_tc_kernel<D> (bf16, mma.sync m16n8k16) and
//    dropattn_bwd_tc_tf32_kernel<D> (f32, each product three TF32 products
//    on m16n8k8 with their small terms in an accumulator of their own:
//    mma_common.cuh), a block holding one whole head at a time in shared
//    memory, as the TPU kernel holds it in VMEM. cp.async brings q, k, v, g
//    (bf16 rows padded to D + 8; f32 rows to D + 8 for q and g, D + 4 for k
//    and v, the strides at which the fragment reads hit distinct banks),
//    the bias row and the lse. Warp w owns query rows 16w..16w+15; sums are
//    f32.
//    - Pass 1, per chunk of 16 keys: S = q k^T and dP = g v^T, probs (bf16:
//      2^(s * scale * log2(e) + (bias - lse) * log2(e)), one exp; f32: the
//      CUDA-core kernels' expf(s * scale + bias - lse)), the keep bits, the
//      row's D = sum(dprobs * probs) with no cross-warp reduction, pd into
//      an [L, L] shared buffer (bf16, or f32 on the f32 route).
//    - dv = pd^T g: warps split over key rows.
//    - Pass 2: S and dP again (cheap on the tensor cores), the keep bits
//      again, ds = probs (dprobs - D) scale into the same buffer; dq = ds k
//      with ds fed from registers.
//    - dk = ds^T q, as dv.
//    The keep bits (L^2 / 8 bytes) are drawn once per element, in pass 1,
//    one Philox call per four neighbouring key columns of one row: each
//    thread's score fragment holds exactly those four, since the keys of a
//    16-key chunk enter the mma in the order 0 1 4 5 8 9 12 13 | 2 3 6 7 ...
//    (ldmatrix takes any row order, so on the bf16 route K and V rows follow
//    it for free; the f32 route stores them in that order, key_slot).
//    At d = 32 they take 12,300 of a head's 42,000 cycles (clock64 stamps
//    on the card), as long as the rest of pass 1: the integer work is the
//    floor above (drawing the next head's bits inside this head's two
//    passes, beside their tensor-core and exp work, gained only 3 %, so the
//    bits stay in pass 1). The blocks are persistent (as many as fit, each
//    walking heads i, i + grid, ...), so the next head's q, k, v, g can
//    arrive by cp.async into a second buffer while this head computes
//    (launch_tc). Every input is read once, no atomics: two launches give
//    the same bits. Shared memory at L = 192 in bf16 at d = 32: 208,896
//    bytes (one block of 12 warps per SM).
// 2. f32 at d = 32, and past the limits above: the first kernel pair on
//    CUDA cores, at d = 32 and 64. The dq kernel (a thread per query row, K
//    and V of the head in shared memory) sums D in one pass and round(ds) k
//    in a second and writes D out; the dk/dv kernel (a thread per key row,
//    Q and G in shared memory) walks the queries once, drawing the mask one
//    element at a time. When a head's rows do not fit a block's 227 KB
//    (2 L d sizeof(T) + 4 or 8 L bytes: at d = 64 in f32 above L = 450 or
//    447) each kernel streams them through shared memory in chunks of 128
//    rows, in the same order, so the sums and the mask are unchanged and any
//    L is taken. The f32 instantiation rounds nothing, which keeps the f32
//    check of the train phase to summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <algorithm>

#include "attn_common.cuh"
#include "mma_common.cuh"
#include "philox.cuh"

namespace sskd {

constexpr int DB_TB = 64;  // rows per block == threads per block
constexpr size_t DB_SMEM_MAX = 227 * 1024;  // shared memory a block may hold
constexpr int DB_KC = 128;  // rows a chunk when the head does not fit DB_SMEM_MAX

// Rows (keys for the dq kernel, queries for the dk/dv kernel) a block holds
// in shared memory at once: all L when they fit DB_SMEM_MAX, else DB_KC (a
// multiple of 4, so each chunk of keys starts a Philox group). A row takes
// two rows of T and `extra` floats.
template <typename T, int D>
static int db_chunk_rows(int L, int extra) {
  const size_t per_row = 2 * (size_t)D * sizeof(T) + extra * sizeof(float);
  return (size_t)L * per_row <= DB_SMEM_MAX ? L : DB_KC;
}

template <typename T, int D>
__global__ void __launch_bounds__(DB_TB) dropattn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ dsum, T* __restrict__ dq, int h, int L, int n_t, int kc, float sm_scale,
    uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + (size_t)kc * D;
  float* s_bias = reinterpret_cast<float*>(s_v + (size_t)kc * D);

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_t;
  const int qi = (blockIdx.x % n_t) * DB_TB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;
  const bool live = qi < L;  // rows past L take part in the barriers only
  const bool resident = kc >= L;  // the whole head in one chunk, staged once

  // keys j0 .. j0 + n - 1: their k and v rows and bias
  auto stage = [&](int j0) {
    const int n = min(kc, L - j0);
    __syncthreads();
    copy_rows<T, D>(s_k, k + head_off + (long)j0 * D, n, tid, DB_TB);
    copy_rows<T, D>(s_v, v + head_off + (long)j0 * D, n, tid, DB_TB);
    for (int j = tid; j < n; j += DB_TB) s_bias[j] = bias[b * L + j0 + j];
    __syncthreads();
    return n;
  };

  float qr[D], gr[D];
  float lse_i = 0.f;
  if (live) {
    load_row<T, D>(qr, q + head_off + (long)qi * D);
    load_row<T, D>(gr, g + head_off + (long)qi * D);
    lse_i = lse[bh * L + qi];
  }

  // pass 1: D = <dprobs, probs>
  float dsum_i = 0.f;
  for (int j0 = 0; j0 < L; j0 += kc) {
    const int n = stage(j0);
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
        const float prob = expf(s - lse_i);
        float dprobs = dot_row<T, D>(gr, s_v + (long)j * D);
        if (p > 0.f) dprobs = philox_uniform(r.w[jj]) >= p ? dprobs * inv : 0.f;
        dsum_i = fmaf(dprobs, prob, dsum_i);
      }
    }
  }

  // pass 2: dq = round(ds) k
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < L; j0 += kc) {
    const int n = resident ? L : stage(j0);
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
        const float prob = expf(s - lse_i);
        float dprobs = dot_row<T, D>(gr, s_v + (long)j * D);
        if (p > 0.f) dprobs = philox_uniform(r.w[jj]) >= p ? dprobs * inv : 0.f;
        const float ds = prob * (dprobs - dsum_i) * sm_scale;
        axpy_row<T, D>(acc, round_as(ds, (const T*)nullptr), s_k + (long)j * D);
      }
    }
  }
  if (!live) return;
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
    int n_t, int qc, float sm_scale, uint32_t seed, float p, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_g = s_q + (size_t)qc * D;
  float* s_lse = reinterpret_cast<float*>(s_g + (size_t)qc * D);
  float* s_dsum = s_lse + qc;

  const int tid = threadIdx.x;
  const long bh = blockIdx.x / n_t;
  const int kj = (blockIdx.x % n_t) * DB_TB + tid;
  const long b = bh / h;
  const long head_off = bh * (long)L * D;
  const bool live = kj < L;  // rows past L take part in the barriers only

  float kr[D], vr[D], acc_k[D], acc_v[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    acc_k[c] = 0.f;
    acc_v[c] = 0.f;
  }
  float bias_j = 0.f;
  if (live) {
    load_row<T, D>(kr, k + head_off + (long)kj * D);
    load_row<T, D>(vr, v + head_off + (long)kj * D);
    bias_j = bias[b * L + kj];
  }
  const bool drop = p > 0.f;
  // the queries in chunks of qc: their q and g rows, lse and D
  for (int i0 = 0; i0 < L; i0 += qc) {
    const int n = min(qc, L - i0);
    __syncthreads();
    copy_rows<T, D>(s_q, q + head_off + (long)i0 * D, n, tid, DB_TB);
    copy_rows<T, D>(s_g, g + head_off + (long)i0 * D, n, tid, DB_TB);
    for (int i = tid; i < n; i += DB_TB) {
      s_lse[i] = lse[bh * L + i0 + i];
      s_dsum[i] = dsum[bh * L + i0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const T* q_i = s_q + (long)i * D;
      const T* g_i = s_g + (long)i * D;
      const float s = dot_row<T, D>(kr, q_i) * sm_scale + bias_j;
      const float prob = expf(s - s_lse[i]);
      const bool keep = !drop || dropout_keep(seed, (uint32_t)bh, i0 + i, kj, p);
      const float pd = drop ? (keep ? prob * inv : 0.f) : prob;
      axpy_row<T, D>(acc_v, round_as(pd, (const T*)nullptr), g_i);
      float dprobs = dot_row<T, D>(vr, g_i);
      if (drop) dprobs = keep ? dprobs * inv : 0.f;
      const float ds = prob * (dprobs - s_dsum[i]) * sm_scale;
      axpy_row<T, D>(acc_k, round_as(ds, (const T*)nullptr), q_i);
    }
  }
  if (!live) return;
  T* ok = dk + head_off + (long)kj * D;
  T* ov = dv + head_off + (long)kj * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    store_as(ok + c, acc_k[c]);
    store_as(ov + c, acc_v[c]);
  }
}


// ---------------------------------------------------------------------------
// Route 1: tensor cores, a whole head per block: bf16 at d in {32, 64}, f32
// (three TF32 products) at d = 64
// ---------------------------------------------------------------------------

constexpr size_t DT_SMEM_MAX = 227 * 1024;  // shared memory a block may hold

// Shared memory of the bf16 route's q, k, v, g tiles (rows padded to D + 8
// bf16: 80 or 144 bytes), the bias and the lse of one head at padded length
// Lp (a multiple of 16): the part that is double-buffered.
template <int D>
__host__ __device__ constexpr size_t dt_head_bytes(int Lp) {
  return 4 * (size_t)Lp * (D + 8) * 2 + 2 * (size_t)Lp * 4;
}
// The f32 route's: q and g rows padded to D + 8 floats (k = query reads of B
// fragments, banks 8 tig + grp), k and v rows to D + 4 (k = d reads, banks
// 4 grp + tig).
template <int D>
__host__ __device__ constexpr size_t df_head_bytes(int Lp) {
  return (size_t)Lp * (2 * (D + 8) + 2 * (D + 4)) * 4 + 2 * (size_t)Lp * 4;
}
// All of it, with n_buf (1 or 2) copies of the head: the [Lp, Lp] buffer of
// pd, then ds (rows padded by 8 elements), the keep bits (16 keys a word),
// the bias and the lse as the kernel uses them.
template <typename T, int D>
__host__ __device__ constexpr size_t dt_smem_bytes(int Lp, int n_buf) {
  return n_buf * (sizeof(T) == 2 ? dt_head_bytes<D>(Lp) : df_head_bytes<D>(Lp))
         + (size_t)Lp * (Lp + 8) * sizeof(T) + (size_t)Lp * (Lp / 16) * 2 + 2 * (size_t)Lp * 4;
}

// The keep bits of one row's four keys key0..key0+3 (one Philox call:
// keep_bits4, in the key order of attn_common.cuh perm_key / key_slot), and
// the row's 16-bit word of chunk c gathered from the four threads tig of a
// row into s_bits by tig 0.
__device__ __forceinline__ uint32_t draw_keep4(uint32_t seed, uint32_t bh, int row, int key0,
                                               float p, int tig, uint16_t* word_dst) {
  const uint32_t keep = keep_bits4(seed, bh, row, key0, p);
  uint32_t word = keep << (4 * tig);
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  if (tig == 0) *word_dst = (uint16_t)word;
  return keep;
}

// Persistent: block i takes heads i, i + gridDim.x, ...; with n_buf = 2 the
// copy of the next head's inputs overlaps the current head's work.
template <int D>
__global__ void __launch_bounds__(512) dropattn_bwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int h, int L, float sm_scale, float scale_log2,
    uint32_t seed, float p, float inv, int BH, int Lp, int n_buf) {
  constexpr int LD = D + 8;       // row stride in bf16
  constexpr unsigned CH = D / 8;  // 16-byte chunks a row (unsigned: divisions are shifts)
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDP = Lp + 8, NC = Lp / 16;
  __nv_bfloat16* s_p = reinterpret_cast<__nv_bfloat16*>(smem + n_buf * dt_head_bytes<D>(Lp));
  uint16_t* s_bits = reinterpret_cast<uint16_t*>(s_p + (size_t)Lp * LDP);
  float* s_bias2 = reinterpret_cast<float*>(s_bits + Lp * NC);
  float* s_lse2 = s_bias2 + Lp;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const bool drop = p > 0.f;

  // the inputs of head bh into buffer buf: q, k, v, g rows (rows past L as
  // zeros), then the bias row and the lse as they are
  auto load_head = [&](long bh, int buf) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + buf * dt_head_bytes<D>(Lp));
    const long head_off = bh * (long)L * D;
    for (unsigned i = tid; i < 4 * Lp * CH; i += nthreads) {
      const int t = i / (Lp * CH), j = i % (Lp * CH), r = j / CH, c = (j % CH) * 8;
      const __nv_bfloat16* src = (t == 0 ? q : t == 1 ? k : t == 2 ? v : g) + head_off;
      cp_async16(dst + t * Lp * LD + r * LD + c, src + (long)min(r, L - 1) * D + c,
                 r < L ? 16 : 0);
    }
    float* raw = reinterpret_cast<float*>(dst + 4 * Lp * LD);
    for (int i = tid; i < L; i += nthreads) {
      cp_async4(raw + i, bias + (bh / h) * L + i);
      cp_async4(raw + Lp + i, lse + bh * L + i);
    }
  };

  int buf = 0;
  long bh = blockIdx.x;
  if (n_buf == 2) load_head(bh, 0);
  cp_async_commit();
  for (; bh < BH; bh += gridDim.x, buf ^= n_buf - 1) {
    const long next = bh + gridDim.x;
    if (n_buf == 1) load_head(bh, 0);
    else if (next < BH) load_head(next, buf ^ 1);
    cp_async_commit();
    if (n_buf == 1) cp_async_wait<0>();
    else cp_async_wait<1>();  // this head's group has landed; the next may be in flight
    __syncthreads();
    const __nv_bfloat16* s_q =
        reinterpret_cast<const __nv_bfloat16*>(smem + buf * dt_head_bytes<D>(Lp));
    const __nv_bfloat16* s_k = s_q + Lp * LD;
    const __nv_bfloat16* s_v = s_k + Lp * LD;
    const __nv_bfloat16* s_g = s_v + Lp * LD;
    const float* raw = reinterpret_cast<const float*>(s_g + Lp * LD);
    // padded rows and keys: probabilities 0 (lse +inf, bias -inf), so every
    // product over them adds exact zeros
    for (int i = tid; i < Lp; i += nthreads) {
      s_bias2[i] = i < L ? raw[i] * LOG2E : -INFINITY;
      s_lse2[i] = i < L ? raw[Lp + i] * LOG2E : INFINITY;
    }
    __syncthreads();
    const long head_off = bh * (long)L * D;

    const int row0 = warp * 16 + grp;  // this thread's rows: row0 and row0 + 8
    uint32_t qa[D / 16][4], ga[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (warp * 16 + mr + (mi & 1) * 8) * LD + ks * 16 + (mi >> 1) * 8;
      ldmatrix_x4(qa[ks], s_q + off);
      ldmatrix_x4(ga[ks], s_g + off);
    }
    const float lse2[2] = {s_lse2[row0], s_lse2[row0 + 8]};

    // S and dP of a 16-key chunk in the permuted key order: element e of
    // tile nt holds row row0 + 8 (e >> 1), key c16 + 4 tig + 2 nt + (e & 1)
    auto scores = [&](int c16, float (&s)[2][4], float (&dp)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      const int key = c16 + perm_key(mr, mi >> 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, s_k + key * LD + ks * 16 + (mi & 1) * 8);
        ldmatrix_x4(vb, s_v + key * LD + ks * 16 + (mi & 1) * 8);
        mma_bf16(s[0], qa[ks], kb[0], kb[1]);
        mma_bf16(s[1], qa[ks], kb[2], kb[3]);
        mma_bf16(dp[0], ga[ks], vb[0], vb[1]);
        mma_bf16(dp[1], ga[ks], vb[2], vb[3]);
      }
    };
    // probs of the thread's four keys key0..key0+3 in row row0 + 8 rr
    auto probs4 = [&](const float (&s)[2][4], int rr, int key0, float (&prob)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float acc = s[j >> 1][2 * rr + (j & 1)];
        prob[j] = exp2_approx(fmaf(acc, scale_log2, s_bias2[key0 + j] - lse2[rr]));
      }
    };

    // ---- pass 1: D, pd and the keep bits ----------------------------------
    float dsum[2] = {0.f, 0.f};
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];
      scores(c * 16, s, dp);
      const int key0 = c * 16 + 4 * tig;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        const uint32_t keep =
            drop ? draw_keep4(seed, (uint32_t)bh, row, key0, p, tig, s_bits + row * NC + c)
                 : 0xFu;
        float prob[4], pd[4];
        probs4(s, rr, key0, prob);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dpv = dp[j >> 1][2 * rr + (j & 1)];
          const bool kj = (keep >> j) & 1u;
          const float dprobs = drop ? (kj ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          dsum[rr] = fmaf(dprobs, prob[j], dsum[rr]);
          pd[j] = drop ? (kj ? __fmul_rn(prob[j], inv) : 0.f) : prob[j];
        }
        *reinterpret_cast<uint2*>(s_p + row * LDP + key0) =
            make_uint2(pack_bf16(pd[0], pd[1]), pack_bf16(pd[2], pd[3]));
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 1);
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 2);
    }
    __syncthreads();

    // ---- x^T y for the warp's 16 keys: x the [Lp, Lp] buffer, y q or g ----
    auto column_product = [&](const __nv_bfloat16* y, __nv_bfloat16* out) {
      float acc[D / 8][4];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      const int kw = warp * 16;
      for (int c = 0; c < NC; ++c) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, s_p + (c * 16 + (mi >> 1) * 8 + mr) * LDP + kw + (mi & 1) * 8);
#pragma unroll
        for (int half = 0; half < D / 16; ++half) {
          uint32_t yb[4];
          ldmatrix_x4_trans(yb, y + (c * 16 + (mi & 1) * 8 + mr) * LD + half * 16 + (mi >> 1) * 8);
          mma_bf16(acc[2 * half], a, yb[0], yb[1]);
          mma_bf16(acc[2 * half + 1], a, yb[2], yb[3]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = kw + grp + 8 * rr;
        if (key >= L) continue;
        uint32_t* dst = reinterpret_cast<uint32_t*>(out + head_off + (long)key * D + 2 * tig);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          dst[dn * 4] = pack_bf16(acc[dn][2 * rr], acc[dn][2 * rr + 1]);
      }
    };
    column_product(s_g, dv);
    __syncthreads();  // pd is consumed: the buffer takes ds

    // ---- pass 2: ds, and dq = ds k from registers -------------------------
    float dqa[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];
      scores(c * 16, s, dp);
      const int key0 = c * 16 + 4 * tig;
      uint32_t a[4];  // ds as the A fragment of a 16-deep product over the permuted keys
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        const uint32_t keep =
            drop ? (uint32_t)(s_bits[row * NC + c] >> (4 * tig)) & 0xFu : 0xFu;
        float prob[4], ds[4];
        probs4(s, rr, key0, prob);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dpv = dp[j >> 1][2 * rr + (j & 1)];
          const float dprobs = drop ? (((keep >> j) & 1u) ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          ds[j] = __fmul_rn(__fmul_rn(prob[j], __fsub_rn(dprobs, dsum[rr])), sm_scale);
        }
        a[rr] = pack_bf16(ds[0], ds[1]);
        a[2 + rr] = pack_bf16(ds[2], ds[3]);
        *reinterpret_cast<uint2*>(s_p + row * LDP + key0) = make_uint2(a[rr], a[2 + rr]);
      }
      const int key = c * 16 + perm_key(mr, mi & 1);
#pragma unroll
      for (int half = 0; half < D / 16; ++half) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, s_k + key * LD + half * 16 + (mi >> 1) * 8);
        mma_bf16(dqa[2 * half], a, kb[0], kb[1]);
        mma_bf16(dqa[2 * half + 1], a, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      if (row >= L) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(dq + head_off + (long)row * D + 2 * tig);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        dst[dn * 4] = pack_bf16(dqa[dn][2 * rr], dqa[dn][2 * rr + 1]);
    }
    __syncthreads();
    column_product(s_q, dk);
    __syncthreads();  // this head's buffers are free for the head after next
  }
}

// The f32 route: the same blocks, passes and keep bits, each product on
// mma.sync m16n8k8 as three TF32 products, each probability the CUDA-core
// kernels' expf(s * scale + bias - lse) in natural units. Fragments are
// 32-bit shared-memory reads: q's and g's once a pass into registers, and
// k's, v's and the [Lp, Lp] buffer's at each use, each split into hi and lo
// where it is used; every product keeps its small terms in an accumulator of
// their own (mma_3xtf32).
// A 16-key chunk's scores are two 8-key tiles whose columns hold slots
// 0..7 and 8..15 of the chunk; k and v rows are stored in slot order
// (key_slot), so element e of tile nt is key c16 + 4 tig + 2 nt + (e & 1), as
// on the bf16 route, and each thread again holds the four neighbours of one
// Philox call. dq = ds k takes ds from registers: its step s (0, 1) takes
// keys 4 tig + 2 s as k = tig and 4 tig + 2 s + 1 as k = tig + 4, which are
// slots 8 s + 2 tig and 8 s + 2 tig + 1.
template <int D>
__global__ void __launch_bounds__(256) dropattn_bwd_tc_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int h, int L,
    float sm_scale, uint32_t seed, float p, float inv, int BH, int Lp, int n_buf) {
  constexpr int LDQ = D + 8, LDK = D + 4;  // row strides in floats
  constexpr unsigned CH = D / 4;           // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDP = Lp + 8, NC = Lp / 16;
  float* s_p = reinterpret_cast<float*>(smem + n_buf * df_head_bytes<D>(Lp));
  uint16_t* s_bits = reinterpret_cast<uint16_t*>(s_p + (size_t)Lp * LDP);
  float* s_bias = reinterpret_cast<float*>(s_bits + Lp * NC);
  float* s_lse = s_bias + Lp;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const bool drop = p > 0.f;

  // head buffer layout: q [Lp][LDQ], k [Lp][LDK], v [Lp][LDK], g [Lp][LDQ],
  // then the raw bias and lse [Lp] each
  auto load_head = [&](long bh, int buf) {
    float* base = reinterpret_cast<float*>(smem + buf * df_head_bytes<D>(Lp));
    const long head_off = bh * (long)L * D;
    for (unsigned i = tid; i < 4 * Lp * CH; i += nthreads) {
      const int t = i / (Lp * CH), j = i % (Lp * CH), r = j / CH, c = (j % CH) * 4;
      const float* src = (t == 0 ? q : t == 1 ? k : t == 2 ? v : g) + head_off;
      float* dst = t == 0   ? base + r * LDQ
                   : t == 3 ? base + Lp * (LDQ + 2 * LDK) + r * LDQ
                            : base + Lp * (LDQ + (t - 1) * LDK) + slot_row(r) * LDK;
      cp_async16(dst + c, src + (long)min(r, L - 1) * D + c, r < L ? 16 : 0);
    }
    float* raw = base + Lp * (2 * LDQ + 2 * LDK);
    for (int i = tid; i < L; i += nthreads) {
      cp_async4(raw + i, bias + (bh / h) * L + i);
      cp_async4(raw + Lp + i, lse + bh * L + i);
    }
  };

  int buf = 0;
  long bh = blockIdx.x;
  if (n_buf == 2) load_head(bh, 0);
  cp_async_commit();
  for (; bh < BH; bh += gridDim.x, buf ^= n_buf - 1) {
    const long next = bh + gridDim.x;
    if (n_buf == 1) load_head(bh, 0);
    else if (next < BH) load_head(next, buf ^ 1);
    cp_async_commit();
    if (n_buf == 1) cp_async_wait<0>();
    else cp_async_wait<1>();
    __syncthreads();
    const float* s_q = reinterpret_cast<const float*>(smem + buf * df_head_bytes<D>(Lp));
    const float* s_k = s_q + Lp * LDQ;
    const float* s_v = s_k + Lp * LDK;
    const float* s_g = s_v + Lp * LDK;
    const float* raw = s_g + Lp * LDQ;
    // padded rows and keys: probabilities 0 (lse +inf, bias -inf)
    for (int i = tid; i < Lp; i += nthreads) {
      s_bias[i] = i < L ? raw[i] : -INFINITY;
      s_lse[i] = i < L ? raw[Lp + i] : INFINITY;
    }
    __syncthreads();
    const long head_off = bh * (long)L * D;

    const int row0 = warp * 16 + grp;  // this thread's rows: row0 and row0 + 8
    const float lse_r[2] = {s_lse[row0], s_lse[row0 + 8]};
    float qa[D / 8][4], ga[D / 8][4];  // A fragments, split into hi and lo at each use
    auto load_qg = [&]() {
      const float* qr = s_q + row0 * LDQ + tig;
      const float* gr = s_g + row0 * LDQ + tig;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const int o = ks * 8;
        qa[ks][0] = qr[o], qa[ks][1] = qr[8 * LDQ + o], qa[ks][2] = qr[o + 4];
        qa[ks][3] = qr[8 * LDQ + o + 4];
        ga[ks][0] = gr[o], ga[ks][1] = gr[8 * LDQ + o], ga[ks][2] = gr[o + 4];
        ga[ks][3] = gr[8 * LDQ + o + 4];
      }
    };
    // S and dP of the 16-key chunk at c16: tile nt's column grp is slot
    // 8 nt + grp (banks 4 grp + tig: no conflict)
    auto scores = [&](int c16, float (&s)[2][4], float (&dp)[2][4]) {
      float s_lo[2][4], dp_lo[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = s_lo[nt][e] = dp_lo[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        split_tf32_a(qa[ks], qh, ql);
        split_tf32_a(ga[ks], gh, gl);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* kr = s_k + (c16 + 8 * nt + grp) * LDK + ks * 8 + tig;
          const float* vr = s_v + (c16 + 8 * nt + grp) * LDK + ks * 8 + tig;
          mma_3xtf32(s[nt], s_lo[nt], qh, ql, kr[0], kr[4]);
          mma_3xtf32(dp[nt], dp_lo[nt], gh, gl, vr[0], vr[4]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        fold_lo(s[nt], s_lo[nt]);
        fold_lo(dp[nt], dp_lo[nt]);
      }
    };
    // probs of the thread's four keys key0..key0+3 in row row0 + 8 rr, as the
    // CUDA-core kernels take them
    auto probs4 = [&](const float (&s)[2][4], int rr, int key0, float (&prob)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = __fadd_rn(__fmul_rn(s[j >> 1][2 * rr + (j & 1)], sm_scale),
                                  s_bias[key0 + j]);
        prob[j] = expf(__fsub_rn(x, lse_r[rr]));
      }
    };

    // ---- pass 1: D, pd and the keep bits ----------------------------------
    load_qg();
    float dsum[2] = {0.f, 0.f};
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];
      scores(c * 16, s, dp);
      const int key0 = c * 16 + 4 * tig;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        const uint32_t keep =
            drop ? draw_keep4(seed, (uint32_t)bh, row, key0, p, tig, s_bits + row * NC + c)
                 : 0xFu;
        float prob[4], pd[4];
        probs4(s, rr, key0, prob);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dpv = dp[j >> 1][2 * rr + (j & 1)];
          const bool kj = (keep >> j) & 1u;
          const float dprobs = drop ? (kj ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          dsum[rr] = fmaf(dprobs, prob[j], dsum[rr]);
          pd[j] = drop ? (kj ? __fmul_rn(prob[j], inv) : 0.f) : prob[j];
        }
        *reinterpret_cast<float4*>(s_p + row * LDP + key0) = make_float4(pd[0], pd[1], pd[2], pd[3]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 1);
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 2);
    }
    __syncthreads();

    // ---- x^T y for the warp's 16 keys: x the [Lp, Lp] buffer, y q or g ----
    // step c8 takes queries c8..c8+7: A from x[query][key] (banks 8 tig +
    // grp with Lp + 8 = 8 mod 16), B from y[query][d] (the same at D + 8)
    auto column_product = [&](const float* y, float* out) {
      float acc[D / 8][4], acc_lo[D / 8][4];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = acc_lo[i][e] = 0.f;
      const int kw = warp * 16;
      for (int c8 = 0; c8 < Lp; c8 += 8) {
        const float* xr = s_p + (c8 + tig) * LDP + kw + grp;
        const float a[4] = {xr[0], xr[8], xr[4 * LDP], xr[4 * LDP + 8]};
        uint32_t ah[4], al[4];
        split_tf32_a(a, ah, al);
        const float* yr = y + (c8 + tig) * LDQ + grp;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          mma_3xtf32(acc[dn], acc_lo[dn], ah, al, yr[dn * 8], yr[4 * LDQ + dn * 8]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) fold_lo(acc[dn], acc_lo[dn]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = kw + grp + 8 * rr;
        if (key >= L) continue;
        float* dst = out + head_off + (long)key * D + 2 * tig;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          *reinterpret_cast<float2*>(dst + dn * 8) = make_float2(acc[dn][2 * rr], acc[dn][2 * rr + 1]);
      }
    };
    column_product(s_g, dv);
    __syncthreads();  // pd is consumed: the buffer takes ds

    // ---- pass 2: ds, and dq = ds k from registers -------------------------
    load_qg();
    float dqa[D / 8][4], dqa_lo[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[i][e] = dqa_lo[i][e] = 0.f;
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];
      scores(c * 16, s, dp);
      const int key0 = c * 16 + 4 * tig;
      float ds[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        const uint32_t keep =
            drop ? (uint32_t)(s_bits[row * NC + c] >> (4 * tig)) & 0xFu : 0xFu;
        float prob[4];
        probs4(s, rr, key0, prob);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dpv = dp[j >> 1][2 * rr + (j & 1)];
          const float dprobs = drop ? (((keep >> j) & 1u) ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          ds[rr][j] = __fmul_rn(__fmul_rn(prob[j], __fsub_rn(dprobs, dsum[rr])), sm_scale);
        }
        *reinterpret_cast<float4*>(s_p + row * LDP + key0) =
            make_float4(ds[rr][0], ds[rr][1], ds[rr][2], ds[rr][3]);
      }
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const float a[4] = {ds[0][2 * st], ds[1][2 * st], ds[0][2 * st + 1], ds[1][2 * st + 1]};
        uint32_t ah[4], al[4];
        split_tf32_a(a, ah, al);
        const float* kr = s_k + (c * 16 + 8 * st + 2 * tig) * LDK + grp;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          mma_3xtf32(dqa[dn], dqa_lo[dn], ah, al, kr[dn * 8], kr[LDK + dn * 8]);
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) fold_lo(dqa[dn], dqa_lo[dn]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      if (row >= L) continue;
      float* dst = dq + head_off + (long)row * D + 2 * tig;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8) = make_float2(dqa[dn][2 * rr], dqa[dn][2 * rr + 1]);
    }
    __syncthreads();
    column_product(s_q, dk);
    __syncthreads();  // this head's buffers are free for the head after next
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
  const int kc = db_chunk_rows<T, D>(L, 1), qc = db_chunk_rows<T, D>(L, 2);
  const size_t smem_dq = 2 * (size_t)kc * D * sizeof(T) + (size_t)kc * sizeof(float);
  const size_t smem_dkv = 2 * (size_t)qc * D * sizeof(T) + 2 * (size_t)qc * sizeof(float);
  int rc = allow_smem(dropattn_bwd_dq_kernel<T, D>, smem_dq);
  if (rc == 0) rc = allow_smem(dropattn_bwd_dkv_kernel<T, D>, smem_dkv);
  if (rc != 0) return rc;
  const int n_t = (L + DB_TB - 1) / DB_TB;
  const unsigned grid = (unsigned)((long)B * h * n_t);
  dropattn_bwd_dq_kernel<T, D><<<grid, DB_TB, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)g, lse, dsum, (T*)dq, h, L, n_t, kc,
      sm_scale, seed, p, inv);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dropattn_bwd_dkv_kernel<T, D><<<grid, DB_TB, smem_dkv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)g, lse, dsum, (T*)dk, (T*)dv, h,
      L, n_t, qc, sm_scale, seed, p, inv);
  return 0;
}

// The tensor-core route's launch for operand T at head dim D: two head
// buffers (the next head's copy in flight) where they fit a block's shared
// memory and cost no block an SM, else one (in f32 at [32, 16, 64, 64] two
// blocks an SM with one buffer beat one block with two:
// tools/probe_attention64.py); refused where one does not fit.
template <typename T, int D, typename Kern, typename... Args>
static int launch_tc(Kern kernel, int max_threads, long BH, int L, cudaStream_t stream,
                     Args... args) {
  const int Lp = (L + 15) / 16 * 16, threads = 2 * Lp;
  if (threads > max_threads) return (int)cudaErrorInvalidValue;
  int per_sm[2] = {0, 0};  // blocks an SM with 1 and 2 head buffers
  for (int nb = 2; nb >= 1; --nb) {
    const size_t bytes = dt_smem_bytes<T, D>(Lp, nb);
    if (bytes > DT_SMEM_MAX) continue;
    int rc = allow_smem(kernel, bytes);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[nb - 1], kernel, threads,
                                                              bytes);
    if (rc != 0) return rc;
  }
  if (per_sm[0] <= 0) return (int)cudaErrorInvalidConfiguration;
  const int n_buf = per_sm[1] >= per_sm[0] ? 2 : 1;
  const size_t smem = dt_smem_bytes<T, D>(Lp, n_buf);
  int rc = allow_smem(kernel, smem);  // the limit the launch needs (the loop set it last for 1)
  int device = 0, n_sm = 0;
  if (rc == 0) rc = (int)cudaGetDevice(&device);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)std::min<long>(BH, (long)n_sm * per_sm[n_buf - 1]);
  kernel<<<grid, threads, smem, stream>>>(args..., (int)BH, Lp, n_buf);
  return (int)cudaGetLastError();
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype: 0 f32, 1 bf16. q, k, v, g, dq, dk, dv: [B, h, L, d] contiguous;
//   bias: [B, L] f32; lse: [B, h, L] f32 from the forward; dsum: [B, h, L] f32
//   scratch. d = 32 or 64 (others are refused), any L; 0 <= p < 1, inv =
//   1 / (1 - p) rounded to f32.
// Launches the dq kernel, then the dk/dv kernel, on one stream.
// Returns cudaGetLastError() after the launches.
extern "C" int sskd_dropattn_bwd(int dtype, const void* q, const void* k, const void* v,
                                 const float* bias, const void* g, const float* lse,
                                 float* dsum, void* dq, void* dk, void* dv, int B, int h, int L,
                                 int d, float sm_scale, uint32_t seed, float p, float inv,
                                 void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || (d != 32 && d != 64) || !(p >= 0.f && p < 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0 && d == 32)
    rc = launch<float, 32>(q, k, v, bias, g, lse, dsum, dq, dk, dv, B, h, L, sm_scale, seed, p,
                           inv, s);
  else if (dtype == 0)
    rc = launch<float, 64>(q, k, v, bias, g, lse, dsum, dq, dk, dv, B, h, L, sm_scale, seed, p,
                           inv, s);
  else if (dtype == 1 && d == 32)
    rc = launch<__nv_bfloat16, 32>(q, k, v, bias, g, lse, dsum, dq, dk, dv, B, h, L, sm_scale,
                                   seed, p, inv, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16, 64>(q, k, v, bias, g, lse, dsum, dq, dk, dv, B, h, L, sm_scale,
                                   seed, p, inv, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

//   The tensor-core routes: dtype 1 (bf16) at d = 32 or 64, dtype 0 (f32) at
//   d = 64, at any L whose head fits a block's shared memory (dt_smem_bytes
//   with one buffer: L <= 256 for bf16 at d = 32, 208 at d = 64, 128 for
//   f32); others are refused. The arguments as above without dsum;
//   scale_log2 = log2(e) / sqrt(d) in f32 (the bf16 route's exponent).
//   Launches one kernel: blocks of L / 16 warps (L rounded up to 16), as many
//   as fit the card at once (at most one per head), each walking its heads
//   (launch_tc).
extern "C" int sskd_dropattn_bwd_tc(int dtype, const void* q, const void* k, const void* v,
                                    const float* bias, const void* g, const float* lse, void* dq,
                                    void* dk, void* dv, int B, int h, int L, int d,
                                    float sm_scale, float scale_log2, uint32_t seed, float p,
                                    float inv, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || !(p >= 0.f && p < 1.f)) return (int)cudaErrorInvalidValue;
  const long BH = (long)B * h;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (dtype == 1 && d == 32)
    return launch_tc<bf, 32>(dropattn_bwd_tc_kernel<32>, 512, BH, L, s, (const bf*)q,
                             (const bf*)k, (const bf*)v, bias, (const bf*)g, lse, (bf*)dq,
                             (bf*)dk, (bf*)dv, h, L, sm_scale, scale_log2, seed, p, inv);
  if (dtype == 1 && d == 64)
    return launch_tc<bf, 64>(dropattn_bwd_tc_kernel<64>, 512, BH, L, s, (const bf*)q,
                             (const bf*)k, (const bf*)v, bias, (const bf*)g, lse, (bf*)dq,
                             (bf*)dk, (bf*)dv, h, L, sm_scale, scale_log2, seed, p, inv);
  if (dtype == 0 && d == 64)
    return launch_tc<float, 64>(dropattn_bwd_tc_tf32_kernel<64>, 256, BH, L, s, (const float*)q,
                                (const float*)k, (const float*)v, bias, (const float*)g, lse,
                                (float*)dq, (float*)dk, (float*)dv, h, L, sm_scale, seed, p, inv);
  return (int)cudaErrorInvalidValue;
}
