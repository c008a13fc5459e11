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
//   D      = rowsum(dprobs * probs)                (f32: / rowsum(probs))
//   ds     = probs * (dprobs - D) / sqrt(d)
//   dq     = round_T(ds) k,   dk = round_T(ds)^T q
// with f32 sums, each output rounded to T once. D is recomputed from the
// scores as the TPU kernel does, not taken from rowsum(g * out), so no bf16
// rounding of the forward's output enters the gradient. The f32 routes
// divide it by the row's sum of the probabilities they recompute
// (normalized_dsum): with an lse from a forward whose score products ran in
// another order those sum to 1 only to a few ulps, and on a row with one
// live key ds was left at a few ulps of dprobs instead of 0.
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
// from (dtype, d, L), both on the tensor cores, neither with atomics (two
// launches give the same bits):
//
// 1. bf16 at d in {16, 32, 64}, f32 at d = 64, while a whole head fits a
//    block's shared memory (L <= 256 in bf16 at d = 16 and 32, 208 at d =
//    64, 128 in f32; the student trains at 64 and 192, the teacher at 64,
//    the tiny models of the pipeline's --tiny runs at d = 16):
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
//      2^(s * scale * log2(e) + (bias - lse) * log2(e)), one exp; f32:
//      expf(s * scale + bias - lse)), the keep bits, the row's D =
//      sum(dprobs * probs) with no cross-warp reduction, pd into an [L, L]
//      shared buffer (bf16, or f32 on the f32 route).
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
//    (launch_tc). Every input is read once. Shared memory at L = 192 in bf16
//    at d = 32: 208,896 bytes (one block of 12 warps per SM).
//    bf16 at d = 16 takes dropattn_bwd_tc_3pass_kernel instead: no [Lp, Lp]
//    buffer (dv and dk from registers in a third pass over the keys, S^T and
//    dP^T recomputed as the streaming route's K3 does; 45 KB a block at L =
//    192 with one head buffer, 84 KB with two, against 119-156 KB), the same
//    sums and roundings, the same bits. On an H100 (tools/probe_dropattn16.py)
//    it took [256, 4, 192, 16] p 0.1 from 0.170 ms to 0.157 and [32, 4, 64,
//    16] from 0.0089 to 0.0077, with its chunk loops unrolled twice (122
//    registers: one 12-warp block an SM still; capped at 64 registers two
//    blocks fit and it spills, and it is no faster at p 0.1). The bound
//    there is the work a score, not latency: the keep-mask's Philox draw
//    (0.065-0.073 ms, p 0.1 less p 0) and, without dropout, 0.087-0.095 ms
//    of exps and elementwise work that freeing the buffer did not shorten.
//    At d = 32 and 64 the three passes lost (0.575 against 0.545 ms at
//    [256, 12, 192, 32] p 0.1, 0.0255 against 0.0220 at [32, 16, 64, 64]),
//    so dropattn_bwd_tc_kernel stays there.
// 2. Every other (dtype, d, L) at d in {16, 32, 64}, bf16 and f32, f32 at
//    d = 16 and 32 at every L (the student trained in f32, the tiny
//    teacher): the streaming kernels, three
//    launches on one stream, each block 4 warps of 16 rows and the other
//    side of the head streamed through shared memory in tiles of 64 rows by
//    cp.async, two tiles in flight, so no head is too long. The products and
//    probabilities are route 1's, fragment for fragment (bf16 m16n8k16
//    through ldmatrix, K and V rows in the Philox order; f32 three TF32
//    products, K and V rows in slot order), with rows padded to D + 8 bf16
//    or D + 4 floats.
//    - K1, dropattn_bwd_stream_rows_kernel<T, D, false>, a block per 64
//      query rows of a head: S and dP per 16-key chunk, probs, the keep bits
//      (the mask's only draw of the backward, one Philox call for four keys
//      of a row), D = sum(dprobs * probs) within the warp's own rows (f32:
//      over sum(probs), normalized_dsum). It
//      writes D (f32 [B*h, L]) and the keep bits packed, uint32 words
//      [B*h, L, ceil(L / 32)], bit j % 32 of word j / 32 for key j, bits
//      past L 0 (ops/attention.py dropout_keep_bits).
//    - K2, the same kernel with DQ: S and dP again, the keep bits read, not
//      drawn, ds = probs (dprobs - D) scale, dq = round_T(ds) k with ds fed
//      from registers, as route 1's pass 2.
//    - K3, dropattn_bwd_stream_cols_kernel<T, D>, a block per 64 keys of a
//      head: its K and V rows and their bias stay; q, g, lse, D and the keep
//      bits of 64 queries stream. S^T = k q^T and dP^T = v g^T come out with
//      keys as rows, so pd^T and ds^T are A fragments from registers: dv +=
//      round_T(pd^T) g and dk += round_T(ds^T) q, f32 sums, each output
//      rounded once. In f32 the warp reads K's and V's A fragments from
//      shared memory at each use rather than hold them beside the four
//      accumulators of dk and dv.
//    D is not folded into K2 by splitting dq into sum(probs dprobs) k -
//    D sum(probs) k: that rounds something other than round_T(ds) and
//    cancels badly. Rows and keys past L are zero rows with lse +inf and
//    bias -inf: probabilities 0, products exact zeros, nothing written.
//    Work at [256 * 12, 512, 32] bf16: nine products of 2 L^2 d over the three
//    kernels (the five of the function, S and dP twice more), three exps a
//    score, the mask drawn once; the keep bits add L^2 / 8 bytes a head,
//    written once and read twice (100.7 MB at that shape).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <algorithm>
#include <climits>
#include <mutex>
#include <type_traits>
#include <vector>

#include "attn_common.cuh"
#include "mma_common.cuh"
#include "philox.cuh"

namespace sskd {

// ---------------------------------------------------------------------------
// Route 1: tensor cores, a whole head per block: bf16 at d in {16, 32, 64}, f32
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

// D of one row on the f32 routes: sum(dprobs * probs) / sum(probs), both
// sums over the probabilities that ds takes. probs = exp(s - lse) with the
// lse of a forward whose score products ran in another order sum to 1 only
// to a few ulps; on a row with one live key that left probs (dprobs - D) at
// a few ulps of dprobs where the exact value is 0 (and the plain pair's,
// whose lse matches its own scores bit for bit). Dividing by the sum makes
// D that key's dprobs again, so ds is 0 there; elsewhere it moves D by the
// same few ulps. Rows with no probability (past L) keep D = 0.
__device__ __forceinline__ float normalized_dsum(float dsum, float psum) {
  return psum > 0.f ? __fdiv_rn(dsum, psum) : 0.f;
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
// mma.sync m16n8k8 as three TF32 products, each probability
// expf(s * scale + bias - lse) in natural units, as the plain version takes
// it. Fragments are
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
    // probs of the thread's four keys key0..key0+3 in row row0 + 8 rr, in
    // natural units
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
    float dsum[2] = {0.f, 0.f}, psum[2] = {0.f, 0.f};
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
          psum[rr] = __fadd_rn(psum[rr], prob[j]);
          pd[j] = drop ? (kj ? __fmul_rn(prob[j], inv) : 0.f) : prob[j];
        }
        *reinterpret_cast<float4*>(s_p + row * LDP + key0) = make_float4(pd[0], pd[1], pd[2], pd[3]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 1);
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 2);
      psum[rr] += __shfl_xor_sync(0xffffffffu, psum[rr], 1);
      psum[rr] += __shfl_xor_sync(0xffffffffu, psum[rr], 2);
      dsum[rr] = normalized_dsum(dsum[rr], psum[rr]);
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

// ---------------------------------------------------------------------------
// Route 2: tensor cores, the head streamed (any L): bf16 and f32 at d in
// {16, 32, 64}
// ---------------------------------------------------------------------------

constexpr int DS_ROWS = 64;  // rows a block owns (K1, K2: queries; K3: keys): 4 warps x 16
constexpr int DS_TILE = 64;  // rows a streamed tile (K1, K2: keys; K3: queries)
constexpr int DS_THREADS = 128;

// Shared row stride of the streaming kernels' tiles: bf16 rows padded to
// D + 8 (ldmatrix's eight row addresses in distinct bank groups), f32 rows
// to D + 4 (= 4 mod 32: the 32-bit fragment reads of rows grp at column tig,
// and of rows 2 tig and 2 tig + 1 at column grp, hit distinct banks).
template <typename T, int D>
__host__ __device__ constexpr int ds_ld() {
  return sizeof(T) == 2 ? D + 8 : D + 4;
}

// Shared memory of either streaming kernel: six tiles of 64 rows (the
// block's own two, then the streamed two in each of two stages), then per
// stage 64 floats of bias (K1, K2) or 64 lse, 64 D and 128 bit words (K3).
// K1 and K2: 31,232 / 55,808 bytes in bf16 at d = 32 / 64, 55,808 / 104,960
// in f32; K3 1,536 more.
template <typename T, int D>
__host__ __device__ constexpr size_t ds_smem_bytes(bool cols) {
  return 6 * (size_t)DS_TILE * ds_ld<T, D>() * sizeof(T) + 2 * (size_t)DS_TILE * (cols ? 16 : 4);
}

// 4 bytes global -> shared, asynchronous; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

// one f32 from shared memory, read where it stands (asm volatile: neither
// hoisted out of its loop nor merged with an earlier read, so K3's f32 A
// fragments do not take registers for the whole tile)
__device__ __forceinline__ float lds_f32(const float* p) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(smem_addr(p)));
  return x;
}

// c + c_lo += a b as mma_3xtf32 takes it, except that this step's hi hi
// product starts from zero and is added to c rounded to nearest. For the
// long sums of the streaming kernels (dq over L keys, dk and dv over L
// queries, L / 8 steps) a truncation of the running sum at each step, all
// toward zero, biases it by up to L / 8 ulps of its value: at L = 72 and
// 192 in f32 that reached 1e-5 on the card. Here each step truncates only
// its own sum.
__device__ __forceinline__ void mma_3xtf32_rn(float (&c)[4], float (&c_lo)[4],
                                              const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                              float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c_lo, al, h0, h1);
  mma_tf32(c_lo, ah, l0, l1);
  mma_tf32(t, ah, h0, h1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// The A fragments of a warp's 16 rows (row16 .. row16 + 15 of a shared tile):
// bf16 four registers of two values per 16-deep step (ldmatrix), f32 four
// values per 8-deep step (split into TF32 terms at each use).
template <int D>
struct BfFrags {
  uint32_t r[D / 16][4];
};
template <int D>
struct F32Frags {
  float r[D / 8][4];
};
template <typename T, int D>
using DsFrags = typename std::conditional<sizeof(T) == 2, BfFrags<D>, F32Frags<D>>::type;

template <int D>
__device__ __forceinline__ void load_frags(BfFrags<D>& f, const __nv_bfloat16* tile, int row16,
                                           int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(f.r[ks], tile + (row16 + mr + (mi & 1) * 8) * (D + 8) + ks * 16 + (mi >> 1) * 8);
}
template <int D>
__device__ __forceinline__ void load_frags(F32Frags<D>& f, const float* tile, int row16,
                                           int lane) {
  const float* r = tile + (row16 + (lane >> 2)) * (D + 4) + (lane & 3);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    f.r[ks][0] = lds_f32(r + ks * 8);
    f.r[ks][1] = lds_f32(r + 8 * (D + 4) + ks * 8);
    f.r[ks][2] = lds_f32(r + ks * 8 + 4);
    f.r[ks][3] = lds_f32(r + 8 * (D + 4) + ks * 8 + 4);
  }
}

// S = a b^T and dP = c e^T of one 16-row x 16-column chunk: a, c the warp's
// A fragments, b, e shared tiles whose rows c16 .. c16 + 15 are the chunk's
// columns. Element e of tile nt holds row grp + 8 (e >> 1), column c16 +
// 4 tig + 2 nt + (e & 1) (the Philox order: bf16 through perm_key, f32 from
// rows stored in slot order), or with `natural` (bf16) c16 + 8 nt + 2 tig +
// (e & 1).
template <int D>
__device__ __forceinline__ void chunk_products(float (&s)[2][4], float (&dp)[2][4],
                                               const BfFrags<D>& a, const BfFrags<D>& c,
                                               const __nv_bfloat16* b, const __nv_bfloat16* e,
                                               int c16, int lane, bool natural) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
  const int row = c16 + (natural ? mr + (mi >> 1) * 8 : perm_key(mr, mi >> 1));
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t bb[4], eb[4];
    ldmatrix_x4(bb, b + row * LD + ks * 16 + (mi & 1) * 8);
    ldmatrix_x4(eb, e + row * LD + ks * 16 + (mi & 1) * 8);
    mma_bf16(s[0], a.r[ks], bb[0], bb[1]);
    mma_bf16(s[1], a.r[ks], bb[2], bb[3]);
    mma_bf16(dp[0], c.r[ks], eb[0], eb[1]);
    mma_bf16(dp[1], c.r[ks], eb[2], eb[3]);
  }
}
template <int D>
__device__ __forceinline__ void chunk_products(float (&s)[2][4], float (&dp)[2][4],
                                               const F32Frags<D>& a, const F32Frags<D>& c,
                                               const float* b, const float* e, int c16, int lane,
                                               bool) {
  constexpr int LD = D + 4;
  const int grp = lane >> 2, tig = lane & 3;
  float s_lo[2][4], dp_lo[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = s_lo[nt][i] = dp_lo[nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    split_tf32_a(a.r[ks], ah, al);
    split_tf32_a(c.r[ks], ch, cl);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* br = b + (c16 + 8 * nt + grp) * LD + ks * 8 + tig;
      const float* er = e + (c16 + 8 * nt + grp) * LD + ks * 8 + tig;
      mma_3xtf32(s[nt], s_lo[nt], ah, al, br[0], br[4]);
      mma_3xtf32(dp[nt], dp_lo[nt], ch, cl, er[0], er[4]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    fold_lo(s[nt], s_lo[nt]);
    fold_lo(dp[nt], dp_lo[nt]);
  }
}

// acc (+ acc_lo) += x y over one 16-deep chunk: x [16 rows, 16] f32 by
// element (x[rr][j]: row grp + 8 rr, the j-th of the thread's four columns
// of chunk_products), y rows c16 .. c16 + 15 of a shared tile with D
// columns, in the chunk's column order. bf16: x rounded and packed into the
// A fragment of one m16n8k16 step, y through ldmatrix.trans (rows in the
// order of x's columns: `natural`, or perm_key); f32: two 8-deep steps
// (mma_3xtf32_rn), step st taking columns 4 tig + 2 st and + 1 as k = tig and
// tig + 4 (rows 8 st + 2 tig and + 1 of a slot-ordered tile).
template <int D>
__device__ __forceinline__ void chunk_accumulate(float (&acc)[D / 8][4], float (&)[D / 8][4],
                                                 const float (&x)[2][4],
                                                 const __nv_bfloat16* y, int c16, int lane,
                                                 bool natural) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t a[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[1][0], x[1][1]),
                         pack_bf16(x[0][2], x[0][3]), pack_bf16(x[1][2], x[1][3])};
  const int row = c16 + (natural ? mr + (mi & 1) * 8 : perm_key(mr, mi & 1));
#pragma unroll
  for (int half = 0; half < D / 16; ++half) {
    uint32_t yb[4];
    ldmatrix_x4_trans(yb, y + row * LD + half * 16 + (mi >> 1) * 8);
    mma_bf16(acc[2 * half], a, yb[0], yb[1]);
    mma_bf16(acc[2 * half + 1], a, yb[2], yb[3]);
  }
}
template <int D>
__device__ __forceinline__ void chunk_accumulate(float (&acc)[D / 8][4], float (&acc_lo)[D / 8][4],
                                                 const float (&x)[2][4], const float* y, int c16,
                                                 int lane, bool) {
  constexpr int LD = D + 4;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const float a[4] = {x[0][2 * st], x[1][2 * st], x[0][2 * st + 1], x[1][2 * st + 1]};
    uint32_t ah[4], al[4];
    split_tf32_a(a, ah, al);
    const float* yr = y + (c16 + 8 * st + 2 * tig) * LD + grp;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      mma_3xtf32_rn(acc[dn], acc_lo[dn], ah, al, yr[dn * 8], yr[LD + dn * 8]);
  }
}

// 2^(s scale log2(e) + bias2 - lse2) in bf16 (bias2, lse2 in log2 units: one
// ex2, route 1's exponent); expf(s scale + bias - lse) in f32
template <typename T>
__device__ __forceinline__ float ds_prob(float s, float bias, float lse, float sm_scale,
                                         float scale_log2) {
  if constexpr (sizeof(T) == 2) return exp2_approx(fmaf(s, scale_log2, bias - lse));
  return expf(__fsub_rn(__fadd_rn(__fmul_rn(s, sm_scale), bias), lse));
}

// Stores a warp's 16 x D f32 accumulator (C fragments) as rows row .. of
// out (rows at or past L skipped), rounded to T once.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 8][4],
                                           int row, int L, int tig) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row + 8 * rr >= L) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (long)(row + 8 * rr) * D + 2 * tig);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) dst[dn * 4] = pack_bf16(acc[dn][2 * rr], acc[dn][2 * rr + 1]);
  }
}
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[D / 8][4], int row, int L,
                                           int tig) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row + 8 * rr >= L) continue;
    float* dst = out + (long)(row + 8 * rr) * D + 2 * tig;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) = make_float2(acc[dn][2 * rr], acc[dn][2 * rr + 1]);
  }
}

// K1 (DQ false) and K2 (DQ true): a block per (head, 64 query rows), warp w
// rows 16w..16w+15, K and V streamed in 64-key tiles. K1 draws the keep bits
// and writes them with D; K2 reads them and D and writes dq.
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(DS_THREADS) dropattn_bwd_stream_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ dsum, uint32_t* __restrict__ bits, T* __restrict__ dq, int h, int L,
    int n_rt, float sm_scale, float scale_log2, uint32_t seed, float p, float inv) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LD = ds_ld<T, D>();
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr unsigned CH = D / VE;     // 16-byte copies a row (unsigned: divisions are shifts)
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_g = s_q + DS_ROWS * LD;
  T* s_k = s_g + DS_ROWS * LD;      // [2][DS_TILE][LD]
  T* s_v = s_k + 2 * DS_TILE * LD;  // [2][DS_TILE][LD]
  float* s_bias = reinterpret_cast<float*>(s_v + 2 * DS_TILE * LD);  // [2][DS_TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_rt;
  const int r0 = (blockIdx.x % n_rt) * DS_ROWS;
  const long head_off = bh * (long)L * D;
  const float* brow = bias + (bh / h) * L;
  const int W = (L + 31) >> 5;  // keep-bit words a row
  const bool drop = p > 0.f;

  // the block's q and g rows (rows past L as zeros)
  for (unsigned i = tid; i < 2 * DS_ROWS * CH; i += DS_THREADS) {
    const unsigned t = i / (DS_ROWS * CH), j = i % (DS_ROWS * CH);
    const int r = j / CH, c = (j % CH) * VE, row = r0 + r;
    cp_async16((t ? s_g : s_q) + r * LD + c,
               (t ? g : q) + head_off + (long)min(row, L - 1) * D + c, row < L ? 16 : 0);
  }
  // keys k0 .. k0 + 63 into stage `stage`: K and V rows (bf16 as they are,
  // f32 in slot order; keys past L as zero rows), the bias by key (bf16 in
  // log2 units; past L -inf)
  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < 2 * DS_TILE * CH; i += DS_THREADS) {
      const unsigned t = i / (DS_TILE * CH), j = i % (DS_TILE * CH);
      const int r = j / CH, c = (j % CH) * VE, key = k0 + r;
      cp_async16((t ? s_v : s_k) + (stage * DS_TILE + (BF ? r : slot_row(r))) * LD + c,
                 (t ? v : k) + head_off + (long)min(key, L - 1) * D + c, key < L ? 16 : 0);
    }
    if (tid < DS_TILE) {
      const int key = k0 + tid;
      s_bias[stage * DS_TILE + tid] = key < L ? (BF ? brow[key] * LOG2E : brow[key]) : -INFINITY;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const int row0 = r0 + warp * 16 + grp;  // this thread's rows: row0 and row0 + 8
  float lse_r[2], dsum_r[2] = {0.f, 0.f}, psum_r[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    // rows past L: probability 0 at every key
    lse_r[rr] = row < L ? (BF ? lse[bh * L + row] * LOG2E : lse[bh * L + row]) : INFINITY;
    if (DQ && row < L) dsum_r[rr] = dsum[bh * L + row];
  }
  DsFrags<T, D> qa, ga;
  float acc[D / 8][4], acc_lo[D / 8][4];  // dq (K2)
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = acc_lo[i][e] = 0.f;

  const int n_kt = (L + DS_TILE - 1) / DS_TILE;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * DS_TILE);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and the block's rows) has landed
    __syncthreads();
    if (t == 0) {
      load_frags(qa, s_q, warp * 16, lane);
      load_frags(ga, s_g, warp * 16, lane);
    }
    const T* sk = s_k + (t & 1) * DS_TILE * LD;
    const T* sv = s_v + (t & 1) * DS_TILE * LD;
    const float* sb = s_bias + (t & 1) * DS_TILE;
    const int k0 = t * DS_TILE;
    const int n_c = min(DS_TILE / 16, (L - k0 + 15) >> 4);  // chunks holding a key < L
    // the rows' keep bits of this tile, bit j for key k0 + j: drawn (K1) or read (K2)
    uint64_t tile_bits[2] = {0u, 0u};
    if (DQ && drop) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        if (row >= L) continue;
        const uint32_t* src = bits + (bh * L + row) * W + (k0 >> 5);
        tile_bits[rr] = src[0] | ((k0 >> 5) + 1 < W ? (uint64_t)src[1] << 32 : 0u);
      }
    }
    for (int c = 0; c < n_c; ++c) {
      float s[2][4], dp[2][4];
      chunk_products(s, dp, qa, ga, sk, sv, c * 16, lane, false);
      const int kc = c * 16 + 4 * tig;  // the thread's four keys kc .. kc + 3 of the tile
      float ds[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        uint32_t keep = 0xFu;
        if (drop && !DQ) {
          keep = keep_bits4(seed, (uint32_t)bh, row0 + 8 * rr, k0 + kc, p);
          uint32_t word = keep << (4 * tig);  // the row's 16 keys of the chunk
          word |= __shfl_xor_sync(0xffffffffu, word, 1);
          word |= __shfl_xor_sync(0xffffffffu, word, 2);
          tile_bits[rr] |= (uint64_t)word << (16 * c);
        } else if (drop) {
          keep = (uint32_t)(tile_bits[rr] >> kc) & 0xFu;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float prob =
              ds_prob<T>(s[j >> 1][2 * rr + (j & 1)], sb[kc + j], lse_r[rr], sm_scale, scale_log2);
          const float dpv = dp[j >> 1][2 * rr + (j & 1)];
          const float dprobs = drop ? (((keep >> j) & 1u) ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          if (DQ) {
            ds[rr][j] = __fmul_rn(__fmul_rn(prob, __fsub_rn(dprobs, dsum_r[rr])), sm_scale);
          } else {
            dsum_r[rr] = fmaf(dprobs, prob, dsum_r[rr]);
            if (!BF) psum_r[rr] = __fadd_rn(psum_r[rr], prob);
          }
        }
      }
      if constexpr (DQ) chunk_accumulate<D>(acc, acc_lo, ds, sk, c * 16, lane, false);
    }
    if (!DQ && drop && tig < 2) {  // lanes tig 0 and 1 write the rows' two words of the tile
      const int w = (k0 >> 5) + tig;
      if (w < W) {
        const int live = L - 32 * w;  // keys of the word below L
        uint32_t word = (uint32_t)(tile_bits[0] >> (32 * tig));
        uint32_t word8 = (uint32_t)(tile_bits[1] >> (32 * tig));
        const uint32_t keep_mask = live >= 32 ? 0xffffffffu : (1u << live) - 1u;
        if (row0 < L) bits[(bh * L + row0) * W + w] = word & keep_mask;
        if (row0 + 8 < L) bits[(bh * L + row0 + 8) * W + w] = word8 & keep_mask;
      }
    }
    __syncthreads();  // the tile's buffers are free for tile t + 2
  }

  if constexpr (DQ) {
    if constexpr (!BF) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) fold_lo(acc[dn], acc_lo[dn]);
    }
    store_rows<D>(dq + head_off, acc, row0, L, tig);
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dsum_r[rr] += __shfl_xor_sync(0xffffffffu, dsum_r[rr], 1);
      dsum_r[rr] += __shfl_xor_sync(0xffffffffu, dsum_r[rr], 2);
      if constexpr (!BF) {  // f32: normalised as the resident f32 kernel's
        psum_r[rr] += __shfl_xor_sync(0xffffffffu, psum_r[rr], 1);
        psum_r[rr] += __shfl_xor_sync(0xffffffffu, psum_r[rr], 2);
        dsum_r[rr] = normalized_dsum(dsum_r[rr], psum_r[rr]);
      }
      if (tig == 0 && row0 + 8 * rr < L) dsum[bh * L + row0 + 8 * rr] = dsum_r[rr];
    }
  }
}

// K3: a block per (head, 64 keys), warp w keys 16w..16w+15, q, g, lse, D
// and the keep bits streamed in 64-query tiles. S^T and dP^T have keys as
// rows and the queries in their natural order: element e of a 16-query
// chunk's tile nt (bf16) holds key grp + 8 (e >> 1), query c16 + 8 nt +
// 2 tig + (e & 1); in f32 each 8-query tile nt holds queries 8 nt + 2 tig +
// (e & 1), its C fragment the A fragment of an 8-deep step with column 2 tig
// as k = tig and 2 tig + 1 as k = tig + 4 (a0 = c0, a1 = c2, a2 = c1, a3 =
// c3), so B reads q's or g's rows 8 nt + 2 tig and + 1.
template <typename T, int D>
__global__ void __launch_bounds__(DS_THREADS) dropattn_bwd_stream_cols_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ dsum, const uint32_t* __restrict__ bits, T* __restrict__ dk,
    T* __restrict__ dv, int h, int L, int n_kt, float sm_scale, float scale_log2, float p,
    float inv) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LD = ds_ld<T, D>();
  constexpr int VE = 16 / sizeof(T);
  constexpr unsigned CH = D / VE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + DS_ROWS * LD;
  T* s_q = s_v + DS_ROWS * LD;      // [2][DS_TILE][LD]
  T* s_g = s_q + 2 * DS_TILE * LD;  // [2][DS_TILE][LD]
  float* s_lse = reinterpret_cast<float*>(s_g + 2 * DS_TILE * LD);  // [2][DS_TILE]
  float* s_dsum = s_lse + 2 * DS_TILE;                              // [2][DS_TILE]
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_dsum + 2 * DS_TILE);  // [2][DS_TILE][2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_kt;
  const int kb0 = (blockIdx.x % n_kt) * DS_ROWS;
  const long head_off = bh * (long)L * D;
  const int W = (L + 31) >> 5;
  const bool drop = p > 0.f;

  // the block's k and v rows (past L as zeros)
  for (unsigned i = tid; i < 2 * DS_ROWS * CH; i += DS_THREADS) {
    const unsigned t = i / (DS_ROWS * CH), j = i % (DS_ROWS * CH);
    const int r = j / CH, c = (j % CH) * VE, key = kb0 + r;
    cp_async16((t ? s_v : s_k) + r * LD + c,
               (t ? v : k) + head_off + (long)min(key, L - 1) * D + c, key < L ? 16 : 0);
  }
  // queries i0 .. i0 + 63 into stage `stage`: q and g rows, lse, D and the
  // two words of keep bits over the block's keys (past L as zeros)
  auto load_tile = [&](int stage, int i0) {
    for (unsigned i = tid; i < 2 * DS_TILE * CH; i += DS_THREADS) {
      const unsigned t = i / (DS_TILE * CH), j = i % (DS_TILE * CH);
      const int r = j / CH, c = (j % CH) * VE, row = i0 + r;
      cp_async16((t ? s_g : s_q) + (stage * DS_TILE + r) * LD + c,
                 (t ? g : q) + head_off + (long)min(row, L - 1) * D + c, row < L ? 16 : 0);
    }
    for (int i = tid; i < 4 * DS_TILE; i += DS_THREADS) {
      const int what = i / DS_TILE, r = i % DS_TILE, row = min(i0 + r, L - 1);
      const bool live = i0 + r < L;
      if (what < 2) {
        cp_async4_zfill((what ? s_dsum : s_lse) + stage * DS_TILE + r,
                        (what ? dsum : lse) + bh * L + row, live ? 4 : 0);
      } else {
        const int w = min((kb0 >> 5) + what - 2, W - 1);
        cp_async4_zfill(s_bits + (stage * DS_TILE + r) * 2 + what - 2,
                        bits + (bh * L + row) * W + w,
                        live && (kb0 >> 5) + what - 2 < W ? 4 : 0);
      }
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const int key0 = kb0 + warp * 16 + grp;  // this thread's keys: key0 and key0 + 8
  const int bit0 = 16 * (warp & 1) + grp;  // their bits in word warp >> 1: bit0, bit0 + 8
  float kbias[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + 8 * rr;
    kbias[rr] = key < L ? (BF ? bias[(bh / h) * L + key] * LOG2E : bias[(bh / h) * L + key])
                        : -INFINITY;
  }
  DsFrags<T, D> ka, va;  // bf16: loaded once; f32: read at each use
  float dka[D / 8][4], dka_lo[D / 8][4], dva[D / 8][4], dva_lo[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dka_lo[i][e] = dva[i][e] = dva_lo[i][e] = 0.f;

  const int n_qt = (L + DS_TILE - 1) / DS_TILE;
  for (int t = 0; t < n_qt; ++t) {
    if (t + 1 < n_qt) load_tile((t + 1) & 1, (t + 1) * DS_TILE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (BF) {
      if (t == 0) {
        load_frags(ka, s_k, warp * 16, lane);
        load_frags(va, s_v, warp * 16, lane);
      }
    }
    const T* sq = s_q + (t & 1) * DS_TILE * LD;
    const T* sg = s_g + (t & 1) * DS_TILE * LD;
    const float* sl = s_lse + (t & 1) * DS_TILE;
    const float* sd = s_dsum + (t & 1) * DS_TILE;
    const uint32_t* sw = s_bits + (t & 1) * DS_TILE * 2 + (warp >> 1);
    const int i0 = t * DS_TILE;
    // pd^T and ds^T of query column `col` (tile-relative) for key row rr
    auto grads = [&](float sv, float dpv, int col, int rr, float& pd, float& ds) {
      const bool live = i0 + col < L;
      const float lse_q = live ? (BF ? sl[col] * LOG2E : sl[col]) : INFINITY;
      const float prob = ds_prob<T>(sv, kbias[rr], lse_q, sm_scale, scale_log2);
      const bool kept = !drop || ((sw[2 * col] >> (bit0 + 8 * rr)) & 1u);
      const float dprobs = drop ? (kept ? __fmul_rn(dpv, inv) : 0.f) : dpv;
      pd = drop ? (kept ? __fmul_rn(prob, inv) : 0.f) : prob;
      ds = __fmul_rn(__fmul_rn(prob, __fsub_rn(dprobs, sd[col])), sm_scale);
    };
    if constexpr (BF) {
      const int n_c = min(DS_TILE / 16, (L - i0 + 15) >> 4);
      for (int c = 0; c < n_c; ++c) {
        float s[2][4], dp[2][4];
        chunk_products(s, dp, ka, va, sq, sg, c * 16, lane, true);
        float pd[2][4], ds[2][4];  // [rr][j]: key row rr, query c16 + 8 (j >> 1) + 2 tig + (j & 1)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            grads(s[nt][e], dp[nt][e], c * 16 + 8 * nt + 2 * tig + (e & 1), e >> 1,
                  pd[e >> 1][2 * nt + (e & 1)], ds[e >> 1][2 * nt + (e & 1)]);
        chunk_accumulate<D>(dva, dva_lo, pd, sg, c * 16, lane, true);
        chunk_accumulate<D>(dka, dka_lo, ds, sq, c * 16, lane, true);
      }
    } else {
      const int n_c = min(DS_TILE / 8, (L - i0 + 7) >> 3);
      for (int nt = 0; nt < n_c; ++nt) {
        float s[4] = {}, s_lo[4] = {}, dp[4] = {}, dp_lo[4] = {};
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          const float* kr = reinterpret_cast<const float*>(s_k) + (warp * 16 + grp) * LD + ks * 8 + tig;
          const float* vr = reinterpret_cast<const float*>(s_v) + (warp * 16 + grp) * LD + ks * 8 + tig;
          const float a_k[4] = {lds_f32(kr), lds_f32(kr + 8 * LD), lds_f32(kr + 4),
                                lds_f32(kr + 8 * LD + 4)};
          const float a_v[4] = {lds_f32(vr), lds_f32(vr + 8 * LD), lds_f32(vr + 4),
                                lds_f32(vr + 8 * LD + 4)};
          uint32_t kh[4], kl[4], vh[4], vl[4];
          split_tf32_a(a_k, kh, kl);
          split_tf32_a(a_v, vh, vl);
          const float* qr = reinterpret_cast<const float*>(sq) + (8 * nt + grp) * LD + ks * 8 + tig;
          const float* gr = reinterpret_cast<const float*>(sg) + (8 * nt + grp) * LD + ks * 8 + tig;
          mma_3xtf32(s, s_lo, kh, kl, qr[0], qr[4]);
          mma_3xtf32(dp, dp_lo, vh, vl, gr[0], gr[4]);
        }
        fold_lo(s, s_lo);
        fold_lo(dp, dp_lo);
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) grads(s[e], dp[e], 8 * nt + 2 * tig + (e & 1), e >> 1, pd[e], ds[e]);
        const float ap[4] = {pd[0], pd[2], pd[1], pd[3]}, as[4] = {ds[0], ds[2], ds[1], ds[3]};
        uint32_t ph[4], pl[4], sh[4], sl_[4];
        split_tf32_a(ap, ph, pl);
        split_tf32_a(as, sh, sl_);
        const float* gr = reinterpret_cast<const float*>(sg) + (8 * nt + 2 * tig) * LD + grp;
        const float* qr = reinterpret_cast<const float*>(sq) + (8 * nt + 2 * tig) * LD + grp;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          mma_3xtf32_rn(dva[dn], dva_lo[dn], ph, pl, gr[dn * 8], gr[LD + dn * 8]);
          mma_3xtf32_rn(dka[dn], dka_lo[dn], sh, sl_, qr[dn * 8], qr[LD + dn * 8]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for tile t + 2
  }
  if constexpr (!BF) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      fold_lo(dka[dn], dka_lo[dn]);
      fold_lo(dva[dn], dva_lo[dn]);
    }
  }
  store_rows<D>(dk + head_off, dka, key0, L, tig);
  store_rows<D>(dv + head_off, dva, key0, L, tig);
}

// ---------------------------------------------------------------------------
// Route 1 without the [Lp, Lp] buffer: bf16, a whole head per block, three
// passes (dropattn_bwd_tc_3pass_kernel)
// ---------------------------------------------------------------------------

// Shared memory of the three-pass kernel with n_buf (1 or 2) copies of the
// head (dt_head_bytes), then the keep bits (16 keys a word), the bias and
// the lse as the kernel uses them, and each row's D: no [Lp, Lp] buffer.
// At L = 192, d = 16: 45,312 bytes with one copy, 83,712 with two.
template <int D>
__host__ __device__ constexpr size_t dt3_smem_bytes(int Lp, int n_buf) {
  return n_buf * dt_head_bytes<D>(Lp) + (size_t)Lp * (Lp / 16) * 2 + 3 * (size_t)Lp * 4;
}

// The function and the blocks of dropattn_bwd_tc_kernel (persistent, one
// head at a time, warp w on query rows 16w..16w+15 and on keys 16w..16w+15),
// with dv and dk taken from registers instead of an [Lp, Lp] buffer:
// - pass 1 (query rows): S and dP, probs, the keep bits drawn once into
//   shared memory (one Philox call per four neighbouring keys of a row), D =
//   sum(dprobs * probs) into shared memory;
// - pass 2 (query rows): S and dP again, ds, dq = round(ds) k from
//   registers (route 1's pass 2);
// - pass 3 (key rows, as the streaming route's K3): S^T = k q^T and
//   dP^T = v g^T per 16-query chunk, so that pd^T and ds^T are the A
//   fragments of dv += round(pd^T) g and dk += round(ds^T) q; each
//   probability from the same folded exponent of the same score, the keep
//   bit and D read back from shared memory.
// Every product is the parent kernel's over the same chunks in the same
// order (S and S^T add the same bf16 products in the same k-steps), so the
// sums and roundings are those of dropattn_bwd_tc_kernel, bit for bit on
// the card. Freeing the buffer cuts a block at L = 192, d = 16 from 119-156
// KB to 45-84 KB; it costs a third computation of S and dP (one k-step each
// at d = 16) and a third exp a score. The registers, not the shared
// memory, set the blocks an SM (see the note at the top).
// The chunk loops are unrolled twice: at d = 16 that overlaps one chunk's
// Philox draw with the other's exps and products, 5 % on the card at p 0.1
// (tools/probe_dropattn16.py; capping the registers to fit two blocks an SM
// spilled and gained nothing at p 0.1).
template <int D>
__global__ void __launch_bounds__(512) dropattn_bwd_tc_3pass_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int h, int L, float sm_scale, float scale_log2,
    uint32_t seed, float p, float inv, int BH, int Lp, int n_buf) {
  constexpr int LD = D + 8;       // row stride in bf16
  constexpr unsigned CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int NC = Lp / 16;
  uint16_t* s_bits = reinterpret_cast<uint16_t*>(smem + n_buf * dt_head_bytes<D>(Lp));
  float* s_bias2 = reinterpret_cast<float*>(s_bits + Lp * NC);
  float* s_lse2 = s_bias2 + Lp;
  float* s_dsum = s_lse2 + Lp;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const bool drop = p > 0.f;

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
    else cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* s_q =
        reinterpret_cast<const __nv_bfloat16*>(smem + buf * dt_head_bytes<D>(Lp));
    const __nv_bfloat16* s_k = s_q + Lp * LD;
    const __nv_bfloat16* s_v = s_k + Lp * LD;
    const __nv_bfloat16* s_g = s_v + Lp * LD;
    const float* raw = reinterpret_cast<const float*>(s_g + Lp * LD);
    for (int i = tid; i < Lp; i += nthreads) {
      s_bias2[i] = i < L ? raw[i] * LOG2E : -INFINITY;
      s_lse2[i] = i < L ? raw[Lp + i] * LOG2E : INFINITY;
    }
    __syncthreads();
    const long head_off = bh * (long)L * D;

    // ---- passes 1 and 2 over the warp's query rows -------------------------
    const int row0 = warp * 16 + grp;
    BfFrags<D> qa, ga;
    load_frags(qa, s_q, warp * 16, lane);
    load_frags(ga, s_g, warp * 16, lane);
    const float lse2[2] = {s_lse2[row0], s_lse2[row0 + 8]};
    // element e of tile nt: row row0 + 8 (e >> 1), key c16 + 4 tig + 2 nt + (e & 1)
    auto probs4 = [&](const float (&s)[2][4], int rr, int key0, float (&prob)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        prob[j] = exp2_approx(fmaf(s[j >> 1][2 * rr + (j & 1)], scale_log2,
                                   s_bias2[key0 + j] - lse2[rr]));
    };

    float dsum[2] = {0.f, 0.f};
#pragma unroll 2
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];
      chunk_products(s, dp, qa, ga, s_k, s_v, c * 16, lane, false);
      const int key0 = c * 16 + 4 * tig;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        const uint32_t keep =
            drop ? draw_keep4(seed, (uint32_t)bh, row, key0, p, tig, s_bits + row * NC + c)
                 : 0xFu;
        float prob[4];
        probs4(s, rr, key0, prob);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dpv = dp[j >> 1][2 * rr + (j & 1)];
          const float dprobs = drop ? (((keep >> j) & 1u) ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          dsum[rr] = fmaf(dprobs, prob[j], dsum[rr]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 1);
      dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 2);
      if (tig == 0) s_dsum[row0 + 8 * rr] = dsum[rr];
    }
    __syncwarp();  // the warp's own keep bits, for pass 2

    float dqa[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];
      chunk_products(s, dp, qa, ga, s_k, s_v, c * 16, lane, false);
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
      }
      chunk_accumulate<D>(dqa, dqa, ds, s_k, c * 16, lane, false);
    }
    store_rows<D>(dq + head_off, dqa, row0, L, tig);
    __syncthreads();  // every row's keep bits and D are in shared memory

    // ---- pass 3 over the warp's keys: dv and dk ------------------------------
    const int kw = warp * 16;
    BfFrags<D> ka, va;
    load_frags(ka, s_k, kw, lane);
    load_frags(va, s_v, kw, lane);
    const float kbias2[2] = {s_bias2[kw + grp], s_bias2[kw + grp + 8]};
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < NC; ++c) {
      float s[2][4], dp[2][4];  // S^T, dP^T: element e of tile nt: key kw + grp + 8 (e >> 1),
      chunk_products(s, dp, ka, va, s_q, s_g, c * 16, lane, true);  // query c16 + 8 nt + 2 tig + (e & 1)
      float pd[2][4], ds[2][4];  // [rr][j]: key kw + grp + 8 rr, query c16 + 8 (j >> 1) + 2 tig + (j & 1)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + 8 * nt + 2 * tig + (e & 1), rr = e >> 1;
          const float prob =
              exp2_approx(fmaf(s[nt][e], scale_log2, kbias2[rr] - s_lse2[col]));
          const bool kept = !drop || ((s_bits[col * NC + warp] >> (grp + 8 * rr)) & 1u);
          const float dpv = dp[nt][e];
          const float dprobs = drop ? (kept ? __fmul_rn(dpv, inv) : 0.f) : dpv;
          pd[rr][2 * nt + (e & 1)] = drop ? (kept ? __fmul_rn(prob, inv) : 0.f) : prob;
          ds[rr][2 * nt + (e & 1)] =
              __fmul_rn(__fmul_rn(prob, __fsub_rn(dprobs, s_dsum[col])), sm_scale);
        }
      chunk_accumulate<D>(dva, dva, pd, s_g, c * 16, lane, true);
      chunk_accumulate<D>(dka, dka, ds, s_q, c * 16, lane, true);
    }
    store_rows<D>(dk + head_off, dka, kw + grp, L, tig);
    store_rows<D>(dv + head_off, dva, kw + grp, L, tig);
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

// The resident route's launch choice for one (device, kernel, Lp): head
// buffers, the grid and the block's shared memory; and the dynamic shared
// memory limit last given to each kernel on each device. Both are looked up
// on every launch and computed on the first one only: the occupancy query
// and the attribute calls cost the host more than the card's time of a
// small launch.
struct TcChoice {
  int device;
  const void* kernel;
  int Lp, n_buf;
  long grid_cap;
  size_t smem;
};
struct SmemLimit {
  int device;
  const void* kernel;
  size_t bytes;
};
static std::mutex tc_mutex;
static std::vector<TcChoice> tc_choices;
static std::vector<SmemLimit> tc_limits;

// The resident route's launch of `kernel` (smem_bytes(Lp, n_buf) its shared
// memory): two head buffers (the next head's copy in flight) where they fit
// a block's shared memory and cost no block an SM, else one (in f32 at [32,
// 16, 64, 64] two blocks an SM with one buffer beat one block with two:
// tools/probe_attention64.py); refused where one does not fit. As many
// blocks as fit the card at once, at most one a head.
template <typename Kern, typename Smem, typename... Args>
static int launch_tc(Kern kernel, Smem smem_bytes, int max_threads, long BH, int L,
                     cudaStream_t stream, Args... args) {
  const int Lp = (L + 15) / 16 * 16, threads = 2 * Lp;
  if (threads > max_threads) return (int)cudaErrorInvalidValue;
  int device = 0;
  int rc = (int)cudaGetDevice(&device);
  if (rc != 0) return rc;
  const void* key = (const void*)kernel;
  TcChoice choice{};
  {
    std::lock_guard<std::mutex> lock(tc_mutex);
    const auto hit = std::find_if(tc_choices.begin(), tc_choices.end(), [&](const TcChoice& c) {
      return c.device == device && c.kernel == key && c.Lp == Lp;
    });
    auto limit = std::find_if(tc_limits.begin(), tc_limits.end(), [&](const SmemLimit& l) {
      return l.device == device && l.kernel == key;
    });
    if (limit == tc_limits.end()) {
      tc_limits.push_back({device, key, 48 * 1024});
      limit = tc_limits.end() - 1;
    }
    if (hit != tc_choices.end()) {
      choice = *hit;
    } else {
      int per_sm[2] = {0, 0};  // blocks an SM with 1 and 2 head buffers
      for (int nb = 2; nb >= 1; --nb) {
        const size_t bytes = smem_bytes(Lp, nb);
        if (bytes > DT_SMEM_MAX) continue;
        rc = allow_smem(kernel, bytes);
        if (rc == 0)
          rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[nb - 1], kernel,
                                                                  threads, bytes);
        if (rc != 0) return rc;
      }
      limit->bytes = 0;  // the queries above left the kernel's limit at their last size
      if (per_sm[0] <= 0) return (int)cudaErrorInvalidConfiguration;
      const int n_buf = per_sm[1] >= per_sm[0] ? 2 : 1;
      int n_sm = 0;
      rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
      if (rc != 0) return rc;
      choice = {device, key, Lp, n_buf, (long)n_sm * per_sm[n_buf - 1], smem_bytes(Lp, n_buf)};
      tc_choices.push_back(choice);
    }
    if (limit->bytes < choice.smem) {  // the limit this launch needs
      rc = allow_smem(kernel, choice.smem);
      if (rc != 0) return rc;
      limit->bytes = choice.smem;
    }
  }
  const unsigned grid = (unsigned)std::min<long>(BH, choice.grid_cap);
  kernel<<<grid, threads, choice.smem, stream>>>(args..., (int)BH, Lp, choice.n_buf);
  return (int)cudaGetLastError();
}

// The streaming route's three launches for operand T at head dim D, one
// block per (head, 64 rows) each.
template <typename T, int D>
static int launch_stream(const void* q, const void* k, const void* v, const float* bias,
                         const void* g, const float* lse, float* dsum, uint32_t* bits, void* dq,
                         void* dk, void* dv, int B, int h, int L, float sm_scale,
                         float scale_log2, uint32_t seed, float p, float inv,
                         cudaStream_t stream) {
  const size_t rows_smem = ds_smem_bytes<T, D>(false), cols_smem = ds_smem_bytes<T, D>(true);
  int rc = allow_smem(dropattn_bwd_stream_rows_kernel<T, D, false>, rows_smem);
  if (rc == 0) rc = allow_smem(dropattn_bwd_stream_rows_kernel<T, D, true>, rows_smem);
  if (rc == 0) rc = allow_smem(dropattn_bwd_stream_cols_kernel<T, D>, cols_smem);
  if (rc != 0) return rc;
  const int n_t = (L + DS_TILE - 1) / DS_TILE;
  if ((long)B * h * n_t > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((long)B * h * n_t);
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v, *tg = (const T*)g;
  dropattn_bwd_stream_rows_kernel<T, D, false><<<grid, DS_THREADS, rows_smem, stream>>>(
      tq, tk, tv, bias, tg, lse, dsum, bits, nullptr, h, L, n_t, sm_scale, scale_log2, seed, p,
      inv);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dropattn_bwd_stream_rows_kernel<T, D, true><<<grid, DS_THREADS, rows_smem, stream>>>(
      tq, tk, tv, bias, tg, lse, dsum, bits, (T*)dq, h, L, n_t, sm_scale, scale_log2, seed, p,
      inv);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dropattn_bwd_stream_cols_kernel<T, D><<<grid, DS_THREADS, cols_smem, stream>>>(
      tq, tk, tv, bias, tg, lse, dsum, bits, (T*)dk, (T*)dv, h, L, n_t, sm_scale, scale_log2, p,
      inv);
  return (int)cudaGetLastError();
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype: 0 f32, 1 bf16. q, k, v, g, dq, dk, dv: [B, h, L, d] contiguous;
//   bias: [B, L] f32; lse: [B, h, L] f32 from the forward; 0 <= p < 1, inv =
//   1 / (1 - p) rounded to f32; sm_scale = 1 / sqrt(d) and scale_log2 =
//   log2(e) / sqrt(d) in f32 (the bf16 kernels' exponent).
//   Each returns cudaGetLastError() after its launches.
//
//   The resident route: dtype 1 (bf16) at d = 16, 32 or 64, dtype 0 (f32) at
//   d = 64, at any L whose head fits a block's shared memory (dt_smem_bytes
//   with one buffer) in at most 512 threads: L <= 256 for bf16 at d = 16
//   and 32, 208 at d = 64, 128 for f32; others are refused. Launches one
//   kernel: blocks of L / 16 warps (L rounded up to 16), as many as fit the
//   card at once (at most one per head), each walking its heads (launch_tc):
//   dropattn_bwd_tc_3pass_kernel<16> for bf16 at d = 16,
//   dropattn_bwd_tc_kernel<D> for bf16 at d = 32 and 64,
//   dropattn_bwd_tc_tf32_kernel<64> for f32.
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
#define SSKD_BF_ARGS \
  (const bf*)q, (const bf*)k, (const bf*)v, bias, (const bf*)g, lse, (bf*)dq, (bf*)dk, (bf*)dv, \
      h, L, sm_scale, scale_log2, seed, p, inv
  if (dtype == 1 && d == 16)
    return launch_tc(dropattn_bwd_tc_3pass_kernel<16>, dt3_smem_bytes<16>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (dtype == 1 && d == 32)
    return launch_tc(dropattn_bwd_tc_kernel<32>, dt_smem_bytes<bf, 32>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (dtype == 1 && d == 64)
    return launch_tc(dropattn_bwd_tc_kernel<64>, dt_smem_bytes<bf, 64>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (dtype == 0 && d == 64)
    return launch_tc(dropattn_bwd_tc_tf32_kernel<64>, dt_smem_bytes<float, 64>, 256, BH, L, s,
                     (const float*)q, (const float*)k, (const float*)v, bias, (const float*)g,
                     lse, (float*)dq, (float*)dk, (float*)dv, h, L, sm_scale, seed, p, inv);
  return (int)cudaErrorInvalidValue;
}

//   Either bf16 resident kernel at d = 16, 32 or 64, for the probes that
//   time them side by side (tools/probe_dropattn16.py, chip_smoke.py): kernel
//   0 dropattn_bwd_tc_kernel<D> (the [Lp, Lp] buffer), 1
//   dropattn_bwd_tc_3pass_kernel<D>; the wrapper's route is
//   sskd_dropattn_bwd_tc. Arguments as there, bf16 only.
extern "C" int sskd_dropattn_bwd_tc_kernel(int kernel, const void* q, const void* k,
                                           const void* v, const float* bias, const void* g,
                                           const float* lse, void* dq, void* dk, void* dv, int B,
                                           int h, int L, int d, float sm_scale, float scale_log2,
                                           uint32_t seed, float p, float inv, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || !(p >= 0.f && p < 1.f)) return (int)cudaErrorInvalidValue;
  const long BH = (long)B * h;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (kernel == 0 && d == 16)
    return launch_tc(dropattn_bwd_tc_kernel<16>, dt_smem_bytes<bf, 16>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (kernel == 0 && d == 32)
    return launch_tc(dropattn_bwd_tc_kernel<32>, dt_smem_bytes<bf, 32>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (kernel == 0 && d == 64)
    return launch_tc(dropattn_bwd_tc_kernel<64>, dt_smem_bytes<bf, 64>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (kernel == 1 && d == 16)
    return launch_tc(dropattn_bwd_tc_3pass_kernel<16>, dt3_smem_bytes<16>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (kernel == 1 && d == 32)
    return launch_tc(dropattn_bwd_tc_3pass_kernel<32>, dt3_smem_bytes<32>, 512, BH, L, s,
                     SSKD_BF_ARGS);
  if (kernel == 1 && d == 64)
    return launch_tc(dropattn_bwd_tc_3pass_kernel<64>, dt3_smem_bytes<64>, 512, BH, L, s,
                     SSKD_BF_ARGS);
#undef SSKD_BF_ARGS
  return (int)cudaErrorInvalidValue;
}

//   The streaming route: dtype 0 or 1 at d = 16, 32 or 64, any L (other head
//   dims are refused). dsum: [B, h, L] f32 and bits: [B*h, L, ceil(L / 32)]
//   uint32, scratch that the first kernel writes (D and the keep bits) and
//   the other two read. Launches K1, K2 and K3 on the stream, each
//   B * h * ceil(L / 64) blocks of 128 threads (launch_stream).
extern "C" int sskd_dropattn_bwd_stream(int dtype, const void* q, const void* k, const void* v,
                                        const float* bias, const void* g, const float* lse,
                                        float* dsum, uint32_t* bits, void* dq, void* dk,
                                        void* dv, int B, int h, int L, int d, float sm_scale,
                                        float scale_log2, uint32_t seed, float p, float inv,
                                        void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0 || !(p >= 0.f && p < 1.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (dtype == 1 && d == 16)
    return launch_stream<bf, 16>(q, k, v, bias, g, lse, dsum, bits, dq, dk, dv, B, h, L,
                                 sm_scale, scale_log2, seed, p, inv, s);
  if (dtype == 0 && d == 16)
    return launch_stream<float, 16>(q, k, v, bias, g, lse, dsum, bits, dq, dk, dv, B, h, L,
                                    sm_scale, scale_log2, seed, p, inv, s);
  if (dtype == 1 && d == 32)
    return launch_stream<bf, 32>(q, k, v, bias, g, lse, dsum, bits, dq, dk, dv, B, h, L,
                                 sm_scale, scale_log2, seed, p, inv, s);
  if (dtype == 1 && d == 64)
    return launch_stream<bf, 64>(q, k, v, bias, g, lse, dsum, bits, dq, dk, dv, B, h, L,
                                 sm_scale, scale_log2, seed, p, inv, s);
  if (dtype == 0 && d == 32)
    return launch_stream<float, 32>(q, k, v, bias, g, lse, dsum, bits, dq, dk, dv, B, h, L,
                                    sm_scale, scale_log2, seed, p, inv, s);
  if (dtype == 0 && d == 64)
    return launch_stream<float, 64>(q, k, v, bias, g, lse, dsum, bits, dq, dk, dv, B, h, L,
                                    sm_scale, scale_log2, seed, p, inv, s);
  return (int)cudaErrorInvalidValue;
}
