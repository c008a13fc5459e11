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
// At the teacher's scoring shape [32, 16, 512, 64] the bytes are 268 MB in
// f32 (0.080 ms; bf16 0.040 ms) and the operations 4 * B*h*L^2*d = 34.4 GFLOP:
// 0.069 ms at TF32's 495 TFLOP/s, 0.035 ms at bf16's 989, but the f32 route
// makes three TF32 passes (0.21 ms), and on the CUDA cores' FMA (67 TFLOP/s)
// the same work takes 0.513 ms. The exp floor is B*h*L^2 = 134 M exps, ~0.03 ms.
// At the f32 encode shape [256, 12, 512, 32] (the evaluator's student) the
// bytes are 805 MB (0.240 ms) and the three TF32 passes of 103 GFLOP 0.625
// ms (the same products on the FMA 1.538 ms); at head dim 16 the bytes bound
// the tiny models' lengths.
//
// Two routes, chosen by the wrapper (ops/attention.py flash_route) from the
// dtype, both on the tensor cores:
//
// 1. bf16, d in {16, 32, 64}: flash_fwd_tc_kernel<32> and
//    flash_fwd_tc2_kernel<D, MT, MINB> at 16 and 64, on the tensor cores
//    (FlashAttention-2 shape). Query rows go in m-tiles
//    of 16, whose q stays in registers as mma A fragments (D / 16 k-steps);
//    a block has 4 warps, each owning one m-tile at d = 32 (64 rows) and two
//    at d = 64 (128 rows, FlashAttention-2's shape for that head dim), where
//    each K and V tile a block copies from L2 then serves twice the rows
//    that it did at 64 (the copies bounded the 64-row kernel) and each K and
//    V fragment a warp reads feeds both m-tiles, two blocks an SM; at d = 16
//    (the tiny models' encode at L = 512) the m-tiles and blocks an SM that
//    tools/probe_flash16.py chose (FT16_MT, FT16_MINB).
//    K and V tiles of 64 keys are double-buffered in shared memory by
//    cp.async (rows padded to D + 8 bf16, 48, 80 or 144 bytes, so ldmatrix reads
//    them without bank conflicts). Per tile a warp computes S = q k^T with
//    mma.sync m16n8k16 (f32 sums), runs the online softmax on the
//    accumulator fragments, and feeds p, rounded to bf16, straight from
//    registers as the A operand of p.v (V through ldmatrix.trans; D / 8
//    output tiles of 8). Exactly one exp per score: the scale and log2(e)
//    are folded into the scores, so each exp is one ex2.approx, and on a tile
//    whose 64 keys are all live (every tile of a full row) its exponent is
//    one fma of the raw sum, with no mask applied; ops/attention.py
//    flash_error_bound derives what that and the tensor cores' f32 sums add
//    to the error. D = 32 is the code of the first tensor-core kernel. At
//    d = 16 one ex2 a score is the highest floor: at [256, 4, 512, 16] 268 M
//    of them at 16 a clock an SM take 0.064 ms, the bytes 0.020 and the
//    products 0.017 at bf16's peak.
// 2. f32, d in {16, 32, 64} (the teacher computes in f32, and so do the
//    evaluator's student and the tiny models): flash_fwd_tc_tf32_kernel<D>,
//    the same blocks and tiles with f32 rows padded to D + 4 floats (20, 36,
//    68: 4 mod 16), each product mma.sync m16n8k8 on tf32 operands as three
//    products (mma_common.cuh 3xTF32: about 2^-21 of each product, f32
//    sums), so the f32 function holds to 1e-5 of the plain version where
//    one TF32 pass is off by ~1e-3. S takes D / 8 k-steps and p v D / 8
//    output tiles.
//    The fragments are plain 32-bit shared-memory reads (ldmatrix moves b16):
//    q's once per block into registers, K's and V's at each use, each split
//    into hi and lo where it is used (two integer operations a term), the
//    small products in accumulators of their own. A score tile's C fragment
//    is the A fragment of its p.v step when column 2tig is taken as k = tig
//    and 2tig + 1 as k = tig + 4, so p stays in registers, and V is read as
//    rows 2tig and 2tig + 1 (no bank conflict at a stride of D + 4:
//    tests/test_torch_attention.py checks 16, 32 and 64). The softmax is the plain version's, in
//    natural units: p = expf(s - m), nothing rounded but by the products.
//    At d = 32 and 16 the head-dim-64 kernel itself won a probe of other
//    schedules on an H100 (tools/probe_attention_f32.py, all of them the
//    same bits): at [256, 12, 512, 32] it takes 2.45 ms (46.6 KB of shared
//    memory, 155 registers, no spill), against 2.76-3.55 ms with each K and
//    V tile split into its TF32 terms once for the block (the terms double
//    the tile's shared memory and its fragment reads' bytes, and two 8-warp
//    blocks an SM cap the registers at 128, where those kernels spill),
//    2.50 ms with 8 warps a block and 2.43 ms with q split once and S an
//    8-key tile at a time (within the noise, at 157 registers); two m-tiles
//    a warp would pass the 255 registers a thread may hold. The CUDA-core
//    kernel it replaced took 4.63 ms there and SDPA 5.90 ms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <float.h>
#include <math.h>

#include "mma_common.cuh"

namespace sskd {

constexpr float FA_NEG = -FLT_MAX / 2;

// ---------------------------------------------------------------------------
// Route 1: bf16, d in {16, 32, 64}, tensor cores
// ---------------------------------------------------------------------------

constexpr int FT_KB = 64;  // keys per tile

constexpr int FT_QB = 64;  // query rows per block: 4 warps x 16
constexpr int FT_THREADS = FT_QB * 2;  // a warp per 16 query rows

// D: the head dim, instantiated at 32 (d = 16 and 64 take flash_fwd_tc2_kernel
// below: built on this template, the two-tile kernel cost d = 32 3-11 % in
// tools/probe_attention64.py). Shared rows are padded to D + 8 bf16 (80
// bytes: 5 units of 16 bytes, so ldmatrix's eight row addresses fall in
// eight bank groups). The copy loops count in unsigned ints, so that the
// divisions by powers of two are shifts (signed, they slow the D = 32
// kernel: tools/probe_attention64.py).
template <int D>
__global__ void __launch_bounds__(FT_THREADS) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int h, int L, int n_qt, float scale_log2) {
  constexpr int LD = D + 8;
  constexpr unsigned CH = D / 8;  // 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 s_q[FT_QB * LD];
  __shared__ __align__(16) __nv_bfloat16 s_k[2][FT_KB * LD];
  __shared__ __align__(16) __nv_bfloat16 s_v[2][FT_KB * LD];
  __shared__ float s_keep[2][FT_KB];  // 1 keep, 0 masked, -1 past L

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * FT_QB;
  const long head_off = bh * (long)L * D;
  const __nv_bfloat16* qh = q + head_off;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;
  const int* mrow = mask + (bh / h) * L;

  // rows past L are copied as zeros (cp.async with 0 source bytes)
  for (unsigned i = tid; i < FT_QB * CH; i += FT_THREADS) {
    const int r = i / CH, c = (i % CH) * 8, qr = q0 + r;
    cp_async16(s_q + r * LD + c, qh + (long)min(qr, L - 1) * D + c, qr < L ? 16 : 0);
  }
  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < FT_KB * CH * 2; i += FT_THREADS) {
      const int which = i / (FT_KB * CH), j = i % (FT_KB * CH);  // the chunks of K, then of V
      const int r = j / CH, c = (j % CH) * 8, kr = k0 + r;
      const __nv_bfloat16* src = (which ? vh : kh) + (long)min(kr, L - 1) * D + c;
      __nv_bfloat16* dst = (which ? s_v[stage] : s_k[stage]) + r * LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < FT_KB) {
      const int kr = k0 + tid;
      s_keep[stage][tid] = kr < L ? (mrow[kr] != 0 ? 1.f : 0.f) : -1.f;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qa[D / 16][4];  // A fragments of the warp's 16 query rows, 16 d each
  float o[D / 8][4];       // 16 rows x D, f32
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
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
      for (int ks = 0; ks < D / 16; ++ks)
        ldmatrix_x4(qa[ks], s_q + (warp * 16 + mr + (mi & 1) * 8) * LD + ks * 16 + (mi >> 1) * 8);
    }
    const __nv_bfloat16* sk = s_k[t & 1];
    const __nv_bfloat16* sv = s_v[t & 1];
    const float* keep = s_keep[t & 1];

    // S = q k^T, 8 tiles of 8 keys, 32 d an ldmatrix
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 32; ++kc) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sk + (nt * 8 + mr) * LD + kc * 32 + mi * 8);
        mma_bf16(s[nt], qa[2 * kc], kb[0], kb[1]);
        mma_bf16(s[nt], qa[2 * kc + 1], kb[2], kb[3]);
      }
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
    for (int dn = 0; dn < D / 8; ++dn) {
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
    // o += p v over the tile's 4 steps of 16 keys, 16 d an ldmatrix
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int half = 0; half < D / 16; ++half) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv + (ks * 16 + mr + (mi & 1) * 8) * LD + half * 16 + (mi >> 1) * 8);
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
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + head_off + (long)row * D + 2 * tig);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        dst[dn * 4] = pack_bf16(o[dn][2 * r] / denom, o[dn][2 * r + 1] / denom);
    }
  }
}

// MT 16-row m-tiles a warp, 4 warps: 64 MT query rows a block, so each K
// and V tile a block copies from L2 serves MT times the rows that the 64-row
// kernel above serves it, and each K and V fragment a warp reads from shared
// memory feeds every m-tile. Each row's arithmetic is the kernel's above,
// bit for bit. MINB blocks an SM bound the registers (__launch_bounds__).
//
// D = 64 at MT 2, MINB 2 (FlashAttention-2's shape for this head dim: at 64
// rows a block the copies bounded the kernel, tools/probe_attention64.py):
// 230 registers, 55.8 KB of dynamic shared memory (q, two stages of K and V,
// their keep flags). D = 16 at MT 2, MINB 4: S takes one k-step, K read as
// 16-d fragments (one ldmatrix_x4 covers two 8-key tiles), rows padded to 24
// bf16 (48 bytes, three 16-byte units: ldmatrix's eight row addresses fall in
// eight bank groups); 120 registers, 18.9 KB of shared memory, four blocks an
// SM. Of eight schedules with the same bits (tools/probe_flash16.py on an
// H100) it came first at [256, 4, 512, 16]: 0.155 ms on the card with a
// ragged mask, 0.141 with every key live, against 0.164 / 0.149 for one
// m-tile at eight blocks an SM (64 registers, 60 bytes of spill), 0.175 /
// 0.161 for one m-tile at 88 registers (five blocks) and two at 131 (three),
// 0.189 / 0.170 for four m-tiles (228), 0.788 for the CUDA-core kernel it
// replaced and 0.283 for SDPA. One ex2 a score takes 0.064 ms of the SFU
// there, the floor above the bytes' 0.020 ms.
constexpr int FT2_MT = 2;                  // m-tiles a warp at D = 64
constexpr int FT16_MT = 2, FT16_MINB = 4;  // at D = 16
__host__ __device__ constexpr size_t ft2_smem_bytes(int d, int mt) {
  return (size_t)(mt * FT_QB + 4 * FT_KB) * (d + 8) * 2 + 2 * FT_KB * 4;
}

template <int D, int MT, int MINB>
__global__ void __launch_bounds__(FT_THREADS, MINB) flash_fwd_tc2_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int h, int L, int n_qt, float scale_log2) {
  constexpr int QB = MT * FT_QB;
  constexpr int LD = D + 8;
  constexpr unsigned CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + QB * LD;         // [2][FT_KB * LD]
  __nv_bfloat16* s_v = s_k + 2 * FT_KB * LD;  // [2][FT_KB * LD]
  // [2][FT_KB]: 1 keep, 0 masked, -1 past L
  float* s_keep = reinterpret_cast<float*>(s_v + 2 * FT_KB * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QB;
  const long head_off = bh * (long)L * D;
  const __nv_bfloat16* qh = q + head_off;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;
  const int* mrow = mask + (bh / h) * L;

  // rows past L are copied as zeros (cp.async with 0 source bytes)
  for (unsigned i = tid; i < QB * CH; i += FT_THREADS) {
    const int r = i / CH, c = (i % CH) * 8, qr = q0 + r;
    cp_async16(s_q + r * LD + c, qh + (long)min(qr, L - 1) * D + c, qr < L ? 16 : 0);
  }
  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < FT_KB * CH * 2; i += FT_THREADS) {
      const int which = i / (FT_KB * CH), j = i % (FT_KB * CH);  // the chunks of K, then of V
      const int r = j / CH, c = (j % CH) * 8, kr = k0 + r;
      const __nv_bfloat16* src = (which ? vh : kh) + (long)min(kr, L - 1) * D + c;
      __nv_bfloat16* dst = (which ? s_v : s_k) + (stage * FT_KB + r) * LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < FT_KB) {
      const int kr = k0 + tid;
      s_keep[stage * FT_KB + tid] = kr < L ? (mrow[kr] != 0 ? 1.f : 0.f) : -1.f;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // the warp's m-tiles of 16 query rows: tile mt holds rows (warp MT + mt) 16 ..
  uint32_t qa[MT][D / 16][4];  // their A fragments, 16 d each
  float o[MT][D / 8][4];       // 16 rows x D each, f32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][i][e] = 0.f;
  float m2[MT][2], l[MT][2];  // rows grp and grp + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m2[mt][0] = m2[mt][1] = FA_NEG;
    l[mt][0] = l[mt][1] = 0.f;
  }

  const int n_kt = (L + FT_KB - 1) / FT_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FT_KB);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          ldmatrix_x4(qa[mt][ks], s_q + ((warp * MT + mt) * 16 + mr + (mi & 1) * 8) * LD +
                                      ks * 16 + (mi >> 1) * 8);
    }
    const __nv_bfloat16* sk = s_k + (t & 1) * FT_KB * LD;
    const __nv_bfloat16* sv = s_v + (t & 1) * FT_KB * LD;
    const float* keep = s_keep + (t & 1) * FT_KB;

    // S = q k^T, 8 tiles of 8 keys, each K fragment into every m-tile of the
    // warp
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
    if constexpr (D == 16) {
      // one k-step: matrices 0 and 1 are d 0-7 and 8-15 of keys 16 np .. + 7
      // (b0, b1 of tile 2 np), matrices 2 and 3 the same of the next 8 keys
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sk + (np * 16 + (mi >> 1) * 8 + mr) * LD + (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt][0], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt][0], kb[2], kb[3]);
        }
      }
    } else {
      // 32 d an ldmatrix: matrix i is d 8 i .. 8 i + 7 of the tile's 8 keys
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int kc = 0; kc < D / 32; ++kc) {
          uint32_t kb[4];
          ldmatrix_x4(kb, sk + (nt * 8 + mr) * LD + kc * 32 + mi * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][nt], qa[mt][2 * kc], kb[0], kb[1]);
            mma_bf16(s[mt][nt], qa[mt][2 * kc + 1], kb[2], kb[3]);
          }
        }
    }
    // The row max in log2 units. A tile whose 64 keys are all live (every
    // tile of a full row) needs no mask: its max is the max of the raw sums
    // times the scale (the rounded product is monotone), and each exponent
    // below is one fma. Otherwise each score is scaled or replaced by its
    // sentinel first.
    const bool live = __all_sync(0xffffffffu, keep[lane] > 0.f && keep[lane + 32] > 0.f);
    // the exponent of each p: s * scale - m in one fma on a live tile
    const float a_mul = live ? scale_log2 : 1.f;
    uint32_t pa[MT][4][4];  // p of each m-tile as bf16 A fragments, 16 keys each
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m2[mt][0], m2[mt][1]};
      if (live) {
        float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) raw[e >> 1] = fmaxf(raw[e >> 1], s[mt][nt][e]);
        mx[0] = fmaxf(mx[0], raw[0] * scale_log2);
        mx[1] = fmaxf(mx[1], raw[1] * scale_log2);
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kf = keep[nt * 8 + 2 * tig + (e & 1)];
            const float x = kf > 0.f ? s[mt][nt][e] * scale_log2 : (kf == 0.f ? FA_NEG : -INFINITY);
            s[mt][nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m2[mt][r] - mx[r]);
        m2[mt][r] = mx[r];
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[mt][dn][0] *= alpha[0];
        o[mt][dn][1] *= alpha[0];
        o[mt][dn][2] *= alpha[1];
        o[mt][dn][3] *= alpha[1];
      }
      // p = 2^(s - m): summed unrounded, then packed as bf16 A fragments
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2_approx(fmaf(s[mt][nt][0], a_mul, -m2[mt][0]));
        const float p1 = exp2_approx(fmaf(s[mt][nt][1], a_mul, -m2[mt][0]));
        const float p2 = exp2_approx(fmaf(s[mt][nt][2], a_mul, -m2[mt][1]));
        const float p3 = exp2_approx(fmaf(s[mt][nt][3], a_mul, -m2[mt][1]));
        l[mt][0] += p0 + p1;
        l[mt][1] += p2 + p3;
        pa[mt][nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
        pa[mt][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
    }
    // o += p v over the tile's 4 steps of 16 keys, 16 d an ldmatrix, each V
    // fragment into every m-tile
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int half = 0; half < D / 16; ++half) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv + (ks * 16 + mr + (mi & 1) * 8) * LD + half * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * half], pa[mt][ks], vb[0], vb[1]);
          mma_bf16(o[mt][2 * half + 1], pa[mt][ks], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for tile t + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      const int row = q0 + (warp * MT + mt) * 16 + grp + 8 * r;
      if (row < L) {
        const float denom = fmaxf(l[mt][r], 1e-30f);
        uint32_t* dst = reinterpret_cast<uint32_t*>(out + head_off + (long)row * D + 2 * tig);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          dst[dn * 4] = pack_bf16(o[mt][dn][2 * r] / denom, o[mt][dn][2 * r + 1] / denom);
      }
    }
}

// ---------------------------------------------------------------------------
// Route 2: f32, d in {16, 32, 64}, tensor cores as three TF32 products
// ---------------------------------------------------------------------------

constexpr int FF_KB = 64;  // keys per tile

// Dynamic shared memory of the f32 route at head dim d: q, two stages of K
// and V (rows padded to d + 4 floats), the keep flags (87.5 KB at d = 64: two
// blocks an SM; 46.6 KB at 32, 26.1 KB at 16).
__host__ __device__ constexpr size_t ff_smem_bytes(int d) {
  return (size_t)(FT_QB + 4 * FF_KB) * (d + 4) * 4 + 2 * FF_KB * 4;
}

template <int D>
__global__ void __launch_bounds__(FT_THREADS) flash_fwd_tc_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, float* __restrict__ out, int h, int L, int n_qt,
    float sm_scale) {
  constexpr int FF_LD = D + 4;  // shared row stride in floats (68 = 4 mod 32 at D = 64)
  constexpr unsigned CH = D / 4;  // 16-byte chunks a row
  constexpr int NT = FF_KB / 8;  // 8-key tiles a tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + FT_QB * FF_LD;       // [2][FF_KB * FF_LD]
  float* s_v = s_k + 2 * FF_KB * FF_LD;   // [2][FF_KB * FF_LD]
  float* s_keep = s_v + 2 * FF_KB * FF_LD;  // [2][FF_KB]: 1 keep, 0 masked, -1 past L

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * FT_QB;
  const long head_off = bh * (long)L * D;
  const float* qh = q + head_off;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const int* mrow = mask + (bh / h) * L;

  for (unsigned i = tid; i < FT_QB * CH; i += FT_THREADS) {
    const int r = i / CH, c = (i % CH) * 4, qr = q0 + r;
    cp_async16(s_q + r * FF_LD + c, qh + (long)min(qr, L - 1) * D + c, qr < L ? 16 : 0);
  }
  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < FF_KB * CH * 2; i += FT_THREADS) {
      const int which = i / (FF_KB * CH), j = i % (FF_KB * CH);
      const int r = j / CH, c = (j % CH) * 4, kr = k0 + r;
      const float* src = (which ? vh : kh) + (long)min(kr, L - 1) * D + c;
      float* dst = (which ? s_v : s_k) + stage * FF_KB * FF_LD + r * FF_LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < FF_KB) {
      const int kr = k0 + tid;
      s_keep[stage * FF_KB + tid] = kr < L ? (mrow[kr] != 0 ? 1.f : 0.f) : -1.f;
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
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};  // rows grp and grp + 8, natural units

  const int n_kt = (L + FF_KB - 1) / FF_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FF_KB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      const float* qr = s_q + (warp * 16 + grp) * FF_LD + tig;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        qa[ks][0] = qr[ks * 8];
        qa[ks][1] = qr[8 * FF_LD + ks * 8];
        qa[ks][2] = qr[ks * 8 + 4];
        qa[ks][3] = qr[8 * FF_LD + ks * 8 + 4];
      }
    }
    const float* sk = s_k + (t & 1) * FF_KB * FF_LD;
    const float* sv = s_v + (t & 1) * FF_KB * FF_LD;
    const float* keep = s_keep + (t & 1) * FF_KB;

    // S = q k^T, NT tiles of 8 keys: B fragment b0 = K[key grp][d tig], b1 at
    // d tig + 4 (banks 4 grp + tig: no conflict)
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
        const float* kr = sk + (nt * 8 + grp) * FF_LD + ks * 8 + tig;
        mma_3xtf32(s[nt], s_lo[nt], ah, al, kr[0], kr[4]);
      }
    }
    // the scores in natural units: a masked key finfo(f32).min / 2, a slot
    // past L -inf
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      fold_lo(s[nt], s_lo[nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kf = keep[nt * 8 + 2 * tig + (e & 1)];
        const float x = kf > 0.f ? s[nt][e] * sm_scale : (kf == 0.f ? FA_NEG : -INFINITY);
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
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
    // p = exp(s - m), summed, then o += p v: tile nt is one 8-deep step whose
    // k = tig is key 2tig and k = tig + 4 key 2tig + 1, so B is V[key 2tig]
    // and V[key 2tig + 1] at d grp (banks 8 tig + grp and + 4: no conflict);
    // the tile's small terms fold into o at its end
    float o_lo[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_lo[dn][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p[4] = {expf(s[nt][0] - m[0]), expf(s[nt][2] - m[1]),
                          expf(s[nt][1] - m[0]), expf(s[nt][3] - m[1])};  // a0..a3
      l[0] += p[0] + p[2];
      l[1] += p[1] + p[3];
      uint32_t ph[4], pl[4];
      split_tf32_a(p, ph, pl);
      const float* vr = sv + (nt * 8 + 2 * tig) * FF_LD + grp;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma_3xtf32(o[dn], o_lo[dn], ph, pl, vr[dn * 8], vr[FF_LD + dn * 8]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) fold_lo(o[dn], o_lo[dn]);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + grp + 8 * r;
    if (row < L) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* dst = out + head_off + (long)row * D + 2 * tig;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8) =
            make_float2(o[dn][2 * r] / denom, o[dn][2 * r + 1] / denom);
    }
  }
}

// A launch of the bf16 multi-tile flash at head dim D. Its shared memory
// passes 48 KB at d = 64: the attribute is set before each such launch.
template <int D, int MT, int MINB>
static int launch_tc2(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const int* mask, __nv_bfloat16* out, int B, int h, int L,
                      float scale_log2, cudaStream_t s) {
  constexpr size_t smem = ft2_smem_bytes(D, MT);
  if constexpr (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(flash_fwd_tc2_kernel<D, MT, MINB>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
    if (rc != 0) return rc;
  }
  const int n_qt = (L + MT * FT_QB - 1) / (MT * FT_QB);
  flash_fwd_tc2_kernel<D, MT, MINB><<<(unsigned)((long)B * h * n_qt), FT_THREADS, smem, s>>>(
      q, k, v, mask, out, h, L, n_qt, scale_log2);
  return 0;
}

// A launch of the f32 tensor-core flash at head dim D. Its shared memory
// passes 48 KB at d = 64: the attribute is set once, on the first launch.
template <int D>
static int launch_tf32(const float* q, const float* k, const float* v, const int* mask,
                       float* out, int B, int h, int L, float sm_scale, cudaStream_t s) {
  constexpr size_t smem = ff_smem_bytes(D);
  static const int attr = (int)cudaFuncSetAttribute(
      flash_fwd_tc_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != 0) return attr;
  const int n_qt = (L + FT_QB - 1) / FT_QB;
  flash_fwd_tc_tf32_kernel<D><<<(unsigned)((long)B * h * n_qt), FT_THREADS, smem, s>>>(
      q, k, v, mask, out, h, L, n_qt, sm_scale);
  return 0;
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   dtype 1 (bf16) or 0 (f32) at d = 16, 32 or 64, each on the tensor cores
//   (others are refused); q, k, v, out [B, h, L, d] contiguous, mask
//   [B, L] int32; sm_scale = 1 / sqrt(d) (the f32 route) and scale_log2 =
//   log2(e) / sqrt(d) (the bf16 route), both in f32.
extern "C" int sskd_flash_attn_fwd_tc(int dtype, const void* q, const void* k, const void* v,
                                      const int* mask, void* out, int B, int h, int L, int d,
                                      float sm_scale, float scale_log2, void* stream) {
  using namespace sskd;
  if (B <= 0 || h <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && d == 32) {
    const int n_qt = (L + FT_QB - 1) / FT_QB;
    flash_fwd_tc_kernel<32><<<(unsigned)((long)B * h * n_qt), FT_THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, mask,
        (__nv_bfloat16*)out, h, L, n_qt, scale_log2);
  } else if (dtype == 1 && (d == 16 || d == 64)) {
    const __nv_bfloat16* bq = (const __nv_bfloat16*)q;
    const __nv_bfloat16* bk = (const __nv_bfloat16*)k;
    const __nv_bfloat16* bv = (const __nv_bfloat16*)v;
    __nv_bfloat16* bo = (__nv_bfloat16*)out;
    const int rc =
        d == 64 ? launch_tc2<64, FT2_MT, 2>(bq, bk, bv, mask, bo, B, h, L, scale_log2, s)
                : launch_tc2<16, FT16_MT, FT16_MINB>(bq, bk, bv, mask, bo, B, h, L, scale_log2, s);
    if (rc != 0) return rc;
  } else if (dtype == 0 && (d == 16 || d == 32 || d == 64)) {
    const float* fq = (const float*)q;
    const float* fk = (const float*)k;
    const float* fv = (const float*)v;
    float* fo = (float*)out;
    const int rc = d == 64   ? launch_tf32<64>(fq, fk, fv, mask, fo, B, h, L, sm_scale, s)
                   : d == 32 ? launch_tf32<32>(fq, fk, fv, mask, fo, B, h, L, sm_scale, s)
                             : launch_tf32<16>(fq, fk, fv, mask, fo, B, h, L, sm_scale, s);
    if (rc != 0) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
