// mma_common.cuh: tensor-core helpers for sm_90a shared by the kernels:
// cp.async copies into shared memory, ldmatrix (plain and transposed),
// mma.sync m16n8k16 with bf16 operands and f32 accumulators (the attention
// kernels), mma.sync m16n8k8 with tf32 operands as three products for f32
// (the f32 attention kernels), mma.sync m16n8k32 with s8
// operands and exact s32 sums over
// padded rows of int8 (the top-k kernels: binmax.cu, bin_gather.cu,
// cell_gather.cu), the unpack of packed int4 rows into s8 fragments, the
// exact split of an f32 query into three bf16 terms (bf16 rows on the tensor
// cores in bin_gather.cu), and the exact widening of bf16 rows to f32.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * grp + tig, grp 0..7,
// tig 0..3), two 16-bit values per 32-bit register:
//   A 16x16: a0 (row grp, k 2tig..+1), a1 (row grp+8, same k),
//            a2 (row grp, k 2tig+8..+9), a3 (row grp+8, k 2tig+8..+9)
//   B 16x8:  b0 (k 2tig..+1, col grp), b1 (k 2tig+8..+9, col grp)
//   C 16x8:  c0, c1 (row grp, cols 2tig, 2tig+1), c2, c3 (row grp+8, same cols)
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 and
// packed in pairs, are the A fragment of a 16-deep product over those 16
// columns: a score tile feeds the next product from registers.
//
// ldmatrix.x4 loads four 8x8 b16 matrices; lane l gives the address of row
// l % 8 of matrix l / 8, so any permutation of the rows is free. Without
// .trans, register i of lane l holds (row grp, cols 2tig..+1) of matrix i;
// with .trans it holds (rows 2tig..+1, col grp).
//
// Fragment layouts of mma.sync.m16n8k32 s8 (four 8-bit values per register):
//   A 16x32: a0 (row grp, k 4tig..+3), a1 (row grp+8, same k),
//            a2 (row grp, k 16+4tig..+3), a3 (row grp+8, k 16+4tig..+3)
//   B 32x8:  b0 (k 4tig..+3, col grp), b1 (k 16+4tig..+3, col grp)
//   C 16x8:  c0, c1 (row grp, cols 2tig, 2tig+1), c2, c3 (row grp+8), s32
// so the A fragment of 16 rows x 32 bytes is one ldmatrix.x4 whose matrices
// are (rows 0-7, bytes 0-15), (rows 8-15, bytes 0-15), (rows 0-7, bytes
// 16-31), (rows 8-15, bytes 16-31): s8_a_offset.

#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace sskd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes global -> shared, asynchronous (both 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// the 128-byte line holding p into L1, without waiting for it
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a b for one 16x8 tile, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (one MUFU op; ex2.approx is accurate to
// 2 ulp, and +0 at -inf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -FLT_MAX / 2;  // finfo(float32).min / 2, the repo's sentinel

// The two bf16 values of a 32-bit word, widened to f32 exactly (a bf16 is the
// high half of an f32); the value at the lower address is the low half.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// --- f32 on the tensor cores as three TF32 products ---------------------------
//
// Fragment layouts of mma.sync.m16n8k8 with tf32 operands (one value per
// 32-bit register; lane = 4 * grp + tig):
//   A 16x8: a0 (row grp, k tig), a1 (row grp+8, k tig),
//           a2 (row grp, k tig+4), a3 (row grp+8, k tig+4)
//   B 8x8:  b0 (k tig, col grp), b1 (k tig+4, col grp)
//   C 16x8: as m16n8k16's: c0, c1 (row grp, cols 2tig, 2tig+1), c2, c3 (row grp+8)
// So the C fragment of a score tile is the A fragment of an 8-deep product
// over its 8 columns when column 2tig is taken as k = tig and 2tig+1 as
// k = tig+4: a0 = c0, a1 = c2, a2 = c1, a3 = c3.
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact
// in f32), and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 sums (the
// small terms apart, mma_3xtf32); what is dropped, lo_a lo_b and the
// rounding of lo, is about 2^-21 of |a b|, which keeps the f32 function of a
// product at the tensor cores' TF32 rate over three passes.

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), low 13 bits 0:
// what cvt.rna.tf32.f32 gives for finite x, in two integer operations (half
// of the dropped bits added to the pattern, then cleared) on the full-rate
// pipes, where the conversion instruction made the f32 flash slower
// (tools/probe_attention64.py times both and holds them bit for bit)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the two TF32 terms of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// the hi and lo terms of an A fragment (4 values) in fragment order
__device__ __forceinline__ void split_tf32_a(const float (&x)[4], uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// c += a b for one 16x8 tile, one 8-deep step, tf32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c + c_lo += a b in f32 as three tf32 products, for A split into (ah, al)
// and the B values b0, b1 (split here): hi hi into c, lo hi and hi lo into
// c_lo. The tensor cores truncate each step's sum toward zero to f32, so
// each mma into the accumulator loses up to an ulp of it; keeping the small
// terms apart leaves c one truncation a step instead of three (c_lo is
// ~2^-11 of c, its truncations ~2^-11 as large). The caller adds c_lo into
// c once, when the sum is done.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], float (&c_lo)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c_lo, al, h0, h1);
  mma_tf32(c_lo, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// c += c_lo, element by element (the end of a 3xTF32 sum)
__device__ __forceinline__ void fold_lo(float (&c)[4], const float (&c_lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += c_lo[e];
}

// --- int8 rows on the tensor cores ------------------------------------------

// shared row stride of an int8 tile: the row rounded up to 32 bytes (the
// mma's depth), plus 16 so that ldmatrix's eight row addresses fall in eight
// different 16-byte bank groups
__host__ __device__ constexpr int tc_stride(int row_bytes) {
  return (row_bytes + 31) / 32 * 32 + 16;
}

// the byte offset, in a 16-row tile of stride ld, of the row that `lane`
// hands ldmatrix_x4 for the A fragment of the tile's first 32 bytes
__device__ __forceinline__ int s8_a_offset(int ld, int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 16;
}

// c += a b for one 16x8 tile, s8 operands (32 deep), exact s32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- packed int4 rows on the tensor cores (binmax.cu, gather_tc.cuh) ---------

// The s8 A fragments of a packed int4 step from the four registers one
// ldmatrix_x4 gives over its 32 bytes a row: lo those of the low nibbles
// (dims 32 ks ..), hi those of the high nibbles (dims D/2 + 32 ks ..). A
// stored nibble n is the value n - 8; it goes to the high half of its byte
// with the top bit flipped, the s8 value 16 (n - 8): the sums are 16 times
// the dot, exact in int32 (|dot| <= 8 * 127 * D), and i4_dot shifts them back.
// A zero-filled byte (a row's tail, a row past the corpus) reads as -8 in both
// halves: the tail meets zero query lanes, and rows past the corpus are masked.
__device__ __forceinline__ void unpack_i4(const uint32_t (&p)[4], uint32_t (&lo)[4],
                                          uint32_t (&hi)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lo[r] = ((p[r] << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
    hi[r] = (p[r] & 0xF0F0F0F0u) ^ 0x80808080u;
  }
}
__device__ __forceinline__ int i4_dot(int acc) { return acc >> 4; }  // exact: a multiple of 16

// --- an f32 query against bf16 rows on the tensor cores (gather_tc.cuh) ------
//
// An f32 x is the exact sum of three bf16 terms: t0 = bf16(x), t1 =
// bf16(x - t0), t2 = x - t0 - t1 (each difference exact in f32, and t2
// holds at most 8 significant bits, so it is a bf16 value), for every x
// whose t0 is finite. With the terms as three columns of a B fragment, one
// bf16 mma gives the three partial dots of a row with the f32 query, each
// product exact in f32.

// x rounded to bf16 (to nearest even), as an f32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// term t (0, 1 or 2) of x, as an f32 holding a bf16 value (t1 rounded by
// the caller's pack_bf16)
__device__ __forceinline__ float bf16_term(float x, int t) {
  if (t == 0) return x;
  const float r = x - bf16_round(x);
  return t == 1 ? r : r - bf16_round(r);
}

}  // namespace sskd
