// Shared inner loop of the two exact-search kernels (binmax.cu, bin_gather.cu).
//
// One thread block of BIN_W = 128 threads owns one 128-row bin of the corpus;
// thread t owns row bin * 128 + t. The block walks the row bytes in chunks of
// CW 32-bit words: each chunk of all 128 rows is staged into shared memory with
// coalesced 16-byte loads (8 threads cover one row's 128 bytes), then every
// thread dots its own row against a tile of QT queries that sit in shared
// memory and are read as broadcasts. Scores stay in registers; nothing of the
// [B, N] score matrix is written to device memory.
//
// Storage modes (the corpus layouts of ops/quant.py):
//   F32: rows are D floats, queries D floats, FMA in f32.
//   BF16: rows are D bf16 (two a word), queries D floats; each bf16 widened to
//        f32 exactly (a 16-bit shift), FMA in f32, one chain in order over k.
//   I8 : rows are D int8, queries D int8 (quantized by the caller), dp4a into int32.
//   I4 : rows are D/2 bytes, byte j holds dim j in its low nibble and dim j + D/2
//        in its high nibble, both biased by +8 ("halves" layout). The nibbles are
//        unpacked in registers with per-byte subtract (__vsub4) and dotted against
//        the matching query halves with dp4a.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"  // NEG_INF, bf16_lo / bf16_hi

namespace sskd {

constexpr int BIN_W = 128;     // rows per bin == threads per block
constexpr int CW = 32;         // row words (128 bytes) staged per chunk
constexpr int RS = CW + 4;     // padded shared-memory row stride: conflict-free 16-byte reads

enum Mode { F32 = 0, I8 = 1, I4 = 2, BF16 = 3 };

template <int MODE> struct AccT { typedef int type; };
template <> struct AccT<F32> { typedef float type; };
template <> struct AccT<BF16> { typedef float type; };

// Query words per chunk: I4 needs the low-half and the high-half query words,
// BF16 the two floats of each row word's two values.
template <int MODE> struct QWords {
  static constexpr int value = (MODE == I4 || MODE == BF16) ? 2 * CW : CW;
};

__device__ __forceinline__ int nib_lo(uint32_t p) { return (int)__vsub4(p & 0x0F0F0F0Fu, 0x08080808u); }
__device__ __forceinline__ int nib_hi(uint32_t p) { return (int)__vsub4((p >> 4) & 0x0F0F0F0Fu, 0x08080808u); }

// Computes acc[j] = <row(row0 + tid), query(q0 + j)> for j < QT over all row words.
// Queries j >= nq are zero-filled and give 0. Rows >= n_rows are zero-filled.
//   q          : [B, q_row_words] 32-bit words (f32 or packed int8)
//   corpus     : [n_rows, row_words] 32-bit words
//   s_rows     : shared, BIN_W * RS words;  s_q: shared, QT * QWords words
template <int MODE, int QT>
__device__ __forceinline__ void bin_dot(
    typename AccT<MODE>::type (&acc)[QT],
    const uint32_t* __restrict__ q, int q0, int nq,
    const uint32_t* __restrict__ corpus, long row0, long n_rows, int row_words,
    uint32_t* s_rows, uint32_t* s_q) {
  constexpr int QW = QWords<MODE>::value;
  const int tid = threadIdx.x;
  const int q_row_words = (MODE == I4 || MODE == BF16) ? 2 * row_words : row_words;
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = 0;

  for (int c0 = 0; c0 < row_words; c0 += CW) {
    const int cw = min(CW, row_words - c0);  // a multiple of 4 (checked by the wrapper)
    __syncthreads();  // the previous chunk has been consumed
    // stage 128 rows x CW words: 1024 16-byte pieces, 8 per thread
    for (int i = tid; i < BIN_W * (CW / 4); i += BIN_W) {
      const int r = i / (CW / 4), v = i % (CW / 4);
      const long gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && v * 4 < cw)
        val = *reinterpret_cast<const uint4*>(corpus + gr * row_words + c0 + v * 4);
      *reinterpret_cast<uint4*>(s_rows + r * RS + v * 4) = val;
    }
    // stage the query tile's words of this chunk
    for (int i = tid; i < QT * QW; i += BIN_W) {
      const int j = i / QW, w = i % QW;
      uint32_t val = 0u;
      if (j < nq) {
        const uint32_t* qrow = q + (long)(q0 + j) * q_row_words;
        if (MODE == I4) {
          const int half = w / CW, ww = w % CW;
          if (ww < cw) val = qrow[half * row_words + c0 + ww];
        } else if (MODE == BF16) {
          if (w < 2 * cw) val = qrow[2 * c0 + w];
        } else if (w < cw) {
          val = qrow[c0 + w];
        }
      }
      s_q[i] = val;
    }
    __syncthreads();
    const uint32_t* my_row = s_rows + tid * RS;
#pragma unroll
    for (int w = 0; w < CW; w += 4) {
      const uint4 rv = *reinterpret_cast<const uint4*>(my_row + w);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (MODE == F32) {
          const float4 qv = *reinterpret_cast<const float4*>(s_q + j * QW + w);
          float a = acc[j];
          a = fmaf(__uint_as_float(rv.x), qv.x, a);
          a = fmaf(__uint_as_float(rv.y), qv.y, a);
          a = fmaf(__uint_as_float(rv.z), qv.z, a);
          a = fmaf(__uint_as_float(rv.w), qv.w, a);
          acc[j] = a;
        } else if (MODE == BF16) {
          const float4 qa = *reinterpret_cast<const float4*>(s_q + j * QW + 2 * w);
          const float4 qb = *reinterpret_cast<const float4*>(s_q + j * QW + 2 * w + 4);
          float a = acc[j];
          a = fmaf(bf16_lo(rv.x), qa.x, a);
          a = fmaf(bf16_hi(rv.x), qa.y, a);
          a = fmaf(bf16_lo(rv.y), qa.z, a);
          a = fmaf(bf16_hi(rv.y), qa.w, a);
          a = fmaf(bf16_lo(rv.z), qb.x, a);
          a = fmaf(bf16_hi(rv.z), qb.y, a);
          a = fmaf(bf16_lo(rv.w), qb.z, a);
          a = fmaf(bf16_hi(rv.w), qb.w, a);
          acc[j] = a;
        } else if (MODE == I8) {
          const uint4 qv = *reinterpret_cast<const uint4*>(s_q + j * QW + w);
          int a = acc[j];
          a = __dp4a((int)rv.x, (int)qv.x, a);
          a = __dp4a((int)rv.y, (int)qv.y, a);
          a = __dp4a((int)rv.z, (int)qv.z, a);
          a = __dp4a((int)rv.w, (int)qv.w, a);
          acc[j] = a;
        } else {
          const uint4 ql = *reinterpret_cast<const uint4*>(s_q + j * QW + w);
          const uint4 qh = *reinterpret_cast<const uint4*>(s_q + j * QW + CW + w);
          int a = acc[j];
          a = __dp4a(nib_lo(rv.x), (int)ql.x, a);
          a = __dp4a(nib_hi(rv.x), (int)qh.x, a);
          a = __dp4a(nib_lo(rv.y), (int)ql.y, a);
          a = __dp4a(nib_hi(rv.y), (int)qh.y, a);
          a = __dp4a(nib_lo(rv.z), (int)ql.z, a);
          a = __dp4a(nib_hi(rv.z), (int)qh.z, a);
          a = __dp4a(nib_lo(rv.w), (int)ql.w, a);
          a = __dp4a(nib_hi(rv.w), (int)qh.w, a);
          acc[j] = a;
        }
      }
    }
  }
}

}  // namespace sskd
