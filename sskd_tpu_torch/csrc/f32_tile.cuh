// f32_tile.cuh: the register-tiled f32 score tile of the CUDA-core routes of
// binmax.cu (binmax_f32_kernel, binmax_strided_f32_kernel), for f32 rows and,
// as the bf16 routes, for bf16 rows against the same f32 queries.
//
// A block holds a chunk of QC queries in shared memory for its whole life and
// walks a list of tiles of the corpus, each one or two bins of 128 rows. Warp
// w owns rows w * RW .. w * RW + RW - 1 of every tile and streams them through
// its own cp.async ring of K-chunks (KC floats a row a stage), across the
// K-chunks of a tile and on into the next tile; it waits on its own copies
// only, so the K loop has no block barrier (a ring of all 128 rows needs one a
// K-chunk, and the card lost time to each). The queries' whole rows are
// staged once, beside the rings; where the rows of even a chunk of 8 do not
// fit, that chunk stages them in bands of whole K-chunks, each band anew for
// each tile between two block barriers, so rows of any length are taken.
// Lane (rl, qg) of a warp keeps the scores of its R rows rl, rl + LR, ...
// against queries qg, qg + QG, ..., an R x C register tile, and takes them
// as outer products: per 4 floats of
// depth, R + C float4 loads from shared memory feed 4 R C FMA (256 at R = C =
// 8), where the dp4a-era loop of bin_dot.cuh fed four FMA with each load.
// Each float4 load takes the SM's shared memory 4 cycles whatever lanes share
// its address (a warp receives 512 bytes at 128 a cycle), so a tile of R x C
// keeps the FMA units at most RC / (4 (R + C)) busy: 0.67 at 4 x 8, 1 at 8 x 8,
// and 8 warps an SM are needed to hide the loads' latency (at four, an 8 x 8
// tile ran 2x slower on an H100).
//
// Each score is one fmaf chain over k = 0, 1, ..., D - 1 in order, in full
// f32 on the CUDA cores: no TF32, which would round the products. Rows past
// the corpus, depth past D and absent queries are zeros, which leave a chain
// as it was. The caller's epilogue gets each tile's finished register tile.
//
// Row type TR: float, or uint16_t holding bf16 bits. bf16 rows stream through
// the rings at 2 bytes a value (a 16-byte copy is 8 values) and are widened
// to f32 exactly as they are read from shared memory (a 16-bit shift), so a
// score is the same fmaf chain over the widened row: the function of the TPU
// kernel's bf16 branch (bf16 rows, an f32 query, f32 sums). bf16 tensor cores
// would round the query to bf16, which is another function.
//
// Bank conflicts: the LR rows (and the QG queries) one float4 load of a warp
// reads are consecutive at a stride of 4 (mod 32) floats, so they lie in
// distinct 16-byte bank groups; the 8-byte loads of bf16 rows, at a stride
// of 144 or 80 bytes (K-chunks of 64 or 32 values), do too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"  // cp_async16, NEG_INF

namespace sskd {

constexpr int FT_ROWS = 128;   // rows of a bin
constexpr int FT_KC_MAX = 64;  // the deepest K-chunk a stage holds
constexpr int FT_STAGES = 2;
constexpr size_t FT_SMEM_MAX = 216 * 1024;  // dynamic; the rest of 227 KB for static arrays

// QC queries a block, R rows a thread, WARPS warps a block, rows of type TR
template <int QC, int R_, int WARPS_, class TR = float>
struct FTile {
  using Row = TR;
  static constexpr int QG = QC >= 64 ? 8 : 4;  // query groups: the lanes of a row group
  static constexpr int C = QC / QG;            // queries a thread
  static constexpr int R = R_;                 // rows a thread scores
  static constexpr int LR = 32 / QG;           // row lanes of a warp
  static constexpr int RW = LR * R;            // rows of a tile a warp owns
  static constexpr int WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = RW * WARPS;      // rows of a tile
  // floats of depth a stage holds: 64 up to 16 queries (half the waits), 32
  // above, where the staged queries leave the rings less room (at 32 queries
  // two blocks, 8 warps, still fit an SM)
  static constexpr int KC = QC <= 16 ? FT_KC_MAX : 32;
  static constexpr int VEC = 16 / (int)sizeof(TR);  // row values a 16-byte copy moves
  static constexpr int LD = KC + VEC;          // shared row stride of a stage (values)
  static constexpr bool BANDS = QC == 8;       // the one chunk staged in bands (f32_chunk)
  static_assert(ROWS % FT_ROWS == 0, "a tile is whole bins");
};

// floats of depth a block stages at once when the whole row fits: D rounded
// up to whole K-chunks
__host__ __device__ constexpr int ft_full_band(int dim) {
  return (dim + FT_KC_MAX - 1) / FT_KC_MAX * FT_KC_MAX;
}
// dynamic shared memory of a block of tile T staging bands of `band` floats
// (a multiple of FT_KC_MAX): its queries at a stride of band + 4, then the
// warps' rings
template <class T>
__host__ __device__ constexpr size_t ft_smem_bytes(int band) {
  return (size_t)T::QG * T::C * (band + 4) * sizeof(float) +
         (size_t)FT_STAGES * T::ROWS * T::LD * sizeof(typename T::Row);
}

// four row values from shared memory as f32: a float4, or four bf16 widened
__device__ __forceinline__ float4 ft_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ft_load4(const uint16_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}

// Stages floats k0 .. k0 + band - 1 of the queries q0 .. q0 + nq - 1 of q
// [B, dim] into s_q [QC][band + 4] (zeros past dim and for absent queries)
// for a block of tile T and publishes them to the block.
template <class T>
__device__ __forceinline__ void ft_stage_queries(float* s_q, const float* __restrict__ q, int q0,
                                                 int nq, int dim, int k0, int band) {
  const int qs = band + 4, vecs = band / 4;
  for (int i = threadIdx.x; i < T::QG * T::C * vecs; i += T::THREADS) {
    const int c = i / vecs, k = (i - c * vecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < nq && k0 + k < dim)
      v = __ldg(reinterpret_cast<const float4*>(q + (long)(q0 + c) * dim + k0 + k));
    *reinterpret_cast<float4*>(s_q + c * qs + k) = v;
  }
  __syncthreads();
}

// Scores the block's n_tiles tiles, tile i starting at corpus row row0_of(i),
// against the queries q0 .. q0 + nq - 1 of q, staged in bands of `band`
// floats (ft_full_band(dim) unless T::BANDS), and hands each finished tile to
// epi(i, acc): acc[r][j] is row warp * RW + r * LR + rl of the tile against
// query j * QG + qg of the chunk. smem: ft_smem_bytes<T>(band) bytes. Every
// thread of the block calls it; epi is called by all of them alike.
template <class T, class RowOf, class Epi>
__device__ __forceinline__ void f32_tiles(const float* __restrict__ q, int q0, int nq,
                                          const typename T::Row* __restrict__ corpus,
                                          long n_rows, int dim, int band, float* smem,
                                          int n_tiles, RowOf row0_of, Epi epi) {
  using TR = typename T::Row;
  constexpr int R = T::R, C = T::C, RW = T::RW, KC = T::KC, LD = T::LD, VEC = T::VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = lane % T::QG, rl = lane / T::QG;
  const int qs = band + 4;
  const int n_kc = (dim + KC - 1) / KC;
  const int band_kc = band / KC;  // K-chunks of a band
  const bool banded = T::BANDS && band_kc < n_kc;  // each band staged anew for each tile
  const int total = n_tiles * n_kc;
  float* s_q = smem;
  TR* my_ring = reinterpret_cast<TR*>(smem + T::QG * T::C * qs) + warp * FT_STAGES * RW * LD;

  // K-chunk `it` (tile it / n_kc) of the warp's rows into stage st: RW rows x
  // KC values, 16 bytes a copy; rows past the corpus and depth past dim as zeros
  auto load = [&](int it, int st) {
    const int i = it / n_kc, k0 = (it - i * n_kc) * KC;
    const long row0 = row0_of(i) + warp * RW;
    TR* dst = my_ring + st * RW * LD;
    for (int p = lane; p < RW * (KC / VEC); p += 32) {
      const int r = p / (KC / VEC), k = k0 + (p % (KC / VEC)) * VEC;
      const bool live = row0 + r < n_rows && k < dim;
      cp_async16(dst + r * LD + (k - k0), corpus + (live ? (row0 + r) * dim + k : 0),
                 live ? 16 : 0);
    }
  };

  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FT_STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  if (!banded) ft_stage_queries<T>(s_q, q, q0, nq, dim, 0, band);
  int st = 0, i = 0, kc = 0;
  for (int it = 0; it < total; ++it) {
    if (banded && kc % band_kc == 0) {
      __syncthreads();  // the block is done with the band before
      ft_stage_queries<T>(s_q, q, q0, nq, dim, kc * KC, band);
    }
    if (it + FT_STAGES - 1 < total)  // into the stage the warp freed last
      load(it + FT_STAGES - 1, st == 0 ? FT_STAGES - 1 : st - 1);
    cp_async_commit();
    cp_async_wait<FT_STAGES - 1>();  // chunk it has landed
    __syncwarp();
    const TR* rows = my_ring + st * RW * LD + rl * LD;
    const float* qk = s_q + qg * qs + (banded ? kc % band_kc : kc) * KC;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = ft_load4(rows + r * T::LR * LD + k);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(qk + j * T::QG * qs + k);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v = acc[r][j];
          v = fmaf(a[r].x, b.x, v);
          v = fmaf(a[r].y, b.y, v);
          v = fmaf(a[r].z, b.z, v);
          v = fmaf(a[r].w, b.w, v);
          acc[r][j] = v;
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    if (++kc == n_kc) {
      epi(i, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[r][j] = 0.f;
      kc = 0;
      ++i;
    }
    st = st + 1 == FT_STAGES ? 0 : st + 1;
  }
}

}  // namespace sskd
