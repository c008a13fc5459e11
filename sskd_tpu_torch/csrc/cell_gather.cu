// cell_gather: the per-cell scoring of clustered (cell-probe) search.
//
// Replaces: sskd_tpu/ops/topk_cluster.py _cell_gather_kernel (the general
// kernel, reached through _cell_scores_pallas) and _cell_gather_kernel_b1 (the
// one-query kernel, reached through _cell_scores_pallas_b1).
//
// The corpus is stored cell-contiguous: cell c owns rows [c * rpc, (c + 1) * rpc).
// For query b and probe slot j, with c = probe[b, j] and r < rpc:
//   general kernels       out[b, j, r] = (dot(row, q b) * q_scale[b]) * scale[row]   (int8)
//                         out[b, j, r] = dot(row, q b) * scale[row]      (f32, scale optional)
//   cell_gather_b1_kernel out[0, j, r] = dot(row, q) * scale[row]     (int8 or f32, one query;
//                         the caller multiplies by the query's scale afterwards)
// where row = c * rpc + r. The int8 dot is the exact int32 sum (mma or dp4a);
// the TPU kernels reach the same integer through an f32 dot of cast values
// (general) or an int32 dot (one query), and each kernel keeps its TPU
// kernel's order of the two scale products. No kernel masks rows: the caller
// masks the padded tail through the rows' positions.
//
// Bound on the H100: bytes. Each distinct probed cell must be read once (rpc *
// (row_bytes + 4) bytes with its scales) and every score written once (B *
// nprobe * rpc * 4 bytes); the products per byte are far below the card's
// rate. At B = 64, nprobe 64 over 977 cells of 1,024 x 384 int8 rows, about
// 962 distinct cells: 0.38 GB read, 17 MB written, 0.120 ms at 3.35 TB/s.
// One query over 64 cells is 25 MB, about 8 us: the one-query kernel is
// bound by its launch.
//
// Three kernels, chosen by the wrapper (ops/topk_cluster.py):
//
// 1. int8, rows of at most 1,024 bytes, any batch: cell_gather_tc_kernel,
//    which brings each 16-row tile of each distinct probed cell from device
//    memory into shared memory once and scores it against every query that
//    probes the cell, on the tensor cores. The wrapper sorts the (query,
//    slot) pairs by cell, which gives the sorted cells and the pairs' order
//    from one sort. Block (run, tile), one warp, takes the pairs [run * 8,
//    run * 8 + 8) of that order, moved to cell boundaries: it skips the
//    leading pairs whose cell the run before ends with, and runs on past its
//    end while the cell goes on (warp ballots over the sorted cells), so
//    every distinct cell lies in exactly one run. It walks the run's cells
//    with the next cell's tile arriving by cp.async into a second buffer
//    while the current one is scored: the tile's rows are mma A fragments
//    (ldmatrix; rows padded to an odd number of 16-byte units, so its reads
//    hit no bank twice), eight queries at a time B fragments read from the
//    query rows (in L1 and L2), and mma.sync m16n8k32 s8 x s8 -> s32 gives
//    the exact integer dots. Rows of a multiple of 16 but not 32 bytes take
//    a zero tail. The time follows the warps an SM holds, not the bytes in
//    flight: each warp waits mostly on its own chain (the pairs' ids, the
//    query rows, twelve dependent mma), so small blocks of one warp and
//    short runs, many of them, beat deeper pipelines (64-row tiles, runs of
//    16, 3 or 4 stages: 10-100 % slower on the card).
// 2. f32, any batch (and int8 rows above 1,024 bytes):
//    cell_gather_kernel, one block per (query, slot, 128-row tile of the
//    cell), walking the pairs in the wrapper's order sorted by cell so that
//    blocks reading one cell run side by side and find it in L2.
// 3. one query: cell_gather_b1_kernel, one block per (slot, 64-row tile).
// Kernels 2 and 3 share one inner loop on CUDA cores: a group of 8
// neighbouring lanes owns a corpus row, each lane reading 16 bytes, so a
// group covers 128 contiguous bytes a step and a warp four such segments;
// the eight partial sums meet through three shuffles. Every group carries 4
// rows at once, so each thread has four independent 16-byte loads in flight
// for each read of the query. Rows are any multiple of 16 bytes, rpc and
// nprobe any size; a ragged last tile of a cell is masked by row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace sskd {

enum CellMode { CELL_F32 = 0, CELL_I8 = 1 };

constexpr int LPR = 8;  // lanes per corpus row
constexpr int RPG = 4;  // rows a lane group carries at once

template <int MODE> struct CellAcc { typedef int type; };
template <> struct CellAcc<CELL_F32> { typedef float type; };

template <int MODE>
__device__ __forceinline__ void dot16(typename CellAcc<MODE>::type& acc, const uint4& r,
                                      const uint4& q) {
  if (MODE == CELL_F32) {
    float a = acc;
    a = fmaf(__uint_as_float(r.x), __uint_as_float(q.x), a);
    a = fmaf(__uint_as_float(r.y), __uint_as_float(q.y), a);
    a = fmaf(__uint_as_float(r.z), __uint_as_float(q.z), a);
    a = fmaf(__uint_as_float(r.w), __uint_as_float(q.w), a);
    acc = a;
  } else {
    int a = acc;
    a = __dp4a((int)r.x, (int)q.x, a);
    a = __dp4a((int)r.y, (int)q.y, a);
    a = __dp4a((int)r.z, (int)q.z, a);
    a = __dp4a((int)r.w, (int)q.w, a);
    acc = a;
  }
}

// Scores of the tile's rows [tile_row0, tile_row0 + THREADS / LPR * RPG) of one
// cell against the query in s_q; lane 0 of each group ends with the full sums in
// acc[i] for the rows rc[i] = tile_row0 + group * RPG + i (only rc[i] < rpc count).
//   cell_rows: the cell's first row, as 16-byte pieces; row_vec pieces per row.
template <int MODE>
__device__ __forceinline__ void cell_tile_dot(
    typename CellAcc<MODE>::type (&acc)[RPG], const uint4* __restrict__ cell_rows,
    const uint4* s_q, int row_vec, int rc0, int rpc) {
  const int sub = threadIdx.x % LPR;
  const uint4* rows[RPG];
  bool live[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    acc[i] = 0;
    live[i] = rc0 + i < rpc;
    rows[i] = cell_rows + (long)(live[i] ? rc0 + i : 0) * row_vec;
  }
  for (int v = sub; v < row_vec; v += LPR) {
    const uint4 qv = s_q[v];
    uint4 rv[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i)
      rv[i] = live[i] ? __ldg(rows[i] + v) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < RPG; ++i) dot16<MODE>(acc[i], rv[i], qv);
  }
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
}

template <int THREADS>
__device__ __forceinline__ void stage_query(uint4* s_q, const uint4* __restrict__ q_row,
                                            int row_vec) {
  for (int v = threadIdx.x; v < row_vec; v += THREADS) s_q[v] = q_row[v];
  __syncthreads();
}

// The general kernel: one block per (query b, probe slot j, tile of the cell).
constexpr int GEN_THREADS = 256;
constexpr int GEN_TILE = GEN_THREADS / LPR * RPG;  // 128 rows

template <int MODE>
__global__ void __launch_bounds__(GEN_THREADS) cell_gather_kernel(
    const uint4* __restrict__ q, const float* __restrict__ q_scale,
    const uint4* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ probe, const long long* __restrict__ order, float* __restrict__ out,
    int nprobe, int rpc, int row_vec, int tiles) {
  extern __shared__ __align__(16) uint4 s_q[];
  const long turn = blockIdx.x / tiles;
  const long slot = order[turn];  // b * nprobe + j
  const int tile = (int)(blockIdx.x % tiles);
  const int b = (int)(slot / nprobe);
  const long cell_row0 = (long)probe[slot] * rpc;
  stage_query<GEN_THREADS>(s_q, q + (long)b * row_vec, row_vec);

  const int rc0 = tile * GEN_TILE + (threadIdx.x / LPR) * RPG;
  typename CellAcc<MODE>::type acc[RPG];
  cell_tile_dot<MODE>(acc, corpus + cell_row0 * row_vec, s_q, row_vec, rc0, rpc);
  if (threadIdx.x % LPR == 0) {
    const float qs = (MODE == CELL_I8) ? q_scale[b] : 1.0f;
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int rc = rc0 + i;
      if (rc < rpc) {
        float s = (float)acc[i];
        if (MODE == CELL_I8) s = (s * qs) * scales[cell_row0 + rc];
        else if (scales != nullptr) s = s * scales[cell_row0 + rc];
        out[slot * rpc + rc] = s;
      }
    }
  }
}

// The one-query kernel: one block per (probe slot j, tile of the cell); the
// query's scale is left to the caller.
constexpr int B1_THREADS = 128;
constexpr int B1_TILE = B1_THREADS / LPR * RPG;  // 64 rows

template <int MODE>
__global__ void __launch_bounds__(B1_THREADS) cell_gather_b1_kernel(
    const uint4* __restrict__ q, const uint4* __restrict__ corpus,
    const float* __restrict__ scales, const int* __restrict__ probe,
    float* __restrict__ out, int rpc, int row_vec, int tiles) {
  extern __shared__ __align__(16) uint4 s_q[];
  const long slot = blockIdx.x / tiles;  // j
  const int tile = (int)(blockIdx.x % tiles);
  const long cell_row0 = (long)probe[slot] * rpc;
  stage_query<B1_THREADS>(s_q, q, row_vec);

  const int rc0 = tile * B1_TILE + (threadIdx.x / LPR) * RPG;
  typename CellAcc<MODE>::type acc[RPG];
  cell_tile_dot<MODE>(acc, corpus + cell_row0 * row_vec, s_q, row_vec, rc0, rpc);
  if (threadIdx.x % LPR == 0) {
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int rc = rc0 + i;
      if (rc < rpc) {
        float s = (float)acc[i];
        if (scales != nullptr) s = s * scales[cell_row0 + rc];
        out[slot * rpc + rc] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 1: int8 on the tensor cores, each probed cell's tile read once
// ---------------------------------------------------------------------------

constexpr int TC_TILE = 16;                // rows of a cell a block scores: 16 a warp
constexpr int TC_THREADS = TC_TILE * 2;    // a warp per 16 rows
constexpr int TC_STAGES = 2;               // cells' tiles in shared memory at once
constexpr int TC_RUN = 8;                  // pairs of the sorted order a block takes,
                                           // before the move to cell boundaries
constexpr int TC_MAX_ROW_BYTES = 1024;

// shared row stride of a tile: the row rounded up to 32 bytes (the mma's
// depth), plus 16 so that ldmatrix's eight row addresses fall in eight
// different 16-byte bank groups
__host__ __device__ constexpr int tc_stride(int row_bytes) {
  return (row_bytes + 31) / 32 * 32 + 16;
}
__host__ __device__ constexpr size_t tc_smem_bytes(int row_bytes) {
  return TC_STAGES * ((size_t)TC_TILE * tc_stride(row_bytes) + TC_TILE * sizeof(float));
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

// The first index i >= from with cells[i] != c (n if none), the cells
// sorted: a warp compares 32 at a time. Every lane returns it.
__device__ __forceinline__ int next_cell(const int* __restrict__ cells, int n, int from, int c,
                                         int lane) {
  for (int base = from; base < n; base += 32) {
    const int i = base + lane;
    const unsigned differs = __ballot_sync(0xffffffffu, i < n && __ldg(cells + i) != c);
    if (differs) return base + __ffs(differs) - 1;
  }
  return n;
}

//   cells: [n_pairs] the probed cells sorted ascending; order: [n_pairs] the
//   pair (b * nprobe + j) of each, as one stable sort gives them.
__global__ void __launch_bounds__(TC_THREADS) cell_gather_tc_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ q_scale,
    const int8_t* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ cells, const long long* __restrict__ order, float* __restrict__ out,
    int n_pairs, int nprobe, int rpc, int row_bytes, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_stride(row_bytes);
  const int stage_bytes = TC_TILE * ld + TC_TILE * (int)sizeof(float);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int run = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int r0 = tile * TC_TILE;

  // the run, moved to cell boundaries: it starts at the first pair whose
  // cell the pair before it does not share, and ends where its last cell does
  int s = run * TC_RUN;
  const int e0 = min(s + TC_RUN, n_pairs);
  if (s > 0) s = next_cell(cells, e0, s, __ldg(cells + s - 1), lane);
  if (s >= e0) return;  // the run before takes all of these pairs
  const int e = next_cell(cells, n_pairs, e0, __ldg(cells + e0 - 1), lane);

  const int row_chunks = ld / 16 - 1;       // 16-byte pieces of a padded row
  const int chunks = row_bytes / 16;        // of them, those the row fills
  // the tile of cell c into stage st: rows past rpc and the tail past the
  // row's bytes as zeros; warp w copies rows w, w + 4, ...
  auto load_tile = [&](int c, int st) {
    unsigned char* dst = smem + st * stage_bytes;
    float* dst_scale = reinterpret_cast<float*>(dst + TC_TILE * ld);
    const long row0 = (long)c * rpc + r0;
    for (int r = warp; r < TC_TILE; r += TC_THREADS / 32) {
      const bool live_row = r0 + r < rpc;
      const int8_t* src = corpus + (live_row ? (row0 + r) * row_bytes : 0);
      for (int k = lane; k < row_chunks; k += 32) {
        const bool live = live_row && k < chunks;
        cp_async16(dst + r * ld + k * 16, src + (live ? k * 16 : 0), live ? 16 : 0);
      }
    }
    if (tid < TC_TILE && r0 + tid < rpc) cp_async4(dst_scale + tid, scales + row0 + tid);
  };

  const int n_k = ld / 32;  // 32-byte steps of the padded row
  // the groups of pairs with one cell, in order: `g` is scored, `load_g` is
  // the next to be loaded; each stage holds one group's tile
  int load_g = s;
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (load_g < e) {
      const int c = __ldg(cells + load_g);
      load_tile(c, i);
      load_g = next_cell(cells, e, load_g + 1, c, lane);
    }
    cp_async_commit();
  }
  int st = 0;
  for (int g = s; g < e; st = st + 1 == TC_STAGES ? 0 : st + 1) {
    const int c = __ldg(cells + g);
    const int g_end = next_cell(cells, e, g + 1, c, lane);
    // the first eight pairs' ids, asked for before the wait for the tile
    const int first = g + grp < g_end ? (int)__ldg(order + g + grp) : 0;
    if (load_g < e) {
      const int lc = __ldg(cells + load_g);
      const int ls = st == 0 ? TC_STAGES - 1 : st - 1;  // the stage freed last
      load_tile(lc, ls);
      load_g = next_cell(cells, e, load_g + 1, lc, lane);
    }
    cp_async_commit();
    cp_async_wait<TC_STAGES - 1>();  // this group's tile has landed
    __syncthreads();
    const unsigned char* tile_rows = smem + st * stage_bytes;
    const float* tile_scale = reinterpret_cast<const float*>(tile_rows + TC_TILE * ld);
    const unsigned char* a_row =
        tile_rows + (warp * 16 + mr + (mi & 1) * 8) * ld + (mi >> 1) * 16;
    // the cell's queries, eight at a time: lane (grp, tig) loads query grp's
    // bytes 4 tig.. of each 32-byte step, and its pair and scale
    for (int q0 = g; q0 < g_end; q0 += 8) {
      const int n_q = min(8, g_end - q0);
      const int my_pair = q0 == g ? first : grp < n_q ? (int)__ldg(order + q0 + grp) : 0;
      const int my_b = my_pair / nprobe;
      const float my_qs = __ldg(q_scale + my_b);
      const int8_t* q_row = q + (long)my_b * row_bytes;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int ks = 0; ks < n_k; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, a_row + ks * 32);
        const int k0 = ks * 32 + 4 * tig;
        const uint32_t b0 = grp < n_q && k0 < row_bytes
            ? __ldg(reinterpret_cast<const uint32_t*>(q_row + k0)) : 0u;
        const uint32_t b1 = grp < n_q && k0 + 16 < row_bytes
            ? __ldg(reinterpret_cast<const uint32_t*>(q_row + k0 + 16)) : 0u;
        mma_s8(acc, a, b0, b1);
      }
      // acc: rows grp and grp + 8 of the warp's 16, queries 2 tig and 2 tig + 1
#pragma unroll
      for (int cq = 0; cq < 2; ++cq) {
        const int col = 2 * tig + cq;
        const int pair = __shfl_sync(0xffffffffu, my_pair, 4 * col);
        const float qs = __shfl_sync(0xffffffffu, my_qs, 4 * col);
        if (col >= n_q) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = warp * 16 + grp + 8 * rr;
          if (r0 + r < rpc)
            out[(long)pair * rpc + r0 + r] = ((float)acc[2 * rr + cq] * qs) * tile_scale[r];
        }
      }
    }
    __syncthreads();  // the stage is free for the group STAGES ahead
    g = g_end;
  }
}

constexpr int MAX_ROW_BYTES = 48 * 1024;  // the query row sits in default shared memory

}  // namespace sskd

// C interface, loaded with ctypes.
//   mode: 0 f32, 1 int8. q: [B, row_bytes] in the corpus type. q_scale: [B] f32 (int8 only).
//   corpus: [P, row_bytes], cell c = rows [c * rpc, (c + 1) * rpc). scales: [P] f32 (required
//   for int8, optional for f32). probe: [B, nprobe] int32, each in [0, P / rpc).
//   order (sskd_cell_gather only): [B * nprobe] int64, a permutation of the (query, slot)
//   pairs b * nprobe + j in the order the blocks take them.
//   out: [B, nprobe, rpc] f32. row_bytes is a multiple of 16, at most 48 KB.
// Each returns cudaGetLastError() after the launch.
extern "C" int sskd_cell_gather(int mode, const void* q, const float* q_scale,
                                const void* corpus, const float* scales, const int* probe,
                                const long long* order, float* out, int B, int nprobe, int rpc,
                                int row_bytes, void* stream) {
  using namespace sskd;
  if (B <= 0 || nprobe <= 0 || rpc <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      row_bytes > MAX_ROW_BYTES || order == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = (rpc + GEN_TILE - 1) / GEN_TILE;
  const long blocks = (long)B * nprobe * tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int row_vec = row_bytes / 16;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* qv = (const uint4*)q;
  const uint4* cv = (const uint4*)corpus;
  if (mode == CELL_F32)
    cell_gather_kernel<CELL_F32><<<(unsigned)blocks, GEN_THREADS, row_bytes, s>>>(
        qv, q_scale, cv, scales, probe, order, out, nprobe, rpc, row_vec, tiles);
  else if (mode == CELL_I8 && q_scale != nullptr && scales != nullptr)
    cell_gather_kernel<CELL_I8><<<(unsigned)blocks, GEN_THREADS, row_bytes, s>>>(
        qv, q_scale, cv, scales, probe, order, out, nprobe, rpc, row_vec, tiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

//   The tensor-core route: int8 only, row_bytes a multiple of 16 of at most 1,024.
//   cells: [B * nprobe] int32, probe's cells sorted ascending; order: [B * nprobe] int64,
//   the pair b * nprobe + j of each (the values and indices of one stable sort of probe).
//   Other arguments as above.
extern "C" int sskd_cell_gather_tc(const void* q, const float* q_scale, const void* corpus,
                                   const float* scales, const int* cells,
                                   const long long* order, float* out, int B, int nprobe,
                                   int rpc, int row_bytes, void* stream) {
  using namespace sskd;
  if (B <= 0 || nprobe <= 0 || rpc <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      row_bytes > TC_MAX_ROW_BYTES || q_scale == nullptr || scales == nullptr)
    return (int)cudaErrorInvalidValue;
  const long n_pairs = (long)B * nprobe;
  const int tiles = (rpc + TC_TILE - 1) / TC_TILE;
  const long blocks = (n_pairs + TC_RUN - 1) / TC_RUN * tiles;
  if (n_pairs > 0x7fffffffL || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(row_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cell_gather_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cell_gather_tc_kernel<<<(unsigned)blocks, TC_THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, q_scale, (const int8_t*)corpus, scales, cells, order, out,
      (int)n_pairs, nprobe, rpc, row_bytes, tiles);
  return (int)cudaGetLastError();
}

extern "C" int sskd_cell_gather_b1(int mode, const void* q, const void* corpus,
                                   const float* scales, const int* probe, float* out,
                                   int nprobe, int rpc, int row_bytes, void* stream) {
  using namespace sskd;
  if (nprobe <= 0 || rpc <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      row_bytes > MAX_ROW_BYTES)
    return (int)cudaErrorInvalidValue;
  const int tiles = (rpc + B1_TILE - 1) / B1_TILE;
  const long blocks = (long)nprobe * tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int row_vec = row_bytes / 16;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* qv = (const uint4*)q;
  const uint4* cv = (const uint4*)corpus;
  if (mode == CELL_F32)
    cell_gather_b1_kernel<CELL_F32><<<(unsigned)blocks, B1_THREADS, row_bytes, s>>>(
        qv, cv, scales, probe, out, rpc, row_vec, tiles);
  else if (mode == CELL_I8 && scales != nullptr)
    cell_gather_b1_kernel<CELL_I8><<<(unsigned)blocks, B1_THREADS, row_bytes, s>>>(
        qv, cv, scales, probe, out, rpc, row_vec, tiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
