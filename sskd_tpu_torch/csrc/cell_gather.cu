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
//                         out[b, j, r] = dot(row, q b)                   (bf16 rows and query)
//   cell_gather_b1_kernel out[0, j, r] = dot(row, q) * scale[row]     (int8, f32 or bf16, one query;
//                         the caller multiplies by the query's scale afterwards)
// where row = c * rpc + r. The int8 dot is the exact int32 sum (mma or dp4a);
// the TPU kernels reach the same integer through an f32 dot of cast values
// (general) or an int32 dot (one query), and each kernel keeps its TPU
// kernel's order of the two scale products. For bf16 rows (CELL_BF16, the
// "bf16" route of both kernels) the query comes rounded to bf16, as the JAX
// package rounds it (topk_cluster.py q.astype(corpus.dtype)): each product
// of two bf16 values is exact in f32 and the sums are f32. No kernel masks
// rows: the caller masks the padded tail through the rows' positions.
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
//    probes the cell, on the tensor cores (the pipeline of gather_tc.cuh,
//    which bin_gather.cu shares). The wrapper sorts the (query, slot) pairs
//    by cell, which gives the sorted cells and the pairs' order from one
//    sort; a block, one warp, takes runs of 8 pairs of that order moved to
//    cell boundaries, so every distinct cell lies in exactly one run. Rows of
//    a multiple of 16 but not 32 bytes take a zero tail.
// 2. f32 and bf16, any batch (and int8 rows above 1,024 bytes):
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
#include <limits.h>
#include <stdint.h>

#include "gather_tc.cuh"

namespace sskd {

enum CellMode { CELL_F32 = 0, CELL_I8 = 1, CELL_BF16 = 2 };

constexpr int LPR = 8;  // lanes per corpus row
constexpr int RPG = 4;  // rows a lane group carries at once

template <int MODE> struct CellAcc { typedef int type; };
template <> struct CellAcc<CELL_F32> { typedef float type; };
template <> struct CellAcc<CELL_BF16> { typedef float type; };

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
  } else if (MODE == CELL_BF16) {  // eight values a piece, widened in order
    float a = acc;
    a = fmaf(bf16_lo(r.x), bf16_lo(q.x), a);
    a = fmaf(bf16_hi(r.x), bf16_hi(q.x), a);
    a = fmaf(bf16_lo(r.y), bf16_lo(q.y), a);
    a = fmaf(bf16_hi(r.y), bf16_hi(q.y), a);
    a = fmaf(bf16_lo(r.z), bf16_lo(q.z), a);
    a = fmaf(bf16_hi(r.z), bf16_hi(q.z), a);
    a = fmaf(bf16_lo(r.w), bf16_lo(q.w), a);
    a = fmaf(bf16_hi(r.w), bf16_hi(q.w), a);
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

constexpr int TC_RUN = 8;  // pairs of the sorted order a block takes, before the
                           // move to cell boundaries
constexpr int TC_STAGES = 2;  // a run's cells' tiles in shared memory at once
static_assert(tc_smem_bytes(1, TC_STAGES, TC_MAX_ROW_BYTES) <= 48 * 1024,
              "no opt-in shared memory needed");

//   cells: [n_pairs] the probed cells sorted ascending; order: [n_pairs] the
//   pair (b * nprobe + j) of each, as one stable sort gives them. The cells
//   are whole (no row past the corpus) and no row is masked.
__global__ void __launch_bounds__(32) cell_gather_tc_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ q_scale,
    const int8_t* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ cells, const long long* __restrict__ order, float* __restrict__ out,
    int n_pairs, int nprobe, int rpc, int row_bytes, int tiles) {
  gather_tc<1, TC_STAGES>(q, q_scale, corpus, scales, cells, order, out, n_pairs, nprobe, rpc,
                          row_bytes, tiles, TC_RUN, LONG_MAX, LONG_MAX);
}

constexpr int MAX_ROW_BYTES = 48 * 1024;  // the query row sits in default shared memory

}  // namespace sskd

// C interface, loaded with ctypes.
//   mode: 0 f32, 1 int8, 2 bf16. q: [B, row_bytes] in the corpus type. q_scale: [B] f32 (int8
//   only). corpus: [P, row_bytes], cell c = rows [c * rpc, (c + 1) * rpc). scales: [P] f32
//   (required for int8, optional for f32 and bf16). probe: [B, nprobe] int32, each in [0, P / rpc).
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
  else if (mode == CELL_BF16)
    cell_gather_kernel<CELL_BF16><<<(unsigned)blocks, GEN_THREADS, row_bytes, s>>>(
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
  const size_t smem = tc_smem_bytes(1, TC_STAGES, row_bytes);
  cell_gather_tc_kernel<<<(unsigned)blocks, 32, smem, (cudaStream_t)stream>>>(
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
  else if (mode == CELL_BF16)
    cell_gather_b1_kernel<CELL_BF16><<<(unsigned)blocks, B1_THREADS, row_bytes, s>>>(
        qv, cv, scales, probe, out, rpc, row_vec, tiles);
  else if (mode == CELL_I8 && scales != nullptr)
    cell_gather_b1_kernel<CELL_I8><<<(unsigned)blocks, B1_THREADS, row_bytes, s>>>(
        qv, cv, scales, probe, out, rpc, row_vec, tiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
