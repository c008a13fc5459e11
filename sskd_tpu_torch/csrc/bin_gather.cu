// bin_gather: phase B of the two-phase exact top-k engine.
//
// Replaces: sskd_tpu/ops/topk_pallas.py _gather_kernel (the second pallas_call
// of _pallas_body).
//
// For query b and each of its kb winning bins (bin ids chosen by the caller
// from binmax's output), rescans the bin's 128 rows exactly:
//   out[b, s, t] = dot(row, q b) * q_scale[b] * scale[row]   (int8 / int4)
//   out[b, s, t] = dot(row, q b) * scale[row]                (f32, scale optional)
//   out[b, s, t] = dot(row, q b)                             (bf16 rows, f32 query)
// where row = bins[b, s] * 128 + t, and rows >= valid_n give finfo(f32).min / 2.
// For int8 and int4 the dot is the exact int32 sum (the TPU kernel reaches the
// same integer through an f32 dot of integer values), then multiplied by the
// query scale and the row scale in that order.
//
// Bound on the H100: bytes, each distinct chosen bin's rows (and scales) once
// plus the output; the products are few. B = 16, kb = 10 at D = 384 is 160
// bins: 7.9 MB of int8 rows (~2.4 us at 3.35 TB/s), 4.0 MB of packed int4
// (~1.2 us), 15.7 MB of bf16 (~4.7 us). A layout that reads each pair's bins
// on their own, as every kernel here does, cannot go below the raw bytes,
// B * kb * 128 rows: the same at kb = 10 (the queries' bins rarely meet),
// but at B = 256, kb = 100 over 1M rows of packed int4 629 MB (0.188 ms)
// against the 196 MB of the distinct bins (0.060 ms). At the small shapes
// the time is latency: a bin's rows must be in flight together, not
// fetched in turn. f32 rows take four times the int8 bytes (31.5 MB at B =
// 16, kb = 10: 0.0094 ms), and where many queries share few bins the
// products bound them instead: the evaluator's B = 1,000, kb = 20 over 64
// bins of 8,192 rows reads 12.6 MB (0.0037 ms) but takes 2.6 G products, 5.9
// GFLOP as three TF32 passes: 0.0119 ms at 495 TFLOP/s (0.0293 at the CUDA
// cores' 67 TFLOP/s of f32 FMA).
//
// Four kernels, chosen by the wrapper (ops/topk_kernels.py bin_gather_route):
//
// 1. int8 rows of at most 1,024 bytes and packed int4 rows of at most 512
//    (D <= 1,024): bin_gather_tc_kernel<TC_S8 / TC_I4>, the tensor-core
//    gather of gather_tc.cuh (shared with cell_gather_tc_kernel) with a
//    128-row bin as the cell. Each warp takes one (query, slot) pair and one
//    16-row tile of its bin, brought into shared memory by cp.async in one
//    burst (B * kb * 8 warps, every tile in flight at once up to B = 16 at kb
//    = 10) and scored by ldmatrix and mma.sync m16n8k32 s8 against the
//    query's B fragment; rows >= valid_n give NEG_INF and the rows of a
//    ragged last bin past the corpus are zero-filled. Packed int4 rows travel
//    as stored (half the int8 bytes), each 32-byte step unpacked in registers
//    into the s8 fragments of both halves of the dims (unpack_i4), two mma a
//    step against the two halves of the query, which the warp stages in its
//    shared memory while the tile arrives. The pairs go in their own order,
//    one a warp, with one stage of shared memory (6.5 KB a warp at 384 int8
//    bytes), so that ~34 warps fit an SM; two such warps a block, so the card
//    dispatches half the blocks (a little faster on the card than one; four
//    no faster). Sorting them by bin, so that a bin that several queries
//    chose is read once, lost on the card (chip_smoke.py bin_gather_order):
//    the sort costs more than the kernel, and the runs it needs serialise the
//    loads.
// 2. bf16 rows of at most 1,024 bytes (D <= 512): bin_gather_bf16_tc_kernel,
//    the same job layout with the TC_BF16 row type: the f32 query split
//    exactly into three bf16 terms, staged once a warp, columns 0-2 of the B
//    fragment of mma.sync m16n8k16 bf16, one mma a 16-dim step for all three
//    partial dots, every product exact; only the summation order differs
//    from the TPU kernel's bf16 branch (bf16 rows against the f32 query, f32
//    sums). A warp holds 15 KB at D = 384 (the tile and the terms), so 14
//    warps fit an SM.
//    On an H100 (tools/probe_gather.py) both beat kernel 3 on these rows
//    where one job's latency is the time (int4 0.0048 against 0.0071 ms,
//    bf16 0.0080 against 0.0157 at B = 16, kb = 10; bf16 1.2-2.7x up to 640
//    pairs B * kb), and from about 640 pairs on both read near the raw
//    bytes' rate, within 7 % of each other either way (int4 0.24-0.25 ms
//    each at B = 256, kb = 100; bf16 3-7 % behind at 2,560 pairs, where its
//    14 warps an SM hold 15 KB each; int4 2-4 % behind at 640, 1.4 waves).
// 3. f32 rows of at most 1,024 floats: bin_gather_f32_tc_kernel, each
//    product three TF32 products on mma.sync m16n8k8 (hi hi, lo hi, hi lo;
//    the function of f32 sums to ~2^-21 a product, within 1e-5 of the plain
//    version on unit rows), the rows as A fragments (a warp a 16-row tile),
//    the queries as B fragments, staged once a group by cp.async and split
//    into hi and lo once for the block. For the bytes: each warp streams its
//    tile through its own cp.async ring of 32-float chunks, STAGES - 1
//    chunks in flight while one is scored, with no barrier beyond the warp.
//    For the products: the pairs sorted by bin (one stable argsort), a
//    block reads a bin once for up to 32 of the queries that chose it, the
//    mma's columns, each 8-deep step's three products issued a product at a
//    time across the column groups so that no mma waits on the one before;
//    in their own order a block of 4 warps takes half of one pair's bin. The
//    wrapper sorts from half a pair a bin of the corpus on
//    (bin_gather_f32_layout: at B <= 64, kb = 10 over 1M rows the own order
//    wins 4-17x, at the evaluator's 312 pairs a bin the sorted one 5x with
//    its sort).
//    On an H100 (tools/probe_gather_f32.py): B = 16, kb = 10 over 1M x 384
//    0.0112 ms (bin_gather_kernel 0.0342: the byte bound's 0.0094 ms is
//    within 1.2x); the evaluator's B = 1,000, kb = 20 over 8,192 rows 0.099
//    ms and the sort 0.05 (bin_gather_kernel 0.515), 8x the three passes'
//    0.0119 at TF32's 495 TFLOP/s: mma.sync takes TF32 at a fraction of
//    that rate (the f32 flash kernels reach 126 TFLOP/s of three-pass work),
//    and each block stages its queries and streams its bin before the
//    products start.
// 4. Longer f32, int8, int4 and bf16 rows: bin_gather_kernel, one
//    block per (query, bin slot), the shared inner loop of bin_dot.cuh with a
//    one-query tile (int8 and int4 by dp4a); each thread writes its row's
//    score, so the block writes 128 contiguous floats. bf16 rows are widened
//    exactly and each score is one fmaf chain in order; a bf16 index has no
//    scales.

#include <algorithm>
#include <atomic>

#include "bin_dot.cuh"
#include "gather_tc.cuh"

namespace sskd {

template <int MODE>
__global__ void __launch_bounds__(BIN_W) bin_gather_kernel(
    const uint32_t* __restrict__ q, const float* __restrict__ q_scale,
    const uint32_t* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ bins, float* __restrict__ out,
    int kb, long n_rows, int row_words, long valid_n) {
  __shared__ __align__(16) uint32_t s_rows[BIN_W * RS];
  __shared__ __align__(16) uint32_t s_q[QWords<MODE>::value];

  const int tid = threadIdx.x;
  const long slot = blockIdx.x;  // b * kb + s
  const int b = (int)(slot / kb);
  const long row0 = (long)bins[slot] * BIN_W;
  const long row = row0 + tid;

  typename AccT<MODE>::type acc[1];
  bin_dot<MODE, 1>(acc, q, b, 1, corpus, row0, n_rows, row_words, s_rows, s_q);
  float s = NEG_INF;
  if (row < valid_n) {
    s = (float)acc[0];
    if (MODE == I8 || MODE == I4) s = s * q_scale[b] * scales[row];
    else if (scales != nullptr) s = s * scales[row];
  }
  out[slot * BIN_W + tid] = s;
}

constexpr int GATHER_WARPS = 2;  // independent one-warp jobs a block holds
static_assert(tc_smem_bytes(GATHER_WARPS, 1, TC_MAX_ROW_BYTES, TC_BF16) <= 48 * 1024,
              "no opt-in shared memory needed");

// ROW: TC_S8 (int8 rows) or TC_I4 (packed int4 rows), int8 queries
template <int ROW>
__global__ void __launch_bounds__(GATHER_WARPS * 32) bin_gather_tc_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ q_scale,
    const int8_t* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ bins, const long long* __restrict__ order, float* __restrict__ out,
    int n_pairs, int kb, int row_bytes, int run_len, long n_rows, long valid_n) {
  gather_tc<GATHER_WARPS, 1, ROW>(q, q_scale, corpus, scales, bins, order, out, n_pairs, kb,
                                  BIN_W, row_bytes, BIN_W / TC_TILE, run_len, n_rows, valid_n);
}

// bf16 rows, f32 queries split into three bf16 terms; scales optional
__global__ void __launch_bounds__(GATHER_WARPS * 32) bin_gather_bf16_tc_kernel(
    const float* __restrict__ q, const uint16_t* __restrict__ corpus,
    const float* __restrict__ scales, const int* __restrict__ bins,
    const long long* __restrict__ order, float* __restrict__ out, int n_pairs, int kb,
    int row_bytes, int run_len, long n_rows, long valid_n) {
  gather_tc<GATHER_WARPS, 1, TC_BF16>(reinterpret_cast<const int8_t*>(q), nullptr,
                                      reinterpret_cast<const int8_t*>(corpus), scales, bins,
                                      order, out, n_pairs, kb, BIN_W, row_bytes,
                                      BIN_W / TC_TILE, run_len, n_rows, valid_n);
}

// ---------------------------------------------------------------------------
// f32 rows on the tensor cores
// ---------------------------------------------------------------------------

constexpr int GF_CK = 32;          // floats of a row a chunk of a warp's ring
constexpr int GF_LD = GF_CK + 4;   // the ring's row stride in floats: the A reads (row grp,
                                   // k tig) hit 32 distinct banks
constexpr size_t GF_SMEM_MAX = 227 * 1024;  // shared memory a block may hold

// The row stride, in floats, of a group's staged queries: the row rounded up to
// whole chunks plus 4 (= 4 mod 32, so that the B reads (query grp, k tig) hit 32
// distinct banks).
__host__ __device__ constexpr int gf_query_ld(int dim) {
  return (dim + GF_CK - 1) / GF_CK * GF_CK + 4;
}
// Shared memory of bin_gather_f32_tc_kernel<WARPS, QMAX, STAGES> for rows of dim
// floats and groups of at most q_cap queries: each warp's ring of STAGES chunks of
// its 16 rows, the group's queries as TF32 hi and lo terms, the rows' scales, and
// the pairs of the block's run and their bins.
__host__ __device__ constexpr size_t gf_smem_bytes(int warps, int qmax, int stages, int dim,
                                                   int q_cap) {
  return 4 * ((size_t)warps * stages * 16 * GF_LD + 2 * (size_t)q_cap * gf_query_ld(dim) +
              (size_t)warps * 16 + 2 * qmax);
}

// What a warp needs to score one group of equal bins (bin_gather_f32_tc_kernel).
struct GfGroup {
  float* ring;                 // the warp's ring of STAGES chunks of its 16 rows
  const uint32_t* s_hi;        // the group's queries, TF32 hi terms, [n_q][ldq]
  const uint32_t* s_lo;        //   and lo terms
  const float* s_scale;        // the block's rows' scales (scaled only)
  const int* s_pair;           // the group's pairs
  const float* corpus;
  float* out;
  long wrow0, row0, n_rows, valid_n;  // the warp's first row, the block's
  int dim, ldq, n_chunks, n_q, r0, warp, lane;
  bool scaled;
};

// chunk ch of the warp's 16 rows into its stage (rows past the corpus, and the
// row past dim, as zeros): a lane four 16-byte pieces
template <int STAGES>
__device__ __forceinline__ void gf_load_chunk(const GfGroup& G, int ch) {
  constexpr int TILE = 16 * GF_LD;
  float* dst = G.ring + (ch % STAGES) * TILE;
  const int k0 = ch * GF_CK;
#pragma unroll
  for (int i = G.lane; i < 16 * (GF_CK / 4); i += 32) {
    const int r = i / (GF_CK / 4), k = k0 + (i % (GF_CK / 4)) * 4;
    const bool live = G.wrow0 + r < G.n_rows && k < G.dim;
    cp_async16(dst + r * GF_LD + k - k0, G.corpus + (live ? (G.wrow0 + r) * G.dim + k : 0),
               live ? 16 : 0);
  }
}

// The warp's 16 rows against the group's NG column groups of 8 queries: the
// chunks streamed through the ring (chunks 0 .. STAGES - 2 already in flight),
// each 8-deep step's three TF32 products issued a product at a time across the
// column groups, so that no mma waits on the one before it (the two into each
// group's small-term sum keep their order: lo hi, then hi lo); then the scores
// written, scaled and masked.
template <int NG, int STAGES>
__device__ __forceinline__ void gf_score(const GfGroup& G) {
  constexpr int TILE = 16 * GF_LD;
  const int grp = G.lane >> 2, tig = G.lane & 3;
  float acc[NG][4], acc_lo[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc_lo[i][j] = 0.f;
  // query gi * 8 + grp of each column group; a column past the group's queries
  // reads the last one (its scores are not written)
  int b_row[NG];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) b_row[gi] = min(gi * 8 + grp, G.n_q - 1) * G.ldq + tig;
  for (int ch = 0; ch < G.n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();  // chunk ch has landed
    __syncwarp();                 // ... for every lane; chunk ch - 1 is scored
    if (ch + STAGES - 1 < G.n_chunks) gf_load_chunk<STAGES>(G, ch + STAGES - 1);
    cp_async_commit();
    const float* a_rows = G.ring + (ch % STAGES) * TILE + grp * GF_LD + tig;
#pragma unroll
    for (int ks = 0; ks < GF_CK / 8; ++ks) {
      const float a[4] = {a_rows[ks * 8], a_rows[8 * GF_LD + ks * 8], a_rows[ks * 8 + 4],
                          a_rows[8 * GF_LD + ks * 8 + 4]};
      uint32_t ah[4], al[4];
      split_tf32_a(a, ah, al);
      const int k = ch * GF_CK + ks * 8;
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int off = b_row[gi] + k;
        bh[gi][0] = G.s_hi[off];
        bh[gi][1] = G.s_hi[off + 4];
        bl[gi][0] = G.s_lo[off];
        bl[gi][1] = G.s_lo[off + 4];
      }
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) mma_tf32(acc_lo[gi], al, bh[gi][0], bh[gi][1]);
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) mma_tf32(acc[gi], ah, bh[gi][0], bh[gi][1]);
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) mma_tf32(acc_lo[gi], ah, bl[gi][0], bl[gi][1]);
    }
  }
  // acc: rows grp and grp + 8 of the warp's tile, queries 8 gi + 2 tig and + 1
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    fold_lo(acc[gi], acc_lo[gi]);
#pragma unroll
    for (int cq = 0; cq < 2; ++cq) {
      const int j = gi * 8 + 2 * tig + cq;
      if (j >= G.n_q) continue;
      const long base = (long)G.s_pair[j] * BIN_W + G.r0 + G.warp * 16;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = G.warp * 16 + grp + 8 * rr;
        const float v = acc[gi][2 * rr + cq];
        G.out[base + grp + 8 * rr] =
            G.row0 + r < G.valid_n ? (G.scaled ? v * G.s_scale[r] : v) : NEG_INF;
      }
    }
  }
}

// gf_score at the group's count of column groups, n_grp in [NG, MAX_NG]: each
// count its own unrolled code, with no branch among the mma
template <int NG, int MAX_NG, int STAGES>
__device__ __forceinline__ void gf_score_groups(const GfGroup& G, int n_grp) {
  if constexpr (NG < MAX_NG) {
    if (n_grp > NG) {
      gf_score_groups<NG + 1, MAX_NG, STAGES>(G, n_grp);
      return;
    }
  }
  gf_score<NG, STAGES>(G);
}

// out[pair, t] = dot(row, q b) (* scale[row]) for row = bins[pair] * 128 + t, b = pair /
// kb, f32 rows and queries, each product as three TF32 products (mma_common.cuh
// mma_3xtf32: hi hi into the sum, lo hi and hi lo into a sum of their own, added once
// at the end), the 8-deep steps of the row in order.
//
// The entries i (the pair order[i], or i for order NULL) come in runs of run_len
// (<= QMAX) taken by 8 / WARPS blocks each, a block WARPS 16-row tiles of the bin, a
// warp one tile: block j takes run j / (8 / WARPS) and rows (j % (8 / WARPS)) * 16
// WARPS of its bin. A run is cut into groups of neighbouring entries of one bin; a
// group's n_q queries are the B fragments of n_q / 8 rounded up mma columns of 8, so
// that each tile is read once for them all (gf_score, unrolled for each count of
// column groups). With order the pairs sorted by bin, every group but a run's first
// and last holds run_len queries of one bin; in the pairs' own order (order NULL,
// run_len 1) a block scores one pair.
//
// A group's queries are brought into shared memory by cp.async, all at once, and
// split there once into their TF32 hi and lo terms by the block; each warp
// streams its own 16 rows through a ring of STAGES chunks of GF_CK floats by
// cp.async (the first chunks in flight while the queries are staged), each chunk
// scored while the next STAGES - 1 arrive, with no barrier beyond the warp: three
// __syncthreads a group.
template <int WARPS, int QMAX, int STAGES>
__global__ void __launch_bounds__(WARPS * 32) bin_gather_f32_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ corpus,
    const float* __restrict__ scales, const int* __restrict__ bins,
    const long long* __restrict__ order, float* __restrict__ out, int n_pairs, int kb, int dim,
    int run_len, long n_rows, long valid_n) {
  constexpr int ROWS = WARPS * 16, THREADS = WARPS * 32, PARTS = 8 / WARPS;
  constexpr int TILE = 16 * GF_LD;  // floats of a stage of a warp's ring
  static_assert(STAGES >= 2 && QMAX % 8 == 0 && QMAX <= THREADS && 8 % WARPS == 0, "layout");
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (dim + GF_CK - 1) / GF_CK, ldq = gf_query_ld(dim);
  float* ring = fsm + warp * STAGES * TILE;
  uint32_t* s_hi = reinterpret_cast<uint32_t*>(fsm + WARPS * STAGES * TILE);  // [run_len][ldq]
  uint32_t* s_lo = s_hi + (size_t)run_len * ldq;
  float* s_scale = reinterpret_cast<float*>(s_lo + (size_t)run_len * ldq);  // [ROWS]
  int* s_pair = reinterpret_cast<int*>(s_scale + ROWS);  // [QMAX]: the run's pairs
  int* s_bin = s_pair + QMAX;                            // [QMAX]: and their bins

  const int run = blockIdx.x / PARTS;
  const int r0 = (blockIdx.x % PARTS) * ROWS;  // the block's first row of the bin
  const int s = run * run_len, e = min(s + run_len, n_pairs);
  const bool scaled = scales != nullptr;

  // the run's pairs and bins, read once and side by side
  if (tid < e - s) {
    const int pair = order != nullptr ? (int)__ldg(order + s + tid) : s + tid;
    s_pair[tid] = pair;
    s_bin[tid] = __ldg(bins + pair);
  }
  __syncthreads();
  for (int g = s; g < e;) {
    const int c = s_bin[g - s];
    int g_end = g + 1;
    while (g_end < e && s_bin[g_end - s] == c) ++g_end;
    const int n_q = g_end - g;
    const long row0 = (long)c * BIN_W + r0;
    const int* pairs = s_pair + (g - s);
    GfGroup G{ring, s_hi, s_lo, s_scale, pairs, corpus, out, row0 + warp * 16, row0, n_rows,
              valid_n, dim, ldq, n_chunks, n_q, r0, warp, lane, scaled};
    __syncthreads();  // the group before is done with the queries and s_scale
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_chunks) gf_load_chunk<STAGES>(G, i);
      cp_async_commit();
    }
    if (scaled && tid < ROWS) s_scale[tid] = row0 + tid < n_rows ? __ldg(scales + row0 + tid) : 0.f;
    // the group's queries into s_hi by cp.async, all in flight at once (zeros
    // past dim), then each split in place into its hi and lo terms
    const int q4 = (ldq - 4) / 4;
    for (int i = tid; i < n_q * q4; i += THREADS) {
      const int j = i / q4, k = (i % q4) * 4;
      const bool live = k < dim;
      cp_async16(s_hi + (size_t)j * ldq + k, q + (live ? (long)(pairs[j] / kb) * dim + k : 0),
                 live ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < n_q * (ldq - 4); i += THREADS) {
      const size_t at = (size_t)(i / (ldq - 4)) * ldq + i % (ldq - 4);
      split_tf32(__uint_as_float(s_hi[at]), s_hi[at], s_lo[at]);
    }
    __syncthreads();
    gf_score_groups<1, QMAX / 8, STAGES>(G, (n_q + 7) / 8);
    g = g_end;
  }
}

// The queries a group may stage for rows of dim floats within a block's shared
// memory (the run length the layout takes, capped there).
template <int WARPS, int QMAX, int STAGES>
static int gf_run_cap(int dim) {
  int cap = QMAX;
  while (cap > 1 && gf_smem_bytes(WARPS, QMAX, STAGES, dim, cap) > GF_SMEM_MAX) --cap;
  return cap;
}

// Launches bin_gather_f32_tc_kernel<WARPS, QMAX, STAGES> over n_pairs entries in runs
// of run_len (<= QMAX, capped at what the rows' length lets a block stage):
// ceil(n_pairs / run_len) * 8 / WARPS blocks. The kernel's shared memory limit is
// raised once a device.
template <int WARPS, int QMAX, int STAGES>
static int gf_launch(const float* q, const float* corpus, const float* scales, const int* bins,
                     const long long* order, float* out, long n_pairs, int kb, int dim,
                     int run_len, long n_rows, long valid_n, cudaStream_t stream) {
  run_len = std::min(run_len, gf_run_cap<WARPS, QMAX, STAGES>(dim));
  const size_t smem = gf_smem_bytes(WARPS, QMAX, STAGES, dim, run_len);
  if (run_len < 1 || smem > GF_SMEM_MAX || n_pairs > 0x7fffffffL / 8)
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised{0ull};  // the devices whose limit is raised
  int device = 0;
  int rc = (int)cudaGetDevice(&device);
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (rc == 0 && !(raised.load() & bit)) {
    rc = (int)cudaFuncSetAttribute(bin_gather_f32_tc_kernel<WARPS, QMAX, STAGES>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GF_SMEM_MAX);
    if (rc == 0) raised |= bit;
  }
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)((n_pairs + run_len - 1) / run_len * (8 / WARPS));
  bin_gather_f32_tc_kernel<WARPS, QMAX, STAGES><<<grid, WARPS * 32, smem, stream>>>(
      q, corpus, scales, bins, order, out, (int)n_pairs, kb, dim, run_len, n_rows, valid_n);
  return (int)cudaGetLastError();
}

// the two layouts of the f32 route: the pairs in their own order, a block of four
// warps a 64-row half of one pair's bin, four chunks in each warp's ring; and sorted
// by bin, a block the whole bin for up to 32 of its queries, four chunks
constexpr int GF_OWN_WARPS = 4, GF_OWN_QMAX = 8, GF_OWN_STAGES = 4;
constexpr int GF_SORT_WARPS = 8, GF_SORT_QMAX = 32, GF_SORT_STAGES = 4;

}  // namespace sskd

// C interface, loaded with ctypes.
//   mode: 0 f32, 1 int8, 2 packed int4, 3 bf16. q: [B, D] f32 (f32 and bf16 rows) or int8.
//   q_scale: [B] f32 (int modes). corpus: [n_rows, row_words] 32-bit words (a multiple of 4).
//   scales: [n_rows] f32 (int modes), or NULL or [n_rows] f32 (f32 and bf16).
//   bins: [B, kb] int32, each in [0, ceil(n_rows / 128)). out: [B, kb, 128] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_bin_gather(int mode, const void* q, const float* q_scale,
                               const void* corpus, const float* scales, const int* bins,
                               float* out, int B, int kb, long n_rows, int row_words,
                               long valid_n, void* stream) {
  using namespace sskd;
  if (B <= 0 || kb <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((long)B * kb);
  const uint32_t* qw = (const uint32_t*)q;
  const uint32_t* cw = (const uint32_t*)corpus;
  if (mode == F32)
    bin_gather_kernel<F32><<<grid, BIN_W, 0, s>>>(qw, q_scale, cw, scales, bins, out, kb, n_rows, row_words, valid_n);
  else if (mode == I8)
    bin_gather_kernel<I8><<<grid, BIN_W, 0, s>>>(qw, q_scale, cw, scales, bins, out, kb, n_rows, row_words, valid_n);
  else if (mode == I4)
    bin_gather_kernel<I4><<<grid, BIN_W, 0, s>>>(qw, q_scale, cw, scales, bins, out, kb, n_rows, row_words, valid_n);
  else if (mode == BF16)
    bin_gather_kernel<BF16><<<grid, BIN_W, 0, s>>>(qw, q_scale, cw, scales, bins, out, kb, n_rows, row_words, valid_n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The tensor-core route. mode: 1 int8 rows, 2 packed int4 rows (queries of 2 row_bytes
//   int8), q_scale and scales required; 3 bf16 rows (queries of row_bytes / 2 floats),
//   q_scale unused, scales NULL or [n_rows] f32. row_bytes a multiple of 16 of at most
//   1,024 (int4: 512).
//   bins: [B * kb] int32, the bins of the pairs in the order the blocks take them, each in
//   [0, ceil(n_rows / 128)); order: [B * kb] int64, the pair b * kb + s of each, or NULL for
//   the pairs in their own order (bins = the [B, kb] bins as they are). run_len >= 1: the
//   entries a block takes before the move to bin boundaries. Other arguments as above.
extern "C" int sskd_bin_gather_tc(int mode, const void* q, const float* q_scale,
                                  const void* corpus, const float* scales, const int* bins,
                                  const long long* order, float* out, int B, int kb, long n_rows,
                                  int row_bytes, long valid_n, int run_len, void* stream) {
  using namespace sskd;
  const int max_bytes = mode == I4 ? TC_MAX_ROW_BYTES / 2 : TC_MAX_ROW_BYTES;
  if ((mode != I8 && mode != I4 && mode != BF16) || B <= 0 || kb <= 0 || n_rows <= 0 ||
      run_len <= 0 || row_bytes <= 0 || row_bytes % 16 || row_bytes > max_bytes ||
      (mode != BF16 && (q_scale == nullptr || scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long n_pairs = (long)B * kb;
  const long jobs = (n_pairs + run_len - 1) / run_len * (BIN_W / TC_TILE);
  const long blocks = (jobs + GATHER_WARPS - 1) / GATHER_WARPS;
  if (n_pairs > 0x7fffffffL || jobs > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int row = mode == BF16 ? TC_BF16 : mode == I4 ? TC_I4 : TC_S8;
  const size_t smem = tc_smem_bytes(GATHER_WARPS, 1, row_bytes, row);
  const dim3 grid((unsigned)blocks), block(GATHER_WARPS * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == BF16)
    bin_gather_bf16_tc_kernel<<<grid, block, smem, s>>>(
        (const float*)q, (const uint16_t*)corpus, scales, bins, order, out, (int)n_pairs, kb,
        row_bytes, run_len, n_rows, valid_n);
  else if (mode == I4)
    bin_gather_tc_kernel<TC_I4><<<grid, block, smem, s>>>(
        (const int8_t*)q, q_scale, (const int8_t*)corpus, scales, bins, order, out,
        (int)n_pairs, kb, row_bytes, run_len, n_rows, valid_n);
  else
    bin_gather_tc_kernel<TC_S8><<<grid, block, smem, s>>>(
        (const int8_t*)q, q_scale, (const int8_t*)corpus, scales, bins, order, out,
        (int)n_pairs, kb, row_bytes, run_len, n_rows, valid_n);
  return (int)cudaGetLastError();
}

// The f32 tensor-core route (bin_gather_f32_tc_kernel). q: [B, dim] f32; corpus:
//   [n_rows, dim] f32, dim a multiple of 4; scales: NULL or [n_rows] f32; bins: [B, kb]
//   int32, each in [0, ceil(n_rows / 128)); order: NULL for the pairs in their own
//   order (a block a part of one pair's bin), or [B * kb] int64, the pairs b * kb + s
//   sorted by bin (one stable sort; a block a bin for up to GF_SORT_QMAX of them);
//   out: [B, kb, 128] f32. Returns cudaGetLastError() after the launch.
extern "C" int sskd_bin_gather_f32_tc(const float* q, const float* corpus, const float* scales,
                                      const int* bins, const long long* order, float* out,
                                      int B, int kb, long n_rows, int dim, long valid_n,
                                      void* stream) {
  using namespace sskd;
  if (B <= 0 || kb <= 0 || n_rows <= 0 || dim <= 0 || dim % 4) return (int)cudaErrorInvalidValue;
  const long n_pairs = (long)B * kb;
  cudaStream_t s = (cudaStream_t)stream;
  if (order != nullptr)
    return gf_launch<GF_SORT_WARPS, GF_SORT_QMAX, GF_SORT_STAGES>(
        q, corpus, scales, bins, order, out, n_pairs, kb, dim, GF_SORT_QMAX, n_rows, valid_n, s);
  return gf_launch<GF_OWN_WARPS, GF_OWN_QMAX, GF_OWN_STAGES>(
      q, corpus, scales, bins, nullptr, out, n_pairs, kb, dim, 1, n_rows, valid_n, s);
}
