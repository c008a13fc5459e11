// binmax: phase A of the two-phase exact top-k engine.
//
// Replaces: sskd_tpu/ops/topk_pallas.py _binmax_kernel (reached through
// _binmax_dispatch and the first pallas_call of _pallas_body).
//
// Computes, for every 128-row bin g of the corpus and every query b,
//   out[g, b] = max over rows r of bin g of (dot(row r, q b) * scale[r]),
// with rows r >= valid_n set to finfo(f32).min / 2 before the max. The dot is
// f32, int8 x int8 summed in int32, or packed int4 nibbles (halves layout)
// against int8 queries. The per-query int8 scale is NOT applied: it is a
// positive factor per column and cannot change a query's ranking of bins, so
// the caller never needs it here (same contract as the TPU kernel).
//
// Bound on the H100: the corpus is read once, so at serving batch sizes the
// kernel is bound by device-memory bytes (N * row_bytes over 3.35 TB/s; 1M x
// 384 int8 is 384 MB, about 115 us). At B >= ~64 the dp4a work on CUDA cores
// takes over: tensor-core int8 (mma.sync / wgmma) is the next step.
//
// Design: one block per bin (bin_dot.cuh stages the bin's rows through shared
// memory in 128-byte chunks), the query batch walked in tiles of QT queries so
// the bin is read from device memory once and from L2/shared memory for later
// tiles. Each thread scales and masks its row's score, a warp shuffle takes the
// max over 32 rows, and four partial maxima per query meet in shared memory.
// A ragged last bin is handled in the kernel (rows >= N are zero-filled and
// masked), so the corpus needs no padding.
//
// binmax_strided_kernel (sskd_binmax_strided) is the approx engine's pass. It
// stands in for the binned reduction of lax.approx_max_k (sskd_tpu/ops/topk.py
// _approx_topk), which XLA fuses into the matmul on the TPU. It returns the
// maximum AND the row that holds it, for bins whose rows lie far apart: with G
// blocks, block j walks the 128-row tiles j, j + G, j + 2G, ... and thread t
// keeps the best of its own rows, so bin (j, t) holds the rows (j + i G) * 128 + t.
// A top-k over such bins loses a result only when two of a query's top k share a
// bin, and near neighbours are often stored side by side (the chunks of one
// document; the cells of a clustered index, where bins of contiguous rows read
// recall@10 0.68 against exact search over 1,000,000 cell-ordered int8 rows in
// chip_smoke.py's clustered phase): rows G * 128 apart are not. No shuffle and no
// shared reduction is needed, the lowest row wins a tie because a later row replaces
// the best only when it is strictly greater, and the same byte bound holds
// (the corpus once, plus G * 128 * B * 8 bytes of output).
//
// binmax_strided has two kernels, chosen by the wrapper (ops/topk_kernels.py
// binmax_strided_route). f32, int4 and int8 rows above 1,024 bytes take
// binmax_strided_kernel on the CUDA cores (bin_dot.cuh, dp4a): a block re-reads
// its tiles for every 32 queries, and its running best costs ~220 registers,
// so few warps hide the synchronous loads. int8 rows of at most 1,024 bytes take
// binmax_strided_tc_kernel:
//  - Logical block j is ST_PARTS CUDA blocks of ST_WARPS warps, each warp
//    owning 16 row positions t of every 128-row tile: the bins are unchanged.
//  - A block stages its chunk of up to 64 queries once, as the B fragments of
//    mma.sync m16n8k32 s8 in shared memory (24 KB at 64 queries of 384
//    bytes), and reads the corpus once for them: above 64 queries the blocks
//    of the other chunks of the same tiles run beside it (the chunk is the
//    fastest index of the grid) and find the tiles in L2.
//  - Each warp has its own ring of two 16-row tiles filled by cp.async (a
//    tile is 16 contiguous rows, so a warp's copy is one coalesced run), and
//    waits on its own copies only: no block barrier after the queries. Two
//    stages beat three on the card at every batch: at 76 KB of shared memory
//    three blocks fit an SM, at 102 KB two.
//  - Per tile and 32-byte step, one ldmatrix A fragment (rows padded by
//    tc_stride) meets each 8-query group's B fragment: 12 mma per group for
//    384-byte rows, exact int32 sums.
//  - (float)acc * scale[row], NEG_INF at rows >= valid_n, is held against the
//    running best in registers in the C-fragment layout; a tile replaces it
//    only when strictly greater, in increasing tile order, so the lowest row
//    wins, and a bin of no valid row keeps NEG_INF and its first row.

#include "bin_dot.cuh"

namespace sskd {

template <int MODE, int QT>
__global__ void __launch_bounds__(BIN_W) binmax_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ out,
    int B, long n_rows, int row_words, long valid_n) {
  __shared__ __align__(16) uint32_t s_rows[BIN_W * RS];
  __shared__ __align__(16) uint32_t s_q[QT * QWords<MODE>::value];
  __shared__ float s_red[BIN_W / 32][QT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long bin = blockIdx.x;
  const long row0 = bin * BIN_W;
  const long row = row0 + tid;
  const float scale = (scales != nullptr && row < n_rows) ? scales[row] : 1.0f;
  const bool live = row < valid_n;

  for (int q0 = 0; q0 < B; q0 += QT) {
    const int nq = min(QT, B - q0);
    typename AccT<MODE>::type acc[QT];
    bin_dot<MODE, QT>(acc, q, q0, nq, corpus, row0, n_rows, row_words, s_rows, s_q);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      float s = live ? (float)acc[j] * scale : NEG_INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) s_red[warp][j] = s;
    }
    __syncthreads();
    if (tid < nq) {
      float m = s_red[0][tid];
#pragma unroll
      for (int w = 1; w < BIN_W / 32; ++w) m = fmaxf(m, s_red[w][tid]);
      out[bin * B + q0 + tid] = m;
    }
    // s_red is rewritten only after bin_dot's next __syncthreads
  }
}

template <int MODE, int QT>
__global__ void __launch_bounds__(BIN_W) binmax_strided_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ out, int* __restrict__ arg,
    int B, long n_rows, int row_words, long valid_n) {
  __shared__ __align__(16) uint32_t s_rows[BIN_W * RS];
  __shared__ __align__(16) uint32_t s_q[QT * QWords<MODE>::value];

  const int tid = threadIdx.x;
  const long n_tiles = (n_rows + BIN_W - 1) / BIN_W;
  const long bin = (long)blockIdx.x * BIN_W + tid;

  for (int q0 = 0; q0 < B; q0 += QT) {
    const int nq = min(QT, B - q0);
    float best[QT];
    int best_tile[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) { best[j] = NEG_INF; best_tile[j] = (int)blockIdx.x; }
    for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long row0 = tile * BIN_W;
      const long row = row0 + tid;
      const float scale = (scales != nullptr && row < n_rows) ? scales[row] : 1.0f;
      const bool live = row < valid_n;
      typename AccT<MODE>::type acc[QT];
      bin_dot<MODE, QT>(acc, q, q0, nq, corpus, row0, n_rows, row_words, s_rows, s_q);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float s = live ? (float)acc[j] * scale : NEG_INF;
        if (s > best[j]) { best[j] = s; best_tile[j] = (int)tile; }
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (j < nq) {
        out[bin * B + q0 + j] = best[j];
        arg[bin * B + q0 + j] = best_tile[j] * BIN_W + tid;
      }
    }
  }
}

constexpr int ST_WARPS = 4;                // a warp scores 16 row positions of a tile
constexpr int ST_ROWS = ST_WARPS * 16;     // row positions of a tile a block owns
constexpr int ST_PARTS = BIN_W / ST_ROWS;  // CUDA blocks of one logical block
constexpr int ST_STAGES = 2;               // tiles in a warp's ring
constexpr int ST_QUERIES = 64;             // queries of a chunk: 8 groups of 8
constexpr int ST_MAX_ROW_BYTES = 1024;

__host__ __device__ constexpr int st_stage_bytes(int row_bytes) {
  return 16 * tc_stride(row_bytes) + 16 * (int)sizeof(float);
}
__host__ __device__ constexpr size_t st_query_bytes(int groups, int row_bytes) {
  return (size_t)groups * (tc_stride(row_bytes) / 32) * 32 * sizeof(uint2);
}
__host__ __device__ constexpr size_t st_smem_bytes(int groups, int row_bytes) {
  return st_query_bytes(groups, row_bytes) +
         (size_t)ST_WARPS * ST_STAGES * st_stage_bytes(row_bytes);
}
static_assert(st_smem_bytes(ST_QUERIES / 8, ST_MAX_ROW_BYTES) <= 227 * 1024,
              "the longest row fits a block");

// NG: the 8-query groups of a chunk (1, 2, 4 or 8). Grid: blocks * ST_PARTS *
// chunks, block (j, part, chunk) at ((j * ST_PARTS + part) * chunks + chunk).
template <int NG>
__global__ void __launch_bounds__(ST_WARPS * 32) binmax_strided_tc_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ out, int* __restrict__ arg,
    int B, long n_rows, int row_bytes, long valid_n, int blocks, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_stride(row_bytes), n_k = ld / 32;
  const int stage_bytes = st_stage_bytes(row_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int chunk = blockIdx.x % chunks;
  const int unit = blockIdx.x / chunks;
  const int j = unit / ST_PARTS;
  const int t0 = (unit % ST_PARTS) * ST_ROWS + warp * 16;  // the warp's first row position
  const int q0 = chunk * ST_QUERIES;
  const int nq = min(NG * 8, B - q0);

  // the chunk's queries as B fragments, [group][step][lane] (b0, b1); absent
  // queries and the tail past the row's bytes are zeros
  uint2* s_qf = reinterpret_cast<uint2*>(smem);
  for (int i = tid; i < NG * n_k * 32; i += ST_WARPS * 32) {
    const int l = i & 31, ks = (i >> 5) % n_k, n = (i >> 5) / n_k;
    const int qq = n * 8 + (l >> 2), k0 = ks * 32 + 4 * (l & 3);
    uint2 v = make_uint2(0u, 0u);
    if (qq < nq) {
      const int8_t* qr = q + (long)(q0 + qq) * row_bytes;
      if (k0 < row_bytes) v.x = __ldg(reinterpret_cast<const uint32_t*>(qr + k0));
      if (k0 + 16 < row_bytes) v.y = __ldg(reinterpret_cast<const uint32_t*>(qr + k0 + 16));
    }
    s_qf[i] = v;
  }
  __syncthreads();

  // the warp's ring: ST_STAGES x (16 rows of stride ld, then their 16 scales)
  unsigned char* ring = smem + st_query_bytes(NG, row_bytes) + warp * ST_STAGES * stage_bytes;
  const long n_tiles = (n_rows + BIN_W - 1) / BIN_W;
  const int n_mine = (int)((n_tiles - 1 - j) / blocks) + 1;  // tiles j, j + blocks, ...
  const int row_chunks = ld / 16 - 1;  // 16-byte pieces of a padded row
  const int chunks16 = row_bytes / 16;  // of them, those the row fills
  // the warp's 16 rows of the i-th tile into stage st: 16 contiguous rows, a
  // lane a 16-byte piece; rows past the corpus and the tail as zeros
  auto load = [&](int i, int st) {
    unsigned char* dst = ring + st * stage_bytes;
    const long row0 = ((long)j + (long)i * blocks) * BIN_W + t0;
    for (int p = lane; p < 16 * row_chunks; p += 32) {
      const int r = p / row_chunks, k = p - r * row_chunks;
      const bool live = row0 + r < n_rows && k < chunks16;
      cp_async16(dst + r * ld + k * 16, corpus + (live ? (row0 + r) * row_bytes + k * 16 : 0),
                 live ? 16 : 0);
    }
    if (lane < 16 && row0 + lane < n_rows)
      cp_async4(dst + 16 * ld + lane * 4, scales + row0 + lane);
  };

  float best[NG][4];
  int best_i[NG][4];  // the tile of each best, as its turn i (tile j + i * blocks)
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { best[n][e] = NEG_INF; best_i[n][e] = 0; }

  const int a_off = s8_a_offset(ld, lane);
#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) {
    if (s < n_mine) load(s, s);
    cp_async_commit();
  }
  int st = 0;
  for (int i = 0; i < n_mine; ++i) {
    if (i + ST_STAGES - 1 < n_mine)  // into the stage the warp freed last
      load(i + ST_STAGES - 1, st == 0 ? ST_STAGES - 1 : st - 1);
    cp_async_commit();
    cp_async_wait<ST_STAGES - 1>();  // this tile has landed
    __syncwarp();
    const unsigned char* tile = ring + st * stage_bytes;
    int acc[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0;
#pragma unroll 2
    for (int ks = 0; ks < n_k; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, tile + a_off + ks * 32);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const uint2 b = s_qf[(n * n_k + ks) * 32 + lane];
        mma_s8(acc[n], a, b.x, b.y);
      }
    }
    // acc[n]: rows t0 + grp (e 0, 1) and t0 + grp + 8 (e 2, 3), queries
    // n * 8 + 2 tig + (e & 1)
    const long row0 = ((long)j + (long)i * blocks) * BIN_W + t0;
    const float* sc = reinterpret_cast<const float*>(tile + 16 * ld);
    const float sc_lo = sc[grp], sc_hi = sc[grp + 8];
    if (row0 + 16 <= valid_n) {  // the warp's rows all valid: no mask
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = (float)acc[n][e] * (e < 2 ? sc_lo : sc_hi);
          if (s > best[n][e]) { best[n][e] = s; best_i[n][e] = i; }
        }
    } else {
      const bool live_lo = row0 + grp < valid_n, live_hi = row0 + grp + 8 < valid_n;
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = e < 2 ? live_lo : live_hi;
          const float s = live ? (float)acc[n][e] * (e < 2 ? sc_lo : sc_hi) : NEG_INF;
          if (s > best[n][e]) { best[n][e] = s; best_i[n][e] = i; }
        }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    st = st + 1 == ST_STAGES ? 0 : st + 1;
  }
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * tig + (e & 1);
      if (col < nq) {
        const int t = t0 + grp + 8 * (e >> 1);
        const long o = ((long)j * BIN_W + t) * B + q0 + col;
        out[o] = best[n][e];
        arg[o] = (int)(((long)j + (long)best_i[n][e] * blocks) * BIN_W + t);
      }
    }
}

template <int NG>
static int launch_strided_tc(const void* q, const void* corpus, const float* scales, float* out,
                             int* arg, int B, long n_rows, int row_bytes, long valid_n,
                             int blocks, int chunks, cudaStream_t stream) {
  const size_t smem = st_smem_bytes(NG, row_bytes);
  const cudaError_t e = cudaFuncSetAttribute(
      binmax_strided_tc_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  binmax_strided_tc_kernel<NG><<<(unsigned)((long)blocks * ST_PARTS * chunks), ST_WARPS * 32,
                                 smem, stream>>>(
      (const int8_t*)q, (const int8_t*)corpus, scales, out, arg, B, n_rows, row_bytes, valid_n,
      blocks, chunks);
  return (int)cudaGetLastError();
}

template <int MODE>
static void launch_strided(const void* q, const void* corpus, const float* scales, float* out,
                           int* arg, int B, long n_rows, int row_words, long valid_n, int blocks,
                           cudaStream_t stream) {
  const uint32_t* qw = (const uint32_t*)q;
  const uint32_t* cw = (const uint32_t*)corpus;
  if (B == 1)
    binmax_strided_kernel<MODE, 1><<<blocks, BIN_W, 0, stream>>>(
        qw, cw, scales, out, arg, B, n_rows, row_words, valid_n);
  else if (B <= 4)
    binmax_strided_kernel<MODE, 4><<<blocks, BIN_W, 0, stream>>>(
        qw, cw, scales, out, arg, B, n_rows, row_words, valid_n);
  else if (B <= 16)
    binmax_strided_kernel<MODE, 16><<<blocks, BIN_W, 0, stream>>>(
        qw, cw, scales, out, arg, B, n_rows, row_words, valid_n);
  else
    binmax_strided_kernel<MODE, 32><<<blocks, BIN_W, 0, stream>>>(
        qw, cw, scales, out, arg, B, n_rows, row_words, valid_n);
}

template <int MODE, int QT>
static void launch(const void* q, const void* corpus, const float* scales, float* out,
                   int B, long n_rows, int row_words, long valid_n, cudaStream_t stream) {
  const long n_bins = (n_rows + BIN_W - 1) / BIN_W;
  binmax_kernel<MODE, QT><<<(unsigned)n_bins, BIN_W, 0, stream>>>(
      (const uint32_t*)q, (const uint32_t*)corpus, scales, out, B, n_rows, row_words, valid_n);
}

template <int MODE>
static void launch_mode(const void* q, const void* corpus, const float* scales, float* out,
                        int B, long n_rows, int row_words, long valid_n, cudaStream_t stream) {
  if (B == 1) launch<MODE, 1>(q, corpus, scales, out, B, n_rows, row_words, valid_n, stream);
  else if (B <= 4) launch<MODE, 4>(q, corpus, scales, out, B, n_rows, row_words, valid_n, stream);
  else if (B <= 16) launch<MODE, 16>(q, corpus, scales, out, B, n_rows, row_words, valid_n, stream);
  else launch<MODE, 32>(q, corpus, scales, out, B, n_rows, row_words, valid_n, stream);
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   mode: 0 f32, 1 int8, 2 packed int4. q: [B, D] f32 or int8. corpus: [n_rows, row_words]
//   32-bit words. scales: [n_rows] f32 or NULL. out: [ceil(n_rows / 128), B] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_binmax(int mode, const void* q, const void* corpus, const float* scales,
                           float* out, int B, long n_rows, int row_words, long valid_n,
                           void* stream) {
  using namespace sskd;
  if (n_rows <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == F32) launch_mode<F32>(q, corpus, scales, out, B, n_rows, row_words, valid_n, s);
  else if (mode == I8) launch_mode<I8>(q, corpus, scales, out, B, n_rows, row_words, valid_n, s);
  else if (mode == I4) launch_mode<I4>(q, corpus, scales, out, B, n_rows, row_words, valid_n, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The approx engine's pass. Arguments as sskd_binmax, and: arg [blocks * 128, B] int32, the
// row of each bin's maximum (a bin of no valid row: NEG_INF and its first row); out has the
// same shape; blocks in [1, ceil(n_rows / 128)]; n_rows + 128 < 2^31.
extern "C" int sskd_binmax_strided(int mode, const void* q, const void* corpus,
                                   const float* scales, float* out, int* arg, int B,
                                   long n_rows, int row_words, long valid_n, int blocks,
                                   void* stream) {
  using namespace sskd;
  if (n_rows <= 0 || B <= 0 || arg == nullptr || n_rows + BIN_W > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if (blocks < 1 || blocks > (n_rows + BIN_W - 1) / BIN_W) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == F32) launch_strided<F32>(q, corpus, scales, out, arg, B, n_rows, row_words, valid_n, blocks, s);
  else if (mode == I8) launch_strided<I8>(q, corpus, scales, out, arg, B, n_rows, row_words, valid_n, blocks, s);
  else if (mode == I4) launch_strided<I4>(q, corpus, scales, out, arg, B, n_rows, row_words, valid_n, blocks, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The tensor-core route of the approx engine's pass: int8 rows only, row_bytes a multiple
// of 16 of at most 1,024; scales required. Arguments and results as sskd_binmax_strided.
extern "C" int sskd_binmax_strided_tc(const void* q, const void* corpus, const float* scales,
                                      float* out, int* arg, int B, long n_rows, int row_bytes,
                                      long valid_n, int blocks, void* stream) {
  using namespace sskd;
  if (n_rows <= 0 || B <= 0 || arg == nullptr || scales == nullptr ||
      n_rows + BIN_W > 0x7fffffffL || row_bytes <= 0 || row_bytes % 16 ||
      row_bytes > ST_MAX_ROW_BYTES)
    return (int)cudaErrorInvalidValue;
  if (blocks < 1 || blocks > (n_rows + BIN_W - 1) / BIN_W) return (int)cudaErrorInvalidValue;
  const int chunks = (B + ST_QUERIES - 1) / ST_QUERIES;
  if ((long)blocks * ST_PARTS * chunks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 8)
    return launch_strided_tc<1>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
  if (B <= 16)
    return launch_strided_tc<2>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
  if (B <= 32)
    return launch_strided_tc<4>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
  return launch_strided_tc<8>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
}
