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
