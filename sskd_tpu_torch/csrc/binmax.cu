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
