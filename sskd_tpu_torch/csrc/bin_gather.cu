// bin_gather: phase B of the two-phase exact top-k engine.
//
// Replaces: sskd_tpu/ops/topk_pallas.py _gather_kernel (the second pallas_call
// of _pallas_body).
//
// For query b and each of its kb winning bins (bin ids chosen by the caller
// from binmax's output), rescans the bin's 128 rows exactly:
//   out[b, s, t] = dot(row, q b) * q_scale[b] * scale[row]   (int8 / int4)
//   out[b, s, t] = dot(row, q b) * scale[row]                (f32, scale optional)
// where row = bins[b, s] * 128 + t, and rows >= valid_n give finfo(f32).min / 2.
// For int8 and int4 the dot is the exact int32 sum (the TPU kernel reaches the
// same integer through an f32 dot of integer values), then multiplied by the
// query scale and the row scale in that order.
//
// Bound on the H100: B * kb * 128 rows are read (B=64, k=10 at 384 int8 bytes
// is 31 MB, ~9 us at 3.35 TB/s) plus the output; the dp4a work is small.
//
// Design: one block per (query, bin slot), the shared inner loop of
// bin_dot.cuh with a one-query tile; each thread writes its row's score, so the
// block writes 128 contiguous floats.

#include "bin_dot.cuh"

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
    if (MODE != F32) s = s * q_scale[b] * scales[row];
    else if (scales != nullptr) s = s * scales[row];
  }
  out[slot * BIN_W + tid] = s;
}

}  // namespace sskd

// C interface, loaded with ctypes.
//   mode: 0 f32, 1 int8, 2 packed int4. q: [B, D] f32 or int8. q_scale: [B] f32 (int modes).
//   corpus: [n_rows, row_words] 32-bit words. scales: [n_rows] f32 or NULL (f32 mode only).
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
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
