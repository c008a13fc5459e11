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
// fetched in turn.
//
// Three kernels, chosen by the wrapper (ops/topk_kernels.py bin_gather_route):
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
// 3. f32 rows, longer int8, int4 and bf16 rows: bin_gather_kernel, one
//    block per (query, bin slot), the shared inner loop of bin_dot.cuh with a
//    one-query tile (int8 and int4 by dp4a); each thread writes its row's
//    score, so the block writes 128 contiguous floats. bf16 rows are widened
//    exactly and each score is one fmaf chain in order; a bf16 index has no
//    scales.

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
