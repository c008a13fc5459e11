// binmax: phase A of the two-phase exact top-k engine.
//
// Replaces: sskd_tpu/ops/topk_pallas.py _binmax_kernel (reached through
// _binmax_dispatch and the first pallas_call of _pallas_body).
//
// Computes, for every 128-row bin g of the corpus and every query b,
//   out[g, b] = max over rows r of bin g of (dot(row r, q b) * scale[r]),
// with rows r >= valid_n set to finfo(f32).min / 2 before the max. The dot is
// f32, bf16 rows widened exactly against f32 queries with f32 sums (the TPU
// kernel's bf16 branch), int8 x int8 summed in int32, or packed int4 nibbles
// (halves layout) against int8 queries. The per-query int8 scale is NOT applied: it is a
// positive factor per column and cannot change a query's ranking of bins, so
// the caller never needs it here (same contract as the TPU kernel).
//
// Bound on the H100: the corpus is read once, so at serving batch sizes the
// kernel is bound by device-memory bytes (N * row_bytes over 3.35 TB/s; 1M x
// 384 int8 is 384 MB, about 115 us, and packed int4 192 MB, about 57 us);
// packed int4 at B = 256 by the int8 mma operations (2 B N D over 1,979
// TOP/s: 0.099 ms at 1M x 384, above its 57 us of bytes); f32 at B = 256 by
// its FMA (2 B N D over 67 TFLOP/s, 2.93 ms at 1M x 384), and so is bf16
// above about 20 queries (768 MB of 1M x 384 bf16 rows take 0.229 ms).
//
// binmax has three kernels, chosen by the wrapper (ops/topk_kernels.py
// binmax_route), the first and third in two row types each:
//  - binmax_tc_kernel, int8 rows of at most 1,024 bytes and packed int4 rows
//    of at most 512 (D <= 1,024), on the tensor cores. The design of
//    binmax_strided_tc_kernel below (queries staged once per block as
//    mma.sync m16n8k32 s8 B fragments, a warp's 16-row tiles through its own
//    two-stage cp.async ring, exact int32 sums) with one maximum a bin:
//    a warp owns one bin of 128 contiguous rows at a time (eight tiles, one
//    48 KB run at 384-byte rows), keeps the masked, scaled running maximum in
//    registers in the C-fragment layout, and reduces it once a bin (the two
//    row halves of the fragment, then shuffles over the grp bits; lanes of
//    grp 0 write). Above 16 queries the grid fills the card once: the chunk
//    of 64 queries is the fastest index, so the blocks that share bins run
//    side by side and find them in L2, and each block walks many bins. Up to
//    16 queries a block stages at most 6 KB of fragments, little beside the
//    48 KB a bin moves: there a warp takes one bin and the block scheduler
//    evens out the tail, which a walk of 3-4 bins a warp leaves uneven.
//    Packed int4 rows (PACKED) move through the rings as they are stored, half
//    the bytes of int8 at the same D, and are unpacked in registers: one
//    ldmatrix over a 32-byte packed step gives the A fragment of those bytes,
//    whose low nibbles are the s8 fragment of dims [32 ks, 32 ks + 32) and
//    high nibbles that of dims [D/2 + 32 ks, ...) (the halves layout), each
//    against the B fragments of its half of the queries (unpack_i4): two mma
//    a packed step, the mma count of int8 at the same D.
//  - binmax_f32_kernel, f32 rows of any length, on the CUDA cores: the
//    register-tiled score tile of f32_tile.cuh (queries staged once per block,
//    or in bands of the row when 8 whole ones do not fit; each warp's rows
//    streamed in K-chunks through its own ring, an R x C tile of outer
//    products per thread, full-precision FMA: 8 x 8 over a tile of two bins
//    at 64 queries, 4 x C over one bin below), the bin's maximum taken by
//    shuffles over the row lanes of a warp and one shared-memory step across
//    warps. The grid fills the card once, the chunk the fastest index.
//    bf16 rows (the "bf16" route) take the same kernel with the tile's row
//    type bf16: half the bytes a row through the rings, widened to f32 when
//    read from shared memory, the same in-order fmaf chain a score.
//  - binmax_kernel, int8 rows above 1,024 bytes and packed int4 rows above
//    512, dp4a on the CUDA cores: one block per bin (bin_dot.cuh stages the
//    bin's rows through shared memory in 128-byte chunks), the queries in
//    tiles of QT, a warp shuffle and four partial maxima in shared memory.
// A ragged last bin is handled in every kernel (rows >= N are zero-filled and
// masked), so the corpus needs no padding. int8 and int4 results are bit for
// bit with the plain version (exact integer sums, max independent of order);
// f32 and bf16 sums run in another order than the plain version's matrix
// product (each score one fmaf chain in order, which the CPU tests write out).
//
// binmax_strided (sskd_binmax_strided) is the approx engine's pass. It
// stands in for the binned reduction of lax.approx_max_k (sskd_tpu/ops/topk.py
// _approx_topk), which XLA fuses into the matmul on the TPU. It returns the
// maximum AND the row that holds it, for bins whose rows lie far apart: with G
// blocks, block j walks the 128-row tiles j, j + G, j + 2G, ... and thread t
// keeps the best of its own rows, so bin (j, t) holds the rows (j + i G) * 128 + t.
// A top-k over such bins loses a result only when two of a query's top k share a
// bin, and near neighbours are often stored side by side (the chunks of one
// document; the cells of a clustered index, where bins of contiguous rows read
// recall@10 0.68 against exact search over 1,000,000 cell-ordered int8 rows in
// chip_smoke.py's clustered phase): rows G * 128 apart are not. The lowest row
// wins a tie because tiles are visited in increasing order and a later row
// replaces the best only when it is strictly greater, and the same byte bound
// holds (the corpus once, plus G * 128 * B * 8 bytes of output).
//
// binmax_strided has three kernels too (binmax_strided_route):
//  - binmax_strided_tc_kernel, int8 rows of at most 1,024 bytes and packed
//    int4 rows of at most 512:
//    - Logical block j is ST_PARTS CUDA blocks of ST_WARPS warps, each warp
//      owning 16 row positions t of every 128-row tile: the bins are unchanged.
//    - A block stages its chunk of up to 64 queries once, as the B fragments of
//      mma.sync m16n8k32 s8 in shared memory (24 KB at 64 queries of 384
//      bytes), and reads the corpus once for them: above 64 queries the blocks
//      of the other chunks of the same tiles run beside it (the chunk is the
//      fastest index of the grid) and find the tiles in L2.
//    - Each warp has its own ring of two 16-row tiles filled by cp.async (a
//      tile is 16 contiguous rows, so a warp's copy is one coalesced run), and
//      waits on its own copies only: no block barrier after the queries. Two
//      stages beat three on the card at every batch: at 76 KB of shared memory
//      three blocks fit an SM, at 102 KB two.
//    - Per tile and 32-byte step, one ldmatrix A fragment (rows padded by
//      tc_stride) meets each 8-query group's B fragment: 12 mma per group for
//      384-byte rows, exact int32 sums. Packed int4 rows as in binmax_tc_kernel:
//      6 packed steps of 192 bytes, each unpacked into two fragments, 12 mma.
//    - (float)acc * scale[row], NEG_INF at rows >= valid_n, is held against the
//      running best in registers in the C-fragment layout; a tile replaces it
//      only when strictly greater, in increasing tile order, so the lowest row
//      wins, and a bin of no valid row keeps NEG_INF and its first row.
//  - binmax_strided_f32_kernel, f32 and (the "bf16" route) bf16 rows: block j
//    (by query chunk) walks its tiles through the f32 score tile of
//    f32_tile.cuh and keeps the running best and its tile per (row position,
//    query) in registers, replaced only when strictly greater.
//  - binmax_strided_kernel, int8 rows above 1,024 bytes and packed int4 rows
//    above 512 (bin_dot.cuh, dp4a): a block re-reads its tiles for every 32
//    queries.

#include "bin_dot.cuh"
#include "f32_tile.cuh"

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

// --- int8 and packed int4 rows on the tensor cores (binmax_tc_kernel,
// binmax_strided_tc_kernel) ---

constexpr int ST_WARPS = 4;                // warps of a block; a warp scores 16-row tiles
constexpr int ST_ROWS = ST_WARPS * 16;     // row positions of a tile a strided block owns
constexpr int ST_PARTS = BIN_W / ST_ROWS;  // CUDA blocks of one logical strided block
constexpr int ST_STAGES = 2;               // tiles in a warp's ring
constexpr int ST_QUERIES = 64;             // queries of a chunk: 8 groups of 8
constexpr int ST_MAX_ROW_BYTES = 1024;     // int8; packed int4 rows half of it (D <= 1,024)
constexpr int BT_TILES = BIN_W / 16;       // 16-row tiles of a bin

// query halves of a row type: a packed int4 row holds dims j and D/2 + j in
// byte j, so its queries are staged as two halves of row_bytes each
__host__ __device__ constexpr int st_halves(bool packed) { return packed ? 2 : 1; }

// shared memory of both tensor-core kernels: the chunk's B fragments (per
// half), then each warp's ring of ST_STAGES x (16 rows of stride tc_stride,
// their scales); row_bytes the bytes a row is stored in
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
static_assert(st_smem_bytes(2 * ST_QUERIES / 8, ST_MAX_ROW_BYTES / 2) <=
              st_smem_bytes(ST_QUERIES / 8, ST_MAX_ROW_BYTES), "so does the longest packed row");

// The chunk's queries q0 .. q0 + nq - 1 as B fragments in shared memory,
// [half][group][step][lane] (b0, b1): half h holds the query bytes [h *
// row_bytes, (h + 1) * row_bytes) of rows of H * row_bytes; absent queries
// and each half's tail past row_bytes are zeros. The caller publishes them
// with a block barrier.
template <int NG, int H>
__device__ __forceinline__ void tc_stage_queries(uint2* s_qf, const int8_t* __restrict__ q, int q0,
                                                 int nq, int row_bytes, int n_k) {
  for (int i = threadIdx.x; i < H * NG * n_k * 32; i += ST_WARPS * 32) {
    const int l = i & 31, ks = (i >> 5) % n_k, g = (i >> 5) / n_k;
    const int h = g / NG, qq = (g % NG) * 8 + (l >> 2), k0 = ks * 32 + 4 * (l & 3);
    uint2 v = make_uint2(0u, 0u);
    if (qq < nq) {
      const int8_t* qr = q + (long)(q0 + qq) * H * row_bytes + h * row_bytes;
      if (k0 < row_bytes) v.x = __ldg(reinterpret_cast<const uint32_t*>(qr + k0));
      if (k0 + 16 < row_bytes) v.y = __ldg(reinterpret_cast<const uint32_t*>(qr + k0 + 16));
    }
    s_qf[i] = v;
  }
}

// NG: the 8-query groups of a chunk (1, 2, 4 or 8); PACKED: packed int4 rows of
// row_bytes = D/2 (queries of D bytes), else int8 rows of row_bytes = D. Grid:
// units * chunks, block (unit, chunk) at unit * chunks + chunk; warp w of a
// unit owns the bins unit * ST_WARPS + w + i * units * ST_WARPS, i = 0, 1, ...
// At least one block an SM: without it ptxas held NG = 8 to 128 registers and
// spilled.
template <int NG, bool PACKED>
__global__ void __launch_bounds__(ST_WARPS * 32, 1) binmax_tc_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ out,
    int B, long n_rows, int row_bytes, long valid_n, int units, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_stride(row_bytes), n_k = ld / 32;
  const int stage_bytes = st_stage_bytes(row_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int chunk = blockIdx.x % chunks;
  const int unit = blockIdx.x / chunks;
  const int q0 = chunk * ST_QUERIES;
  const int nq = min(NG * 8, B - q0);

  uint2* s_qf = reinterpret_cast<uint2*>(smem);
  tc_stage_queries<NG, st_halves(PACKED)>(s_qf, q, q0, nq, row_bytes, n_k);
  __syncthreads();

  // the warp's ring: ST_STAGES x (16 rows of stride ld, then their 16 scales)
  unsigned char* ring = smem + st_query_bytes(st_halves(PACKED) * NG, row_bytes) +
                        warp * ST_STAGES * stage_bytes;
  const int n_bins = (int)((n_rows + BIN_W - 1) / BIN_W);
  const int first = unit * ST_WARPS + warp, step = units * ST_WARPS;
  const int n_mine = first < n_bins ? (n_bins - 1 - first) / step + 1 : 0;
  const int n_tiles = n_mine * BT_TILES;  // tile i: tile i % 8 of the warp's bin i / 8
  const int row_chunks = ld / 16 - 1;  // 16-byte pieces of a padded row
  const int chunks16 = row_bytes / 16;  // of them, those the row fills
  // the i-th tile into stage st: 16 contiguous rows, a lane a 16-byte piece;
  // rows past the corpus and the tail as zeros, their scales not read
  auto load = [&](int i, int st) {
    unsigned char* dst = ring + st * stage_bytes;
    const long row0 = (long)(first + (i / BT_TILES) * step) * BIN_W + (i % BT_TILES) * 16;
    for (int p = lane; p < 16 * row_chunks; p += 32) {
      const int r = p / row_chunks, k = p - r * row_chunks;
      const bool live = row0 + r < n_rows && k < chunks16;
      cp_async16(dst + r * ld + k * 16, corpus + (live ? (row0 + r) * row_bytes + k * 16 : 0),
                 live ? 16 : 0);
    }
    if (lane < 16 && row0 + lane < n_rows)
      cp_async4(dst + 16 * ld + lane * 4, scales + row0 + lane);
  };

  float mx[NG][4];  // the running maximum of the warp's bin, C-fragment layout
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[n][e] = NEG_INF;

  const int a_off = s8_a_offset(ld, lane);
#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  int st = 0;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + ST_STAGES - 1 < n_tiles)  // into the stage the warp freed last
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
      if constexpr (PACKED) {  // the low nibbles against the first half of the queries
        uint32_t lo[4], hi[4];
        unpack_i4(a, lo, hi);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const uint2 bl = s_qf[(n * n_k + ks) * 32 + lane];
          const uint2 bh = s_qf[((NG + n) * n_k + ks) * 32 + lane];
          mma_s8(acc[n], lo, bl.x, bl.y);
          mma_s8(acc[n], hi, bh.x, bh.y);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const uint2 b = s_qf[(n * n_k + ks) * 32 + lane];
          mma_s8(acc[n], a, b.x, b.y);
        }
      }
    }
    if constexpr (PACKED) {
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = i4_dot(acc[n][e]);
    }
    // acc[n]: rows row0 + grp (e 0, 1) and row0 + grp + 8 (e 2, 3), queries
    // n * 8 + 2 tig + (e & 1)
    const long row0 = (long)(first + (i / BT_TILES) * step) * BIN_W + (i % BT_TILES) * 16;
    const float* sc = reinterpret_cast<const float*>(tile + 16 * ld);
    const float sc_lo = sc[grp], sc_hi = sc[grp + 8];
    if (row0 + 16 <= valid_n) {  // the tile's rows all valid: no mask
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[n][e] = fmaxf(mx[n][e], (float)acc[n][e] * (e < 2 ? sc_lo : sc_hi));
    } else {  // masked before the max: no stale scale of a dead row reaches it
      const bool live_lo = row0 + grp < valid_n, live_hi = row0 + grp + 8 < valid_n;
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = e < 2 ? live_lo : live_hi;
          const float s = live ? (float)acc[n][e] * (e < 2 ? sc_lo : sc_hi) : NEG_INF;
          mx[n][e] = fmaxf(mx[n][e], s);
        }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    st = st + 1 == ST_STAGES ? 0 : st + 1;
    if (i % BT_TILES == BT_TILES - 1) {  // the bin's last tile: reduce and write
      const long bin = first + (i / BT_TILES) * step;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        float m0 = fmaxf(mx[n][0], mx[n][2]), m1 = fmaxf(mx[n][1], mx[n][3]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // over grp: rows, never queries
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        const int col = n * 8 + 2 * tig;
        if (grp == 0 && col < nq) out[bin * B + q0 + col] = m0;
        if (grp == 0 && col + 1 < nq) out[bin * B + q0 + col + 1] = m1;
        mx[n][0] = mx[n][1] = mx[n][2] = mx[n][3] = NEG_INF;
      }
    }
  }
}

// NG and PACKED as binmax_tc_kernel's. Grid: blocks * ST_PARTS * chunks, block
// (j, part, chunk) at ((j * ST_PARTS + part) * chunks + chunk). Its tile loop
// (and binmax_tc_kernel's) is written out in the kernel: moved into helper
// functions, it ran 17 % slower at B = 256 on an H100, and with the 32-byte
// step alone in one, the int8 pass 6-10 % slower at B = 64 and 256.
template <int NG, bool PACKED>
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

  uint2* s_qf = reinterpret_cast<uint2*>(smem);
  tc_stage_queries<NG, st_halves(PACKED)>(s_qf, q, q0, nq, row_bytes, n_k);
  __syncthreads();

  // the warp's ring: ST_STAGES x (16 rows of stride ld, then their 16 scales)
  unsigned char* ring = smem + st_query_bytes(st_halves(PACKED) * NG, row_bytes) +
                        warp * ST_STAGES * stage_bytes;
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
      if constexpr (PACKED) {  // the low nibbles against the first half of the queries
        uint32_t lo[4], hi[4];
        unpack_i4(a, lo, hi);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const uint2 bl = s_qf[(n * n_k + ks) * 32 + lane];
          const uint2 bh = s_qf[((NG + n) * n_k + ks) * 32 + lane];
          mma_s8(acc[n], lo, bl.x, bl.y);
          mma_s8(acc[n], hi, bh.x, bh.y);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const uint2 b = s_qf[(n * n_k + ks) * 32 + lane];
          mma_s8(acc[n], a, b.x, b.y);
        }
      }
    }
    if constexpr (PACKED) {
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = i4_dot(acc[n][e]);
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

// --- f32 rows on the CUDA cores (binmax_f32_kernel, binmax_strided_f32_kernel) ---

// The f32 tiles (f32_tile.cuh), 8 warps at 64 queries and 4 below: binmax
// scores 8 x 8 a thread at 64 queries, a tile of two bins; the strided pass
// keeps a best and its tile for each score, so it stays at 4 x C (R = 8 would
// need some 230 registers), one bin a tile.
template <int QC, class TR>
using BinmaxTile = FTile<QC, QC >= 64 ? 8 : 4, QC >= 64 ? 8 : 4, TR>;
template <int QC, class TR>
using StridedTile = FTile<QC, 4, QC >= 64 ? 8 : 4, TR>;

// Grid: units * chunks, block (unit, chunk) at unit * chunks + chunk; a block
// walks the tiles unit, unit + units, ... TR: float, or uint16_t for bf16 rows.
template <int QC, class TR>
__global__ void __launch_bounds__(BinmaxTile<QC, TR>::THREADS) binmax_f32_kernel(
    const float* __restrict__ q, const TR* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ out,
    int B, long n_rows, int dim, int band, long valid_n, int units, int chunks) {
  using T = BinmaxTile<QC, TR>;
  constexpr int BINS = T::ROWS / FT_ROWS, WPB = T::WARPS / BINS;  // bins a tile, warps a bin
  extern __shared__ __align__(16) float fsmem[];
  __shared__ float s_red[2][T::WARPS][QC];  // by tile parity: warps run a tile apart at most
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane % T::QG, rl = lane / T::QG;
  const int chunk = blockIdx.x % chunks, unit = blockIdx.x / chunks;
  const int q0 = chunk * QC, nq = min(QC, B - q0);
  const long n_bins = (n_rows + FT_ROWS - 1) / FT_ROWS;
  const long n_tiles = (n_rows + T::ROWS - 1) / T::ROWS;
  const int n_mine = unit < n_tiles ? (int)((n_tiles - 1 - unit) / units) + 1 : 0;
  f32_tiles<T>(
      q, q0, nq, corpus, n_rows, dim, band, fsmem, n_mine,
      [&](int i) { return ((long)unit + (long)i * units) * T::ROWS; },
      [&](int i, float (&acc)[T::R][T::C]) {
        const long tile0 = ((long)unit + (long)i * units) * T::ROWS;
        const long row0 = tile0 + warp * T::RW + rl;
        float m[T::C];
#pragma unroll
        for (int j = 0; j < T::C; ++j) m[j] = NEG_INF;
#pragma unroll
        for (int r = 0; r < T::R; ++r) {
          const long row = row0 + r * T::LR;
          const bool live = row < valid_n;
          const float sc = scales != nullptr && live ? __ldg(scales + row) : 1.0f;
#pragma unroll
          for (int j = 0; j < T::C; ++j) m[j] = fmaxf(m[j], live ? acc[r][j] * sc : NEG_INF);
        }
#pragma unroll
        for (int j = 0; j < T::C; ++j)
#pragma unroll
          for (int off = T::QG; off < 32; off <<= 1)  // over the warp's row lanes
            m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
        float (*red)[QC] = s_red[i & 1];
        if (lane < T::QG) {
#pragma unroll
          for (int j = 0; j < T::C; ++j) red[warp][j * T::QG + qg] = m[j];
        }
        __syncthreads();  // s_red[i & 1] is written again only after the next tile's barrier
        if (tid < BINS * QC) {  // the tile's bins: warps b * WPB .. of bin b
          const int b = tid / QC, col = tid % QC;
          const long bin = tile0 / FT_ROWS + b;
          if (col < nq && bin < n_bins) {
            float v = red[b * WPB][col];
#pragma unroll
            for (int w = 1; w < WPB; ++w) v = fmaxf(v, red[b * WPB + w][col]);
            out[bin * B + q0 + col] = v;
          }
        }
      });
}

// Grid: blocks * chunks, block (j, chunk) at j * chunks + chunk.
template <int QC, class TR>
__global__ void __launch_bounds__(StridedTile<QC, TR>::THREADS) binmax_strided_f32_kernel(
    const float* __restrict__ q, const TR* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ out, int* __restrict__ arg,
    int B, long n_rows, int dim, int band, long valid_n, int blocks, int chunks) {
  using T = StridedTile<QC, TR>;
  static_assert(T::ROWS == FT_ROWS, "a strided tile is one bin of rows");
  extern __shared__ __align__(16) float fsmem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = lane % T::QG, rl = lane / T::QG;
  const int t0 = warp * T::RW + rl;  // the thread's first row position of a tile
  const int chunk = blockIdx.x % chunks, j = blockIdx.x / chunks;
  const int q0 = chunk * QC, nq = min(QC, B - q0);
  const long n_tiles = (n_rows + FT_ROWS - 1) / FT_ROWS;
  const int n_mine = (int)((n_tiles - 1 - j) / blocks) + 1;  // tiles j, j + blocks, ...

  float best[T::R][T::C];
  int best_i[T::R][T::C];  // the tile of each best, as its turn i (tile j + i * blocks)
#pragma unroll
  for (int r = 0; r < T::R; ++r)
#pragma unroll
    for (int c = 0; c < T::C; ++c) { best[r][c] = NEG_INF; best_i[r][c] = 0; }
  f32_tiles<T>(
      q, q0, nq, corpus, n_rows, dim, band, fsmem, n_mine,
      [&](int i) { return ((long)j + (long)i * blocks) * FT_ROWS; },
      [&](int i, float (&acc)[T::R][T::C]) {
        const long row0 = ((long)j + (long)i * blocks) * FT_ROWS + t0;
#pragma unroll
        for (int r = 0; r < T::R; ++r) {
          const long row = row0 + r * T::LR;
          const bool live = row < valid_n;
          const float sc = scales != nullptr && live ? __ldg(scales + row) : 1.0f;
#pragma unroll
          for (int c = 0; c < T::C; ++c) {
            const float s = live ? acc[r][c] * sc : NEG_INF;
            if (s > best[r][c]) { best[r][c] = s; best_i[r][c] = i; }
          }
        }
      });
#pragma unroll
  for (int r = 0; r < T::R; ++r)
#pragma unroll
    for (int c = 0; c < T::C; ++c) {
      const int col = c * T::QG + qg;
      if (col < nq) {
        const int t = t0 + r * T::LR;
        const long o = ((long)j * BIN_W + t) * B + q0 + col;
        out[o] = best[r][c];
        arg[o] = (int)(((long)j + (long)best_i[r][c] * blocks) * BIN_W + t);
      }
    }
}

// --- launches ---

// Readies a launch of `kernel` with `smem` bytes of dynamic shared memory:
// allows it `max_smem`, the most any launch of it takes (the same at every
// launch, so that no launch lowers another's allowance), and, where `resident`
// is given, sets it to the blocks the card holds at once (SMs x blocks an SM).
static cudaError_t launch_setup(const void* kernel, size_t max_smem, int threads, size_t smem,
                                long* resident) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
  if (e != cudaSuccess || resident == nullptr) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *resident = (long)sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

// units of a walking grid: enough blocks of every chunk to fill the card once,
// and no more than the work items
static long fill_units(long resident, int chunks, long items) {
  const long units = resident / chunks > 1 ? resident / chunks : 1;
  return units < items ? units : items;
}

// the dynamic shared memory of a tensor-core block of NG groups over rows of
// row_bytes, and the most any launch of that kernel takes (its longest row)
template <int NG, bool PACKED>
static size_t tc_smem(int row_bytes) {
  return st_smem_bytes(st_halves(PACKED) * NG, row_bytes);
}
template <int NG, bool PACKED>
static size_t tc_max_smem() {
  return tc_smem<NG, PACKED>(ST_MAX_ROW_BYTES / st_halves(PACKED));
}

template <int NG, bool PACKED>
static int launch_binmax_tc(const void* q, const void* corpus, const float* scales, float* out,
                            int B, long n_rows, int row_bytes, long valid_n, int chunks,
                            cudaStream_t stream) {
  const size_t smem = tc_smem<NG, PACKED>(row_bytes);
  long resident = 0;  // read above 16 queries only: below, a warp takes one bin
  const cudaError_t e = launch_setup((const void*)binmax_tc_kernel<NG, PACKED>, tc_max_smem<NG, PACKED>(),
                                     ST_WARPS * 32, smem, NG <= 2 ? nullptr : &resident);
  if (e != cudaSuccess) return (int)e;
  const long n_bins = (n_rows + BIN_W - 1) / BIN_W;
  const long items = (n_bins + ST_WARPS - 1) / ST_WARPS;  // one bin a warp
  const long units = NG <= 2 ? items : fill_units(resident, chunks, items);
  binmax_tc_kernel<NG, PACKED><<<(unsigned)(units * chunks), ST_WARPS * 32, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)corpus, scales, out, B, n_rows, row_bytes, valid_n,
      (int)units, chunks);
  return (int)cudaGetLastError();
}

// binmax_tc_kernel at the batch's size class
template <bool PACKED>
static int launch_binmax_tc_batch(const void* q, const void* corpus, const float* scales,
                                  float* out, int B, long n_rows, int row_bytes, long valid_n,
                                  cudaStream_t s) {
  const int chunks = (B + ST_QUERIES - 1) / ST_QUERIES;
  if (B <= 8) return launch_binmax_tc<1, PACKED>(q, corpus, scales, out, B, n_rows, row_bytes, valid_n, chunks, s);
  if (B <= 16) return launch_binmax_tc<2, PACKED>(q, corpus, scales, out, B, n_rows, row_bytes, valid_n, chunks, s);
  if (B <= 32) return launch_binmax_tc<4, PACKED>(q, corpus, scales, out, B, n_rows, row_bytes, valid_n, chunks, s);
  return launch_binmax_tc<8, PACKED>(q, corpus, scales, out, B, n_rows, row_bytes, valid_n, chunks, s);
}

// the dynamic shared memory of a block of Tile<qc, TR> staging bands of `band` floats
template <template <int, class> class Tile, class TR>
static size_t f32_smem(int qc, int band) {
  return qc == 64 ? ft_smem_bytes<Tile<64, TR>>(band)
       : qc == 32 ? ft_smem_bytes<Tile<32, TR>>(band)
       : qc == 16 ? ft_smem_bytes<Tile<16, TR>>(band) : ft_smem_bytes<Tile<8, TR>>(band);
}

// (queries a block of an f32 kernel holds, floats of depth it stages at once):
// the batch's size class, halved while the whole row does not fit, down to 8
// queries, whose rows are then staged in bands of as many K-chunks as fit
template <template <int, class> class Tile, class TR>
static int2 f32_chunk(int B, int dim) {
  const int full = ft_full_band(dim);
  int qc = B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
  while (qc > 8 && f32_smem<Tile, TR>(qc, full) > FT_SMEM_MAX) qc /= 2;
  int band = full;
  while (f32_smem<Tile, TR>(qc, band) > FT_SMEM_MAX) band -= FT_KC_MAX;
  return make_int2(qc, band);
}

template <int QC, class TR>
static int launch_binmax_f32(const void* q, const void* corpus, const float* scales, float* out,
                             int B, long n_rows, int dim, int band, long valid_n,
                             cudaStream_t stream) {
  using T = BinmaxTile<QC, TR>;
  const size_t smem = ft_smem_bytes<T>(band);
  long resident = 0;
  const cudaError_t e = launch_setup((const void*)binmax_f32_kernel<QC, TR>, FT_SMEM_MAX,
                                     T::THREADS, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const int chunks = (B + QC - 1) / QC;
  const long units = fill_units(resident, chunks, (n_rows + T::ROWS - 1) / T::ROWS);
  binmax_f32_kernel<QC, TR><<<(unsigned)(units * chunks), T::THREADS, smem, stream>>>(
      (const float*)q, (const TR*)corpus, scales, out, B, n_rows, dim, band, valid_n,
      (int)units, chunks);
  return (int)cudaGetLastError();
}

// binmax over f32 (TR float) or bf16 (TR uint16_t) rows of `dim` values
template <class TR>
static int launch_binmax_tiled(const void* q, const void* corpus, const float* scales,
                               float* out, int B, long n_rows, int dim, long valid_n,
                               cudaStream_t s) {
  const int2 c = f32_chunk<BinmaxTile, TR>(B, dim);
  if (c.x == 64) return launch_binmax_f32<64, TR>(q, corpus, scales, out, B, n_rows, dim, c.y, valid_n, s);
  if (c.x == 32) return launch_binmax_f32<32, TR>(q, corpus, scales, out, B, n_rows, dim, c.y, valid_n, s);
  if (c.x == 16) return launch_binmax_f32<16, TR>(q, corpus, scales, out, B, n_rows, dim, c.y, valid_n, s);
  return launch_binmax_f32<8, TR>(q, corpus, scales, out, B, n_rows, dim, c.y, valid_n, s);
}

template <int QC, class TR>
static int launch_strided_f32(const void* q, const void* corpus, const float* scales, float* out,
                              int* arg, int B, long n_rows, int dim, int band, long valid_n,
                              int blocks, cudaStream_t stream) {
  using T = StridedTile<QC, TR>;
  const size_t smem = ft_smem_bytes<T>(band);
  const cudaError_t e = launch_setup((const void*)binmax_strided_f32_kernel<QC, TR>,
                                     FT_SMEM_MAX, T::THREADS, smem, nullptr);
  if (e != cudaSuccess) return (int)e;
  const int chunks = (B + QC - 1) / QC;
  if ((long)blocks * chunks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  binmax_strided_f32_kernel<QC, TR><<<(unsigned)((long)blocks * chunks), T::THREADS, smem,
                                      stream>>>(
      (const float*)q, (const TR*)corpus, scales, out, arg, B, n_rows, dim, band, valid_n,
      blocks, chunks);
  return (int)cudaGetLastError();
}

// binmax_strided over f32 (TR float) or bf16 (TR uint16_t) rows of `dim` values
template <class TR>
static int launch_strided_tiled(const void* q, const void* corpus, const float* scales,
                                float* out, int* arg, int B, long n_rows, int dim, long valid_n,
                                int blocks, cudaStream_t s) {
  const int2 c = f32_chunk<StridedTile, TR>(B, dim);
  if (c.x == 64) return launch_strided_f32<64, TR>(q, corpus, scales, out, arg, B, n_rows, dim, c.y, valid_n, blocks, s);
  if (c.x == 32) return launch_strided_f32<32, TR>(q, corpus, scales, out, arg, B, n_rows, dim, c.y, valid_n, blocks, s);
  if (c.x == 16) return launch_strided_f32<16, TR>(q, corpus, scales, out, arg, B, n_rows, dim, c.y, valid_n, blocks, s);
  return launch_strided_f32<8, TR>(q, corpus, scales, out, arg, B, n_rows, dim, c.y, valid_n, blocks, s);
}

template <int NG, bool PACKED>
static int launch_strided_tc(const void* q, const void* corpus, const float* scales, float* out,
                             int* arg, int B, long n_rows, int row_bytes, long valid_n,
                             int blocks, int chunks, cudaStream_t stream) {
  const size_t smem = tc_smem<NG, PACKED>(row_bytes);
  const cudaError_t e = launch_setup((const void*)binmax_strided_tc_kernel<NG, PACKED>,
                                     tc_max_smem<NG, PACKED>(), ST_WARPS * 32, smem, nullptr);
  if (e != cudaSuccess) return (int)e;
  binmax_strided_tc_kernel<NG, PACKED><<<(unsigned)((long)blocks * ST_PARTS * chunks),
                                     ST_WARPS * 32, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)corpus, scales, out, arg, B, n_rows, row_bytes, valid_n,
      blocks, chunks);
  return (int)cudaGetLastError();
}

// binmax_strided_tc_kernel at the batch's size class
template <bool PACKED>
static int launch_strided_tc_batch(const void* q, const void* corpus, const float* scales,
                                   float* out, int* arg, int B, long n_rows, int row_bytes,
                                   long valid_n, int blocks, int chunks, cudaStream_t s) {
  if (B <= 8)
    return launch_strided_tc<1, PACKED>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
  if (B <= 16)
    return launch_strided_tc<2, PACKED>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
  if (B <= 32)
    return launch_strided_tc<4, PACKED>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
  return launch_strided_tc<8, PACKED>(q, corpus, scales, out, arg, B, n_rows, row_bytes, valid_n, blocks, chunks, s);
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
//   mode: 0 f32, 1 int8, 2 packed int4, 3 bf16. q: [B, D] f32 (f32 and bf16 rows) or int8.
//   corpus: [n_rows, row_words] 32-bit words (a multiple of 4). scales: [n_rows] f32 or NULL.
//   out: [ceil(n_rows / 128), B] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int sskd_binmax(int mode, const void* q, const void* corpus, const float* scales,
                           float* out, int B, long n_rows, int row_words, long valid_n,
                           void* stream) {
  using namespace sskd;
  if (n_rows <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == F32)
    return launch_binmax_tiled<float>(q, corpus, scales, out, B, n_rows, row_words, valid_n, s);
  if (mode == BF16)
    return launch_binmax_tiled<uint16_t>(q, corpus, scales, out, B, n_rows, 2 * row_words,
                                         valid_n, s);
  if (mode == I8) launch_mode<I8>(q, corpus, scales, out, B, n_rows, row_words, valid_n, s);
  else if (mode == I4) launch_mode<I4>(q, corpus, scales, out, B, n_rows, row_words, valid_n, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The tensor-core route of binmax. mode: 1 int8 rows, row_bytes a multiple of 16
// of at most 1,024; 2 packed int4 rows, row_bytes (D/2) a multiple of 16 of at
// most 512, queries of 2 row_bytes int8. Scales required; n_rows < 2^31.
// Arguments and result as sskd_binmax.
extern "C" int sskd_binmax_tc(int mode, const void* q, const void* corpus, const float* scales,
                              float* out, int B, long n_rows, int row_bytes, long valid_n,
                              void* stream) {
  using namespace sskd;
  const int max_bytes = mode == I4 ? ST_MAX_ROW_BYTES / 2 : ST_MAX_ROW_BYTES;
  if ((mode != I8 && mode != I4) || n_rows <= 0 || B <= 0 || scales == nullptr ||
      row_bytes <= 0 || row_bytes % 16 || row_bytes > max_bytes || n_rows > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == I4)
    return launch_binmax_tc_batch<true>(q, corpus, scales, out, B, n_rows, row_bytes, valid_n, s);
  return launch_binmax_tc_batch<false>(q, corpus, scales, out, B, n_rows, row_bytes, valid_n, s);
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
  if (mode == F32)
    return launch_strided_tiled<float>(q, corpus, scales, out, arg, B, n_rows, row_words,
                                       valid_n, blocks, s);
  if (mode == BF16)
    return launch_strided_tiled<uint16_t>(q, corpus, scales, out, arg, B, n_rows,
                                          2 * row_words, valid_n, blocks, s);
  if (mode == I8) launch_strided<I8>(q, corpus, scales, out, arg, B, n_rows, row_words, valid_n, blocks, s);
  else if (mode == I4) launch_strided<I4>(q, corpus, scales, out, arg, B, n_rows, row_words, valid_n, blocks, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The tensor-core route of the approx engine's pass: mode and rows as
// sskd_binmax_tc's; scales required. Arguments and results as sskd_binmax_strided.
extern "C" int sskd_binmax_strided_tc(int mode, const void* q, const void* corpus,
                                      const float* scales, float* out, int* arg, int B,
                                      long n_rows, int row_bytes, long valid_n, int blocks,
                                      void* stream) {
  using namespace sskd;
  const int max_bytes = mode == I4 ? ST_MAX_ROW_BYTES / 2 : ST_MAX_ROW_BYTES;
  if ((mode != I8 && mode != I4) || n_rows <= 0 || B <= 0 || arg == nullptr ||
      scales == nullptr || n_rows + BIN_W > 0x7fffffffL || row_bytes <= 0 || row_bytes % 16 ||
      row_bytes > max_bytes)
    return (int)cudaErrorInvalidValue;
  if (blocks < 1 || blocks > (n_rows + BIN_W - 1) / BIN_W) return (int)cudaErrorInvalidValue;
  const int chunks = (B + ST_QUERIES - 1) / ST_QUERIES;
  if ((long)blocks * ST_PARTS * chunks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == I4)
    return launch_strided_tc_batch<true>(q, corpus, scales, out, arg, B, n_rows, row_bytes,
                                         valid_n, blocks, chunks, s);
  return launch_strided_tc_batch<false>(q, corpus, scales, out, arg, B, n_rows, row_bytes,
                                        valid_n, blocks, chunks, s);
}
