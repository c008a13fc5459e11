// gather_tc.cuh: the tensor-core gather shared by cell_gather_tc_kernel
// (cell_gather.cu, a probed cell of rpc rows, int8) and the bin gathers of
// bin_gather.cu (a 128-row bin of the exact engine: int8, packed int4 and
// bf16 rows).
//
// A "cell" c is the rows [c * rpc, (c + 1) * rpc). A pair p = b * per_query + j
// asks for the scores of one cell against query b:
//   out[p, r] = ((float)dot(row, q b) * q_scale[b]) * scale[row]   if row < valid_n
//             = NEG_INF                                             otherwise
// for r < rpc and row = c * rpc + r (bf16 rows: dot(row, q b) * scale[row],
// the scale optional). Rows >= n_rows are read as zero bytes, so a ragged
// last cell needs no padding of the corpus. The row type (ROW):
//   TC_S8   int8 rows of row_bytes = D, int8 queries: mma.sync m16n8k32 s8
//           steps, the exact int32 dot.
//   TC_I4   packed int4 rows of row_bytes = D/2 (ops/quant.py's halves
//           layout), int8 queries of D bytes: each 32-byte packed step one
//           ldmatrix whose registers unpack_i4 turns into the s8 fragments of
//           dims [32 ks, 32 ks + 32) and [D/2 + 32 ks, ...), each against the
//           matching half of the query (lanes past a half read as zeros, so
//           a half of 16 mod 32 bytes meets zeros in its zero-filled tail,
//           which unpacks to -8), the 16-fold sums shifted back: the exact
//           int32 dot. Rows past the corpus read as -8 in every dim and stay
//           masked by valid_n <= n_rows.
//   TC_BF16 bf16 rows of row_bytes = 2 D, f32 queries of D floats: the query
//           split exactly into three bf16 terms (mma_common.cuh bf16_term)
//           that fill columns 0-2 of the B fragment of mma.sync m16n8k16
//           bf16 (columns 3-7 zero), so one mma a 16-dim step gives the three
//           partial dots of 16 rows, every product exact; each score is
//           (c2 + c1) + c0, the smallest first. Only the summation order
//           (each step's sum truncated to f32 by the tensor cores) differs
//           from an f32 dot of the widened rows. One query at a time.
//
// The pairs come as one sequence: cells[i] is the cell of the i-th pair and
// order[i] the pair (order NULL: the i-th pair is pair i). A warp, job (run,
// tile), takes the entries [run * run_len, run * run_len + run_len). For
// run_len > 1 the run is moved to the boundaries of equal cells: it skips the
// leading entries whose cell the entry before shares, and runs on past its end
// while the cell goes on (warp ballots), so every group of equal neighbouring
// cells is scored by exactly one run; sorted by cell (one stable sort gives
// cells and order), every distinct cell is then brought from device memory
// once. run_len 1 takes its one entry as it is, with no look at its
// neighbours. A run walks its groups with the next group's 16-row tile
// arriving by cp.async into another of STAGES buffers while the current one
// is scored (STAGES 1: in turn): the tile's rows are mma A fragments
// (ldmatrix; rows padded by tc_stride), eight of the group's queries at a time
// B fragments read from the query rows (in L1 and L2); TC_I4 and TC_BF16 take
// the queries one at a time, each staged in the warp's shared memory while
// the tile arrives (the halves zero-padded; the three terms split once): read
// a step at a time from the query row, the B fragments held those two back
// (on an H100, tools/probe_gather.py: bf16 0.0122 ms a launch at B = 1, kb =
// 10, against 0.0055 staged; int4 0.392 against 0.241-0.246 at B = 256, kb =
// 100).
//
// What bounds it on the H100 and why one warp per run: each warp waits mostly
// on its own chain (the pairs' ids, the query rows, n_k dependent mma), so the
// time follows the warps an SM holds, not the bytes in flight: runs of one
// warp, many of them, beat deeper pipelines (64-row tiles, runs of 16, 3 or 4
// stages: 10-100 % slower on the card for the cells). A block holds WARPS such
// runs side by side, each warp with its own shared memory and no barrier
// beyond the warp: more warps a block only spare the card dispatching blocks.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace sskd {

constexpr int TC_TILE = 16;                // rows of a cell a warp scores
constexpr int TC_MAX_ROW_BYTES = 1024;     // the longest row the gather takes, in bytes

enum TcRow { TC_S8 = 0, TC_I4 = 1, TC_BF16 = 2 };  // the row types of the gather

// a warp's staged query (TC_I4: the two halves of the int8 query, each
// zero-padded to the steps; TC_BF16: the three bf16 terms of each pair of
// dims, tc_term_words apart; TC_S8 reads its queries from L1)
__host__ __device__ constexpr int tc_term_words(int row_bytes) {
  return (row_bytes + 31) / 32 * 8 + 8;  // 8 a step, and 8 so that the terms' banks differ
}
__host__ __device__ constexpr int tc_query_bytes(int row, int row_bytes) {
  return row == TC_I4 ? 2 * ((row_bytes + 31) / 32 * 32)
         : row == TC_BF16 ? 3 * 4 * tc_term_words(row_bytes) : 0;
}

// shared memory of a block of `warps` runs with `stages` groups' tiles each,
// and each warp's staged query
__host__ __device__ constexpr size_t tc_smem_bytes(int warps, int stages, int row_bytes,
                                                   int row = TC_S8) {
  return (size_t)warps * (stages * ((size_t)TC_TILE * tc_stride(row_bytes) +
                                    TC_TILE * sizeof(float)) +
                          tc_query_bytes(row, row_bytes));
}

// The first index i >= from with cells[i] != c (n if none): a warp compares
// 32 at a time. Every lane returns it.
__device__ __forceinline__ int next_cell(const int* __restrict__ cells, int n, int from, int c,
                                         int lane) {
  for (int base = from; base < n; base += 32) {
    const int i = base + lane;
    const unsigned differs = __ballot_sync(0xffffffffu, i < n && __ldg(cells + i) != c);
    if (differs) return base + __ffs(differs) - 1;
  }
  return n;
}

// The body of the kernels: launched with 32 * WARPS threads, tc_smem_bytes
// (WARPS, STAGES, row_bytes) of dynamic shared memory and ceil(ceil(n_pairs /
// run_len) * tiles / WARPS) blocks, tiles = ceil(rpc / TC_TILE); warp w of
// block i takes (run, tile) number i * WARPS + w. row_bytes: a multiple of
// 16, at most TC_MAX_ROW_BYTES. q: the queries' rows, of row_bytes int8
// (TC_S8), 2 row_bytes int8 (TC_I4) or row_bytes / 2 floats (TC_BF16).
// q_scale and scales are required but for TC_BF16, which has no q_scale and
// takes scales NULL for none.
template <int WARPS, int STAGES, int ROW = TC_S8>
__device__ __forceinline__ void gather_tc(
    const int8_t* __restrict__ q, const float* __restrict__ q_scale,
    const int8_t* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ cells, const long long* __restrict__ order, float* __restrict__ out,
    int n_pairs, int per_query, int rpc, int row_bytes, int tiles, int run_len, long n_rows,
    long valid_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_stride(row_bytes);
  const int stage_bytes = TC_TILE * ld + TC_TILE * (int)sizeof(float);
  const bool scaled = ROW != TC_BF16 || scales != nullptr;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long job = (long)blockIdx.x * WARPS + warp;  // (run, tile)
  if (job >= (long)((n_pairs + run_len - 1) / run_len) * tiles) return;
  const int run = (int)(job / tiles), tile = (int)(job % tiles);
  const int r0 = tile * TC_TILE;
  // the warp's own: its STAGES tiles, then its staged query
  unsigned char* ring = smem + (size_t)warp * (STAGES * stage_bytes +
                                               tc_query_bytes(ROW, row_bytes));
  unsigned char* s_q = ring + STAGES * stage_bytes;

  // the run, moved to cell boundaries: it starts at the first entry whose
  // cell the entry before it does not share, and ends where its last cell does
  int s = run * run_len;
  int e = s + 1;
  if (run_len > 1) {
    const int e0 = min(s + run_len, n_pairs);
    if (s > 0) s = next_cell(cells, e0, s, __ldg(cells + s - 1), lane);
    if (s >= e0) return;  // the run before takes all of these entries
    e = next_cell(cells, n_pairs, e0, __ldg(cells + e0 - 1), lane);
  }

  const int row_chunks = ld / 16 - 1;       // 16-byte pieces of a padded row
  const int chunks = row_bytes / 16;        // of them, those the row fills
  // the tile of cell c into stage st, a lane a 16-byte piece: rows past rpc
  // or n_rows and the tail past the row's bytes as zeros
  auto load_tile = [&](int c, int st) {
    unsigned char* dst = ring + st * stage_bytes;
    float* dst_scale = reinterpret_cast<float*>(dst + TC_TILE * ld);
    const long row0 = (long)c * rpc + r0;
    for (int p = lane; p < TC_TILE * row_chunks; p += 32) {
      const int r = p / row_chunks, k = p - r * row_chunks;
      const bool live = r0 + r < rpc && row0 + r < n_rows && k < chunks;
      cp_async16(dst + r * ld + k * 16, corpus + (live ? (row0 + r) * row_bytes + k * 16 : 0),
                 live ? 16 : 0);
    }
    if (scaled && lane < TC_TILE && r0 + lane < rpc && row0 + lane < n_rows)
      cp_async4(dst_scale + lane, scales + row0 + lane);
  };
  auto pair_at = [&](int i) { return order != nullptr ? (int)__ldg(order + i) : i; };

  const int n_k = ld / 32;  // 32-byte steps of the padded row
  const int span = n_k * 32;  // bytes of a padded row; TC_I4: of each query half
  const int words = tc_term_words(row_bytes);
  // TC_I4, TC_BF16: the query of `pair` into s_q, a lane 16 bytes (the two
  // halves) or a pair of dims (the three terms) at a time, zeros past the row
  auto stage_query = [&](int pair) {
    const long b = pair / per_query;
    if constexpr (ROW == TC_I4) {
      const int8_t* qr = q + b * 2 * row_bytes;
      const int n16 = span / 16;
      for (int i = lane; i < 2 * n16; i += 32) {
        const int h = i >= n16, k = (i - h * n16) * 16;
        const uint4 v = k < row_bytes ? __ldg(reinterpret_cast<const uint4*>(qr + h * row_bytes + k))
                                      : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(s_q + h * span + k) = v;
      }
    } else if constexpr (ROW == TC_BF16) {
      const int d = row_bytes / 2;
      const float* qr = reinterpret_cast<const float*>(q) + b * d;
      uint32_t* w = reinterpret_cast<uint32_t*>(s_q);
      for (int j = lane; j < span / 4; j += 32) {  // dims 2 j and 2 j + 1
        const float2 v = 2 * j < d ? __ldg(reinterpret_cast<const float2*>(qr + 2 * j))
                                   : make_float2(0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          w[t * words + j] = pack_bf16(bf16_term(v.x, t), bf16_term(v.y, t));
      }
    }
  };
  // the groups of entries with one cell, in order: `g` is scored, `load_g` is
  // the next to be loaded; each stage holds one group's tile
  int load_g = s;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (load_g < e) {
      const int c = __ldg(cells + load_g);
      load_tile(c, i);
      load_g = next_cell(cells, e, load_g + 1, c, lane);
    }
    cp_async_commit();
  }
  int st = 0;
  for (int g = s; g < e; st = st + 1 == STAGES ? 0 : st + 1) {
    const int c = __ldg(cells + g);
    const int g_end = e == g + 1 ? e : next_cell(cells, e, g + 1, c, lane);
    // the first eight pairs' ids, asked for before the wait for the tile, and
    // their query rows brought into L1 meanwhile (the bin gather, one query a
    // warp, waits for little else once its tile has landed); TC_I4 and
    // TC_BF16 stage the first query instead, once the tile is on its way
    const int first = g + grp < g_end ? pair_at(g + grp) : 0;
    if (ROW == TC_S8 && g + grp < g_end) {
      const int8_t* q_row = q + (long)(first / per_query) * row_bytes;
      for (int off = 128 * tig; off < row_bytes; off += 512) prefetch_l1(q_row + off);
    }
    if (load_g < e) {
      const int lc = __ldg(cells + load_g);
      const int ls = st == 0 ? STAGES - 1 : st - 1;  // the stage freed last
      load_tile(lc, ls);
      load_g = next_cell(cells, e, load_g + 1, lc, lane);
    }
    cp_async_commit();
    if constexpr (ROW != TC_S8) stage_query(__shfl_sync(0xffffffffu, first, 0));
    cp_async_wait<STAGES - 1>();  // this group's tile has landed
    __syncwarp();
    const unsigned char* tile_rows = ring + st * stage_bytes;
    const float* tile_scale = reinterpret_cast<const float*>(tile_rows + TC_TILE * ld);
    const unsigned char* a_row = tile_rows + s8_a_offset(ld, lane);
    if constexpr (ROW != TC_S8) {
      // the cell's queries one at a time, each staged in s_q: the B
      // fragment's column 0 (TC_I4: its two halves, one mma each) or
      // columns 0-2 (TC_BF16: the three terms); the other columns are zeros
      for (int qi = g; qi < g_end; ++qi) {
        const int pair = qi == g ? __shfl_sync(0xffffffffu, first, 0) : pair_at(qi);
        if (qi != g) {
          __syncwarp();  // the warp is done with the query before
          stage_query(pair);
          __syncwarp();
        }
        if constexpr (ROW == TC_I4) {
          const unsigned char* q_lo = s_q + 4 * tig;
          int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
          for (int ks = 0; ks < n_k; ++ks) {
            uint32_t a[4], lo[4], hi[4];
            ldmatrix_x4(a, a_row + ks * 32);
            unpack_i4(a, lo, hi);
            const unsigned char* qk = q_lo + ks * 32;
            const uint32_t b0 = grp == 0 ? *reinterpret_cast<const uint32_t*>(qk) : 0u;
            const uint32_t b1 = grp == 0 ? *reinterpret_cast<const uint32_t*>(qk + 16) : 0u;
            const uint32_t h0 = grp == 0 ? *reinterpret_cast<const uint32_t*>(qk + span) : 0u;
            const uint32_t h1 =
                grp == 0 ? *reinterpret_cast<const uint32_t*>(qk + span + 16) : 0u;
            mma_s8(acc, lo, b0, b1);
            mma_s8(acc, hi, h0, h1);
          }
          // acc[0], acc[2]: rows grp and grp + 8, the query's column in the tig = 0 lanes
          if (tig == 0) {
            const float qs = __ldg(q_scale + pair / per_query);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int r = grp + 8 * rr;
              if (r0 + r < rpc)
                out[(long)pair * rpc + r0 + r] = (long)c * rpc + r0 + r < valid_n
                    ? ((float)i4_dot(acc[2 * rr]) * qs) * tile_scale[r] : NEG_INF;
            }
          }
        } else {
          const uint32_t* w = reinterpret_cast<const uint32_t*>(s_q) + grp * words + tig;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int ks = 0; ks < n_k; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(a, a_row + ks * 32);
            const uint32_t b0 = grp < 3 ? w[8 * ks] : 0u;
            const uint32_t b1 = grp < 3 ? w[8 * ks + 4] : 0u;
            mma_bf16(acc, a, b0, b1);
          }
          // acc: rows grp and grp + 8, columns 2 tig and 2 tig + 1: the tig = 0
          // lane holds terms 0 and 1, its neighbour term 2
          const float t2_lo = __shfl_down_sync(0xffffffffu, acc[0], 1);
          const float t2_hi = __shfl_down_sync(0xffffffffu, acc[2], 1);
          if (tig == 0) {
            const float sc[2] = {(t2_lo + acc[1]) + acc[0], (t2_hi + acc[3]) + acc[2]};
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int r = grp + 8 * rr;
              if (r0 + r < rpc)
                out[(long)pair * rpc + r0 + r] = (long)c * rpc + r0 + r < valid_n
                    ? (scaled ? sc[rr] * tile_scale[r] : sc[rr]) : NEG_INF;
            }
          }
        }
      }
    } else {
      // the cell's queries, eight at a time: lane (grp, tig) loads query grp's
      // bytes 4 tig.. of each 32-byte step, and its pair and scale
      for (int q0 = g; q0 < g_end; q0 += 8) {
        const int n_q = min(8, g_end - q0);
        const int my_pair = q0 == g ? first : grp < n_q ? pair_at(q0 + grp) : 0;
        const int my_b = my_pair / per_query;
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
        // acc: rows grp and grp + 8 of the tile, queries 2 tig and 2 tig + 1
#pragma unroll
        for (int cq = 0; cq < 2; ++cq) {
          const int col = 2 * tig + cq;
          const int pair = __shfl_sync(0xffffffffu, my_pair, 4 * col);
          const float qs = __shfl_sync(0xffffffffu, my_qs, 4 * col);
          if (col >= n_q) continue;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = grp + 8 * rr;
            if (r0 + r < rpc)
              out[(long)pair * rpc + r0 + r] = (long)c * rpc + r0 + r < valid_n
                  ? ((float)acc[2 * rr + cq] * qs) * tile_scale[r] : NEG_INF;
          }
        }
      }
    }
    __syncwarp();  // the stage is free for the group STAGES ahead
    g = g_end;
  }
}

}  // namespace sskd
