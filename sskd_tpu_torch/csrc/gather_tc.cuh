// gather_tc.cuh: the int8 tensor-core gather shared by cell_gather_tc_kernel
// (cell_gather.cu, a probed cell of rpc rows) and bin_gather_tc_kernel
// (bin_gather.cu, a 128-row bin of the exact engine).
//
// A "cell" c is the rows [c * rpc, (c + 1) * rpc). A pair p = b * per_query + j
// asks for the scores of one cell against query b:
//   out[p, r] = ((float)dot(row, q b) * q_scale[b]) * scale[row]   if row < valid_n
//             = NEG_INF                                             otherwise
// for r < rpc and row = c * rpc + r. The dot is the exact int32 sum of mma.sync
// m16n8k32 s8 steps; rows >= n_rows are read as zeros, so a ragged last cell
// needs no padding of the corpus.
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
// B fragments read from the query rows (in L1 and L2).
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
constexpr int TC_MAX_ROW_BYTES = 1024;     // the longest int8 row the gather takes

// shared memory of a block of `warps` runs with `stages` groups' tiles each
__host__ __device__ constexpr size_t tc_smem_bytes(int warps, int stages, int row_bytes) {
  return (size_t)warps * stages *
         ((size_t)TC_TILE * tc_stride(row_bytes) + TC_TILE * sizeof(float));
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

// The body of both kernels: launched with 32 * WARPS threads, tc_smem_bytes
// (WARPS, STAGES, row_bytes) of dynamic shared memory and ceil(ceil(n_pairs /
// run_len) * tiles / WARPS) blocks, tiles = ceil(rpc / TC_TILE); warp w of
// block i takes (run, tile) number i * WARPS + w. row_bytes: a multiple of
// 16, at most TC_MAX_ROW_BYTES.
template <int WARPS, int STAGES>
__device__ __forceinline__ void gather_tc(
    const int8_t* __restrict__ q, const float* __restrict__ q_scale,
    const int8_t* __restrict__ corpus, const float* __restrict__ scales,
    const int* __restrict__ cells, const long long* __restrict__ order, float* __restrict__ out,
    int n_pairs, int per_query, int rpc, int row_bytes, int tiles, int run_len, long n_rows,
    long valid_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_stride(row_bytes);
  const int stage_bytes = TC_TILE * ld + TC_TILE * (int)sizeof(float);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long job = (long)blockIdx.x * WARPS + warp;  // (run, tile)
  if (job >= (long)((n_pairs + run_len - 1) / run_len) * tiles) return;
  const int run = (int)(job / tiles), tile = (int)(job % tiles);
  const int r0 = tile * TC_TILE;
  unsigned char* ring = smem + (size_t)warp * STAGES * stage_bytes;  // the warp's own

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
    if (lane < TC_TILE && r0 + lane < rpc && row0 + lane < n_rows)
      cp_async4(dst_scale + lane, scales + row0 + lane);
  };
  auto pair_at = [&](int i) { return order != nullptr ? (int)__ldg(order + i) : i; };

  const int n_k = ld / 32;  // 32-byte steps of the padded row
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
    // warp, waits for little else once its tile has landed)
    const int first = g + grp < g_end ? pair_at(g + grp) : 0;
    if (g + grp < g_end) {
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
    cp_async_wait<STAGES - 1>();  // this group's tile has landed
    __syncwarp();
    const unsigned char* tile_rows = ring + st * stage_bytes;
    const float* tile_scale = reinterpret_cast<const float*>(tile_rows + TC_TILE * ld);
    const unsigned char* a_row = tile_rows + s8_a_offset(ld, lane);
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
    __syncwarp();  // the stage is free for the group STAGES ahead
    g = g_end;
  }
}

}  // namespace sskd
