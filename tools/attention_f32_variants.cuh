// attention_f32_variants.cuh: other schedules of the f32 attention forwards
// at head dims 16 and 32, for tools/probe_attention_f32.py only (the port
// does not build this file). Each computes the bits of
// csrc/flash_attn.cu flash_fwd_tc_tf32_kernel<D> /
// csrc/dropattn_fwd.cu dropattn_fwd_tc_tf32_kernel<D> (the same products in
// the same order, the same softmax and keep bits); the probe holds them to
// those bit for bit and times them in turns:
//
// - flash_fwd_tc_tf32_tuned_kernel<D, NW, SPLIT> /
//   dropattn_fwd_tc_tf32_tuned_kernel<D, NW, SPLIT>: the route's kernel with
//   NW warps, q's A fragments split once into registers, S an 8-key tile at
//   a time (the small terms in four registers), and for flash a tile of 64
//   live keys unmasked; with SPLIT, each K and V tile that cp.async brought
//   is split into its TF32 terms once for the block (SplitTile's layout)
//   behind one more barrier, where without it each warp splits what it
//   reads;
// - flash_fwd_tc_tf32_split_kernel<D, NW> /
//   dropattn_fwd_tc_tf32_split_kernel<D, NW>: the split tile again, each
//   tile brought into registers while the block computes the one before it
//   and stored split into the other of two stages, one barrier a tile.
//
// Include after the kernel's source: SSKD_PROBE_FLASH after flash_attn.cu,
// SSKD_PROBE_DROPATTN after dropattn_fwd.cu.

#pragma once

namespace sskd {

// mma_3xtf32 with B already split: b = (hi, lo) of b0, then (hi, lo) of b1
// (the split K and V tiles below); the same three products in the same order
__device__ __forceinline__ void mma_3xtf32_b(float (&c)[4], float (&c_lo)[4],
                                             const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                             const float4& b) {
  const uint32_t h0 = __float_as_uint(b.x), l0 = __float_as_uint(b.y);
  const uint32_t h1 = __float_as_uint(b.z), l1 = __float_as_uint(b.w);
  mma_tf32(c_lo, al, h0, h1);
  mma_tf32(c_lo, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// (hi, lo) of x, then of y, as one 16-byte shared-memory word
__device__ __forceinline__ float4 split_tf32_pair(float x, float y) {
  uint32_t hx, lx, hy, ly;
  split_tf32(x, hx, lx);
  split_tf32(y, hy, ly);
  return make_float4(__uint_as_float(hx), __uint_as_float(lx), __uint_as_float(hy),
                     __uint_as_float(ly));
}

// --- K and V tiles split into TF32 terms once, in shared memory ---------------
//
// The split kernels below take a 64-key tile of K and V from global memory
// into registers while they compute the tile before it, then split each
// value into its hi and lo TF32 terms once for the whole block and store
// the terms where a warp's mma fragments read them with one 16-byte load
// (the tuned kernels with SPLIT split the tile cp.async brought, into the
// same layout): K as row r, float4 g of row (g = 4 ks + tig) holding the
// terms of columns 8 ks + tig and 8 ks + tig + 4 (b0 and b1 of the score
// step ks), V as row pair p, float4 c holding the terms of rows 2p and
// 2p + 1 at column c (b0 and b1 of the p v step over those rows). The row
// strides, D / 2 + 4 float4s for K and D + 2 for V, put the eight lanes of
// each quarter-warp of a fragment read on eight distinct 16-byte bank
// groups (4 grp + tig and 2 tig + grp mod 8). Where a warp splits each
// value it reads, a block of NW warps splits it NW times; here once.
//
// With SLOTS the tile's rows are stored in slot order (slot_row: the
// dropout kernel's Philox groups), so shared row pair p holds
// the two neighbouring keys key_of_slot(2p) and + 1.

constexpr int TS_KB = 64;  // keys a tile
__host__ __device__ constexpr int ts_k_ld(int d) { return d / 2 + 4; }  // float4s a K row
__host__ __device__ constexpr int ts_v_ld(int d) { return d + 2; }      // float4s a V row pair
// bytes of one stage of split K and V
__host__ __device__ constexpr size_t ts_stage_bytes(int d) {
  return (size_t)(TS_KB * ts_k_ld(d) + TS_KB / 2 * ts_v_ld(d)) * 16;
}

// the key (0..15) of slot s of a 16-key chunk: the inverse of key_slot
__host__ __device__ constexpr int key_of_slot(int s) {
  return 4 * ((s >> 1) & 3) + 2 * (s >> 3) + (s & 1);
}

template <int D, int THREADS, bool SLOTS>
struct SplitTile {
  // a chunk: 8 columns of one K row, or 4 columns of one V row pair
  static constexpr int K_CHUNKS = TS_KB * D / 8, CHUNKS = 2 * K_CHUNKS;
  static constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr int LDK = ts_k_ld(D), LDV = ts_v_ld(D);
  float4 a[PER], b[PER];

  // keys k0 .. k0 + 63 of the head at kh / vh into registers (past L: zeros)
  __device__ __forceinline__ void load(const float* __restrict__ kh, const float* __restrict__ vh,
                                       int k0, int L, int tid) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i >= CHUNKS) continue;
      if (i < K_CHUNKS) {
        const int r = i / (D / 8), g = i % (D / 8), kr = k0 + r;
        if (kr < L) {
          const float4* src = reinterpret_cast<const float4*>(kh + (long)kr * D + 8 * g);
          a[u] = src[0];
          b[u] = src[1];
        }
      } else {
        const int j = i - K_CHUNKS, pr = j / (D / 4), c = (j % (D / 4)) * 4;
        const int kr = k0 + (SLOTS ? (pr >> 3) * 16 + key_of_slot(2 * (pr & 7)) : 2 * pr);
        if (kr < L) a[u] = *reinterpret_cast<const float4*>(vh + (long)kr * D + c);
        if (kr + 1 < L) b[u] = *reinterpret_cast<const float4*>(vh + (long)(kr + 1) * D + c);
      }
    }
  }

  // the registers' terms into one stage: sk [TS_KB * LDK], sv [TS_KB / 2 * LDV]
  __device__ __forceinline__ void store(float4* __restrict__ sk, float4* __restrict__ sv,
                                        int tid) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      if (i >= CHUNKS) continue;
      const float x[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
      const float y[4] = {b[u].x, b[u].y, b[u].z, b[u].w};
      float4* dst;
      if (i < K_CHUNKS) {
        const int r = i / (D / 8), g = i % (D / 8);
        dst = sk + (SLOTS ? slot_row(r) : r) * LDK + 4 * g;
      } else {
        const int j = i - K_CHUNKS;
        dst = sv + (j / (D / 4)) * LDV + (j % (D / 4)) * 4;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = split_tf32_pair(x[e], y[e]);
    }
  }
};


#ifdef SSKD_PROBE_FLASH

template <int D, int NW, bool SPLIT>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1) flash_fwd_tc_tf32_tuned_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, float* __restrict__ out, int h, int L, int n_qt,
    float sm_scale) {
  constexpr int QB = 16 * NW, THREADS = 32 * NW, LD = D + 4, NT = FF_KB / 8;
  constexpr int LDK = ts_k_ld(D), LDV = ts_v_ld(D);
  constexpr unsigned CH = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_k = reinterpret_cast<float*>(smem);  // [2][FF_KB * LD]
  float* s_v = s_k + 2 * FF_KB * LD;
  float* s_keep = s_v + 2 * FF_KB * LD;         // [2][FF_KB]
  float4* s_k2 = reinterpret_cast<float4*>(s_keep + 2 * FF_KB);  // SPLIT: [FF_KB * LDK]
  float4* s_v2 = s_k2 + FF_KB * LDK;                              // SPLIT: [FF_KB / 2 * LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QB;
  const long head_off = bh * (long)L * D;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const int* mrow = mask + (bh / h) * L;
  const int row0 = q0 + warp * 16 + grp;
  const bool rows = q0 + warp * 16 < L;

  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < FF_KB * CH * 2; i += THREADS) {
      const int which = i / (FF_KB * CH), j = i % (FF_KB * CH);
      const int r = j / CH, c = (j % CH) * 4, kr = k0 + r;
      const float* src = (which ? vh : kh) + (long)min(kr, L - 1) * D + c;
      float* dst = (which ? s_v : s_k) + stage * FF_KB * LD + r * LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < FF_KB) {
      const int kr = k0 + tid;
      s_keep[stage * FF_KB + tid] = kr < L ? (mrow[kr] != 0 ? 1.f : 0.f) : -1.f;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qh[D / 8][4], ql[D / 8][4];
  {
    const float* r0 = q + head_off + (long)min(row0, L - 1) * D + tig;
    const float* r1 = q + head_off + (long)min(row0 + 8, L - 1) * D + tig;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const float a[4] = {row0 < L ? r0[ks * 8] : 0.f, row0 + 8 < L ? r1[ks * 8] : 0.f,
                          row0 < L ? r0[ks * 8 + 4] : 0.f, row0 + 8 < L ? r1[ks * 8 + 4] : 0.f};
      split_tf32_a(a, qh[ks], ql[ks]);
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};

  const int n_kt = (L + FF_KB - 1) / FF_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * FF_KB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sk = s_k + (t & 1) * FF_KB * LD;
    const float* sv = s_v + (t & 1) * FF_KB * LD;
    const float* keep = s_keep + (t & 1) * FF_KB;
    if constexpr (SPLIT) {
      for (int i = tid; i < 16 * D; i += THREADS) {
        if (i < 8 * D) {
          const int r = i / (D / 8), g = i % (D / 8);
          const float* x = sk + r * LD + 8 * g;
#pragma unroll
          for (int e = 0; e < 4; ++e) s_k2[r * LDK + 4 * g + e] = split_tf32_pair(x[e], x[e + 4]);
        } else {
          const int j = i - 8 * D, pr = j / (D / 4), c = (j % (D / 4)) * 4;
          const float* x = sv + 2 * pr * LD + c;
#pragma unroll
          for (int e = 0; e < 4; ++e) s_v2[pr * LDV + c + e] = split_tf32_pair(x[e], x[LD + e]);
        }
      }
      __syncthreads();
    }
    if (rows) {
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float s_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          if constexpr (SPLIT) {
            mma_3xtf32_b(s[nt], s_lo, qh[ks], ql[ks], s_k2[(nt * 8 + grp) * LDK + 4 * ks + tig]);
          } else {
            const float* kr = sk + (nt * 8 + grp) * LD + ks * 8 + tig;
            mma_3xtf32(s[nt], s_lo, qh[ks], ql[ks], kr[0], kr[4]);
          }
        }
        fold_lo(s[nt], s_lo);
      }
      const bool live = __all_sync(0xffffffffu, keep[lane] > 0.f && keep[lane + 32] > 0.f);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sm_scale;
          if (!live) {
            const float kf = keep[nt * 8 + 2 * tig + (e & 1)];
            x = kf > 0.f ? x : (kf == 0.f ? FA_NEG : -INFINITY);
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
      float o_lo[D / 8][4];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_lo[dn][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p[4] = {expf(s[nt][0] - m[0]), expf(s[nt][2] - m[1]),
                            expf(s[nt][1] - m[0]), expf(s[nt][3] - m[1])};
        l[0] += p[0] + p[2];
        l[1] += p[1] + p[3];
        uint32_t ph[4], pl[4];
        split_tf32_a(p, ph, pl);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          if constexpr (SPLIT) {
            mma_3xtf32_b(o[dn], o_lo[dn], ph, pl, s_v2[(nt * 4 + tig) * LDV + dn * 8 + grp]);
          } else {
            const float* vr = sv + (nt * 8 + 2 * tig) * LD + grp;
            mma_3xtf32(o[dn], o_lo[dn], ph, pl, vr[dn * 8], vr[LD + dn * 8]);
          }
        }
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) fold_lo(o[dn], o_lo[dn]);
    }
    __syncthreads();
  }
  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < L) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* dst = out + head_off + (long)row * D + 2 * tig;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8) =
            make_float2(o[dn][2 * r] / denom, o[dn][2 * r + 1] / denom);
    }
  }
}

template <int D, int NW, bool SPLIT>
static int launch_tf32_tuned(const float* q, const float* k, const float* v, const int* mask,
                             float* out, int B, int h, int L, float sm_scale, cudaStream_t s) {
  constexpr size_t smem = (size_t)(4 * FF_KB * (D + 4) + 2 * FF_KB) * 4 +
                          (SPLIT ? ts_stage_bytes(D) : 0);
  static const int attr = (int)cudaFuncSetAttribute(
      flash_fwd_tc_tf32_tuned_kernel<D, NW, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != 0) return attr;
  const int n_qt = (L + 16 * NW - 1) / (16 * NW);
  flash_fwd_tc_tf32_tuned_kernel<D, NW, SPLIT>
      <<<(unsigned)((long)B * h * n_qt), 32 * NW, smem, s>>>(q, k, v, mask, out, h, L, n_qt,
                                                             sm_scale);
  return 0;
}

// ---------------------------------------------------------------------------
// K and V split into TF32 terms once a tile, the tile prefetched in registers
// ---------------------------------------------------------------------------

// Dynamic shared memory at n_stage (1 or 2) tiles: the split K and V, the
// keep flags (76.3 KB at d = 32 with two stages, 43.5 KB at d = 16).
__host__ __device__ constexpr size_t ff_split_smem_bytes(int d, int n_stage) {
  return n_stage * (ts_stage_bytes(d) + FF_KB * 4);
}

// The f32 function of flash_fwd_tc_tf32_kernel, bit for bit (the same
// products in the same order, the same softmax), in another schedule: a
// block of NW warps owns 16 NW query rows; each 64-key tile of K and V comes
// from global memory into registers while the block computes the tile
// before it and is split into TF32 terms once for all NW warps (SplitTile),
// into the other of two stages; one barrier a tile. q's A fragments come
// from global memory once and stay split in registers. S is taken an
// 8-key tile at a time over its D / 8 steps (the small terms in four
// registers), and a tile whose 64 keys are all live skips the mask. Warps
// whose rows all lie past L only load, split and wait.
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW, 8 / NW * 2) flash_fwd_tc_tf32_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, float* __restrict__ out, int h, int L, int n_qt, int n_stage,
    float sm_scale) {
  constexpr int QB = 16 * NW, THREADS = 32 * NW;
  constexpr int NT = FF_KB / 8;  // 8-key tiles a tile
  using Tile = SplitTile<D, THREADS, false>;
  constexpr int LDK = Tile::LDK, LDV = Tile::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_k = reinterpret_cast<float4*>(smem);   // [n_stage][FF_KB * LDK]
  float4* s_v = s_k + n_stage * FF_KB * LDK;       // [n_stage][FF_KB / 2 * LDV]
  float* s_keep = reinterpret_cast<float*>(s_v + n_stage * FF_KB / 2 * LDV);  // [n_stage][FF_KB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QB;
  const long head_off = bh * (long)L * D;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const int* mrow = mask + (bh / h) * L;
  const int row0 = q0 + warp * 16 + grp;
  const bool rows = q0 + warp * 16 < L;  // the warp has a row before L

  Tile tile;
  float keep_r = -1.f;  // thread tid < FF_KB: the keep flag of key k0 + tid
  auto load = [&](int k0) {
    tile.load(kh, vh, k0, L, tid);
    if (tid < FF_KB) keep_r = k0 + tid < L ? (mrow[k0 + tid] != 0 ? 1.f : 0.f) : -1.f;
  };
  auto store = [&](int stage) {
    tile.store(s_k + stage * FF_KB * LDK, s_v + stage * FF_KB / 2 * LDV, tid);
    if (tid < FF_KB) s_keep[stage * FF_KB + tid] = keep_r;
  };
  load(0);

  uint32_t qh[D / 8][4], ql[D / 8][4];  // q's A fragments as hi and lo terms, 8 d a step
  {
    const float* r0 = q + head_off + (long)min(row0, L - 1) * D + tig;
    const float* r1 = q + head_off + (long)min(row0 + 8, L - 1) * D + tig;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const float a[4] = {row0 < L ? r0[ks * 8] : 0.f, row0 + 8 < L ? r1[ks * 8] : 0.f,
                          row0 < L ? r0[ks * 8 + 4] : 0.f, row0 + 8 < L ? r1[ks * 8 + 4] : 0.f};
      split_tf32_a(a, qh[ks], ql[ks]);
    }
  }
  store(0);
  __syncthreads();

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};  // rows grp and grp + 8, natural units

  const int n_kt = (L + FF_KB - 1) / FF_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load((t + 1) * FF_KB);
    const float4* sk = s_k + (t & 1) * FF_KB * LDK;  // one stage: a head of one tile
    const float4* sv = s_v + (t & 1) * FF_KB / 2 * LDV;
    const float* keep = s_keep + (t & 1) * FF_KB;
    if (rows) {
      // S = q k^T, an 8-key tile at a time: b0 and b1 of key grp, step ks in
      // one 16-byte read (banks: group 4 grp + tig mod 8)
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float s_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const float4* kr = sk + (nt * 8 + grp) * LDK + tig;
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) mma_3xtf32_b(s[nt], s_lo, qh[ks], ql[ks], kr[4 * ks]);
        fold_lo(s[nt], s_lo);
      }
      // the scores in natural units, masked as flash_fwd_kernel masks them;
      // a tile of 64 live keys (every tile of a full row) only scales
      const bool live = __all_sync(0xffffffffu, keep[lane] > 0.f && keep[lane + 32] > 0.f);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sm_scale;
          if (!live) {
            const float kf = keep[nt * 8 + 2 * tig + (e & 1)];
            x = kf > 0.f ? x : (kf == 0.f ? FA_NEG : -INFINITY);
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
      // p = exp(s - m), summed, then o += p v: step nt's b0 and b1 (V rows
      // nt * 8 + 2 tig and + 1 at d grp) in one 16-byte read of row pair
      // nt * 4 + tig (banks: group 2 tig + grp mod 8)
      float o_lo[D / 8][4];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_lo[dn][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p[4] = {expf(s[nt][0] - m[0]), expf(s[nt][2] - m[1]),
                            expf(s[nt][1] - m[0]), expf(s[nt][3] - m[1])};  // a0..a3
        l[0] += p[0] + p[2];
        l[1] += p[1] + p[3];
        uint32_t ph[4], pl[4];
        split_tf32_a(p, ph, pl);
        const float4* vr = sv + (nt * 4 + tig) * LDV + grp;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) mma_3xtf32_b(o[dn], o_lo[dn], ph, pl, vr[dn * 8]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) fold_lo(o[dn], o_lo[dn]);
    }
    if (t + 1 < n_kt) store((t + 1) & 1);  // tile t - 1's stage: every warp is done with it
    __syncthreads();  // tile t + 1 is in place, tile t free
  }

  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < L) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* dst = out + head_off + (long)row * D + 2 * tig;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8) =
            make_float2(o[dn][2 * r] / denom, o[dn][2 * r + 1] / denom);
    }
  }
}

template <int D, int NW>
static int launch_tf32_split(const float* q, const float* k, const float* v, const int* mask,
                             float* out, int B, int h, int L, float sm_scale, cudaStream_t s) {
  constexpr size_t smem2 = ff_split_smem_bytes(D, 2);
  if (smem2 > 48 * 1024) {
    static const int attr = (int)cudaFuncSetAttribute(
        flash_fwd_tc_tf32_split_kernel<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem2);
    if (attr != 0) return attr;
  }
  const int n_stage = L > FF_KB ? 2 : 1;
  const int n_qt = (L + 16 * NW - 1) / (16 * NW);
  flash_fwd_tc_tf32_split_kernel<D, NW>
      <<<(unsigned)((long)B * h * n_qt), 32 * NW, ff_split_smem_bytes(D, n_stage), s>>>(
          q, k, v, mask, out, h, L, n_qt, n_stage, sm_scale);
  return 0;
}

#endif  // SSKD_PROBE_FLASH

#ifdef SSKD_PROBE_DROPATTN

template <int D, int NW, bool SPLIT>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1) dropattn_fwd_tc_tf32_tuned_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ lse, int h,
    int L, int n_qt, float sm_scale, uint32_t seed, float p, float inv) {
  constexpr int QB = 16 * NW, THREADS = 32 * NW, LD = D + 4, NT = DF32_KB / 8;
  constexpr int LDK = ts_k_ld(D), LDV = ts_v_ld(D);
  constexpr unsigned CH = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_k = reinterpret_cast<float*>(smem);  // [2][DF32_KB * LD], rows in slot order
  float* s_v = s_k + 2 * DF32_KB * LD;
  float* s_bias = s_v + 2 * DF32_KB * LD;       // [2][DF32_KB], by key
  float4* s_k2 = reinterpret_cast<float4*>(s_bias + 2 * DF32_KB);
  float4* s_v2 = s_k2 + DF32_KB * LDK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QB;
  const long head_off = bh * (long)L * D;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const float* brow = bias + (bh / h) * L;
  const bool drop = p > 0.f;
  const int row0 = q0 + warp * 16 + grp;
  const bool rows = q0 + warp * 16 < L;

  auto load_tile = [&](int stage, int k0) {
    for (unsigned i = tid; i < DF32_KB * CH * 2; i += THREADS) {
      const int which = i / (DF32_KB * CH), j = i % (DF32_KB * CH);
      const int r = j / CH, c = (j % CH) * 4, kr = k0 + r;
      const float* src = (which ? vh : kh) + (long)min(kr, L - 1) * D + c;
      float* dst = (which ? s_v : s_k) + (stage * DF32_KB + slot_row(r)) * LD + c;
      cp_async16(dst, src, kr < L ? 16 : 0);
    }
    if (tid < DF32_KB) {
      const int kr = k0 + tid;
      s_bias[stage * DF32_KB + tid] = kr < L ? brow[kr] : -INFINITY;
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qh[D / 8][4], ql[D / 8][4];
  {
    const float* r0 = q + head_off + (long)min(row0, L - 1) * D + tig;
    const float* r1 = q + head_off + (long)min(row0 + 8, L - 1) * D + tig;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const float a[4] = {row0 < L ? r0[ks * 8] : 0.f, row0 + 8 < L ? r1[ks * 8] : 0.f,
                          row0 < L ? r0[ks * 8 + 4] : 0.f, row0 + 8 < L ? r1[ks * 8 + 4] : 0.f};
      split_tf32_a(a, qh[ks], ql[ks]);
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_kt = (L + DF32_KB - 1) / DF32_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile((t + 1) & 1, (t + 1) * DF32_KB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sk = s_k + (t & 1) * DF32_KB * LD;
    const float* sv = s_v + (t & 1) * DF32_KB * LD;
    const float* sb = s_bias + (t & 1) * DF32_KB;
    if constexpr (SPLIT) {
      for (int i = tid; i < 16 * D; i += THREADS) {
        if (i < 8 * D) {
          const int r = i / (D / 8), g = i % (D / 8);
          const float* x = sk + r * LD + 8 * g;
#pragma unroll
          for (int e = 0; e < 4; ++e) s_k2[r * LDK + 4 * g + e] = split_tf32_pair(x[e], x[e + 4]);
        } else {
          const int j = i - 8 * D, pr = j / (D / 4), c = (j % (D / 4)) * 4;
          const float* x = sv + 2 * pr * LD + c;
#pragma unroll
          for (int e = 0; e < 4; ++e) s_v2[pr * LDV + c + e] = split_tf32_pair(x[e], x[LD + e]);
        }
      }
      __syncthreads();
    }
    if (rows) {
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float s_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          if constexpr (SPLIT) {
            mma_3xtf32_b(s[nt], s_lo, qh[ks], ql[ks], s_k2[(nt * 8 + grp) * LDK + 4 * ks + tig]);
          } else {
            const float* kr = sk + (nt * 8 + grp) * LD + ks * 8 + tig;
            mma_3xtf32(s[nt], s_lo, qh[ks], ql[ks], kr[0], kr[4]);
          }
        }
        fold_lo(s[nt], s_lo);
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + (e & 1);
          const float x = __fadd_rn(__fmul_rn(s[nt][e], sm_scale), sb[key]);
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = expf(m[r] - base[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
      float o_lo[D / 8][4];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_lo[dn][e] = 0.f;
#pragma unroll
      for (int c = 0; c < NT / 2; ++c) {
        uint32_t keep[2] = {0xFu, 0xFu};
        if (drop) {
          const int key0 = t * DF32_KB + 16 * c + 4 * tig;
          keep[0] = keep_bits4(seed, (uint32_t)bh, row0, key0, p);
          keep[1] = keep_bits4(seed, (uint32_t)bh, row0 + 8, key0, p);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * c + half;
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = expf(s[nt][e] - base[e >> 1]);
            l[e >> 1] += pv;
            pe[e] = drop ? (((keep[e >> 1] >> (2 * half + (e & 1))) & 1u) ? __fmul_rn(pv, inv)
                                                                        : 0.f)
                         : pv;
          }
          const float a[4] = {pe[0], pe[2], pe[1], pe[3]};
          uint32_t ah[4], al[4];
          split_tf32_a(a, ah, al);
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn) {
            if constexpr (SPLIT) {
              mma_3xtf32_b(o[dn], o_lo[dn], ah, al, s_v2[(nt * 4 + tig) * LDV + dn * 8 + grp]);
            } else {
              const float* vr = sv + (nt * 8 + 2 * tig) * LD + grp;
              mma_3xtf32(o[dn], o_lo[dn], ah, al, vr[dn * 8], vr[LD + dn * 8]);
            }
          }
        }
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) fold_lo(o[dn], o_lo[dn]);
    }
    __syncthreads();
  }
  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + head_off + (long)row * D + 2 * tig;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
    if (tig == 0) lse[bh * L + row] = m[r] + logf(l[r]);
  }
}

template <int D, int NW, bool SPLIT>
static int launch_tf32_tuned(const float* q, const float* k, const float* v, const float* bias,
                             float* out, float* lse, int B, int h, int L, float sm_scale,
                             uint32_t seed, float p, float inv, cudaStream_t s) {
  constexpr size_t smem = (size_t)(4 * DF32_KB * (D + 4) + 2 * DF32_KB) * 4 +
                          (SPLIT ? ts_stage_bytes(D) : 0);
  static const int attr = (int)cudaFuncSetAttribute(
      dropattn_fwd_tc_tf32_tuned_kernel<D, NW, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != 0) return attr;
  const int n_qt = (L + 16 * NW - 1) / (16 * NW);
  dropattn_fwd_tc_tf32_tuned_kernel<D, NW, SPLIT>
      <<<(unsigned)((long)B * h * n_qt), 32 * NW, smem, s>>>(q, k, v, bias, out, lse, h, L, n_qt,
                                                             sm_scale, seed, p, inv);
  return 0;
}

// ---------------------------------------------------------------------------
// K and V split into TF32 terms once a tile, the tile prefetched in registers
// ---------------------------------------------------------------------------

// Dynamic shared memory at n_stage (1 or 2) tiles: the split K and V, the
// bias of each key (76.3 KB at d = 32 with two stages, 43.5 KB at d = 16).
__host__ __device__ constexpr size_t df32_split_smem_bytes(int d, int n_stage) {
  return n_stage * (ts_stage_bytes(d) + DF32_KB * 4);
}

// The f32 function of dropattn_fwd_tc_tf32_kernel, bit for bit (the same
// products in the same order, the same online softmax, the same keep bits),
// in the schedule of flash_attn.cu flash_fwd_tc_tf32_split_kernel: a block
// of NW warps owns 16 NW query rows; each 64-key tile of K and V comes from
// global memory into registers while the block computes the tile before
// it and is split into TF32 terms once for all NW warps (SplitTile, rows in
// slot order), into the other of two stages; one barrier a tile. q's A
// fragments stay split in registers. Warps whose rows all lie past L only
// load, split and wait.
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW, 8 / NW * 2) dropattn_fwd_tc_tf32_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ lse, int h,
    int L, int n_qt, int n_stage, float sm_scale, uint32_t seed, float p, float inv) {
  constexpr int QB = 16 * NW, THREADS = 32 * NW;
  constexpr int NT = DF32_KB / 8;  // 8-key tiles a tile
  using Tile = SplitTile<D, THREADS, true>;
  constexpr int LDK = Tile::LDK, LDV = Tile::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_k = reinterpret_cast<float4*>(smem);  // [n_stage][DF32_KB * LDK]
  float4* s_v = s_k + n_stage * DF32_KB * LDK;    // [n_stage][DF32_KB / 2 * LDV]
  float* s_bias = reinterpret_cast<float*>(s_v + n_stage * DF32_KB / 2 * LDV);  // by key

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QB;
  const long head_off = bh * (long)L * D;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const float* brow = bias + (bh / h) * L;
  const bool drop = p > 0.f;
  const int row0 = q0 + warp * 16 + grp;
  const bool rows = q0 + warp * 16 < L;  // the warp has a row before L

  Tile tile;
  float bias_r = -INFINITY;  // thread tid < DF32_KB: the bias of key k0 + tid (past L: -inf)
  auto load = [&](int k0) {
    tile.load(kh, vh, k0, L, tid);
    if (tid < DF32_KB) bias_r = k0 + tid < L ? brow[k0 + tid] : -INFINITY;
  };
  auto store = [&](int stage) {
    tile.store(s_k + stage * DF32_KB * LDK, s_v + stage * DF32_KB / 2 * LDV, tid);
    if (tid < DF32_KB) s_bias[stage * DF32_KB + tid] = bias_r;
  };
  load(0);

  uint32_t qh[D / 8][4], ql[D / 8][4];  // q's A fragments as hi and lo terms, 8 d a step
  {
    const float* r0 = q + head_off + (long)min(row0, L - 1) * D + tig;
    const float* r1 = q + head_off + (long)min(row0 + 8, L - 1) * D + tig;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const float a[4] = {row0 < L ? r0[ks * 8] : 0.f, row0 + 8 < L ? r1[ks * 8] : 0.f,
                          row0 < L ? r0[ks * 8 + 4] : 0.f, row0 + 8 < L ? r1[ks * 8 + 4] : 0.f};
      split_tf32_a(a, qh[ks], ql[ks]);
    }
  }
  store(0);
  __syncthreads();

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // rows grp and grp + 8: the running max (natural units) and this thread's
  // part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_kt = (L + DF32_KB - 1) / DF32_KB;
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load((t + 1) * DF32_KB);
    const float4* sk = s_k + (t & 1) * DF32_KB * LDK;  // one stage: a head of one tile
    const float4* sv = s_v + (t & 1) * DF32_KB / 2 * LDV;
    const float* sb = s_bias + (t & 1) * DF32_KB;
    if (rows) {
      // S = q k^T, an 8-slot tile at a time (element e of tile nt holds key
      // 16 (nt >> 1) + 4 tig + 2 (nt & 1) + (e & 1), as in the kernel above)
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float s_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const float4* kr = sk + (nt * 8 + grp) * LDK + tig;
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) mma_3xtf32_b(s[nt], s_lo, qh[ks], ql[ks], kr[4 * ks]);
        fold_lo(s[nt], s_lo);
      }
      // the scores as the plain version forms them, qk * scale + bias
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + (e & 1);
          const float x = __fadd_rn(__fmul_rn(s[nt][e], sm_scale), sb[key]);
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no -inf - -inf
        alpha[r] = expf(m[r] - base[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
      // p = exp(s - max) summed as it is, kept ones times 1 / (1 - p) into
      // p v, step nt's b0 and b1 in one 16-byte read of row pair nt * 4 + tig
      float o_lo[D / 8][4];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_lo[dn][e] = 0.f;
#pragma unroll
      for (int c = 0; c < NT / 2; ++c) {
        uint32_t keep[2] = {0xFu, 0xFu};  // rows grp, grp + 8: bit j for key 4 tig + j
        if (drop) {
          const int key0 = t * DF32_KB + 16 * c + 4 * tig;
          keep[0] = keep_bits4(seed, (uint32_t)bh, row0, key0, p);
          keep[1] = keep_bits4(seed, (uint32_t)bh, row0 + 8, key0, p);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * c + half;
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = expf(s[nt][e] - base[e >> 1]);
            l[e >> 1] += pv;
            pe[e] = drop ? (((keep[e >> 1] >> (2 * half + (e & 1))) & 1u) ? __fmul_rn(pv, inv)
                                                                        : 0.f)
                         : pv;
          }
          const float a[4] = {pe[0], pe[2], pe[1], pe[3]};
          uint32_t ah[4], al[4];
          split_tf32_a(a, ah, al);
          const float4* vr = sv + (nt * 4 + tig) * LDV + grp;
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn) mma_3xtf32_b(o[dn], o_lo[dn], ah, al, vr[dn * 8]);
        }
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) fold_lo(o[dn], o_lo[dn]);
    }
    if (t + 1 < n_kt) store((t + 1) & 1);  // tile t - 1's stage: every warp is done with it
    __syncthreads();  // tile t + 1 is in place, tile t free
  }

  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + head_off + (long)row * D + 2 * tig;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
    if (tig == 0) lse[bh * L + row] = m[r] + logf(l[r]);
  }
}

template <int D, int NW>
static int launch_tf32_split(const float* q, const float* k, const float* v, const float* bias,
                             float* out, float* lse, int B, int h, int L, float sm_scale,
                             uint32_t seed, float p, float inv, cudaStream_t s) {
  constexpr size_t smem2 = df32_split_smem_bytes(D, 2);
  if (smem2 > 48 * 1024) {
    static const int attr = (int)cudaFuncSetAttribute(
        dropattn_fwd_tc_tf32_split_kernel<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem2);
    if (attr != 0) return attr;
  }
  const int n_stage = L > DF32_KB ? 2 : 1;
  const int n_qt = (L + 16 * NW - 1) / (16 * NW);
  dropattn_fwd_tc_tf32_split_kernel<D, NW>
      <<<(unsigned)((long)B * h * n_qt), 32 * NW, df32_split_smem_bytes(D, n_stage), s>>>(
          q, k, v, bias, out, lse, h, L, n_qt, n_stage, sm_scale, seed, p, inv);
  return 0;
}

#endif  // SSKD_PROBE_DROPATTN

}  // namespace sskd
