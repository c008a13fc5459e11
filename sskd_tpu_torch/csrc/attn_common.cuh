// attn_common.cuh: element helpers shared by the attention kernels
// (flash_attn.cu, dropattn_fwd.cu, dropattn_bwd.cu). T is __nv_bfloat16 (the
// CUDA-core kernels' one type since every f32 attention takes the tensor
// cores); arithmetic is f32, and round_as rounds an f32 value to T and back,
// as a cast to the input type before a product does.

#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sskd {

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Loads 16 bytes of T values starting at src (16-byte aligned) into f32 dst.
template <typename T>
__device__ __forceinline__ void load_vec(float* dst, const T* src) {
  constexpr int VE = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VE; ++i) dst[i] = to_f(e[i]);
}

// Loads a whole row of D values of T into f32 registers.
template <typename T, int D>
__device__ __forceinline__ void load_row(float* dst, const T* src) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < D; c += VE) load_vec<T>(dst + c, src + c);
}

// dot of f32 registers a[D] with a row of T in shared memory (a broadcast
// read when every thread of the warp reads the same row)
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* a, const T* row) {
  constexpr int VE = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += VE) {
    float e[VE];
    load_vec<T>(e, row + c);
#pragma unroll
    for (int i = 0; i < VE; ++i) acc = fmaf(a[c + i], e[i], acc);
  }
  return acc;
}

// acc[D] += w * row (row of T in shared memory)
template <typename T, int D>
__device__ __forceinline__ void axpy_row(float* acc, float w, const T* row) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < D; c += VE) {
    float e[VE];
    load_vec<T>(e, row + c);
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[c + i] = fmaf(w, e[i], acc[c + i]);
  }
}

// The key order of the tensor-core dropout kernels. A 16-key chunk enters
// the mma in the order 0 1 4 5 8 9 12 13 | 2 3 6 7 10 11 14 15, so that each
// thread's C fragment of the chunk's scores (columns 2 tig, 2 tig + 1 of its
// two 8-key tiles) holds keys 4 tig .. 4 tig + 3: the four words of one
// Philox call (philox.cuh keep_bits4).
// perm_key: the key of slot r (0..7) of ldmatrix matrix `second` (0 or 1):
// the bf16 kernels hand ldmatrix these rows, which it reads in any order.
__device__ __forceinline__ int perm_key(int r, int second) {
  return 4 * (r >> 1) + (r & 1) + 2 * second;
}
// key_slot: its inverse, the slot (8 second + r) of key t (0..15) of a chunk.
// The f32 kernels, whose 32-bit fragment reads cannot permute rows as
// ldmatrix does, store k and v rows in slot order (slot_row) and read eight
// consecutive slots.
__host__ __device__ constexpr int key_slot(int t) {
  return 8 * ((t >> 1) & 1) + 2 * (t >> 2) + (t & 1);
}
// the shared row of key r of a tile whose 16-key chunks are in slot order
__host__ __device__ constexpr int slot_row(int r) { return (r & ~15) + key_slot(r & 15); }

// Copies n_rows rows of D values of T from global src to shared dst,
// 16 bytes per thread per step, the block's threads striding together.
template <typename T, int D>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int n_rows, int tid, int nthreads) {
  constexpr int VE = 16 / sizeof(T);
  const int n_vec = n_rows * (D / VE);
  for (int i = tid; i < n_vec; i += nthreads) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
}

}  // namespace sskd
