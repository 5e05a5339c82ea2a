// Tile helpers shared by the clip_mha forward (clip_mha_fwd.cu) and backward
// (clip_mha_bwd.cu) kernels: storage-dtype conversions, fp32 tiles in shared
// memory, and the 16 x 16-thread tile product both kernels are built from.
//
// Layout convention: a CTA of 256 threads is a 16 x 16 grid (tx = threadIdx.x
// % 16, ty = threadIdx.x / 16).  For a [64 x 64] tile of dot products, thread
// (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, tx+48.
// Tiles of one head's Dh-slice sit in shared memory as fp32 rows padded to
// Dh+1 floats, so the 16 threads of a half-warp read 16 different banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace clip_mha {

constexpr int kBlockQ = 64;          // query rows per tile
constexpr int kBlockK = 64;          // keys per tile
constexpr int kThreads = 256;        // 16 x 16 thread grid
constexpr int kRows = kBlockQ / 16;  // tile rows per thread
constexpr int kCols = kBlockK / 16;  // tile columns per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to the storage dtype T and widened back to fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Copy rows [row0, row0 + count) of one head's Dh-slice into shared memory
// as fp32, zero-filling rows at or beyond n.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* __restrict__ src, int64_t src_stride,
                                          int row0, int count, int n) {
  for (int i = threadIdx.x; i < count * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const int row = row0 + r;
    dst[r * dst_stride + c] = row < n ? to_float(src[row * src_stride + c]) : 0.f;
  }
}

// acc[r][j] = a[ty*kRows + r] . b[tx + 16*j] over DH columns (fp32 FMAs, in
// column order), for two [64][DH + 1] tiles in shared memory.
template <int DH>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx, float (&acc)[kRows][kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < DH; ++c) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) av[r] = a[(ty * kRows + r) * (DH + 1) + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tx + 16 * j) * (DH + 1) + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
  }
}

// acc[r][c] += sum_k p[(ty*kRows + r)*(kBlockK + 1) + k] * v[k*v_stride + tx + 16*c]:
// a [64 x 64] tile of weights (rows padded to kBlockK + 1) times a [64 x DH]
// tile, accumulated into thread (ty, tx)'s kRows x DH/16 outputs.
template <int DH>
__device__ __forceinline__ void tile_accumulate(const float* p, const float* v, int v_stride, int ty, int tx,
                                                float (&acc)[kRows][DH / 16]) {
#pragma unroll 4
  for (int k = 0; k < kBlockK; ++k) {
    float vv[DH / 16];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) vv[c] = v[k * v_stride + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float w = p[(ty * kRows + r) * (kBlockK + 1) + k];
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) acc[r][c] = fmaf(w, vv[c], acc[r][c]);
    }
  }
}

}  // namespace clip_mha
