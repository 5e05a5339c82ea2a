// LayerNorm over the last axis, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels clip_fsar_tpu/ops/fused_layernorm.py:
// _fwd_kernel (K6) and _bwd_kernel (K7), the two halves of the public op
// layer_norm.  Same functions, per row of x [R, D], all arithmetic in fp32:
//
//   mu  = mean(x), var = max(mean(x*x) - mu*mu, 0), inv = rsqrt(var + eps)
//   forward:   y  = (x - mu) * inv * g + b                       (x's dtype)
//   backward:  xhat = (x - mu) * inv, gdy = g * dy
//              dx = inv * (gdy - mean(gdy) - xhat * mean(gdy * xhat))   (x's dtype)
//              dg = sum_rows(dy * xhat), db = sum_rows(dy)              (fp32)
//
// The backward keeps no statistics from the forward: it recomputes mu and inv
// from x, as the TPU kernel does.
//
// What bounds them on an H100: bytes.  A row is read once (forward) or x and
// dy once each (backward) and written once, with a few operations per
// element, so the least time is the traffic over the card's memory rate.
//
// Design:
//   * one warp per row.  A lane loads 16 bytes at a time (8 bf16 or 4 fp32),
//     lane l taking the vectors l, l + 32, ... of the row, so a warp reads a
//     contiguous 512 bytes per step.  The row stays in registers between the
//     statistics and the normalisation: x is read once.  D is any multiple of
//     8 up to kMaxD = 1024 (every CLIP width the towers and the head use: 32,
//     64, 512, 640, 768, 1024); the number of vectors per lane is a template
//     parameter so the register arrays have a fixed size;
//   * sums across the warp are xor-shuffle butterflies: a fixed order, the
//     same result on every run;
//   * any number of rows: the TPU kernel's padding of the rows to blocks of
//     512 exists for its grid and is not carried over.  A warp past the last
//     row does nothing;
//   * K7's dg and db: a block is 8 warps and takes kBlockRows = 64 rows, 8 per
//     warp.  Each lane sums dy * xhat and dy of its own columns over its
//     warp's rows in registers; the 8 warps' sums are combined through shared
//     memory in warp order and written as one row of the [blocks, D] fp32
//     partials.  A second kernel sums the partials over the blocks, in a fixed
//     order with no atomics.  64 rows: the partials then cost R*D/8 bytes in
//     all, 1/48 of the backward's bf16 traffic, while a [94560, 768] call
//     still has 1478 blocks for the card's 132 SMs.  Rows past R add nothing;
//   * the kernels allocate nothing and do not synchronise; they run on the
//     stream they are given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                            // warps (rows in flight) per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;                      // K7: rows a warp sums dg, db over
constexpr int kBlockRows = kWarps * kRowsPerWarp;    // K7: rows per block of partials
constexpr int kMaxD = 1024;

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // elements per 16-byte load
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}
// N consecutive fp32 values (N = 4 or 8) of g or b, read through the read-only cache.
template <int N>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Loads the lane's vectors of one row into v and returns the row's mu and inv.
template <typename T, int CHUNKS>
__device__ __forceinline__ void load_row_stats(const T* __restrict__ row, int d, int lane, float eps,
                                               float (&v)[CHUNKS][Vec<T>::n], float& mu, float& inv) {
  constexpr int VEC = Vec<T>::n;
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (lane + 32 * c) * VEC;
    if (col < d) {
      load16(row + col, v[c]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s += v[c][e];
        sq = fmaf(v[c][e], v[c][e], sq);
      }
    }
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  mu = s / (float)d;
  const float var = fmaxf(sq / (float)d - mu * mu, 0.f);
  inv = rsqrtf(var + eps);
}

// ---- K6 ----
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kThreads) layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                                                                  const float* __restrict__ b, T* __restrict__ y,
                                                                  int64_t rows, int d, float eps) {
  constexpr int VEC = Vec<T>::n;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  float v[CHUNKS][VEC];
  float mu, inv;
  load_row_stats<T, CHUNKS>(x + row * d, d, lane, eps, v, mu, inv);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (lane + 32 * c) * VEC;
    if (col < d) {
      float gv[VEC], bv[VEC], out[VEC];
      load_f32<VEC>(g + col, gv);
      load_f32<VEC>(b + col, bv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = (v[c][e] - mu) * inv * gv[e] + bv[e];
      store16(y + row * d + col, out);
    }
  }
}

// ---- K7 ----
// dg_part, db_part: [gridDim.x, d] fp32, row blockIdx.x written by this block.
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kThreads) layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                                                                  const T* __restrict__ dy, T* __restrict__ dx,
                                                                  float* __restrict__ dg_part, float* __restrict__ db_part,
                                                                  int64_t rows, int d, float eps) {
  constexpr int VEC = Vec<T>::n;
  extern __shared__ float red[];  // [kWarps][d]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float dg[CHUNKS][VEC], db[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dg[c][e] = db[c][e] = 0.f;

  const int64_t row0 = (int64_t)blockIdx.x * kBlockRows;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    // neighbouring warps take neighbouring rows; the whole warp leaves together
    const int64_t row = row0 + warp + kWarps * i;
    if (row >= rows) break;
    float v[CHUNKS][VEC], gdy[CHUNKS][VEC];
    float mu, inv;
    load_row_stats<T, CHUNKS>(x + row * d, d, lane, eps, v, mu, inv);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (lane + 32 * c) * VEC;
      if (col < d) {
        float dyv[VEC], gv[VEC];
        load16(dy + row * d + col, dyv);
        load_f32<VEC>(g + col, gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xhat = (v[c][e] - mu) * inv;
          v[c][e] = xhat;
          gdy[c][e] = gv[e] * dyv[e];
          s1 += gdy[c][e];
          s2 = fmaf(gdy[c][e], xhat, s2);
          dg[c][e] = fmaf(dyv[e], xhat, dg[c][e]);
          db[c][e] += dyv[e];
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)d;
    const float m2 = warp_sum(s2) / (float)d;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (lane + 32 * c) * VEC;
      if (col < d) {
        float out[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = inv * (gdy[c][e] - m1 - v[c][e] * m2);
        store16(dx + row * d + col, out);
      }
    }
  }

  // the 8 warps' column sums -> one row of the partials, warp 0 first: dg, then db through the same buffer
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) __syncthreads();  // dg's sums read before db's overwrite them
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (lane + 32 * c) * VEC;
      if (col < d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[warp * d + col + e] = pass == 0 ? dg[c][e] : db[c][e];
      }
    }
    __syncthreads();
    float* part = (pass == 0 ? dg_part : db_part) + (int64_t)blockIdx.x * d;
    for (int col = threadIdx.x; col < d; col += kThreads) {
      float s = red[col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += red[w * d + col];
      part[col] = s;
    }
  }
}

// dg[col] = sum over blocks of dg_part[block][col] (blockIdx.y = 0), db likewise (blockIdx.y = 1).
// A block of 32 x 32 threads takes 32 columns: thread (ty, tx) sums the partial rows ty, ty + 32,
// ... of column tx in that order, and thread (0, tx) then adds the 32 sums in ty order.
__global__ void __launch_bounds__(1024) layer_norm_bwd_reduce_kernel(const float* __restrict__ dg_part,
                                                                     const float* __restrict__ db_part,
                                                                     float* __restrict__ dg, float* __restrict__ db,
                                                                     int blocks, int d) {
  __shared__ float red[32][33];
  const float* part = blockIdx.y == 0 ? dg_part : db_part;
  float* out = blockIdx.y == 0 ? dg : db;
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int r = threadIdx.y; r < blocks; r += 32) s += part[(int64_t)r * d + col];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float total = red[0][threadIdx.x];
#pragma unroll
    for (int r = 1; r < 32; ++r) total += red[r][threadIdx.x];
    out[col] = total;
  }
}

template <typename T, int CHUNKS>
int launch_fwd(const void* x, const void* g, const void* b, void* y, int64_t rows, int d, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  layer_norm_fwd_kernel<T, CHUNKS><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const float*>(g),
                                                                   static_cast<const float*>(b), static_cast<T*>(y), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, int CHUNKS>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg_part, void* db_part, void* dg, void* db,
               int64_t rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (int)((rows + kBlockRows - 1) / kBlockRows);
  const size_t smem = (size_t)kWarps * d * sizeof(float);  // at most 32 KB
  layer_norm_bwd_kernel<T, CHUNKS><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_reduce_kernel<<<dim3((d + 31) / 32, 2), dim3(32, 32), 0, stream>>>(
      static_cast<const float*>(dg_part), static_cast<const float*>(db_part), static_cast<float*>(dg), static_cast<float*>(db),
      blocks, d);
  return (int)cudaGetLastError();
}

// Vectors per lane for a row of d elements of T: ceil(d / (32 lanes * elements per vector)).
template <typename T>
int chunks_for(int d) {
  return (d + 32 * Vec<T>::n - 1) / (32 * Vec<T>::n);
}

bool shape_ok(int64_t rows, int d) { return rows > 0 && rows < ((int64_t)1 << 31) && d >= 8 && d <= kMaxD && d % 8 == 0; }

}  // namespace

// fp32 rows take up to 8 vectors of 4 per lane, bf16 rows up to 4 vectors of 8.
#define LN_DISPATCH_4(T, n, CALL) \
  switch (n) {                    \
    case 1: return CALL(T, 1);    \
    case 2: return CALL(T, 2);    \
    case 3: return CALL(T, 3);    \
    case 4: return CALL(T, 4);    \
    default: break;               \
  }
#define LN_DISPATCH_8(T, n, CALL) \
  LN_DISPATCH_4(T, n, CALL)       \
  switch (n) {                    \
    case 5: return CALL(T, 5);    \
    case 6: return CALL(T, 6);    \
    case 7: return CALL(T, 7);    \
    case 8: return CALL(T, 8);    \
    default: break;               \
  }

// Rows per block of K7's partials: the caller allocates dg_part and db_part as
// [ceil(rows / layer_norm_bwd_block_rows()), d] fp32.
extern "C" int layer_norm_bwd_block_rows() { return kBlockRows; }

// dtype: 0 = float32, 1 = bfloat16 (x and y; g and b are float32).  d: a multiple
// of 8, 8 <= d <= 1024.  Returns a cudaError_t (0 = launched).
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b, void* y, int64_t rows, int d, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(rows, d)) return (int)cudaErrorInvalidValue;
#define LN_FWD(T, C) launch_fwd<T, C>(x, g, b, y, rows, d, eps, s)
  if (dtype == 1) { LN_DISPATCH_4(__nv_bfloat16, chunks_for<__nv_bfloat16>(d), LN_FWD) }
  if (dtype == 0) { LN_DISPATCH_8(float, chunks_for<float>(d), LN_FWD) }
#undef LN_FWD
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx in one dtype; g, the partials, dg and db float32.
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg_part, void* db_part, void* dg,
                              void* db, int64_t rows, int d, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(rows, d)) return (int)cudaErrorInvalidValue;
#define LN_BWD(T, C) launch_bwd<T, C>(x, g, dy, dx, dg_part, db_part, dg, db, rows, d, eps, s)
  if (dtype == 1) { LN_DISPATCH_4(__nv_bfloat16, chunks_for<__nv_bfloat16>(d), LN_BWD) }
  if (dtype == 0) { LN_DISPATCH_8(float, chunks_for<float>(d), LN_BWD) }
#undef LN_BWD
  return (int)cudaErrorInvalidValue;
}
