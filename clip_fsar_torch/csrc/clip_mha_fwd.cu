// Whole-sequence multi-head attention forward on the packed QKV projection
// output, for sm_90a.
//
// Replaces the Pallas TPU kernel clip_fsar_tpu/ops/fused_attention.py:
// _fwd_kernel (public op clip_mha).  Same function, per clip b and head h:
//
//   S = q_h k_h^T * Dh^-1/2          (fp32)
//   m = rowmax(S), p = exp(S - m), l = rowsum(p)   (fp32)
//   O_h = (round_to_storage_dtype(p) . v_h) / l    (fp32 accumulate)
//   LSE_h = m + log(l)                              (fp32, kept for the backward)
//
// q, k and v are read by stride straight out of qkv [B, N, 3*H*Dh] (q | k | v
// along the last axis); O_h is written into the head's Dh-slice of
// out [B, N, H*Dh]; lse is [B, H, N].  Non-causal, unmasked.
//
// What bounds it on an H100: at CLIP shapes (N = 197, Dh = 64) one head is a
// [197x64].[64x197] and a [197x197].[197x64] product, about 10 MFLOP, read from
// 3*197*64*2 bytes of bf16 -- some 130 FLOP per byte, so the kernel is bound by
// instruction rate, latency and occupancy (many small independent (clip, head)
// problems), not by HBM bandwidth.
//
// bf16, the type the models run in, goes to the tensor cores: attn_mma.cuh
// holds that kernel and the note on its design (one CTA per clip and head, K
// and V once into shared memory as bf16, mma.sync for both products, P kept in
// registers; q.k^T formed once for N <= 256, two tensor-core passes above).
//
// fp32 keeps the exact kernel below: the tensor cores have no fp32 product
// (TF32 keeps three digits), and the fp32 checks against float64 need all of
// fp32.  It is simple rather than fast: scalar FMAs out of shared memory.
//
// Design of the fp32 kernel:
//   * grid = (ceil(N / 64) query tiles, H, B); 256 threads per CTA, laid out
//     as a 16 x 16 grid in which each thread owns 4 query rows and 4 key
//     columns (scores) or 4 x Dh/16 output elements (P.V);
//   * keys and values stream through shared memory in tiles of 64, so any N
//     fits (N = 577 in fp32 would need 295 KB to hold whole K and V);
//   * two passes over the keys: the first finds the exact row max m, the
//     second forms p = exp(s - m) against that final max, rounds p to the
//     storage dtype before P.V and divides by l at the end -- the TPU
//     kernel's rounding points (fused_attention.py:83-88), so bf16 results
//     track it.  The price is computing q.k^T twice;
//   * the kernel allocates nothing and does not synchronise; it runs on the
//     stream it is given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "clip_mha_tile.cuh"

namespace {

using namespace clip_mha;

struct clip_mha_fwd_bf16 {};  // names this file's instantiations of attn_mma::forward_kernel

// Reductions over the 16 threads (one half-warp) that share a query row.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
constexpr size_t smem_floats() {
  // q tile, k tile (rows padded by one float against bank conflicts), v tile, p tile
  return kBlockQ * (DH + 1) + kBlockK * (DH + 1) + kBlockK * DH + kBlockQ * (kBlockK + 1);
}

// s[r][j] = q[ty*kRows + r] . k[tx + 16*j] * scale, key columns >= n masked to -inf.
template <int DH>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks, int ty, int tx, int k0, int n, float scale,
                                            float (&s)[kRows][kCols]) {
  tile_dot<DH>(qs, ks, ty, tx, s);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[r][j] = (k0 + tx + 16 * j) < n ? s[r][j] * scale : -INFINITY;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) clip_mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                                                                float* __restrict__ lse, int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                           // [kBlockQ][DH + 1]
  float* ks = qs + kBlockQ * (DH + 1);        // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);        // [kBlockK][DH]
  float* ps = vs + kBlockK * DH;              // [kBlockQ][kBlockK + 1]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int d = heads * DH;
  const int64_t row_stride = 3 * (int64_t)d;
  const T* base = qkv + b * n * row_stride + h * DH;
  const T* qg = base;
  const T* kg = base + d;
  const T* vg = base + 2 * d;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;

  load_tile<T, DH>(qs, DH + 1, qg, row_stride, q0, kBlockQ, n);

  // ---- pass 1: exact row max over all keys ----
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // q tile written / previous k tile consumed
    load_tile<T, DH>(ks, DH + 1, kg, row_stride, k0, kBlockK, n);
    __syncthreads();
    float s[kRows][kCols];
    tile_scores<DH>(qs, ks, ty, tx, k0, n, scale, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float tmax = s[r][0];
#pragma unroll
      for (int j = 1; j < kCols; ++j) tmax = fmaxf(tmax, s[r][j]);
      m[r] = fmaxf(m[r], half_warp_max(tmax));
    }
  }

  // ---- pass 2: p = exp(s - m); l = sum p (fp32); O += round(p) . v ----
  constexpr int kOut = DH / 16;  // output columns per thread
  float acc[kRows][kOut];
  float l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // previous k/v/p tiles consumed
    load_tile<T, DH>(ks, DH + 1, kg, row_stride, k0, kBlockK, n);
    load_tile<T, DH>(vs, DH, vg, row_stride, k0, kBlockK, n);
    __syncthreads();
    float s[kRows][kCols];
    tile_scores<DH>(qs, ks, ty, tx, k0, n, scale, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = (k0 + tx + 16 * j) < n ? expf(s[r][j] - m[r]) : 0.f;
        l[r] += p;
        ps[(ty * kRows + r) * (kBlockK + 1) + tx + 16 * j] = round_to<T>(p);
      }
    __syncthreads();
    tile_accumulate<DH>(ps, vs, DH, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float row_l = half_warp_sum(l[r]);
    const int qi = q0 + ty * kRows + r;
    if (qi >= n) continue;
    T* o = out + (b * n + qi) * d + h * DH;
#pragma unroll
    for (int c = 0; c < kOut; ++c) o[tx + 16 * c] = from_float<T>(acc[r][c] / row_l);
    if (tx == 0) lse[(b * heads + h) * n + qi] = m[r] + logf(row_l);
  }
}

template <typename T, int DH>
int launch(const void* qkv, void* out, void* lse, int b, int n, int heads, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(clip_mha_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh**-0.5 rounded once to fp32, as on the JAX side
  clip_mha_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                                               static_cast<float*>(lse), n, heads, scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernel on the packed projection, q | k | v and the heads found by stride.
template <int DH>
int launch_mma(const void* qkv, void* out, void* lse, int b, int n, int heads, cudaStream_t stream) {
  const attn_mma::Params p = attn_mma::packed_params<DH>(qkv, out, lse, n, heads);
  return attn_mma::launch_forward<clip_mha_fwd_bf16, DH, attn_mma::kTwoPass, attn_mma::kFull>(p, b, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int clip_mha_fwd(const void* qkv, void* out, void* lse, int b, int n, int heads, int dh, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 64) return launch_mma<64>(qkv, out, lse, b, n, heads, s);
  if (dtype == 1 && dh == 32) return launch_mma<32>(qkv, out, lse, b, n, heads, s);
  if (dtype == 0 && dh == 64) return launch<float, 64>(qkv, out, lse, b, n, heads, s);
  if (dtype == 0 && dh == 32) return launch<float, 32>(qkv, out, lse, b, n, heads, s);
  return (int)cudaErrorInvalidValue;
}

// The most keys the bf16 forwards (clip_mha, flash_mha) take as one block of scores; key tiles above.
extern "C" int attn_fwd_single_block_max() { return attn_mma::kSingleBlockMax; }

extern "C" const char* clip_kernels_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
