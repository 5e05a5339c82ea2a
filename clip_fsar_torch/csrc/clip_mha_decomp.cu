// Deliberately ablated variants of the clip_mha forward, for sm_90a: they
// time the stages of clip_mha_fwd.cu by leaving stages out.
//
// Replaces the Pallas TPU kernels of tools/_fa_decomp.py: make_kernel(mode),
// called through impl.  Per clip b and head h, with s = q_h k_h^T * Dh^-1/2 in
// fp32:
//
//   mode 0 "matmul":  O_h = round(s) . v_h
//   mode 1 "exp":     O_h = round(exp(s)) . v_h             (no max, no sum)
//   mode 2 "nomax":   p = exp(s), l = rowsum(p), O_h = (round(p) . v_h) / l
//
// round() is the rounding to the storage dtype before the second product, as
// in the full kernel.  The numbers are wrong by design (no row max, so the
// caller keeps s small); only the differences between the modes' times and
// the full kernel's mean anything: full - nomax is the row max (with its
// subtraction, and above 256 keys the first pass), nomax - exp the row sum and
// the divide, exp - matmul the exponential.  The fourth mode of the TPU tool,
// "full", is clip_mha_fwd.cu itself and has no copy here.
//
// What bounds them on an H100: the same as clip_mha_fwd.cu, whose bytes they
// move (less the lse) and whose two products they compute.
//
// Design: each mode is the kernel clip_mha_fwd.cu launches for the same dtype
// with stages left out, so the products cost what they cost there.  bf16: the
// tensor-core kernel of attn_mma.cuh with its STAGE parameter set (same grid,
// shared memory, fragments and loop; no max, and for matmul and exp no sum).
// fp32: clip_mha_fwd.cu's grid (query tile, head, clip), 256 threads, 64 x 64
// tiles and tile helpers (clip_mha_tile.cuh) in a single pass over the key
// tiles, the full kernel's first pass being what "full - nomax" measures.
// Only O is written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "clip_mha_tile.cuh"

namespace {

using namespace clip_mha;

struct clip_mha_decomp_bf16 {};  // names this file's instantiations of attn_mma::forward_kernel

constexpr int kMatmul = 0, kExp = 1, kNoMax = 2;

template <int DH>
constexpr size_t smem_floats() {
  // q tile, k tile (rows padded by one float against bank conflicts), v tile, p tile: as clip_mha_fwd.cu
  return kBlockQ * (DH + 1) + kBlockK * (DH + 1) + kBlockK * DH + kBlockQ * (kBlockK + 1);
}

template <typename T, int DH, int MODE>
__global__ void __launch_bounds__(kThreads) clip_mha_decomp_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n,
                                                                   int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockQ][DH + 1]
  float* ks = qs + kBlockQ * (DH + 1);  // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);  // [kBlockK][DH]
  float* ps = vs + kBlockK * DH;        // [kBlockQ][kBlockK + 1]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int d = heads * DH;
  const int64_t row_stride = 3 * (int64_t)d;
  const T* base = qkv + b * n * row_stride + h * DH;
  const T* kg = base + d;
  const T* vg = base + 2 * d;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;

  load_tile<T, DH>(qs, DH + 1, base, row_stride, q0, kBlockQ, n);

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
    __syncthreads();  // q tile written / previous k, v and p tiles consumed
    load_tile<T, DH>(ks, DH + 1, kg, row_stride, k0, kBlockK, n);
    load_tile<T, DH>(vs, DH, vg, row_stride, k0, kBlockK, n);
    __syncthreads();
    float s[kRows][kCols];
    tile_dot<DH>(qs, ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float sc = s[r][j] * scale;
        float p = MODE == kMatmul ? sc : expf(sc);
        if (k0 + tx + 16 * j >= n) p = 0.f;  // keys past the sequence add nothing
        if (MODE == kNoMax) l[r] += p;
        ps[(ty * kRows + r) * (kBlockK + 1) + tx + 16 * j] = round_to<T>(p);
      }
    __syncthreads();
    tile_accumulate<DH>(ps, vs, DH, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float row_l = 1.f;
    if (MODE == kNoMax) {  // the 16 threads (one half-warp) that share the query row
      row_l = l[r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) row_l += __shfl_xor_sync(0xffffffffu, row_l, off);
    }
    const int qi = q0 + ty * kRows + r;
    if (qi >= n) continue;
    T* o = out + (b * n + qi) * d + h * DH;
#pragma unroll
    for (int c = 0; c < kOut; ++c) o[tx + 16 * c] = from_float<T>(MODE == kNoMax ? acc[r][c] / row_l : acc[r][c]);
  }
}

template <typename T, int DH, int MODE>
int launch(const void* qkv, void* out, int b, int n, int heads, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(clip_mha_decomp_kernel<T, DH, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh**-0.5 rounded once to fp32, as on the JAX side
  clip_mha_decomp_kernel<T, DH, MODE><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), n,
                                                                         heads, scale);
  return (int)cudaGetLastError();
}

// bf16: clip_mha_fwd.cu's tensor-core launch with the stage code of the mode (kMatmul, kExp, kNoMax = mode + 1).
template <int DH, int STAGE>
int launch_mma(const void* qkv, void* out, int b, int n, int heads, cudaStream_t stream) {
  const attn_mma::Params p = attn_mma::packed_params<DH>(qkv, out, nullptr, n, heads);
  return attn_mma::launch_forward<clip_mha_decomp_bf16, DH, attn_mma::kTwoPass, STAGE>(p, b, stream);
}

template <int DH>
int launch_mma_mode(int mode, const void* qkv, void* out, int b, int n, int heads, cudaStream_t stream) {
  if (mode == kMatmul) return launch_mma<DH, attn_mma::kMatmul>(qkv, out, b, n, heads, stream);
  if (mode == kExp) return launch_mma<DH, attn_mma::kExp>(qkv, out, b, n, heads, stream);
  if (mode == kNoMax) return launch_mma<DH, attn_mma::kNoMax>(qkv, out, b, n, heads, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DH>
int launch_mode(int mode, const void* qkv, void* out, int b, int n, int heads, cudaStream_t stream) {
  if (mode == kMatmul) return launch<T, DH, kMatmul>(qkv, out, b, n, heads, stream);
  if (mode == kExp) return launch<T, DH, kExp>(qkv, out, b, n, heads, stream);
  if (mode == kNoMax) return launch<T, DH, kNoMax>(qkv, out, b, n, heads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 = matmul, 1 = exp, 2 = nomax.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = launched).
extern "C" int clip_mha_decomp(const void* qkv, void* out, int b, int n, int heads, int dh, int dtype, int mode,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 64) return launch_mma_mode<64>(mode, qkv, out, b, n, heads, s);
  if (dtype == 1 && dh == 32) return launch_mma_mode<32>(mode, qkv, out, b, n, heads, s);
  if (dtype == 0 && dh == 64) return launch_mode<float, 64>(mode, qkv, out, b, n, heads, s);
  if (dtype == 0 && dh == 32) return launch_mode<float, 32>(mode, qkv, out, b, n, heads, s);
  return (int)cudaErrorInvalidValue;
}
