// Backward of the whole-sequence multi-head attention on the packed QKV
// projection output, for sm_90a.
//
// Replaces the Pallas TPU kernel clip_fsar_tpu/ops/fused_attention.py:
// _bwd_kernel (the custom_vjp backward of clip_mha).  Same function, per clip
// b and head h, with the TPU kernel's rounding points (T = storage dtype):
//
//   S = q_h k_h^T * Dh^-1/2,  P = exp(S - LSE_h)         (fp32, LSE from the forward)
//   delta = rowsum(dO_h o O_h)                          (fp32 products of T values)
//   dP = dO_h v_h^T                                      (fp32)
//   dS = round_T(P o (dP - delta))
//   dq_h = round_T((dS k_h) * scale)
//   dk_h = round_T((dS^T q_h) * scale)
//   dv_h = round_T(round_T(P)^T dO_h)                    (each product accumulated in fp32)
//
// Inputs are qkv [B, N, 3*H*Dh], o and dO [B, N, H*Dh] (T), lse [B, H, N]
// (fp32, as clip_mha_fwd.cu writes it); dq, dk and dv go straight into their
// column slices of the packed dqkv [B, N, 3*H*Dh], as the TPU kernel writes them.
//
// bf16, the type the models run in, goes to the tensor cores: attn_mma_bwd.cuh
// holds that kernel, what bounds it, and the note on its design (a dQ pass that
// also writes delta and a dK/dV pass, one body; a warp owns 16 rows with their
// operands as A fragments from global memory, the other side's operands in
// swizzled shared memory by cp.async, all seven products mma.sync, P from one
// ex2.approx, dS and P^T from accumulator fragment to A fragment).
//
// fp32 keeps the exact kernels below: the tensor cores have no fp32 product,
// and the fp32 checks against float64 autograd need all of fp32.  They are
// simple rather than fast: scalar FMAs out of shared memory.
//
// Design of the fp32 kernels -- no order between blocks, so no cross-block
// accumulation and no atomics (FlashAttention-2's split):
//   1. delta kernel: one warp per (clip, row, head) writes delta [B, H, N]
//      into fp32 scratch the wrapper allocates;
//   2. dq kernel: grid (query tiles of 64, H, B); streams key/value tiles of
//      64 through shared memory, recomputes S and P from the saved LSE, and
//      accumulates dS k for its 64 query rows;
//   3. dkv kernel: grid (key tiles of 64, H, B); streams query/dO tiles of 64,
//      recomputes S^T and P^T (bit-identical to the dq kernel's: the same
//      FMAs in the same order), and accumulates dS^T q and round(P)^T dO
//      for its 64 key rows.
//   Tiles of 64 in both directions, so any N fits.  Each kernel writes only
//   its own outputs, so the result does not depend on the run.  Nothing is
//   allocated and nothing synchronises inside; all run on the stream they
//   are given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma_bwd.cuh"
#include "clip_mha_tile.cuh"

namespace {

using namespace clip_mha;

struct clip_mha_bwd_bf16 {};  // names this file's instantiations of attn_mma::backward_kernel

constexpr int kWarps = kThreads / 32;

// delta[b, h, i] = sum_c dO[b, i, h*Dh + c] * O[b, i, h*Dh + c], one warp per
// row = (b*N + i)*H + h, which is also the row's offset in units of Dh.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) clip_mha_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                                                      float* __restrict__ delta, int64_t rows, int n,
                                                                      int heads) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp shares the row
  const T* op = o + row * DH;
  const T* dp = dout + row * DH;
  float acc = 0.f;
  for (int c = lane; c < DH; c += 32) acc = fmaf(to_float(dp[c]), to_float(op[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t token = row / heads;  // b*N + i
    const int h = (int)(row % heads);
    const int64_t b = token / n;
    const int i = (int)(token % n);
    delta[(b * heads + h) * n + i] = acc;
  }
}

template <int DH>
constexpr size_t dq_smem_floats() {
  // q, dO, k, v tiles ([64][DH + 1] each), dS tile [64][65]
  return 4 * kBlockQ * (DH + 1) + kBlockQ * (kBlockK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) clip_mha_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                                                   const float* __restrict__ lse,
                                                                   const float* __restrict__ delta, T* __restrict__ dqkv,
                                                                   int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBlockQ][DH + 1]
  float* dos = qs + kBlockQ * (DH + 1);  // [kBlockQ][DH + 1]
  float* ks = dos + kBlockQ * (DH + 1);  // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);   // [kBlockK][DH + 1]
  float* dss = vs + kBlockK * (DH + 1);  // [kBlockQ][kBlockK + 1]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int d = heads * DH;
  const int64_t row_stride = 3 * (int64_t)d;
  const T* base = qkv + b * n * row_stride + h * DH;
  const T* kg = base + d;
  const T* vg = base + 2 * d;
  const T* dog = dout + b * n * d + h * DH;
  const float* lse_bh = lse + (b * heads + h) * n;
  const float* delta_bh = delta + (b * heads + h) * n;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int num_tiles = (n + kBlockK - 1) / kBlockK;

  load_tile<T, DH>(qs, DH + 1, base, row_stride, q0, kBlockQ, n);
  load_tile<T, DH>(dos, DH + 1, dog, d, q0, kBlockQ, n);
  float row_lse[kRows], row_delta[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    row_lse[r] = qi < n ? lse_bh[qi] : 0.f;
    row_delta[r] = qi < n ? delta_bh[qi] : 0.f;
  }

  constexpr int kOut = DH / 16;
  float acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // q/dO tiles written; previous k/v/dS tiles consumed
    load_tile<T, DH>(ks, DH + 1, kg, row_stride, k0, kBlockK, n);
    load_tile<T, DH>(vs, DH + 1, vg, row_stride, k0, kBlockK, n);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<DH>(qs, ks, ty, tx, s);
    tile_dot<DH>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = (k0 + tx + 16 * j) < n ? expf(s[r][j] * scale - row_lse[r]) : 0.f;
        dss[(ty * kRows + r) * (kBlockK + 1) + tx + 16 * j] = round_to<T>(p * (dp[r][j] - row_delta[r]));
      }
    __syncthreads();
    tile_accumulate<DH>(dss, ks, DH + 1, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    if (qi >= n) continue;
    T* dq = dqkv + (b * n + qi) * row_stride + h * DH;
#pragma unroll
    for (int c = 0; c < kOut; ++c) dq[tx + 16 * c] = from_float<T>(acc[r][c] * scale);
  }
}

template <int DH>
constexpr size_t dkv_smem_floats() {
  // k, v, q, dO tiles ([64][DH + 1] each), P^T and dS^T tiles [64][65], LSE and delta of the query tile
  return 4 * kBlockK * (DH + 1) + 2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) clip_mha_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                                                    const float* __restrict__ lse,
                                                                    const float* __restrict__ delta,
                                                                    T* __restrict__ dqkv, int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                        // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);       // [kBlockK][DH + 1]
  float* qs = vs + kBlockK * (DH + 1);       // [kBlockQ][DH + 1]
  float* dos = qs + kBlockQ * (DH + 1);      // [kBlockQ][DH + 1]
  float* pts = dos + kBlockQ * (DH + 1);     // [kBlockK][kBlockQ + 1]: round(P)^T
  float* dsts = pts + kBlockK * (kBlockQ + 1);  // [kBlockK][kBlockQ + 1]: dS^T
  float* lses = dsts + kBlockK * (kBlockQ + 1);  // [kBlockQ]
  float* deltas = lses + kBlockQ;                // [kBlockQ]

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int d = heads * DH;
  const int64_t row_stride = 3 * (int64_t)d;
  const T* base = qkv + b * n * row_stride + h * DH;
  const T* kg = base + d;
  const T* vg = base + 2 * d;
  const T* dog = dout + b * n * d + h * DH;
  const float* lse_bh = lse + (b * heads + h) * n;
  const float* delta_bh = delta + (b * heads + h) * n;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int num_tiles = (n + kBlockQ - 1) / kBlockQ;

  load_tile<T, DH>(ks, DH + 1, kg, row_stride, k0, kBlockK, n);
  load_tile<T, DH>(vs, DH + 1, vg, row_stride, k0, kBlockK, n);

  constexpr int kOut = DH / 16;
  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  for (int t = 0; t < num_tiles; ++t) {
    const int q0 = t * kBlockQ;
    __syncthreads();  // k/v tiles written; previous q/dO/P^T/dS^T tiles consumed
    load_tile<T, DH>(qs, DH + 1, base, row_stride, q0, kBlockQ, n);
    load_tile<T, DH>(dos, DH + 1, dog, d, q0, kBlockQ, n);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      lses[i] = q0 + i < n ? lse_bh[q0 + i] : 0.f;
      deltas[i] = q0 + i < n ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();
    float st[kRows][kCols], dpt[kRows][kCols];
    tile_dot<DH>(ks, qs, ty, tx, st);    // st[r][j] = k[ty*4 + r] . q[tx + 16j]
    tile_dot<DH>(vs, dos, ty, tx, dpt);  // dpt[r][j] = v[ty*4 + r] . dO[tx + 16j]
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        // padded query rows (q0 + col >= n) contribute nothing to dk or dv
        const float p = q0 + col < n ? expf(st[r][j] * scale - lses[col]) : 0.f;
        pts[(ty * kRows + r) * (kBlockQ + 1) + col] = round_to<T>(p);
        dsts[(ty * kRows + r) * (kBlockQ + 1) + col] = round_to<T>(p * (dpt[r][j] - deltas[col]));
      }
    __syncthreads();
    tile_accumulate<DH>(pts, dos, DH + 1, ty, tx, acc_dv);
    tile_accumulate<DH>(dsts, qs, DH + 1, ty, tx, acc_dk);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + ty * kRows + r;
    if (kj >= n) continue;
    T* dk = dqkv + (b * n + kj) * row_stride + d + h * DH;
    T* dv = dk + d;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dk[tx + 16 * c] = from_float<T>(acc_dk[r][c] * scale);
      dv[tx + 16 * c] = from_float<T>(acc_dv[r][c]);
    }
  }
}

template <typename T, int DH>
int launch_bwd(const void* qkv, const void* o, const void* dout, const void* lse, void* delta, void* dqkv, int b, int n,
               int heads, cudaStream_t stream) {
  const T* qkv_t = static_cast<const T*>(qkv);
  const T* dout_t = static_cast<const T*>(dout);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  T* dqkv_t = static_cast<T*>(dqkv);

  const int64_t rows = (int64_t)b * n * heads;
  const unsigned delta_blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  clip_mha_bwd_delta_kernel<T, DH><<<delta_blocks, kThreads, 0, stream>>>(static_cast<const T*>(o), dout_t, delta_f, rows,
                                                                          n, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t dq_smem = dq_smem_floats<DH>() * sizeof(float);
  const size_t dkv_smem = dkv_smem_floats<DH>() * sizeof(float);
  err = cudaFuncSetAttribute(clip_mha_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(clip_mha_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, b);  // kBlockQ == kBlockK: one grid serves both kernels
  const float scale = (float)(1.0 / sqrt((double)DH));    // Dh**-0.5 rounded once to fp32, as in the forward
  clip_mha_bwd_dq_kernel<T, DH><<<grid, kThreads, dq_smem, stream>>>(qkv_t, dout_t, lse_f, delta_f, dqkv_t, n, heads,
                                                                      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  clip_mha_bwd_dkv_kernel<T, DH><<<grid, kThreads, dkv_smem, stream>>>(qkv_t, dout_t, lse_f, delta_f, dqkv_t, n, heads,
                                                                        scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core passes on the packed projection, q | k | v and the heads found by stride.
template <int DH>
int launch_mma(const void* qkv, const void* o, const void* dout, const void* lse, void* delta, void* dqkv, int b, int n, int heads,
               cudaStream_t stream) {
  const attn_mma::BwdParams p = attn_mma::packed_bwd_params<DH>(qkv, o, dout, lse, delta, dqkv, n, heads);
  return attn_mma::launch_backward<clip_mha_bwd_bf16, DH>(p, b, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta: fp32 scratch of B*H*N floats.
// Returns a cudaError_t (0 = every kernel launched).
extern "C" int clip_mha_bwd(const void* qkv, const void* o, const void* dout, const void* lse, void* delta, void* dqkv,
                            int b, int n, int heads, int dh, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 64) return launch_mma<64>(qkv, o, dout, lse, delta, dqkv, b, n, heads, s);
  if (dtype == 1 && dh == 32) return launch_mma<32>(qkv, o, dout, lse, delta, dqkv, b, n, heads, s);
  if (dtype == 0 && dh == 64) return launch_bwd<float, 64>(qkv, o, dout, lse, delta, dqkv, b, n, heads, s);
  if (dtype == 0 && dh == 32) return launch_bwd<float, 32>(qkv, o, dout, lse, delta, dqkv, b, n, heads, s);
  return (int)cudaErrorInvalidValue;
}

// The most streamed rows (keys in the dQ pass, queries in the dK/dV pass) the bf16 backward keeps in shared
// memory at once; longer sequences go through it in stages.
extern "C" int attn_bwd_resident_max() { return attn_mma::kBwdResidentMax; }
