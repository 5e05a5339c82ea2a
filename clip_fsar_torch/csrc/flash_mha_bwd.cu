// Backward of the online-softmax ("flash") multi-head attention on
// head-split tensors, for sm_90a: K4 (dQ) and K5 (dK/dV).
//
// Replaces the Pallas TPU kernels clip_fsar_tpu/ops/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (the custom_vjp backward of flash_mha,
// _bwd_impl).  Same function, per clip b and head h, with the TPU kernels'
// rounding points (T = storage dtype):
//
//   s = q_h k_h^T * Dh^-1/2, masked as in the forward (keys >= Nk; with
//   `causal` keys j > i); P = exp(s - LSE_h)        (fp32, LSE from the forward)
//   delta = rowsum(dO_h o O_h)                       (fp32, flash_attention.py:229)
//   dP = dO_h v_h^T                                  (fp32)
//   dS = round_T(P o (dP - delta))                   (:116, :144)
//   dq_h = round_T((dS k_h) * scale)
//   dk_h = round_T((dS^T q_h) * scale)
//   dv_h = round_T(round_T(P)^T dO_h)                (:141-142; each product fp32-accumulated)
//
// q, k, v, o and dO are read through their batch, head and sequence strides
// (unit stride on Dh; o and dO share theirs, k and v theirs); dq, dk and dv
// are written through the strides the wrapper gives (a [B, N, H, Dh] buffer
// each, the layout the head split's backward reads without a copy).  lse
// and delta are fp32 [B, H, Nq].
//
// bf16, the type the models run in, goes to the tensor cores: attn_mma_bwd.cuh
// holds that kernel, what bounds it, and the note on its design.  The two
// entry points below are its two passes, one to one: flash_mha_bwd_dq is the
// dQ pass (a warp owns 16 query rows with q and dO as A fragments from global
// memory, k and v of the head in swizzled shared memory by cp.async; it also
// forms delta from the dO fragments it holds and O's and writes it, so there
// is no delta kernel), flash_mha_bwd_dkv the dK/dV pass (a warp owns 16 key
// rows, q and dO stream, LSE and delta staged beside them).  All seven
// products are mma.sync, P comes from one ex2.approx, dS and P^T go from
// accumulator fragment to A fragment (the packing is the rounding above), and
// the causal mask is a template flag of the body: whole tiles past the
// diagonal are skipped and P is set to 0 per element in the tiles across it.
//
// fp32 keeps the exact kernels below: the tensor cores have no fp32 product,
// and the fp32 checks against float64 autograd need all of fp32.  They are
// simple rather than fast, scalar FMAs out of shared memory; per (clip, head)
// seven N x N x Dh products on 5*N*Dh values, so at N = 197 far from the HBM
// bound and bound by the fp32 FMA rate, latency and occupancy.
//
// Design of the fp32 kernels -- blocks run in no order, so nothing is
// accumulated across blocks and nothing uses atomics (FlashAttention-2's
// split, as on the TPU):
//   1. delta pass: one warp per (clip, head, query row) writes delta into
//      fp32 scratch the wrapper allocates (the JAX package computes it
//      outside its kernels);
//   2. K4, dq kernel: grid (query tiles of 64, H, B); streams key/value tiles
//      of 64 through shared memory, recomputes P from the saved LSE, and
//      accumulates dS k for its 64 query rows; with `causal` it stops after
//      the key tile of its last row;
//   3. K5, dkv kernel: grid (key tiles of 64, H, B); streams query/dO tiles
//      of 64, recomputes S^T and P^T (bit-identical to K4's: the same FMAs in
//      the same order), and accumulates dS^T q and round(P)^T dO for its 64
//      key rows; with `causal` it starts at the query tile of its first key.
//      Query rows past Nq (q = 0, LSE 0) would give P = 1: they get P = 0
//      explicitly, as the TPU kernel's q_ids < nq mask does (:136-137).
//   Masked entries are P = 0, which is exp(-1e30 - LSE) on the TPU.  Each
//   kernel writes only its own rows, so the result does not depend on the
//   run.  Nothing is allocated and nothing synchronises inside; all run on
//   the stream they are given.  In both types delta is fp32 [B, H, Nq],
//   written by the dq entry and read by the dkv entry after it on the same
//   stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma_bwd.cuh"
#include "clip_mha_tile.cuh"

namespace {

using namespace clip_mha;
using attn_mma::Strides;  // batch, head and sequence strides in elements; Dh has stride 1

// name this file's instantiations of attn_mma::backward_kernel, one tag a pass, so a profile tells K4 and K5 apart
struct flash_mha_bwd_dq_bf16 {};
struct flash_mha_bwd_dkv_bf16 {};

constexpr int kWarps = kThreads / 32;

// delta[(b*H + h)*Nq + i] = sum_c dO[b, h, i, c] * O[b, h, i, c], one warp per row.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_mha_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                                                       float* __restrict__ delta, int64_t rows, int heads,
                                                                       int nq, Strides ost) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp shares the row
  const int i = (int)(row % nq);
  const int64_t bh = row / nq;
  const int64_t off = (bh / heads) * ost.b + (bh % heads) * ost.h + i * ost.n;
  float acc = 0.f;
  for (int c = lane; c < DH; c += 32) acc = fmaf(to_float(dout[off + c]), to_float(o[off + c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

template <int DH>
constexpr size_t dq_smem_floats() {
  // q, dO, k, v tiles ([64][DH + 1] each), dS tile [64][65]
  return 4 * kBlockQ * (DH + 1) + kBlockQ * (kBlockK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dq, int heads, int nq, int nk, int causal, Strides qst, Strides kvst,
                            Strides ost, Strides dqst, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBlockQ][DH + 1]
  float* dos = qs + kBlockQ * (DH + 1);  // [kBlockQ][DH + 1]
  float* ks = dos + kBlockQ * (DH + 1);  // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);   // [kBlockK][DH + 1]
  float* dss = vs + kBlockK * (DH + 1);  // [kBlockQ][kBlockK + 1]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qg = q + b * qst.b + h * qst.h;
  const T* kg = k + b * kvst.b + h * kvst.h;
  const T* vg = v + b * kvst.b + h * kvst.h;
  const T* dog = dout + b * ost.b + h * ost.h;
  const float* lse_bh = lse + (b * heads + h) * nq;
  const float* delta_bh = delta + (b * heads + h) * nq;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int num_tiles = (nk + kBlockK - 1) / kBlockK;
  if (causal) num_tiles = min(num_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  load_tile<T, DH>(qs, DH + 1, qg, qst.n, q0, kBlockQ, nq);
  load_tile<T, DH>(dos, DH + 1, dog, ost.n, q0, kBlockQ, nq);
  float row_lse[kRows], row_delta[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    row_lse[r] = qi < nq ? lse_bh[qi] : 0.f;
    row_delta[r] = qi < nq ? delta_bh[qi] : 0.f;
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
    load_tile<T, DH>(ks, DH + 1, kg, kvst.n, k0, kBlockK, nk);
    load_tile<T, DH>(vs, DH + 1, vg, kvst.n, k0, kBlockK, nk);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<DH>(qs, ks, ty, tx, s);
    tile_dot<DH>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + ty * kRows + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < nk && !(causal && kj > qi);
        const float p = live ? expf(s[r][j] * scale - row_lse[r]) : 0.f;
        dss[(ty * kRows + r) * (kBlockK + 1) + tx + 16 * j] = round_to<T>(p * (dp[r][j] - row_delta[r]));
      }
    }
    __syncthreads();
    tile_accumulate<DH>(dss, ks, DH + 1, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + ty * kRows + r;
    if (qi >= nq) continue;
    T* dqrow = dq + b * dqst.b + h * dqst.h + qi * dqst.n;
#pragma unroll
    for (int c = 0; c < kOut; ++c) dqrow[tx + 16 * c] = from_float<T>(acc[r][c] * scale);
  }
}

template <int DH>
constexpr size_t dkv_smem_floats() {
  // k, v, q, dO tiles ([64][DH + 1] each), P^T and dS^T tiles [64][65], LSE and delta of the query tile
  return 4 * kBlockK * (DH + 1) + 2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int heads,
                             int nq, int nk, int causal, Strides qst, Strides kvst, Strides ost, Strides dkvst,
                             float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                              // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);           // [kBlockK][DH + 1]
  float* qs = vs + kBlockK * (DH + 1);           // [kBlockQ][DH + 1]
  float* dos = qs + kBlockQ * (DH + 1);          // [kBlockQ][DH + 1]
  float* pts = dos + kBlockQ * (DH + 1);         // [kBlockK][kBlockQ + 1]: round(P)^T
  float* dsts = pts + kBlockK * (kBlockQ + 1);   // [kBlockK][kBlockQ + 1]: dS^T
  float* lses = dsts + kBlockK * (kBlockQ + 1);  // [kBlockQ]
  float* deltas = lses + kBlockQ;                // [kBlockQ]

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qg = q + b * qst.b + h * qst.h;
  const T* kg = k + b * kvst.b + h * kvst.h;
  const T* vg = v + b * kvst.b + h * kvst.h;
  const T* dog = dout + b * ost.b + h * ost.h;
  const float* lse_bh = lse + (b * heads + h) * nq;
  const float* delta_bh = delta + (b * heads + h) * nq;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int num_tiles = (nq + kBlockQ - 1) / kBlockQ;
  const int first_tile = causal ? k0 / kBlockQ : 0;  // earlier query rows see none of these keys

  load_tile<T, DH>(ks, DH + 1, kg, kvst.n, k0, kBlockK, nk);
  load_tile<T, DH>(vs, DH + 1, vg, kvst.n, k0, kBlockK, nk);

  constexpr int kOut = DH / 16;
  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  for (int t = first_tile; t < num_tiles; ++t) {
    const int q0 = t * kBlockQ;
    __syncthreads();  // k/v tiles written; previous q/dO/P^T/dS^T tiles consumed
    load_tile<T, DH>(qs, DH + 1, qg, qst.n, q0, kBlockQ, nq);
    load_tile<T, DH>(dos, DH + 1, dog, ost.n, q0, kBlockQ, nq);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      lses[i] = q0 + i < nq ? lse_bh[q0 + i] : 0.f;
      deltas[i] = q0 + i < nq ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();
    float st[kRows][kCols], dpt[kRows][kCols];
    tile_dot<DH>(ks, qs, ty, tx, st);    // st[r][j] = k[ty*4 + r] . q[tx + 16j]
    tile_dot<DH>(vs, dos, ty, tx, dpt);  // dpt[r][j] = v[ty*4 + r] . dO[tx + 16j]
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kj = k0 + ty * kRows + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const int qi = q0 + col;
        // query rows past Nq, and with `causal` queries before the key, contribute nothing
        const bool live = qi < nq && !(causal && kj > qi);
        const float p = live ? expf(st[r][j] * scale - lses[col]) : 0.f;
        pts[(ty * kRows + r) * (kBlockQ + 1) + col] = round_to<T>(p);
        dsts[(ty * kRows + r) * (kBlockQ + 1) + col] = round_to<T>(p * (dpt[r][j] - deltas[col]));
      }
    }
    __syncthreads();
    tile_accumulate<DH>(pts, dos, DH + 1, ty, tx, acc_dv);
    tile_accumulate<DH>(dsts, qs, DH + 1, ty, tx, acc_dk);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + ty * kRows + r;
    if (kj >= nk) continue;
    const int64_t off = b * dkvst.b + h * dkvst.h + kj * dkvst.n;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dk[off + tx + 16 * c] = from_float<T>(acc_dk[r][c] * scale);
      dv[off + tx + 16 * c] = from_float<T>(acc_dv[r][c]);
    }
  }
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse, void* delta,
              void* dq, int b, int heads, int nq, int nk, int causal, Strides qst, Strides kvst, Strides ost,
              Strides dqst, cudaStream_t stream) {
  const int64_t rows = (int64_t)b * heads * nq;
  const unsigned delta_blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  flash_mha_bwd_delta_kernel<T, DH><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows, heads, nq, ost);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = dq_smem_floats<DH>() * sizeof(float);
  err = cudaFuncSetAttribute(flash_mha_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh**-0.5 rounded once to fp32, as in the forward
  flash_mha_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), heads, nq, nk, causal, qst,
      kvst, ost, dqst, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int b, int heads, int nq, int nk, int causal, Strides qst, Strides kvst, Strides ost,
               Strides dkvst, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<DH>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(flash_mha_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nk + kBlockK - 1) / kBlockK, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));
  flash_mha_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), heads,
      nq, nk, causal, qst, kvst, ost, dkvst, scale);
  return (int)cudaGetLastError();
}

// bf16: one tensor-core pass (DKV false: dq and delta; true: dk and dv) on the head-split views.
template <typename TAG, int DH, bool DKV>
int launch_mma(const attn_mma::BwdParams& p, int b, cudaStream_t stream) {
  return p.causal ? attn_mma::launch_shaped<TAG, DH, DKV, true>(p, b, stream) : attn_mma::launch_shaped<TAG, DH, DKV, false>(p, b, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements: q's, k's and v's
// (shared), o's and dO's (shared), the output's.  delta: fp32 scratch of
// B*H*Nq floats, written here and read by flash_mha_bwd_dkv after it on the
// same stream.  Returns a cudaError_t (0 = K4 launched; in fp32 the delta pass before it too).
extern "C" int flash_mha_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                const void* lse, void* delta, void* dq, int b, int heads, int nq, int nk, int dh,
                                int dtype, int causal, int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb,
                                int64_t kv_sh, int64_t kv_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn, int64_t dq_sb,
                                int64_t dq_sh, int64_t dq_sn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qst{q_sb, q_sh, q_sn}, kvst{kv_sb, kv_sh, kv_sn}, ost{o_sb, o_sh, o_sn}, dqst{dq_sb, dq_sh, dq_sn};
#define FLASH_DQ_MMA(DH)                                                                                                      \
  launch_mma<flash_mha_bwd_dq_bf16, DH, false>(attn_mma::split_bwd_params<DH>(q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, \
                                                                              heads, nq, nk, causal, qst, kvst, ost, dqst, Strides{}), b, s)
#define FLASH_DQ(T, DH) launch_dq<T, DH>(q, k, v, o, dout, lse, delta, dq, b, heads, nq, nk, causal, qst, kvst, ost, dqst, s)
  if (dtype == 1 && dh == 64) return FLASH_DQ_MMA(64);
  if (dtype == 1 && dh == 32) return FLASH_DQ_MMA(32);
  if (dtype == 0 && dh == 64) return FLASH_DQ(float, 64);
  if (dtype == 0 && dh == 32) return FLASH_DQ(float, 32);
#undef FLASH_DQ
#undef FLASH_DQ_MMA
  return (int)cudaErrorInvalidValue;
}

// As flash_mha_bwd_dq, with dk and dv written through one set of strides.
// Returns a cudaError_t (0 = K5 launched).
extern "C" int flash_mha_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b, int heads, int nq, int nk, int dh,
                                 int dtype, int causal, int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb,
                                 int64_t kv_sh, int64_t kv_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
                                 int64_t dkv_sb, int64_t dkv_sh, int64_t dkv_sn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qst{q_sb, q_sh, q_sn}, kvst{kv_sb, kv_sh, kv_sn}, ost{o_sb, o_sh, o_sn}, dkvst{dkv_sb, dkv_sh, dkv_sn};
#define FLASH_DKV_MMA(DH)                                                                                                  \
  launch_mma<flash_mha_bwd_dkv_bf16, DH, true>(                                                                            \
      attn_mma::split_bwd_params<DH>(q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv, heads, nq, nk, causal, qst, \
                                     kvst, ost, Strides{}, dkvst), b, s)
#define FLASH_DKV(T, DH) \
  launch_dkv<T, DH>(q, k, v, dout, lse, delta, dk, dv, b, heads, nq, nk, causal, qst, kvst, ost, dkvst, s)
  if (dtype == 1 && dh == 64) return FLASH_DKV_MMA(64);
  if (dtype == 1 && dh == 32) return FLASH_DKV_MMA(32);
  if (dtype == 0 && dh == 64) return FLASH_DKV(float, 64);
  if (dtype == 0 && dh == 32) return FLASH_DKV(float, 32);
#undef FLASH_DKV
#undef FLASH_DKV_MMA
  return (int)cudaErrorInvalidValue;
}
