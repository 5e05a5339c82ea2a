// Online-softmax ("flash") multi-head attention forward on head-split
// tensors, for sm_90a.
//
// Replaces the Pallas TPU kernel clip_fsar_tpu/ops/flash_attention.py:
// _fwd_kernel (behind _fwd_impl and the public op flash_mha).  Same function,
// per clip b and head h, one pass over the keys (T = storage dtype):
//
//   s = q_h k_h^T * Dh^-1/2 (fp32); keys j >= Nk, and with `causal` keys
//   j > i, get -1e30 (absolute indices: top-left aligned)
//   per key tile:  m_new = max(m, rowmax(s));  p = exp(s - m_new)
//                  alpha = exp(m - m_new);  l = alpha * l + rowsum(p)
//                  acc = alpha * acc + round_T(p) . v_h      (fp32 accumulate)
//   O_h = acc / max(l, 1e-30),  LSE_h = m + log(max(l, 1e-30))  (fp32)
//
// p is rounded to T against the running max before P.V, and the accumulator
// is rescaled in fp32, at the TPU kernel's points (flash_attention.py:63-90).
// The bf16 kernel takes the TPU's own key blocks (one block up to 256 keys,
// blocks of 128 above), so it rounds p where the TPU kernel does; the fp32
// kernel's tiles of 64 keys rescale at other points, which is the same
// function in fp32.
//
// q [B, H, Nq, Dh] and k, v [B, H, Nk, Dh] are read through their batch,
// head and sequence strides (unit stride on Dh), so head-split views of the
// packed QKV projection need no copy; o is written through its own strides
// (the wrapper gives a [B, Nq, H, Dh] buffer, the layout merge_heads reads);
// lse is fp32 [B, H, Nq].  The TPU's padding of Dh to 128 lanes and its
// lane-replicated LSE buffer are TPU tiling artefacts and are not carried.
//
// What bounds it on an H100: at CLIP shapes (N = 197, Dh = 64) one head is a
// [197x64].[64x197] and a [197x197].[197x64] product, about 10 MFLOP, from
// 3*197*64*2 bytes of bf16 -- some 130 FLOP per byte, so it is bound by the
// instruction rate, latency and occupancy (many small independent (clip,
// head) problems), not by HBM bandwidth.
//
// bf16, the type the models run in, goes to the tensor cores: attn_mma.cuh
// holds that kernel and the note on its design (one CTA per clip and head, K
// and V once into shared memory as bf16, mma.sync for both products, P kept in
// registers; one block of scores for Nk <= 256, the online recurrence over key
// tiles of 128 above, causal tiles past the diagonal skipped).
//
// fp32 keeps the exact kernel below: the tensor cores have no fp32 product
// (TF32 keeps three digits), and the fp32 checks against float64 need all of
// fp32.  It is simple rather than fast: scalar FMAs out of shared memory.
//
// Design of the fp32 kernel:
//   * grid = (ceil(Nq / 64) query tiles, H, B); 256 threads per CTA as the
//     16 x 16 grid of clip_mha_tile.cuh: 4 query rows x 4 key columns per
//     thread for the scores, 4 rows x Dh/16 columns for P.V;
//   * one pass over key tiles of 64 through shared memory, so any Nk fits,
//     against K1's two passes (clip_mha_fwd.cu): q.k^T is formed once;
//   * each thread keeps its rows' running max (shared by the 16 threads of
//     the row through a half-warp max), a partial running sum and its fp32
//     accumulators; the partial sums are added at the end;
//   * m starts at -1e30, not -inf, so a tile masked for a whole row gives
//     p = exp(-1e30 - m) = 0 and alpha = 1, never inf - inf; with `causal`
//     the key tiles past the query tile's last row are not visited at all
//     (they would add exactly nothing);
//   * the kernel allocates nothing and does not synchronise; it runs on the
//     stream it is given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "clip_mha_tile.cuh"

namespace {

using namespace clip_mha;

struct flash_mha_fwd_bf16 {};  // names this file's instantiations of attn_mma::forward_kernel

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

struct Strides {  // batch, head and sequence strides in elements; Dh has stride 1
  int64_t b, h, n;
};

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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int heads, int nq, int nk, int causal, Strides qst, Strides kvst,
                         Strides ost, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockQ][DH + 1]
  float* ks = qs + kBlockQ * (DH + 1);  // [kBlockK][DH + 1]
  float* vs = ks + kBlockK * (DH + 1);  // [kBlockK][DH]
  float* ps = vs + kBlockK * DH;        // [kBlockQ][kBlockK + 1]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qg = q + b * qst.b + h * qst.h;
  const T* kg = k + b * kvst.b + h * kvst.h;
  const T* vg = v + b * kvst.b + h * kvst.h;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int num_tiles = (nk + kBlockK - 1) / kBlockK;
  if (causal) num_tiles = min(num_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);  // keys up to the tile's last row

  load_tile<T, DH>(qs, DH + 1, qg, qst.n, q0, kBlockQ, nq);

  constexpr int kOut = DH / 16;  // output columns per thread
  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // q tile written / previous k, v and p tiles consumed
    load_tile<T, DH>(ks, DH + 1, kg, kvst.n, k0, kBlockK, nk);
    load_tile<T, DH>(vs, DH, vg, kvst.n, k0, kBlockK, nk);
    __syncthreads();
    float s[kRows][kCols];
    tile_dot<DH>(qs, ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + ty * kRows + r;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < nk && !(causal && kj > qi);
        s[r][j] = live ? s[r][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[r][j]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(tmax));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[r][j] - m_new);
        psum += p;
        ps[(ty * kRows + r) * (kBlockK + 1) + tx + 16 * j] = round_to<T>(p);
      }
      l[r] = alpha * l[r] + psum;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
    __syncthreads();
    tile_accumulate<DH>(ps, vs, DH, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float row_l = fmaxf(half_warp_sum(l[r]), 1e-30f);
    const int qi = q0 + ty * kRows + r;
    if (qi >= nq) continue;
    T* orow = o + b * ost.b + h * ost.h + qi * ost.n;
#pragma unroll
    for (int c = 0; c < kOut; ++c) orow[tx + 16 * c] = from_float<T>(acc[r][c] / row_l);
    if (tx == 0) lse[(b * heads + h) * nq + qi] = m[r] + logf(row_l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int heads, int nq, int nk, int causal,
           Strides qst, Strides kvst, Strides ost, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(flash_mha_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, heads, b);
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh**-0.5 rounded once to fp32, as on the JAX side
  flash_mha_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), heads, nq, nk, causal, qst, kvst, ost, scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernel on the strided head-split views.
template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse, int b, int heads, int nq, int nk, int causal,
               Strides qst, Strides kvst, Strides ost, cudaStream_t stream) {
  attn_mma::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qs = {qst.b, qst.h, qst.n};
  p.ks = {kvst.b, kvst.h, kvst.n};
  p.os = {ost.b, ost.h, ost.n};
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.causal = causal;
  p.scale = (float)(1.0 / sqrt((double)DH));
  return attn_mma::launch_forward<flash_mha_fwd_bf16, DH, attn_mma::kOnline, attn_mma::kFull>(p, b, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements: q's, k's and v's
// (shared), o's.  Returns a cudaError_t (0 = launched).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b, int heads, int nq,
                             int nk, int dh, int dtype, int causal, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                             int64_t kv_sb, int64_t kv_sh, int64_t kv_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qst{q_sb, q_sh, q_sn}, kvst{kv_sb, kv_sh, kv_sn}, ost{o_sb, o_sh, o_sn};
  if (dtype == 1 && dh == 64) return launch_mma<64>(q, k, v, o, lse, b, heads, nq, nk, causal, qst, kvst, ost, s);
  if (dtype == 1 && dh == 32) return launch_mma<32>(q, k, v, o, lse, b, heads, nq, nk, causal, qst, kvst, ost, s);
  if (dtype == 0 && dh == 64) return launch<float, 64>(q, k, v, o, lse, b, heads, nq, nk, causal, qst, kvst, ost, s);
  if (dtype == 0 && dh == 32) return launch<float, 32>(q, k, v, o, lse, b, heads, nq, nk, causal, qst, kvst, ost, s);
  return (int)cudaErrorInvalidValue;
}
