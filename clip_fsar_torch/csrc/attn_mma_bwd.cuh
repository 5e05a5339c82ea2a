// Tensor-core attention backward for bf16 on sm_90a, built from the pieces of
// attn_mma.cuh (cp.async staging into XOR-swizzled tiles, ldmatrix, mma.sync,
// fragment-to-fragment packing).  clip_mha_bwd.cu instantiates it for the
// backward of clip_mha on the packed projection, flash_mha_bwd.cu for the two
// backward kernels of flash_mha on head-split views (cross-attention and the
// causal mask included); it is what replaces, for bf16, the Pallas TPU kernels
// clip_fsar_tpu/ops/fused_attention.py: _bwd_kernel and
// clip_fsar_tpu/ops/flash_attention.py: _bwd_dq_kernel, _bwd_dkv_kernel.  The
// body reads and writes through batch, head and sequence strides (unit stride
// on Dh) and keeps Nq and Nk apart.  fp32 inputs do not come here: the tensor
// cores have no fp32 product.
//
// The function, per clip b and head h (scale = Dh^-1/2, T = bf16):
//
//   S = q k^T * scale, P = exp(S - LSE)       (fp32; LSE saved by the forward;
//   with CAUSAL, P = 0 where key j > query i, absolute indices, top-left aligned)
//   delta = rowsum(dO o O)                     (fp32 products of T values)
//   dP = dO v^T                                (fp32)
//   dS = round_T(P o (dP - delta))             (rounded once, used for dq and dk)
//   dq = round_T((dS k) * scale), dk = round_T((dS^T q) * scale)
//   dv = round_T(round_T(P)^T dO)              (every product accumulated in fp32)
//
// What bounds it on an H100: seven N x N x Dh products per head (S and dP in
// both passes, dq, dk, dv) on 8 N Dh values of input and output: at N = 197,
// Dh = 64 about 35 MFLOP from 0.2 MB, 170 FLOP per byte -- like the forward,
// far from HBM, and bound by instruction issue and shared-memory reads of the
// B fragments at a few warps a sub-core.
//
// Design -- no order between blocks, no atomics, the same bits on every run
// (FlashAttention-2's split into a pass over query rows and a pass over key
// rows, P recomputed in both):
//   * two passes of ONE body (template flag DKV).  A warp owns 16 rows of its
//     side and holds their two operands as A fragments straight from global
//     memory; the other side's two operands sit in shared memory:
//
//       pass   owns      A1, A2    streamed B1, B2   accumulates
//       dQ     queries   q, dO     k, v              dq += dS . k
//       dK/dV  keys      k, v      q, dO             dk += dS^T . q, dv += P^T . dO
//
//     In both, X = A1 . B1^T (S or S^T) and Y = A2 . B2^T (dP or dP^T) contract
//     over Dh, so B1 and B2 go through plain ldmatrix (their rows run along n
//     of the product); the accumulating products contract over the streamed
//     rows, so the same tiles go through ldmatrix.trans (rows along k);
//   * LSE is known, so there is no row max and no need for a whole row of
//     scores: the streamed side goes in tiles of 16 * KT rows, and X and Y of
//     one tile are 16 * KT fp32 registers a thread;
//   * P = ex2(X * scale * log2(e) - LSE * log2(e)), one FMA and one ex2.approx;
//     dS = P * (Y - delta).  The two accumulator fragments of 16 streamed rows,
//     packed to bf16 pairs, are the A fragment of the accumulating product: the
//     packing is the rounding of dS (and, for dv, of P), and neither P nor dS
//     touches shared memory;
//   * the dQ pass also forms delta for its rows from the dO fragments it holds
//     and O's, and writes it to fp32 scratch [B, H, Nq]; the dK/dV pass, launched
//     after it on the same stream, stages -LSE * log2(e) and delta of the
//     streamed queries in shared memory beside q and dO, because there they
//     belong to the fragment's columns (2t, 2t + 1 of each 8-query tile);
//   * rows of the streamed side past its length are zero-filled in whole tiles
//     and every sub-tile is computed; in the one tile that can cross the length
//     P is set to 0 for the dead columns explicitly (LSE and delta are not
//     defined there: exp(0 - LSE) * 0 must not become NaN).  Dead rows of the
//     warp's own last block are computed and not stored;
//   * CAUSAL is a template flag, so the kernels without it carry no test.  With
//     it, whole tiles on the dead side of the diagonal are left out by the
//     bounds of the tile loop (the dQ pass stops after the tile of its block's
//     last query, the dK/dV pass starts at the tile of its block's first key;
//     a staged block still takes part in every stage's load), and in the tiles
//     that cross the diagonal P is set to 0 per element: P, not S, for the
//     reason of the dead columns.  One CTA still owns a whole (clip, head), so
//     its late query blocks (early key blocks) carry most of the work;
//   * one CTA per (clip, head) while the streamed operands of the head fit in
//     shared memory (kBwdResidentMax rows), its warps walking the 16-row blocks
//     with no block-wide synchronisation after the load; longer sequences are
//     streamed in stages of kBwdResidentMax rows, every warp owning one block;
//   * up to kSingleBlockMax rows 4 or 5 warps a CTA and three CTAs an SM, above
//     that 8 warps and one CTA an SM (the shared memory of N = 577 allows no more).

#pragma once

#include "attn_mma.cuh"

namespace attn_mma {

constexpr int kBwdResidentMax = 832;  // streamed rows one CTA keeps in shared memory; a multiple of every tile (16, 32, 64)

struct BwdParams {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  __nv_bfloat16 *dq, *dk, *dv;
  const float* lse;  // [B, H, Nq]
  float* delta;      // [B, H, Nq]: written by the dQ pass, read by the dK/dV pass
  Strides qs, ks, os, dqs, dks;  // of q; k and v; o and dO; dq; dk and dv
  int heads, nq, nk;
  int causal;          // read by the launchers only: the kernels take it as a template flag
  int stage_rows;      // streamed rows in shared memory at a time, a multiple of the tile
  int blocks_per_cta;  // 16-row blocks of its own side a CTA walks
  float scale;
};

// X = A . B^T for the warp's 16 rows against the KT * 16 streamed rows that lie `offset` bytes into the tile
// whose plain lane addresses are `at`: x[2kk], x[2kk + 1] are the accumulator fragments of streamed rows
// 16kk .. 16kk + 7 and 16kk + 8 .. 16kk + 15.  The slice of Dh is the outer loop, so consecutive mma write
// different accumulators.
template <int DH, int KT>
__device__ __forceinline__ void tile_product(float (&x)[2 * KT][4], const uint32_t (&a)[DH / 16][4], const uint32_t (&at)[DH / 16],
                                             uint32_t offset) {
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, at[kt] + offset + kk * kSubtileBytes<DH>);
      if (kt == 0) {
        mma_bf16_first(x[2 * kk], a[kt], b[0], b[1]);
        mma_bf16_first(x[2 * kk + 1], a[kt], b[2], b[3]);
      } else {
        mma_bf16(x[2 * kk], a[kt], b[0], b[1]);
        mma_bf16(x[2 * kk + 1], a[kt], b[2], b[3]);
      }
    }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// acc (fp32 fragments of the warp's 16 rows over all of Dh) scaled, rounded and stored; rows at or past n are not.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t stride, const float (&acc)[DH / 8][4], float scale, int r0, int n,
                                           int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  __nv_bfloat16* lo = out + ra * stride + 2 * (lane & 3);  // row g, column 2t
  __nv_bfloat16* hi = lo + 8 * stride;                     // row g + 8
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    if (ra < n) *reinterpret_cast<uint32_t*>(lo + 8 * i) = pack_bf16(acc[i][0] * scale, acc[i][1] * scale);
    if (rb < n) *reinterpret_cast<uint32_t*>(hi + 8 * i) = pack_bf16(acc[i][2] * scale, acc[i][3] * scale);
  }
}

// ---- the kernel body: the dQ pass (DKV = false) or the dK/dV pass (DKV = true) ----

template <int DH, int KT, bool DKV, bool CAUSAL>
__device__ __forceinline__ void backward(const BwdParams& p) {
  extern __shared__ __align__(128) unsigned char attn_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const __nv_bfloat16* qg = p.q + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* kg = p.k + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* vg = p.v + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* og = p.o + b * p.os.b + h * p.os.h;
  const __nv_bfloat16* dog = p.dout + b * p.os.b + h * p.os.h;
  const float* lse = p.lse + (b * p.heads + h) * (int64_t)p.nq;
  float* delta = p.delta + (b * p.heads + h) * (int64_t)p.nq;

  // the warp's own side (A operands, from global memory) and the streamed side (B operands, in shared memory)
  const __nv_bfloat16* own1 = DKV ? kg : qg;
  const __nv_bfloat16* own2 = DKV ? vg : dog;
  const int64_t own1_stride = DKV ? p.ks.n : p.qs.n, own2_stride = DKV ? p.ks.n : p.os.n;
  const __nv_bfloat16* str1 = DKV ? qg : kg;
  const __nv_bfloat16* str2 = DKV ? dog : vg;
  const int64_t str1_stride = DKV ? p.qs.n : p.ks.n, str2_stride = DKV ? p.os.n : p.ks.n;
  const int n_own = DKV ? p.nk : p.nq, n_str = DKV ? p.nq : p.nk;

  const uint32_t tile_bytes = (uint32_t)p.stage_rows * DH * 2;
  const uint32_t t1 = (uint32_t)__cvta_generic_to_shared(attn_smem);  // B1: [stage_rows][DH] bf16, swizzled
  const uint32_t t2 = t1 + tile_bytes;                                // B2: the same
  float* nls = reinterpret_cast<float*>(attn_smem + 2 * tile_bytes);  // dK/dV pass: -LSE * log2(e) of the streamed queries
  float* dls = nls + p.stage_rows;                                    // and their delta
  const LaneAddresses<DH> at1(t1, t2, lane);  // .k: plain on B1 (X); .v: trans on B2 (dv)
  const LaneAddresses<DH> at2(t2, t1, lane);  // .k: plain on B2 (Y); .v: trans on B1 (dq, dk)
  const int n_stages = (n_str + p.stage_rows - 1) / p.stage_rows;
  const bool resident = n_stages <= 1;

  // Bring streamed rows [s * stage_rows, ...) in, whole tiles, zero-filled past n_str; every thread of the block calls it together.
  auto load_stage = [&](int s) {
    const int row0 = s * p.stage_rows;
    const int rows = min(p.stage_rows, (n_str - row0 + 16 * KT - 1) / (16 * KT) * (16 * KT));
    __syncthreads();  // the stage before this one is consumed
    load_rows<DH>(t1, str1, str1_stride, row0, rows, n_str);
    load_rows<DH>(t2, str2, str2_stride, row0, rows, n_str);
    if (DKV) {
      for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        const bool live = row0 + i < n_str;
        nls[i] = live ? -lse[row0 + i] * kLog2e : 0.f;
        dls[i] = live ? delta[row0 + i] : 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  };
  if (resident) load_stage(0);

  const float c = p.scale * kLog2e;
  const int total_blocks = (n_own + 15) / 16;
  const int first = blockIdx.x * p.blocks_per_cta;
  // streaming: every warp makes exactly one trip, in step with the block's loads
  const int last = resident ? min(first + p.blocks_per_cta, total_blocks) : first + warps;
  for (int rb = first + warp; rb < last; rb += warps) {
    const int r0 = rb * 16;
    uint32_t a1[DH / 16][4], a2[DH / 16][4];
    load_q_fragments<DH>(a1, own1, own1_stride, r0, n_own, lane);
    load_q_fragments<DH>(a2, own2, own2_stride, r0, n_own, lane);

    float nl0 = 0.f, nl1 = 0.f, dl0 = 0.f, dl1 = 0.f;  // dQ pass: -LSE * log2(e) and delta of rows g and g + 8
    if (!DKV) {
      uint32_t oa[DH / 16][4];
      load_q_fragments<DH>(oa, og, p.os.n, r0, n_own, lane);
#pragma unroll
      for (int kt = 0; kt < DH / 16; ++kt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = unpack_bf16(a2[kt][i]), y = unpack_bf16(oa[kt][i]);
          const float s = fmaf(x.x, y.x, x.y * y.y);
          if (i & 1) dl1 += s; else dl0 += s;
        }
      dl0 = quad_sum(dl0);
      dl1 = quad_sum(dl1);
      const int ra = r0 + g, rb8 = ra + 8;
      if (ra < n_own) {
        nl0 = -lse[ra] * kLog2e;
        if (t == 0) delta[ra] = dl0;
      }
      if (rb8 < n_own) {
        nl1 = -lse[rb8] * kLog2e;
        if (t == 0) delta[rb8] = dl1;
      }
    }

    float acc1[DH / 8][4], acc2[DH / 8][4];  // dq or dk; dv (dK/dV pass only)
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][e] = acc2[i][e] = 0.f;

    for (int s = 0; s < n_stages; ++s) {
      if (!resident) load_stage(s);
      int lo = s * p.stage_rows, hi = min(lo + p.stage_rows, n_str);
      const int stage_lo = lo;  // the stage's first row: what the shared tiles' row 0 holds
      if (CAUSAL) {  // whole tiles on the dead side of the diagonal
        if (DKV) lo = max(lo, r0 / (16 * KT) * (16 * KT));  // queries before the block's first key see none of its keys
        else hi = min(hi, r0 + 16);                         // keys after the block's last query are seen by none of its rows
      }
      for (int c0 = lo; c0 < hi; c0 += 16 * KT) {
        const uint32_t offset = (uint32_t)(c0 - stage_lo) * DH * 2;
        float x[2 * KT][4], y[2 * KT][4];
        tile_product<DH, KT>(x, a1, at1.k, offset);  // S or S^T, before the scale
        tile_product<DH, KT>(y, a2, at2.k, offset);  // dP or dP^T
        const bool edge = c0 + 16 * KT > n_str;      // the one tile with dead streamed rows
        const bool diag = CAUSAL && (DKV ? c0 < r0 + 15 : c0 + 16 * KT - 1 > r0);  // a tile that crosses the diagonal
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t dsa[4], pa[4];  // A fragments of dS (or dS^T) and of P^T over these 16 streamed rows
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = c0 + 16 * kk + 8 * j + 2 * t;  // streamed row of elements 0 and 2; 1 and 3 are the next
            float2 nl = make_float2(0.f, 0.f), dl = nl;
            if (DKV) {
              nl = *reinterpret_cast<const float2*>(nls + (col - stage_lo));
              dl = *reinterpret_cast<const float2*>(dls + (col - stage_lo));
            }
            float pv[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float neg = DKV ? ((e & 1) ? nl.y : nl.x) : ((e >> 1) ? nl1 : nl0);
              const float del = DKV ? ((e & 1) ? dl.y : dl.x) : ((e >> 1) ? dl1 : dl0);
              float pe = ex2(fmaf(x[2 * kk + j][e], c, neg));
              if (edge && col + (e & 1) >= n_str) pe = 0.f;
              if (CAUSAL) {  // own row r0 + g (+ 8) against streamed row col (+ 1): key j is dead for query i when j > i
                const int own = r0 + g + 8 * (e >> 1), str = col + (e & 1);
                if (diag && (DKV ? str < own : str > own)) pe = 0.f;
              }
              pv[e] = pe;
              ds[e] = pe * (y[2 * kk + j][e] - del);
            }
            dsa[2 * j] = pack_bf16(ds[0], ds[1]);
            dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
            if (DKV) {
              pa[2 * j] = pack_bf16(pv[0], pv[1]);
              pa[2 * j + 1] = pack_bf16(pv[2], pv[3]);
            }
          }
#pragma unroll
          for (int i = 0; i < DH / 16; ++i) {  // acc[2i], acc[2i + 1]: output columns 16i .. 16i + 15
            uint32_t bt[4];
            ldmatrix_x4_trans(bt, at2.v[i] + offset + kk * kSubtileBytes<DH>);  // B1 with its rows along k
            mma_bf16(acc1[2 * i], dsa, bt[0], bt[1]);
            mma_bf16(acc1[2 * i + 1], dsa, bt[2], bt[3]);
            if (DKV) {
              ldmatrix_x4_trans(bt, at1.v[i] + offset + kk * kSubtileBytes<DH>);  // B2 = dO
              mma_bf16(acc2[2 * i], pa, bt[0], bt[1]);
              mma_bf16(acc2[2 * i + 1], pa, bt[2], bt[3]);
            }
          }
        }
      }
    }

    if (DKV) {
      store_rows<DH>(p.dk + b * p.dks.b + h * p.dks.h, p.dks.n, acc1, p.scale, r0, n_own, lane);
      store_rows<DH>(p.dv + b * p.dks.b + h * p.dks.h, p.dks.n, acc2, 1.f, r0, n_own, lane);
    } else {
      store_rows<DH>(p.dq + b * p.dqs.b + h * p.dqs.h, p.dqs.n, acc1, p.scale, r0, n_own, lane);
    }
  }
}

// Self-attention backward on the packed projection: qkv and dqkv [B, N, 3*H*Dh] (q | k | v on the last axis),
// o and dout [B, N, H*Dh], lse and the delta scratch [B, H, N]; the heads are found by stride.
template <int DH>
BwdParams packed_bwd_params(const void* qkv, const void* o, const void* dout, const void* lse, void* delta, void* dqkv, int n,
                            int heads) {
  const int64_t d = (int64_t)heads * DH;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* dbase = static_cast<__nv_bfloat16*>(dqkv);
  BwdParams p{};
  p.q = base;
  p.k = base + d;
  p.v = base + 2 * d;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = dbase;
  p.dk = dbase + d;
  p.dv = dbase + 2 * d;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.qs = p.ks = p.dqs = p.dks = Strides{n * 3 * d, DH, 3 * d};
  p.os = Strides{n * d, DH, d};
  p.heads = heads;
  p.nq = p.nk = n;
  p.scale = (float)(1.0 / sqrt((double)DH));  // Dh**-0.5 rounded once to fp32, as in the forward
  return p;
}

// Attention backward on head-split views: q, o, dout, dq [B, H, Nq, Dh] and k, v, dk, dv [B, H, Nk, Dh], each
// found by its own batch, head and sequence strides (k's are v's, o's are dout's, dk's are dv's), lse and delta
// [B, H, Nq].  The dQ pass reads no dk or dv and the dK/dV pass no o or dq: a pass is given null for those.
template <int DH>
BwdParams split_bwd_params(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                           void* delta, void* dq, void* dk, void* dv, int heads, int nq, int nk, int causal, Strides qs,
                           Strides ks, Strides os, Strides dqs, Strides dks) {
  BwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.qs = qs;
  p.ks = ks;
  p.os = os;
  p.dqs = dqs;
  p.dks = dks;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.causal = causal;
  p.scale = (float)(1.0 / sqrt((double)DH));
  return p;
}

// TAG only names the instantiations of one source file (and of one pass, where a file wants its passes told
// apart), so a profile tells the kernels apart.
template <typename TAG, int DH, int KT, bool DKV, bool CAUSAL, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) backward_kernel(const BwdParams p) {
  backward<DH, KT, DKV, CAUSAL>(p);
}

template <typename TAG, int DH, int KT, bool DKV, bool CAUSAL, int THREADS, int MIN_BLOCKS>
int launch_pass(BwdParams p, int batch, cudaStream_t stream) {
  auto kernel = backward_kernel<TAG, DH, KT, DKV, CAUSAL, THREADS, MIN_BLOCKS>;
  constexpr int kTile = 16 * KT;  // streamed rows are staged in whole tiles, zero-filled past their length
  static_assert(kBwdResidentMax % kTile == 0, "a stage holds whole tiles");
  const int n_own = DKV ? p.nk : p.nq, n_str = DKV ? p.nq : p.nk;
  const bool resident = n_str <= kBwdResidentMax;
  const int warps = THREADS / 32, blocks = (n_own + 15) / 16;
  p.stage_rows = resident ? (n_str + kTile - 1) / kTile * kTile : kBwdResidentMax;
  p.blocks_per_cta = resident ? blocks : warps;
  const size_t smem = (size_t)2 * p.stage_rows * DH * 2 + (DKV ? (size_t)2 * p.stage_rows * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(resident ? 1 : (blocks + warps - 1) / warps, p.heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// One pass in the launch shape that follows from the lengths alone.  Up to kSingleBlockMax rows: tiles of 16
// streamed rows (X and Y are 16 registers, and 208 staged rows hold N = 197), three CTAs an SM; the dQ pass with
// 5 warps (13 row blocks make 3 rounds with 2 idle slots), the dK/dV pass, which holds two accumulators and
// wants 168 registers, with 4.  Above: tiles of 32, 8 warps, one CTA an SM.  Picked by timing the passes at
// [480, 197, 2304] and [64, 577, 3072] over tiles of 16, 32 and 64 rows and 2 to 16 warps a CTA.
template <typename TAG, int DH, bool DKV, bool CAUSAL>
int launch_shaped(const BwdParams& p, int batch, cudaStream_t stream) {
  if ((p.nq > p.nk ? p.nq : p.nk) <= kSingleBlockMax) return launch_pass<TAG, DH, 1, DKV, CAUSAL, DKV ? 128 : 160, 3>(p, batch, stream);
  return launch_pass<TAG, DH, 2, DKV, CAUSAL, 256, 1>(p, batch, stream);
}

// The dQ pass (which also writes delta), then the dK/dV pass, on one stream, without the causal mask.
template <typename TAG, int DH>
int launch_backward(const BwdParams& p, int batch, cudaStream_t stream) {
  const int err = launch_shaped<TAG, DH, false, false>(p, batch, stream);
  return err ? err : launch_shaped<TAG, DH, true, false>(p, batch, stream);
}

}  // namespace attn_mma
