// Tensor-core attention forward for bf16 on sm_90a: the warp-level pieces and
// the kernel body shared by the clip_mha forward (clip_mha_fwd.cu), the
// flash_mha forward (flash_mha_fwd.cu) and the clip_mha stage-ablation kernels
// (clip_mha_decomp.cu).  fp32 inputs do not come here: the tensor cores have no
// fp32 product, and the fp32 kernels of those files stay exact.  For bf16 it
// is what replaces the Pallas TPU kernels clip_fsar_tpu/ops/fused_attention.py:
// _fwd_kernel, clip_fsar_tpu/ops/flash_attention.py: _fwd_kernel and
// tools/_fa_decomp.py: make_kernel(mode).
//
// The function, per clip b and head h (scale = Dh^-1/2):
//
//   s = q_h k_h^T * scale (fp32); keys j >= Nk, and with `causal` keys j > i,
//   are masked (absolute indices: top-left aligned)
//   p = exp(s - m), l = rowsum(p) in fp32, O_h = (round_bf16(p) . v_h) / l,
//   LSE_h = m + log(l)
//
// with m the exact row max (clip_mha) or the running max of the online
// recurrence over key tiles of 128 (flash_mha, where p is rounded against the
// running max and O and l are rescaled by exp(m_old - m_new), and l is clamped
// to 1e-30).  q, k, v and o are read and written through their batch, head and
// sequence strides (unit stride on Dh), so the packed projection and its
// head-split views need no copy.
//
// What bounds it on an H100: one head at N = 197, Dh = 64 is 10 MFLOP from
// 75 KB, 130 FLOP per byte, so neither HBM nor the tensor cores' peak.  A warp
// of 16 query rows executes, per query block of 208 keys, 208 mma.sync, 104
// ldmatrix.x4 (it reads all of K and V from shared memory once: 53 KB, about
// what the 128 B per clock of an SM's shared memory feeds four sub-cores'
// mma.sync), 104 exponentials, and some 900 other instructions (max, FMA, sum,
// pack, masks, addresses); with 104 fp32 scores a thread an SM holds 8 warps,
// so the limit is instruction rate and latency at two warps a sub-core.
//
// Design:
//   * one CTA per (clip, head) when K and V of the head fit in shared memory
//     (Nk <= 896 at Dh = 64): they are brought in once, as bf16, with 16-byte
//     cp.async into XOR-swizzled rows (ldmatrix then reads 8 rows of one
//     16-byte column without bank conflicts), in whole key tiles, rows past Nk
//     zero-filled; the warps then walk the 16-row query blocks independently,
//     with no further block-wide synchronisation.  Longer Nk streams K and V
//     through the same buffer in stages of 896 keys, every warp owning one
//     query block;
//   * both products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Q's A
//     fragments come straight from global memory (32-bit loads, whole 32-byte
//     sectors; on the single-block branch the next query block's are loaded
//     behind the softmax); K is the B operand of q.k^T through ldmatrix, V the
//     B operand of P.V through ldmatrix.trans;
//   * P never touches shared memory: the fp32 accumulator fragment of q.k^T,
//     packed to bf16 pairs, is the A fragment of P.V (the layouts match), and
//     that packing is the rounding of p.  l is summed from the fp32 p before
//     the packing; row max and row sum cross the four lanes of a quad by
//     shuffle;
//   * Nk <= 256 (kSingle): a warp keeps its whole [16, Nk] block of scores in
//     registers (104 fp32 at Nk = 197), so q.k^T is formed once and p is still
//     rounded against the exact max; this is also flash_mha's single key block
//     at these lengths.  Two warps a CTA (13 query blocks make 7 rounds with
//     one idle slot) and four CTAs an SM by shared memory (52 KB each), which
//     leaves each thread 255 registers and nothing spills.  Above, key tiles of
//     128 and eight warps: clip_mha makes two passes (kTwoPass: the first only
//     for the max, both on the tensor cores, K and V already in shared memory),
//     flash_mha the online recurrence (kOnline);
//   * no test inside the products: every 16-key sub-tile of a tile is computed
//     (zero-filled rows past Nk cost one sub-tile at N = 197), then the
//     sub-tiles that can cross Nk or the diagonal are masked elementwise, and
//     whole key tiles past the diagonal are skipped; the last query block's
//     dead rows (11 of 208 at N = 197) are computed and not stored;
//   * exp(s - m) is ex2.approx(s * scale * log2(e) - m * log2(e)) with one FMA;
//   * the STAGE template parameter leaves stages of the loop out for the
//     stage-ablation tool (no exponential, no max, no sum).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_mma {

constexpr int kSingleBlockMax = 256;  // most keys a warp keeps as one block of scores in registers
constexpr int kTileKeys = 128;        // key tile of the tiled branches (the TPU kernels' block)
constexpr int kMaxSmemBytes = 232448; // dynamic shared memory one block may take on sm_90
constexpr float kMasked = -1e30f;     // the TPU kernels' mask value: the row max never falls below it
constexpr float kLog2e = 1.4426950408889634f;

enum Mode : int { kSingle = 0, kOnline = 1, kTwoPass = 2 };
enum Stage : int { kFull = 0, kMatmul = 1, kExp = 2, kNoMax = 3 };  // kFull is the shipped function

struct Strides {  // batch, head and sequence strides in elements; Dh has stride 1
  int64_t b, h, n;
};

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;          // [B, H, Nq]; written by kFull only
  Strides qs, ks, os;  // k's strides are v's too
  int heads, nq, nk, causal;
  int stage_rows;        // rows of K (and of V) in shared memory at a time, a multiple of 16
  int q_blocks_per_cta;  // 16-row query blocks a CTA walks
  float scale;
};

// ---- PTX ----

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool live) {
  const int bytes = live ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a . b for a [16 x 16] (row-major fragment), b [16 x 8] (column-major fragment), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a . b: the first product of a chain needs no zeroed accumulator.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// (lo, hi) rounded to nearest-even bf16, lo in the low half: the order of a fragment's element pairs.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes that share a fragment row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- tiles in shared memory ----

// Byte offset of 16-byte chunk `chunk` of row `row` in a [rows][DH] bf16 tile.  The chunk index is XORed
// with the row's position in its group of 8 (Dh = 64: 8 chunks a row) or with half of it (Dh = 32: 4 chunks,
// two rows to a 128-byte line), so 8 consecutive rows of one chunk column lie in 8 different 16-byte bank
// groups.  The XOR depends on row % 16 only: a lane's offset within one 16-row sub-tile is its offset in all.
template <int DH>
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  constexpr int kChunks = DH / 8;
  const int swizzle = kChunks == 8 ? (row & 7) : ((row >> 1) & 3);
  return (uint32_t)(row * (DH * 2) + ((chunk ^ swizzle) << 4));
}
template <int DH>
constexpr int kSubtileBytes = 16 * DH * 2;  // 16 keys of one head

// cp.async rows [row0, row0 + rows) of one head's Dh-slice into a tile, zero-filling rows at or past n.
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t tile, const __nv_bfloat16* __restrict__ src, int64_t src_stride, int row0,
                                          int rows, int n) {
  constexpr int kChunks = DH / 8;  // a thread keeps its 16-byte column and steps down the rows
  const int c = threadIdx.x % kChunks, step = blockDim.x / kChunks;
  for (int r = threadIdx.x / kChunks; r < rows; r += step) {
    const bool live = row0 + r < n;
    cp_async_16(tile + tile_offset<DH>(r, c), live ? src + (row0 + r) * src_stride + c * 8 : src, live);
  }
}

// The A fragments of the 16 query rows from q0 over all of Dh, from global memory; rows at or past nq are 0.
// Lane (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each
// 16-wide slice.
template <int DH>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qa)[DH / 16][4], const __nv_bfloat16* __restrict__ q, int64_t stride,
                                                 int q0, int nq, int lane) {
  const int row = q0 + (lane >> 2);
  const __nv_bfloat16* lo = q + row * stride + 2 * (lane & 3);  // row g, column 2t
  const __nv_bfloat16* hi = lo + 8 * stride;                     // row g + 8
  const bool live_lo = row < nq, live_hi = row + 8 < nq;
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* at = ((i & 1) ? hi : lo) + kt * 16 + (i >> 1) * 8;
      qa[kt][i] = ((i & 1) ? live_hi : live_lo) ? __ldg(reinterpret_cast<const uint32_t*>(at)) : 0u;
    }
}

// A lane's ldmatrix addresses within the first 16-key sub-tile of the K and of the V tile, one per 16-wide
// slice of Dh; sub-tile kk lies kk * kSubtileBytes further on.
//   K (B operand of q.k^T, keys along n): the four 8x8 matrices of one ldmatrix.x4 are (keys 0-7, lower 8 of
//   the slice), (keys 0-7, upper 8), (keys 8-15, lower), (keys 8-15, upper): the B fragments of two 8-key tiles.
//   V (B operand of P.V, keys along k, hence ldmatrix.trans): (keys 0-7, columns 16c..16c+7), (keys 8-15,
//   the same columns), (keys 0-7, columns 16c+8..), (keys 8-15, those): the B fragments of two 8-column tiles.
template <int DH>
struct LaneAddresses {
  uint32_t k[DH / 16], v[DH / 16];
  __device__ __forceinline__ LaneAddresses(uint32_t ks, uint32_t vs, int lane) {
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt) {
      k[kt] = ks + tile_offset<DH>((lane & 7) + ((lane >> 4) << 3), 2 * kt + ((lane >> 3) & 1));
      v[kt] = vs + tile_offset<DH>(lane & 15, 2 * kt + (lane >> 4));
    }
  }
};

// The raw scores (before the scale) of the warp's 16 rows against the KT * 16 keys from `key0`, which lie
// `offset` bytes into the K tile: sc[2kk], sc[2kk + 1] are the accumulator fragments of keys 16kk .. 16kk + 7
// and 16kk + 8 .. 16kk + 15 (lane (g, t) holds rows g and g + 8, keys 2t and 2t + 1).  The slice of Dh is the
// outer loop, so consecutive mma write different accumulators and need not wait for each other.  Masked keys
// hold -inf (0 for kMatmul, which has no exponential to send it to 0); lim0 / lim1: the keys rows g / g + 8
// see; k_all: the keys every row sees (sub-tiles below it need no masking).  The first FREE sub-tiles lie
// below Nk whatever it is (the launcher picked KT for it), so only the causal mask can reach them.
template <int DH, int KT, int STAGE, int FREE>
__device__ __forceinline__ void tile_scores(float (&sc)[2 * KT][4], const uint32_t (&qa)[DH / 16][4], const LaneAddresses<DH>& at,
                                            uint32_t offset, int key0, int k_all, int lim0, int lim1, bool causal, int lane) {
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, at.k[kt] + offset + kk * kSubtileBytes<DH>);
      if (kt == 0) {
        mma_bf16_first(sc[2 * kk], qa[kt], b[0], b[1]);
        mma_bf16_first(sc[2 * kk + 1], qa[kt], b[2], b[3]);
      } else {
        mma_bf16(sc[2 * kk], qa[kt], b[0], b[1]);
        mma_bf16(sc[2 * kk + 1], qa[kt], b[2], b[3]);
      }
    }
  if (key0 + 16 * KT <= k_all) return;  // an inner tile: every row sees every key
  const float masked = STAGE == kMatmul ? 0.f : -INFINITY;
  const int d0 = lim0 - key0 - 2 * (lane & 3), d1 = lim1 - key0 - 2 * (lane & 3);  // key 16kk + 8j + e%2 is masked from here on
  auto mask = [&](int kk) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (16 * kk + 8 * j + (e & 1) >= ((e >> 1) ? d1 : d0)) sc[2 * kk + j][e] = masked;
  };
  if (FREE > 0 && causal) {
#pragma unroll
    for (int kk = 0; kk < FREE; ++kk) mask(kk);
  }
#pragma unroll
  for (int kk = FREE; kk < KT; ++kk) mask(kk);
}

// Row max of a tile's raw scores for rows g and g + 8, over the quad.
template <int KT>
__device__ __forceinline__ void tile_max(const float (&sc)[2 * KT][4], float& mx0, float& mx1) {
  float a0 = sc[0][0], b0 = sc[0][1], a1 = sc[0][2], b1 = sc[0][3];  // two chains a row, so a max need not wait for the last
#pragma unroll
  for (int j = 1; j < 2 * KT; ++j) {
    a0 = fmaxf(a0, sc[j][0]);
    b0 = fmaxf(b0, sc[j][1]);
    a1 = fmaxf(a1, sc[j][2]);
    b1 = fmaxf(b1, sc[j][3]);
  }
  mx0 = quad_max(fmaxf(a0, b0));
  mx1 = quad_max(fmaxf(a1, b1));
}

// ---- the kernel body ----

template <int DH, int KT, int MODE, int STAGE>
__device__ __forceinline__ void forward(const Params& p) {
  extern __shared__ __align__(128) unsigned char attn_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const __nv_bfloat16* qg = p.q + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* kg = p.k + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* vg = p.v + b * p.ks.b + h * p.ks.h;
  __nv_bfloat16* og = p.o + b * p.os.b + h * p.os.h;

  const uint32_t ks = (uint32_t)__cvta_generic_to_shared(attn_smem);  // [stage_rows][DH] bf16, swizzled
  const uint32_t vs = ks + p.stage_rows * DH * 2;                     // the same for V
  const LaneAddresses<DH> at(ks, vs, lane);
  const int n_stages = (p.nk + p.stage_rows - 1) / p.stage_rows;
  const bool resident = n_stages <= 1;  // K and V of the whole head stay in shared memory

  // Bring keys [s * stage_rows, ...) in, whole key tiles, zero-filled past Nk; every thread of the block calls it together.
  auto load_stage = [&](int s) {
    const int row0 = s * p.stage_rows;
    const int rows = min(p.stage_rows, (p.nk - row0 + 16 * KT - 1) / (16 * KT) * (16 * KT));
    __syncthreads();  // the stage before this one is consumed
    load_rows<DH>(ks, kg, p.ks.n, row0, rows, p.nk);
    load_rows<DH>(vs, vg, p.ks.n, row0, rows, p.nk);
    cp_async_wait_all();
    __syncthreads();
  };
  if (n_stages == 1) load_stage(0);

  // kSingle: Nk exceeds the next smaller block (4, 8, 13, 16 sub-tiles), so that many sub-tiles lie below Nk
  constexpr int kFree = MODE != kSingle ? 0 : KT == 16 ? 13 : KT == 13 ? 8 : KT == 8 ? 4 : 0;
  const float c = p.scale * kLog2e;
  const int total_blocks = (p.nq + 15) / 16;
  const int first = blockIdx.x * p.q_blocks_per_cta;
  // streaming K and V: every warp makes exactly one trip, in step with the block's loads
  const int last = resident ? min(first + p.q_blocks_per_cta, total_blocks) : first + warps;
  uint32_t qa[DH / 16][4];
  if (MODE == kSingle) load_q_fragments<DH>(qa, qg, p.qs.n, (first + warp) * 16, p.nq, lane);
  for (int qb = first + warp; qb < last; qb += warps) {
    const int q0 = qb * 16;
    if (MODE != kSingle) load_q_fragments<DH>(qa, qg, p.qs.n, q0, p.nq, lane);
    const int lim0 = p.causal ? min(p.nk, q0 + g + 1) : p.nk;  // keys row g sees
    const int lim1 = p.causal ? min(p.nk, q0 + g + 9) : p.nk;  // keys row g + 8 sees
    const int k_any = p.causal ? min(p.nk, q0 + 16) : p.nk;    // keys some row of the block sees
    const int k_all = p.causal ? min(p.nk, q0 + 1) : p.nk;     // keys every row of the block sees

    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;  // rows g and g + 8: max (scaled), this lane's share of the sum
    float acc[DH / 8][4];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    if (MODE == kTwoPass && STAGE == kFull) {  // first pass: the exact row max over all keys
      for (int s = 0; s < n_stages; ++s) {
        if (!resident) load_stage(s);
        const int lo = s * p.stage_rows, hi = min(lo + p.stage_rows, k_any);
        for (int key0 = lo; key0 < hi; key0 += 16 * KT) {
          float sc[2 * KT][4], mx0, mx1;
          tile_scores<DH, KT, STAGE, kFree>(sc, qa, at, (key0 - lo) * DH * 2, key0, k_all, lim0, lim1, p.causal, lane);
          tile_max<KT>(sc, mx0, mx1);
          m0 = fmaxf(m0, mx0 * p.scale);
          m1 = fmaxf(m1, mx1 * p.scale);
        }
      }
    }

    for (int s = 0; s < n_stages; ++s) {
      if (!resident) load_stage(s);
      const int lo = s * p.stage_rows, hi = min(lo + p.stage_rows, k_any);  // whole tiles past k_any are skipped
      for (int key0 = lo; key0 < hi; key0 += 16 * KT) {
        const uint32_t offset = (key0 - lo) * DH * 2;
        float sc[2 * KT][4];
        tile_scores<DH, KT, STAGE, kFree>(sc, qa, at, offset, key0, k_all, lim0, lim1, p.causal, lane);
        // the one block of scores is formed and q's fragments are free: the warp's next query block loads
        // behind the softmax and P.V
        if (MODE == kSingle) load_q_fragments<DH>(qa, qg, p.qs.n, (qb + warps) * 16, p.nq, lane);
        if (MODE != kTwoPass && STAGE == kFull) {
          float mx0, mx1;
          tile_max<KT>(sc, mx0, mx1);
          const float n0 = fmaxf(m0, mx0 * p.scale), n1 = fmaxf(m1, mx1 * p.scale);
          if (MODE == kOnline) {  // rescale what earlier tiles left; exp(-1e30 - m) = 0 on the first
            const float a0 = ex2((m0 - n0) * kLog2e), a1 = ex2((m1 - n1) * kLog2e);
            l0 *= a0;
            l1 *= a1;
#pragma unroll
            for (int i = 0; i < DH / 8; ++i) {
              acc[i][0] *= a0;
              acc[i][1] *= a0;
              acc[i][2] *= a1;
              acc[i][3] *= a1;
            }
          }
          m0 = n0;
          m1 = n1;
        }
        const float neg0 = STAGE == kFull ? -m0 * kLog2e : 0.f, neg1 = STAGE == kFull ? -m1 * kLog2e : 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t pa[4];  // p's A fragment for these 16 keys: packing the accumulator pairs is the rounding of p
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = STAGE == kMatmul ? sc[2 * kk + j][e] * p.scale : ex2(fmaf(sc[2 * kk + j][e], c, (e >> 1) ? neg1 : neg0));
            if (STAGE == kFull || STAGE == kNoMax) {
              l0 += w[0] + w[1];
              l1 += w[2] + w[3];
            }
            pa[2 * j] = pack_bf16(w[0], w[1]);
            pa[2 * j + 1] = pack_bf16(w[2], w[3]);
          }
#pragma unroll
          for (int i = 0; i < DH / 16; ++i) {  // acc[2i], acc[2i + 1]: output columns 16i .. 16i + 15
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, at.v[i] + offset + kk * kSubtileBytes<DH>);
            mma_bf16(acc[2 * i], pa, bv[0], bv[1]);
            mma_bf16(acc[2 * i + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }

    float inv0 = 1.f, inv1 = 1.f;
    if (STAGE == kFull || STAGE == kNoMax) {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      if (STAGE == kFull) {
        l0 = fmaxf(l0, 1e-30f);
        l1 = fmaxf(l1, 1e-30f);
      }
      inv0 = __fdividef(1.f, l0);  // o is rounded to bf16: the approximate reciprocal's 2 ulp of fp32 do not show
      inv1 = __fdividef(1.f, l1);
    }
    const int r0 = q0 + g, r1 = q0 + g + 8;
    __nv_bfloat16* o0 = og + r0 * p.os.n + 2 * t;  // row g, column 2t
    __nv_bfloat16* o1 = o0 + 8 * p.os.n;           // row g + 8
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      if (r0 < p.nq) *reinterpret_cast<uint32_t*>(o0 + 8 * i) = pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
      if (r1 < p.nq) *reinterpret_cast<uint32_t*>(o1 + 8 * i) = pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
    }
    if (STAGE == kFull && t == 0) {
      float* lse = p.lse + (b * p.heads + h) * (int64_t)p.nq;
      if (r0 < p.nq) lse[r0] = m0 + __logf(l0);  // lg2.approx * ln 2: about 1e-6 absolute on a sum of at most Nk ones
      if (r1 < p.nq) lse[r1] = m1 + __logf(l1);
    }
  }
}

// Self-attention on the packed projection qkv [B, N, 3*H*Dh] (q | k | v on the last axis) into out [B, N, H*Dh]:
// the heads are found by stride.
template <int DH>
Params packed_params(const void* qkv, void* out, void* lse, int n, int heads) {
  const int64_t d = (int64_t)heads * DH;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  Params p{};
  p.q = base;
  p.k = base + d;
  p.v = base + 2 * d;
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.qs = p.ks = Strides{n * 3 * d, DH, 3 * d};
  p.os = Strides{n * d, DH, d};
  p.heads = heads;
  p.nq = p.nk = n;
  p.causal = 0;
  p.scale = (float)(1.0 / sqrt((double)DH));  // Dh**-0.5 rounded once to fp32, as on the JAX side
  return p;
}

// TAG only names the instantiations of one source file, so a profile tells the files' kernels apart.
template <typename TAG, int DH, int KT, int MODE, int STAGE, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) forward_kernel(const Params p) {
  forward<DH, KT, MODE, STAGE>(p);
}

template <typename TAG, int DH, int KT, int MODE, int STAGE>
int launch_one(Params p, int batch, cudaStream_t stream) {
  // kSingle: 2 warps (13 query blocks at N = 197 then make 7 rounds with one idle slot) and four blocks to an
  // SM by shared memory (52 KB at 208 keys), which leaves a thread 255 registers: the score block takes 8 per
  // 16 keys, 104 at 13 sub-tiles, and must not spill; three blocks at 16 sub-tiles (64 KB).  Tiled: 8 warps,
  // one block to an SM by shared memory at the lengths that come here
  constexpr int kThreads = MODE == kSingle ? 64 : 256;
  constexpr int kMinBlocks = MODE != kSingle ? 1 : (KT <= 13 ? 4 : 3);
  auto kernel = forward_kernel<TAG, DH, KT, MODE, STAGE, kThreads, kMinBlocks>;
  constexpr int kTile = 16 * KT;  // keys; K and V are staged in whole tiles, zero-filled past Nk
  const int warps = kThreads / 32;
  const int tiled_keys = p.nk > kTile ? (p.nk + kTile - 1) / kTile * kTile : kTile;
  const int max_rows = kMaxSmemBytes / (2 * DH * 2) / kTile * kTile;  // of K and of V: 896 at Dh = 64
  const bool resident = tiled_keys <= max_rows;
  const int q_blocks = (p.nq + 15) / 16;
  p.stage_rows = resident ? tiled_keys : max_rows;
  p.q_blocks_per_cta = resident ? q_blocks : warps;
  const size_t smem = (size_t)2 * p.stage_rows * DH * 2;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(resident ? 1 : (q_blocks + warps - 1) / warps, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The branch follows from Nk alone: one block of scores up to kSingleBlockMax keys, in the smallest of 4, 8, 13
// or 16 sub-tiles of 16 keys that holds them (13: 208 keys, which covers N = 197), key tiles of kTileKeys
// above, in the TILED mode the caller's function needs (kTwoPass: exact max; kOnline: running max).
template <typename TAG, int DH, int TILED, int STAGE>
int launch_forward(const Params& p, int batch, cudaStream_t stream) {
  if (p.nk <= 4 * 16) return launch_one<TAG, DH, 4, kSingle, STAGE>(p, batch, stream);
  if (p.nk <= 8 * 16) return launch_one<TAG, DH, 8, kSingle, STAGE>(p, batch, stream);
  if (p.nk <= 13 * 16) return launch_one<TAG, DH, 13, kSingle, STAGE>(p, batch, stream);
  if (p.nk <= kSingleBlockMax) return launch_one<TAG, DH, kSingleBlockMax / 16, kSingle, STAGE>(p, batch, stream);
  return launch_one<TAG, DH, kTileKeys / 16, TILED, STAGE>(p, batch, stream);
}

}  // namespace attn_mma
