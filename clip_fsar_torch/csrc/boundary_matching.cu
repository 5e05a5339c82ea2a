// BMN's boundary-matching layer as two gathers over the sample mask's nonzeros, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package computes the layer
// (clip_fsar_tpu/models/heads/bmn.py:94-103) as XLA ops: the features mid
// [B, C, T] times the dense sample mask [T, N*D*T], viewed as [B, C, N, D, T],
// then an (N, 1, 1) Conv3d of stride (N, 1, 1) and a ReLU.  Both steps are
// linear, so the port groups them the other way round (ops/boundary_matching.py):
//
//   P[b, o, n, t']  = sum_c W[o, c, n] * mid[b, c, t']                  (torch.matmul)
//   out[b, o, cell] = relu(bias[o] + sum_n sum_{t'} mask[t', n, cell] * P[b, o, n, t'])
//                                                                       (bm_gather_fwd)
//   dP[b, o, n, t'] = sum_cell mask[t', n, cell] * (out > 0 ? dout : 0)[b, o, cell]
//                                                                       (bm_gather_bwd)
//
// with cell = d * T + t (duration d, start t).  The mask is 99 % zeros: at
// most a handful of entries in each (n, cell) column, a few hundred in each
// (n, t') row.  So the dense path's 10.5 GB [B, C, N, D, T] activation and its
// gradient are never formed, and no convolution backward (whose cuDNN
// algorithms may add with atomics) runs.  Both kernels write each output
// element once, from one thread, adding in a fixed order: the forward over n
// ascending and each column's t' ascending, the backward over each row's
// cells ascending.  Products and sums are rounded separately (no fused
// multiply-add), as the plain versions in ops/boundary_matching.py compute
// them in the same order, so kernel and plain version give the same fp32 bits.
//
// The lists (built once per mask on the host, ops/boundary_matching.py):
//   order [cells]        the active cells (any entry in any n) ascending, then the others
//   col_t, col_w [N, K, A], col_n [N, A]
//                        column (n, order[i]) for i < A: its entries (t', w), t' ascending,
//                        padded to K, the largest count of any column; col_n the count
//   (the row form, row (n, t')'s entries (cell, w) in CSR, stays on the host: the
//   plain version walks it, and the tile lists below are built from the same nonzeros)
//
// What bounds it on an H100.  Forward: P read and out written once (0.76 GB at
// the preset B 8, C3 512, N 32, D = T 200) and 2 operations for each nonzero
// and (b, o) (20 GFLOP of fp32 at 67 TFLOP/s): about 0.3 ms either way.
// Design: the lists are the same for every (b, o), so a forward block takes
// one b and OB output channels, holds those channels' P in shared memory (OB *
// N * T floats: 25.6 KB a channel at the preset) and walks a run of cells, one
// thread a cell, reading each column entry once from device memory for all OB
// channels.
//
// Backward: out and dout read, dP written (1.4 GB, 0.43 ms).  It first writes
// dyt [cells, B*C3] = (out > 0 ? dout : 0) transposed (a scratch buffer the
// wrapper allocates; through 64 x 64 tiles, 16 bytes a read and a write),
// so that one cell's channels lie side by side.  The first gather (a thread a channel of 8 rows, each row's
// entries read through L1/L2; 7.5 ms) was held by L2's rate: every nonzero
// cost a 128-byte line a warp, 40 GB in all, as a cell's line was read again
// by each of the ~122 rows that touch it.  The gather now takes rows in tiles
// of 4 samples n by 16 positions t', whose rows share cells (the union of a
// tile's cells is ~8.6 times smaller than its entries at the preset), and
// walks each tile's rows in pairs (t' even, t' + 1), which share a third of
// their cells, from tile lists built once on the host:
//   tile_cell_ptr [tiles + 1], tile_cells   each tile's union of cells, ascending
//   tile_chunk_ptr [tiles + 1]              each tile's first chunk of 32 union
//                                           cells among all tiles' chunks
//   ent [merged] int4                       for each chunk, row pair and cell of
//                                           the chunk that either row holds, in
//                                           ascending order: (the cell's index in
//                                           the chunk | 256 if row t' holds it |
//                                           512 if row t' + 1 does, the two rows'
//                                           weights' bits, 0)
//   chunk_cut [chunks * 32 + 1]             the first merged entry of (chunk, pair)
// A block owns one tile and 128 channels of dyt.  It streams the union's cells
// through a ring of three chunks in shared memory, each cell's 512 bytes and
// the chunk's merged entries and cuts copied by cp.async two chunks ahead of
// the sum (the cells and entry range a copy needs loaded into registers a
// chunk before that), and each of its 16 warps owns 2 row pairs, each lane 4
// channels: so every (row, channel) sum has one owner, which adds its row's
// entries in ascending cell order from shared memory, reading a cell the pair
// shares once for both rows.  The grid runs each channel block's tiles
// together, so its slice of dyt stays in L2.  dP goes out through shared
// memory, a row's 16 positions t' side by side.  What holds the gather now is
// issue and shared memory together: a warp spends ~22 instructions and reads
// 528 bytes of shared memory on each merged entry (1.1 G instructions and 27
// GB at the preset, each ~1.0-1.1 ms at the card's peak rate).  The transpose
// and the gather take 3.22 ms at the preset (chip_smoke.py phase 34): 13.3 % of
// the 0.43 ms bound (the bytes above and the row lists', the function's own list
// of nonzeros, read once).
// No atomics; the kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kFwdCellsPerThread = 4;  // a block's run of cells: P is loaded once for 2048 cells
constexpr int kTileN = 4, kTileT = 16;  // a backward tile: 4 samples n by 16 positions t' (ops/boundary_matching.py TILE_N, TILE_T)
constexpr int kTileRows = kTileN * kTileT;
constexpr int kChunk = 32;  // union cells a slot of the backward's ring holds (TILE_CHUNK)
constexpr int kBwdChannels = 128;  // channels of dyt a backward block takes
constexpr int kLaneChannels = kBwdChannels / 32;  // 4 a lane: one 16-byte read of a cell's slice
constexpr int kBwdWarps = 16;  // two row pairs a warp
constexpr int kSlots = 3;  // the backward's ring: chunks k, k + 1 and k + 2
constexpr int kBwdMinBlocks = 2;  // backward blocks an SM holds (registers to match: 32 warps an SM)
constexpr int kPairs = kTileRows / 2;  // row pairs (t' even, t' + 1) of a tile
constexpr int kPairsPerWarp = kPairs / kBwdWarps;
static_assert(kTileT % 2 == 0 && kPairs % kBwdWarps == 0 && kLaneChannels == 4, "a backward tile's rows and channels");
constexpr int kMaxChannels = 8;  // OB: output channels a forward block takes
constexpr int kSharedMax = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

template <int OB>
__global__ void __launch_bounds__(kFwdThreads) bm_gather_fwd_kernel(const float* __restrict__ p, const int32_t* __restrict__ order,
                                                                     const int16_t* __restrict__ col_t, const float* __restrict__ col_w,
                                                                     const uint8_t* __restrict__ col_n, const float* __restrict__ bias,
                                                                     float* __restrict__ out, int O, int N, int T, int cells, int A, int K) {
  extern __shared__ float ps[];  // [OB, N, T]: this block's channels of P
  const int oblocks = (O + OB - 1) / OB;
  const int b = blockIdx.y / oblocks, o0 = (blockIdx.y % oblocks) * OB;
  const int nob = min(OB, O - o0);
  const int plane = N * T;
  const float* src = p + ((int64_t)b * O + o0) * plane;
  for (int i = threadIdx.x; i < nob * plane; i += kFwdThreads) ps[i] = src[i];
  __syncthreads();
  float bo[OB];
#pragma unroll
  for (int o = 0; o < OB; ++o) bo[o] = o < nob ? bias[o0 + o] : 0.f;
  float* dst = out + ((int64_t)b * O + o0) * cells;
  const int first = blockIdx.x * kFwdThreads * kFwdCellsPerThread;
  const int last = min(cells, first + kFwdThreads * kFwdCellsPerThread);
  for (int i = first + threadIdx.x; i < last; i += kFwdThreads) {
    float acc[OB];
#pragma unroll
    for (int o = 0; o < OB; ++o) acc[o] = 0.f;
    if (i < A) {
      for (int n = 0; n < N; ++n) {
        const int count = col_n[(int64_t)n * A + i];
        const float* pn = ps + n * T;
        for (int k = 0; k < count; ++k) {
          const int64_t e = ((int64_t)n * K + k) * A + i;
          const float w = col_w[e];
          const float* pt = pn + col_t[e];
#pragma unroll
          for (int o = 0; o < OB; ++o) acc[o] = __fadd_rn(acc[o], __fmul_rn(w, pt[o * plane]));
        }
      }
    }
    const int cell = order[i];
#pragma unroll
    for (int o = 0; o < OB; ++o)
      if (o < nob) dst[(int64_t)o * cells + cell] = relu(__fadd_rn(acc[o], bo[o]));
  }
}

// The backward's first pass: dyt [cells, BO] = (out > 0 ? dout : 0) transposed from [BO, cells], through a 64 x 64
// tile in shared memory, so that the gather reads a cell's BO channels from one row.  A thread reads 4 consecutive
// cells of a channel and writes 4 consecutive channels of a cell, 16 bytes at a time where the extents and pointers
// allow (reads_vec: cells % 4 == 0; writes_vec: BO % 4 == 0), else one float at a time.
__global__ void __launch_bounds__(256) bm_mask_transpose_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                                                 float* __restrict__ dyt, int BO, int cells, int reads_vec, int writes_vec) {
  __shared__ float tile[64][65];
  const int c0 = blockIdx.x * 64, ch0 = blockIdx.y * 64, q = threadIdx.x & 15, r = threadIdx.x >> 4;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int ch = ch0 + r + 16 * m, cell = c0 + 4 * q;
    float* row = &tile[r + 16 * m][4 * q];
    if (ch < BO && reads_vec && cell + 4 <= cells) {
      const int64_t at = (int64_t)ch * cells + cell;
      const float4 o = *reinterpret_cast<const float4*>(out + at), d = *reinterpret_cast<const float4*>(dout + at);
      row[0] = o.x > 0.f ? d.x : 0.f, row[1] = o.y > 0.f ? d.y : 0.f, row[2] = o.z > 0.f ? d.z : 0.f, row[3] = o.w > 0.f ? d.w : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t at = (int64_t)ch * cells + cell + i;
        row[i] = ch < BO && cell + i < cells && out[at] > 0.f ? dout[at] : 0.f;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int cell = c0 + r + 16 * m, ch = ch0 + 4 * q;
    if (cell >= cells) continue;
    const float v0 = tile[4 * q][r + 16 * m], v1 = tile[4 * q + 1][r + 16 * m], v2 = tile[4 * q + 2][r + 16 * m], v3 = tile[4 * q + 3][r + 16 * m];
    float* to = dyt + (int64_t)cell * BO + ch;
    if (writes_vec && ch + 4 <= BO) {
      *reinterpret_cast<float4*>(to) = make_float4(v0, v1, v2, v3);
    } else {
      const float v[4] = {v0, v1, v2, v3};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ch + i < BO) to[i] = v[i];
    }
  }
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// a lane's kLaneChannels consecutive floats of shared memory, one 16-byte read
__device__ __forceinline__ void load_lane(const float* p, float (&v)[kLaneChannels]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
// A merged entry m of a row pair: w * v added to the rows that hold its cell, each product and sum rounded on its own.
__device__ __forceinline__ void add_merged(float (&a)[kLaneChannels], float (&b)[kLaneChannels], const int4& m, const float (&v)[kLaneChannels]) {
  if (m.x & 256) {
    const float w = __int_as_float(m.y);
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) a[c] = __fadd_rn(a[c], __fmul_rn(w, v[c]));
  }
  if (m.x & 512) {
    const float w = __int_as_float(m.z);
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) b[c] = __fadd_rn(b[c], __fmul_rn(w, v[c]));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The backward's gather over row tiles.  Block = (channel block, tile), the channel block outermost; warp w owns the
// tile's row pairs p = w + kBwdWarps * i (rows 2p and 2p + 1: sample n0 + 2p / kTileT, positions t0 + 2p % kTileT and
// the next), lane l its channels c0 + kLaneChannels * l onwards.  A slot of the ring holds one chunk: its cells'
// channels [kChunk][kBwdChannels] floats, its merged entries (at most max_entries int4) and its (pair -> first entry)
// cuts [kPairs + 1].  A merged entry reads its cell's channels once for both rows of the pair.  Chunk k + 2 is copied in
// while chunk k is summed, and the cells and entry range a thread's copies of chunk k + 3 need are loaded into
// registers then too, so no copy waits on a load.
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks) bm_gather_bwd_kernel(const float* __restrict__ dyt, const int32_t* __restrict__ tile_cells,
                                                                        const int32_t* __restrict__ tile_cell_ptr,
                                                                        const int32_t* __restrict__ tile_chunk_ptr,
                                                                        const int32_t* __restrict__ chunk_cut, const int4* __restrict__ ent,
                                                                        float* __restrict__ dp, int BO, int N, int T, int tiles_t, int tiles,
                                                                        int max_entries, int aligned) {
  constexpr int kThreadsBwd = kBwdWarps * 32, kCopies = kChunk * kBwdChannels / 4 / kThreadsBwd;
  static_assert(kChunk * kBwdChannels / 4 % kThreadsBwd == 0, "a chunk's 16-byte copies split evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ent_bytes = max_entries * 16;
  const int slot_bytes = kChunk * kBwdChannels * 4 + ent_bytes + (((kPairs + 1) * 4 + 15) & ~15);
  const int tile = blockIdx.x % tiles, c0 = (blockIdx.x / tiles) * kBwdChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = tile_cell_ptr[tile], ucount = tile_cell_ptr[tile + 1] - first;
  const int32_t* cells = tile_cells + first;
  const int chunk0 = tile_chunk_ptr[tile], chunks = tile_chunk_ptr[tile + 1] - chunk0;

  auto ring_of = [&](int k) { return reinterpret_cast<float*>(smem + (k % kSlots) * slot_bytes); };
  auto ents_of = [&](int k) { return reinterpret_cast<int4*>(smem + (k % kSlots) * slot_bytes + kChunk * kBwdChannels * 4); };
  auto cuts_of = [&](int k) { return reinterpret_cast<int32_t*>(smem + (k % kSlots) * slot_bytes + kChunk * kBwdChannels * 4 + ent_bytes); };
  int next_cell[kCopies], next_e0 = 0, next_e1 = 0;  // what this thread's copies of the next chunk to stage read
  auto fetch = [&](int k) {
    if (k >= chunks) return;
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      const int u = k * kChunk + (threadIdx.x + m * kThreadsBwd) / (kBwdChannels / 4);
      next_cell[m] = u < ucount ? cells[u] : -1;
    }
    next_e0 = chunk_cut[(int64_t)(chunk0 + k) * kPairs];
    next_e1 = chunk_cut[(int64_t)(chunk0 + k) * kPairs + kPairs];
  };
  auto stage = [&](int k) {  // chunk k (from fetch(k)): its cells' channels (zeros past the union or BO), entries, cuts
    if (k < chunks) {
      float* ring = ring_of(k);
#pragma unroll
      for (int m = 0; m < kCopies; ++m) {
        const int i = threadIdx.x + m * kThreadsBwd, ch = c0 + (i % (kBwdChannels / 4)) * 4;
        float* to = ring + i * 4;
        if (next_cell[m] >= 0 && aligned && ch + 4 <= BO) {
          cp_async_16(to, dyt + (int64_t)next_cell[m] * BO + ch);
        } else {
          const float* from = dyt + (next_cell[m] >= 0 ? (int64_t)next_cell[m] * BO : 0);
#pragma unroll
          for (int c = 0; c < 4; ++c) to[c] = next_cell[m] >= 0 && ch + c < BO ? from[ch + c] : 0.f;
        }
      }
      int4* ents = ents_of(k);
      for (int i = threadIdx.x; i < next_e1 - next_e0; i += kThreadsBwd) cp_async_16(ents + i, ent + next_e0 + i);
      int32_t* cuts = cuts_of(k);
      for (int i = threadIdx.x; i <= kPairs; i += kThreadsBwd) cp_async_4(cuts + i, chunk_cut + (int64_t)(chunk0 + k) * kPairs + i);
    }
    cp_async_commit();  // a group for every chunk index, empty past the last, so that the waits below count alike
  };

  float acc[kPairsPerWarp][2][kLaneChannels];  // [pair][row t' or t' + 1][channel]
#pragma unroll
  for (int i = 0; i < kPairsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) acc[i][0][c] = acc[i][1][c] = 0.f;
  fetch(0);
  stage(0);
  fetch(1);
  stage(1);
  fetch(2);
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<1>();  // chunk k is in (k + 1 may not be)
    __syncthreads();  // ... for every thread; and every warp is done with chunk k - 1, whose slot chunk k + 2 takes
    stage(k + 2);
    fetch(k + 3);
    const float* ring = ring_of(k) + lane * kLaneChannels;
    const int4* ents = ents_of(k);
    const int32_t* cuts = cuts_of(k);
    const int e0 = cuts[0];
#pragma unroll
    for (int i = 0; i < kPairsPerWarp; ++i) {
      const int p = warp + kBwdWarps * i;
      const int end = cuts[p + 1] - e0;
      int e = cuts[p] - e0;
      for (; e + 2 <= end; e += 2) {  // two merged entries in flight, added in order
        const int4 a = ents[e], b = ents[e + 1];
        float va[kLaneChannels], vb[kLaneChannels];
        load_lane(ring + (a.x & 255) * kBwdChannels, va);
        load_lane(ring + (b.x & 255) * kBwdChannels, vb);
        add_merged(acc[i][0], acc[i][1], a, va);
        add_merged(acc[i][0], acc[i][1], b, vb);
      }
      if (e < end) {
        const int4 a = ents[e];
        float va[kLaneChannels];
        load_lane(ring + (a.x & 255) * kBwdChannels, va);
        add_merged(acc[i][0], acc[i][1], a, va);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which dP's tile takes

  // dP's tile through shared memory, so that neighbouring threads write neighbouring positions t' of one channel
  float* out = reinterpret_cast<float*>(smem);  // [kBwdChannels][kTileRows + 1]
#pragma unroll
  for (int i = 0; i < kPairsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      const int j = 2 * (warp + kBwdWarps * i);
      out[(lane * kLaneChannels + c) * (kTileRows + 1) + j] = acc[i][0][c];
      out[(lane * kLaneChannels + c) * (kTileRows + 1) + j + 1] = acc[i][1][c];
    }
  __syncthreads();
  const int n0 = (tile / tiles_t) * kTileN, t0 = (tile % tiles_t) * kTileT, rows = N * T;
  for (int i = threadIdx.x; i < kBwdChannels * kTileRows; i += kBwdWarps * 32) {
    const int ch = i / kTileRows, j = i % kTileRows, n = n0 + j / kTileT, t = t0 + j % kTileT;
    if (c0 + ch < BO && n < N && t < T) dp[(int64_t)(c0 + ch) * rows + n * T + t] = out[ch * (kTileRows + 1) + j];
  }
}

// A backward block's shared memory: the ring's slots, or dP's tile if that is larger.
int64_t bwd_smem_bytes(int max_entries) {
  const int64_t slot = kChunk * kBwdChannels * 4 + (int64_t)max_entries * 16 + (((kPairs + 1) * 4 + 15) & ~15);
  const int64_t out = (int64_t)kBwdChannels * (kTileRows + 1) * 4;
  return kSlots * slot > out ? kSlots * slot : out;
}

// OB for a forward block: the most channels (8, 4, 2 or 1) whose P fits the shared memory; 0 if one channel does not.
int fwd_channels(int N, int T) {
  const int64_t plane = (int64_t)N * T * sizeof(float);
  for (int ob = kMaxChannels; ob >= 1; ob /= 2)
    if (ob * plane <= kSharedMax) return ob;
  return 0;
}

template <int OB>
int launch_fwd(const float* p, const int32_t* order, const int16_t* col_t, const float* col_w, const uint8_t* col_n, const float* bias,
               float* out, int B, int O, int N, int T, int cells, int A, int K, cudaStream_t stream) {
  const int bytes = OB * N * T * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bm_gather_fwd_kernel<OB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cells + kFwdThreads * kFwdCellsPerThread - 1) / (kFwdThreads * kFwdCellsPerThread), B * ((O + OB - 1) / OB));
  bm_gather_fwd_kernel<OB><<<grid, kFwdThreads, bytes, stream>>>(p, order, col_t, col_w, col_n, bias, out, O, N, T, cells, A, K);
  return (int)cudaGetLastError();
}

}  // namespace

// p [B, O, N, T], bias [O], out [B, O, cells] float32, contiguous; the column lists as above.  Returns a
// cudaError_t (0 = launched).
extern "C" int bm_gather_fwd(const void* p, const void* order, const void* col_t, const void* col_w, const void* col_n, const void* bias,
                             void* out, int B, int O, int N, int T, int cells, int A, int K, void* stream) {
  const int ob = fwd_channels(N, T);
  if (B < 0 || O < 0 || N < 1 || T < 1 || cells < 0 || A < 0 || A > cells || K < 0 || ob == 0 || (int64_t)B * ((O + ob - 1) / ob) > 65535)
    return (int)cudaErrorInvalidValue;  // (ob == 0: one channel's P does not fit a block's shared memory)
  if ((int64_t)B * O == 0 || cells == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  const int32_t* ord = static_cast<const int32_t*>(order);
  const int16_t* ct = static_cast<const int16_t*>(col_t);
  const float* cw = static_cast<const float*>(col_w);
  const uint8_t* cn = static_cast<const uint8_t*>(col_n);
  const float* bs = static_cast<const float*>(bias);
  float* y = static_cast<float*>(out);
  switch (ob) {
    case 8: return launch_fwd<8>(pp, ord, ct, cw, cn, bs, y, B, O, N, T, cells, A, K, s);
    case 4: return launch_fwd<4>(pp, ord, ct, cw, cn, bs, y, B, O, N, T, cells, A, K, s);
    case 2: return launch_fwd<2>(pp, ord, ct, cw, cn, bs, y, B, O, N, T, cells, A, K, s);
    case 1: return launch_fwd<1>(pp, ord, ct, cw, cn, bs, y, B, O, N, T, cells, A, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out, dout [B, O, cells], dyt [cells, B * O] (scratch), dp [B, O, N * T] float32, contiguous; the tile lists as above
// (tiles = ceil(N / 4) * ceil(T / 16), ent as int4; max_entries the most entries of a chunk), built for tiles of tile_n
// samples by tile_t positions and chunks of chunk cells, which must be the kernel's (kTileN, kTileT, kChunk).  Launches the
// masked transpose, then the gather.  Returns a cudaError_t (0 = launched).
extern "C" int bm_gather_bwd(const void* out, const void* dout, void* dyt, const void* tile_cells, const void* tile_cell_ptr,
                             const void* tile_chunk_ptr, const void* chunk_cut, const void* ent, void* dp, int B, int O, int N, int T, int cells,
                             int max_entries, int tile_n, int tile_t, int chunk, void* stream) {
  if (tile_n != kTileN || tile_t != kTileT || chunk != kChunk) return (int)cudaErrorInvalidValue;  // lists built for other tiles
  const int64_t bo = (int64_t)B * O;
  const int tiles_t = (T + kTileT - 1) / kTileT;
  const int64_t tiles = (int64_t)((N + kTileN - 1) / kTileN) * tiles_t;
  const int64_t blocks = tiles * ((bo + kBwdChannels - 1) / kBwdChannels);
  const int64_t smem = bwd_smem_bytes(max_entries);
  if (B < 0 || O < 0 || N < 1 || T < 1 || cells < 0 || bo > INT32_MAX || (bo + 63) / 64 > 65535 || blocks > INT32_MAX ||
      (int64_t)N * T > INT32_MAX || max_entries < 0 || max_entries > kPairs * kChunk || smem > kSharedMax)
    return (int)cudaErrorInvalidValue;
  if (bo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(dyt);
  if (cells > 0) {
    const dim3 tgrid((cells + 63) / 64, (unsigned)((bo + 63) / 64));
    const int reads_vec = cells % 4 == 0 && ((uintptr_t)out & 15) == 0 && ((uintptr_t)dout & 15) == 0;
    const int writes_vec = bo % 4 == 0 && ((uintptr_t)dyt & 15) == 0;
    bm_mask_transpose_kernel<<<tgrid, 256, 0, s>>>(static_cast<const float*>(out), static_cast<const float*>(dout), g, (int)bo, cells, reads_vec,
                                                  writes_vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(bm_gather_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int aligned = bo % 4 == 0 && ((uintptr_t)dyt & 15) == 0;
  bm_gather_bwd_kernel<<<(unsigned)blocks, kBwdWarps * 32, (size_t)smem, s>>>(
      g, static_cast<const int32_t*>(tile_cells), static_cast<const int32_t*>(tile_cell_ptr), static_cast<const int32_t*>(tile_chunk_ptr),
      static_cast<const int32_t*>(chunk_cut), static_cast<const int4*>(ent), static_cast<float*>(dp), (int)bo, N, T, tiles_t, (int)tiles, max_entries,
      aligned);
  return (int)cudaGetLastError();
}
