// BMN's boundary-matching layer as two gathers over the sample mask's nonzeros, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package computes the layer
// (clip_fsar_tpu/models/heads/bmn.py:94-103) as XLA ops: the features mid
// [B, C, T] times the dense sample mask [T, N*D*T], viewed as [B, C, N, D, T],
// then an (N, 1, 1) Conv3d of stride (N, 1, 1) and a ReLU.  Both steps are
// linear, so the port groups them the other way round (ops/boundary_matching.py):
//
//   P[n, t', b, o]  = sum_c W[o, c, n] * mid[b, c, t']                  (torch.matmul)
//   out[b, o, cell] = relu(bias[o] + sum_n sum_{t'} mask[t', n, cell] * P[n, t', b, o])
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
// The column form (each (n, cell) column's entries, t' ascending) and the row
// form (each (n, t') row's entries, cell ascending) stay on the host: the plain
// versions walk them.  The kernels walk tile forms of the same nonzeros, built
// once per mask on the host (ops/boundary_matching.py), one for each gather.
//
// Forward: P read and out written once (0.76 GB at the preset B 8, C3 512,
// N 32, D = T 200) and 2 operations for each nonzero and (b, o) (20 GFLOP of
// fp32 at 67 TFLOP/s, 0.30 ms, the bound; a product and a sum rounded apart
// issue as two instructions, so this kernel takes 0.60 ms at the least).
// P comes from its matrix product as rows [N*T', B*C3], a row's channels side
// by side.  The first forward (a block of 8 channels' whole P in shared memory,
// a thread a cell, 5.47 ms) read P 20 times over, half of it for blocks of
// inactive cells, and each column entry once for only 8 channels.  The kernel
// now takes cells in tiles of 8 durations d by 8 starts t, whose cells share
// their rows (a tile's union of rows is ~17 times smaller than its entries at
// the preset), and walks each tile's cells in pairs (d even, d + 1) at one t,
// which share 41 % of their rows (2.46 M entries merge to 1.46 M), from tile lists:
//   fwd_tile_row_ptr [tiles + 1], fwd_tile_rows   each tile's union of rows n * T + t', ascending
//   fwd_tile_chunk_ptr [tiles + 1]                each tile's first chunk of 32 union rows
//   fwd_ent [merged] int4                         for each chunk, cell pair and row of the chunk
//                                                 that either cell holds, ascending: (the row's
//                                                 index in the chunk | 256 if cell d holds it |
//                                                 512 if cell d + 1 does, the two weights' bits, 0)
//   fwd_chunk_cut [chunks * 32 + 1]               the first merged entry of (chunk, pair)
// A block owns one tile and 128 channels; the union's rows stream through the
// ring of three chunks that the two gathers share (tile_sums), each of 16 warps
// owns 2 cell pairs, each lane 4 channels, one 16-byte shared read an entry for
// both cells of a pair.  A tile of no active cell stages nothing.  The output goes out through
// shared memory with the bias and the ReLU.  At the preset it takes 2.28 ms
// (chip_smoke.py phase 34), 13.3 % of the bound, 0.45x torch.sparse.mm; of the
// tiles tried (4 x 16, 8 x 16, 16 x 8, 16 x 16, 8 x 4, chunks of 16 and 64, 8
// warps, 1 to 4 blocks an SM) none was faster.  What holds it is issue: the loop
// spends ~24.5 instructions a merged entry and warp (the 16 products and sums
// of the pair predicated, so issued whether a cell holds the row or not), 1.1 G
// at the preset, ~1.2 ms at the card's full issue rate; staging alone (no sums)
// takes 1.13 ms and the sums alone 2.17, overlapped to 2.28.
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

// Both gathers stream a tile's union of rows (forward) or cells (backward) through one ring in shared memory: chunks
// of kChunk union items (ops/boundary_matching.py TILE_CHUNK), 128 channels a block, 16 warps of two output pairs,
// each lane 4 channels; a tile holds 2 * kPairs outputs
constexpr int kChunk = 32;
constexpr int kChannels = 128;
constexpr int kLaneChannels = kChannels / 32;  // 4 a lane: one 16-byte read of an item's slice
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 3;  // chunks k, k + 1 and k + 2
constexpr int kMinBlocks = 2;  // blocks an SM holds (registers to match: 32 warps an SM)
constexpr int kPairs = 32;
constexpr int kPairsPerWarp = kPairs / kWarps;
constexpr int kTileOut = 2 * kPairs;
static_assert(kPairs % kWarps == 0 && kLaneChannels == 4 && kChunk <= 256, "a tile's pairs, channels and chunk");
// a backward tile: 4 samples n by 16 positions t' (TILE_N, TILE_T), rows in pairs (t' even, t' + 1)
constexpr int kTileN = 4, kTileT = 16;
// a forward tile: 8 durations d by 8 starts t (FWD_TILE_D, FWD_TILE_T), cells in pairs (d even, d + 1) at one t
constexpr int kFwdTileD = 8, kFwdTileT = 8;
static_assert(kTileN * kTileT == kTileOut && kTileT % 2 == 0 && kFwdTileD * kFwdTileT == kTileOut && kFwdTileD % 2 == 0, "the tiles");
constexpr int kSharedMax = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

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

// One tile's sums, the part both gathers share.  The block owns a tile and kChannels channels c0 onwards of src
// [items, BO] (a row's BO channels side by side); the tile's union of items (ucount of them, ascending, in ``items``) is
// staged chunk by chunk into a ring slot: its items' channels [kChunk][kChannels] floats (zeros past the union or BO),
// its merged entries (at most max_entries int4: the item's index in the chunk | 256 if output 0 of the pair holds it |
// 512 if output 1 does, the two weights' bits, 0) and its (pair -> first entry) cuts [kPairs + 1].  Warp w sums pairs
// q = w + kWarps * i, lane l channels c0 + kLaneChannels * l onwards: each (output, channel) sum has one owner, which adds
// its output's entries in the union's order, reading an item the pair shares once for both outputs.  Chunk k + 2 is
// copied in by cp.async while chunk k is summed, and the items and entry range a thread's copies of chunk k + 3 need
// are loaded into registers then too, so no copy waits on a load.  On return every warp is done with shared memory.
__device__ __forceinline__ void tile_sums(const float* __restrict__ src, const int32_t* __restrict__ items, int ucount, int chunk0, int chunks,
                                          const int32_t* __restrict__ chunk_cut, const int4* __restrict__ ent, int c0, int BO,
                                          int max_entries, int aligned, unsigned char* smem, float (&acc)[kPairsPerWarp][2][kLaneChannels]) {
  constexpr int kCopies = kChunk * kChannels / 4 / kThreads;
  static_assert(kChunk * kChannels / 4 % kThreads == 0, "a chunk's 16-byte copies split evenly over the threads");
  const int ent_bytes = max_entries * 16;
  const int slot_bytes = kChunk * kChannels * 4 + ent_bytes + (((kPairs + 1) * 4 + 15) & ~15);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto ring_of = [&](int k) { return reinterpret_cast<float*>(smem + (k % kSlots) * slot_bytes); };
  auto ents_of = [&](int k) { return reinterpret_cast<int4*>(smem + (k % kSlots) * slot_bytes + kChunk * kChannels * 4); };
  auto cuts_of = [&](int k) { return reinterpret_cast<int32_t*>(smem + (k % kSlots) * slot_bytes + kChunk * kChannels * 4 + ent_bytes); };
  int next_item[kCopies], next_e0 = 0, next_e1 = 0;  // what this thread's copies of the next chunk to stage read
  auto fetch = [&](int k) {
    if (k >= chunks) return;
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      const int u = k * kChunk + (threadIdx.x + m * kThreads) / (kChannels / 4);
      next_item[m] = u < ucount ? items[u] : -1;
    }
    next_e0 = chunk_cut[(int64_t)(chunk0 + k) * kPairs];
    next_e1 = chunk_cut[(int64_t)(chunk0 + k) * kPairs + kPairs];
  };
  auto stage = [&](int k) {  // chunk k (from fetch(k)): its items' channels, entries, cuts
    if (k < chunks) {
      float* ring = ring_of(k);
#pragma unroll
      for (int m = 0; m < kCopies; ++m) {
        const int i = threadIdx.x + m * kThreads, ch = c0 + (i % (kChannels / 4)) * 4;
        float* to = ring + i * 4;
        if (next_item[m] >= 0 && aligned && ch + 4 <= BO) {
          cp_async_16(to, src + (int64_t)next_item[m] * BO + ch);
        } else {
          const float* from = src + (next_item[m] >= 0 ? (int64_t)next_item[m] * BO : 0);
#pragma unroll
          for (int c = 0; c < 4; ++c) to[c] = next_item[m] >= 0 && ch + c < BO ? from[ch + c] : 0.f;
        }
      }
      int4* ents = ents_of(k);
      for (int i = threadIdx.x; i < next_e1 - next_e0; i += kThreads) cp_async_16(ents + i, ent + next_e0 + i);
      int32_t* cuts = cuts_of(k);
      for (int i = threadIdx.x; i <= kPairs; i += kThreads) cp_async_4(cuts + i, chunk_cut + (int64_t)(chunk0 + k) * kPairs + i);
    }
    cp_async_commit();  // a group for every chunk index, empty past the last, so that the waits below count alike
  };

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
      const int q = warp + kWarps * i;
      const int end = cuts[q + 1] - e0;
      int e = cuts[q] - e0;
      for (; e + 2 <= end; e += 2) {  // two merged entries in flight, added in order
        const int4 a = ents[e], b = ents[e + 1];
        float va[kLaneChannels], vb[kLaneChannels];
        load_lane(ring + (a.x & 255) * kChannels, va);
        load_lane(ring + (b.x & 255) * kChannels, vb);
        add_merged(acc[i][0], acc[i][1], a, va);
        add_merged(acc[i][0], acc[i][1], b, vb);
      }
      if (e < end) {
        const int4 a = ents[e];
        float va[kLaneChannels];
        load_lane(ring + (a.x & 255) * kChannels, va);
        add_merged(acc[i][0], acc[i][1], a, va);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which the caller's output tile takes
}

// A gather block's shared memory: the ring's slots, or the output's tile [kChannels][kTileOut + 1] if that is larger.
int64_t gather_smem_bytes(int max_entries) {
  const int64_t slot = kChunk * kChannels * 4 + (int64_t)max_entries * 16 + (((kPairs + 1) * 4 + 15) & ~15);
  const int64_t out = (int64_t)kChannels * (kTileOut + 1) * 4;
  return kSlots * slot > out ? kSlots * slot : out;
}

// The backward's gather over row tiles: block = (channel block, tile), the channel block outermost, so that the channel
// block's slice of dyt stays in L2 while its tiles run; the tile's union of cells summed by ``tile_sums`` (pair q: rows
// t' and t' + 1 of sample n0 + 2q / kTileT, t' = t0 + 2q % kTileT); dP goes out through shared memory, a row's kTileT
// positions t' side by side.
__global__ void __launch_bounds__(kThreads, kMinBlocks) bm_gather_bwd_kernel(const float* __restrict__ dyt, const int32_t* __restrict__ tile_cells,
                                                                           const int32_t* __restrict__ tile_cell_ptr,
                                                                           const int32_t* __restrict__ tile_chunk_ptr,
                                                                           const int32_t* __restrict__ chunk_cut, const int4* __restrict__ ent,
                                                                           float* __restrict__ dp, int BO, int N, int T, int tiles_t, int tiles,
                                                                           int max_entries, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x % tiles, c0 = (blockIdx.x / tiles) * kChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = tile_cell_ptr[tile], chunk0 = tile_chunk_ptr[tile];
  float acc[kPairsPerWarp][2][kLaneChannels];  // [pair][row t' or t' + 1][channel]
  tile_sums(dyt, tile_cells + first, tile_cell_ptr[tile + 1] - first, chunk0, tile_chunk_ptr[tile + 1] - chunk0, chunk_cut, ent, c0, BO,
            max_entries, aligned, smem, acc);

  float* out = reinterpret_cast<float*>(smem);  // [kChannels][kTileOut + 1]
#pragma unroll
  for (int i = 0; i < kPairsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      const int j = 2 * (warp + kWarps * i);
      out[(lane * kLaneChannels + c) * (kTileOut + 1) + j] = acc[i][0][c];
      out[(lane * kLaneChannels + c) * (kTileOut + 1) + j + 1] = acc[i][1][c];
    }
  __syncthreads();
  const int n0 = (tile / tiles_t) * kTileN, t0 = (tile % tiles_t) * kTileT, rows = N * T;
  for (int i = threadIdx.x; i < kChannels * kTileOut; i += kThreads) {
    const int ch = i / kTileOut, j = i % kTileOut, n = n0 + j / kTileT, t = t0 + j % kTileT;
    if (c0 + ch < BO && n < N && t < T) dp[(int64_t)(c0 + ch) * rows + n * T + t] = out[ch * (kTileOut + 1) + j];
  }
}

// The forward's gather over cell tiles, the backward's mirror: block = (channel block, tile), the channel block outermost,
// so that a channel block's slice of P stays in L2 while its tiles run; the tile's union of rows summed by ``tile_sums``
// (pair q: cells d0 + 2 (q / kFwdTileT) and the next duration, at start t0 + q % kFwdTileT).  The union is ascending in
// (n, t') and a pair's entries within a chunk ascending too, so each cell adds its column's entries n by n, t' by t', as
// the plain version does.  A tile with no active cell has no chunk: its block stages nothing and writes relu(0 + bias).
// The output goes out through shared memory, the kFwdTileT starts t of a (channel, d) side by side.
__global__ void __launch_bounds__(kThreads, kMinBlocks) bm_gather_fwd_kernel(const float* __restrict__ p, const int32_t* __restrict__ tile_rows,
                                                                           const int32_t* __restrict__ tile_row_ptr,
                                                                           const int32_t* __restrict__ tile_chunk_ptr,
                                                                           const int32_t* __restrict__ chunk_cut, const int4* __restrict__ ent,
                                                                           const float* __restrict__ bias, float* __restrict__ out, int BO, int O,
                                                                           int D, int T, int tiles_t, int tiles, int max_entries, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x % tiles, c0 = (blockIdx.x / tiles) * kChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = tile_row_ptr[tile], chunk0 = tile_chunk_ptr[tile];
  float acc[kPairsPerWarp][2][kLaneChannels];  // [pair][cell d or d + 1][channel]
  tile_sums(p, tile_rows + first, tile_row_ptr[tile + 1] - first, chunk0, tile_chunk_ptr[tile + 1] - chunk0, chunk_cut, ent, c0, BO,
            max_entries, aligned, smem, acc);

  float* tile_out = reinterpret_cast<float*>(smem);  // [kChannels][kTileOut + 1]
#pragma unroll
  for (int i = 0; i < kPairsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kLaneChannels; ++c) {
      const int q = warp + kWarps * i, j = (q / kFwdTileT) * 2 * kFwdTileT + q % kFwdTileT;
      tile_out[(lane * kLaneChannels + c) * (kTileOut + 1) + j] = acc[i][0][c];
      tile_out[(lane * kLaneChannels + c) * (kTileOut + 1) + j + kFwdTileT] = acc[i][1][c];
    }
  __syncthreads();
  const int d0 = (tile / tiles_t) * kFwdTileD, t0 = (tile % tiles_t) * kFwdTileT;
  const int64_t cells = (int64_t)D * T;
  for (int i = threadIdx.x; i < kChannels * kTileOut; i += kThreads) {
    const int ch = i / kTileOut, j = i % kTileOut, d = d0 + j / kFwdTileT, t = t0 + j % kFwdTileT;
    if (c0 + ch < BO && d < D && t < T)
      out[(c0 + ch) * cells + d * T + t] = relu(__fadd_rn(tile_out[ch * (kTileOut + 1) + j], bias[(c0 + ch) % O]));
  }
}

}  // namespace

// p [N * T, B * O] (row n * T + t' holds its B * O channels side by side), bias [O], out [B, O, D * T] float32,
// contiguous; the forward's tile lists as above (tiles = ceil(D / 8) * ceil(T / 8), ent as int4; max_entries the most
// entries of a chunk), built for tiles of tile_d durations by tile_t starts and chunks of chunk rows, which must be the
// kernel's (kFwdTileD, kFwdTileT, kChunk).  Returns a cudaError_t (0 = launched).
extern "C" int bm_gather_fwd(const void* p, const void* tile_rows, const void* tile_row_ptr, const void* tile_chunk_ptr, const void* chunk_cut,
                             const void* ent, const void* bias, void* out, int B, int O, int N, int T, int D, int max_entries, int tile_d,
                             int tile_t, int chunk, void* stream) {
  if (tile_d != kFwdTileD || tile_t != kFwdTileT || chunk != kChunk) return (int)cudaErrorInvalidValue;  // lists built for other tiles
  const int64_t bo = (int64_t)B * O;
  const int tiles_t = (T + kFwdTileT - 1) / kFwdTileT;
  const int64_t tiles = (int64_t)((D + kFwdTileD - 1) / kFwdTileD) * tiles_t;
  const int64_t blocks = tiles * ((bo + kChannels - 1) / kChannels);
  const int64_t smem = gather_smem_bytes(max_entries);
  if (B < 0 || O < 0 || N < 1 || T < 1 || D < 1 || bo > INT32_MAX || blocks > INT32_MAX || (int64_t)N * T > INT32_MAX ||
      (int64_t)D * T > INT32_MAX || max_entries < 0 || max_entries > kPairs * kChunk || smem > kSharedMax)
    return (int)cudaErrorInvalidValue;
  if (bo == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(bm_gather_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int aligned = bo % 4 == 0 && ((uintptr_t)p & 15) == 0;
  bm_gather_fwd_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const int32_t*>(tile_rows), static_cast<const int32_t*>(tile_row_ptr),
      static_cast<const int32_t*>(tile_chunk_ptr), static_cast<const int32_t*>(chunk_cut), static_cast<const int4*>(ent),
      static_cast<const float*>(bias), static_cast<float*>(out), (int)bo, O, D, T, tiles_t, (int)tiles, max_entries, aligned);
  return (int)cudaGetLastError();
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
  const int64_t blocks = tiles * ((bo + kChannels - 1) / kChannels);
  const int64_t smem = gather_smem_bytes(max_entries);
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
  bm_gather_bwd_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(
      g, static_cast<const int32_t*>(tile_cells), static_cast<const int32_t*>(tile_cell_ptr), static_cast<const int32_t*>(tile_chunk_ptr),
      static_cast<const int32_t*>(chunk_cut), static_cast<const int4*>(ent), static_cast<float*>(dp), (int)bo, N, T, tiles_t, (int)tiles, max_entries,
      aligned);
  return (int)cudaGetLastError();
}
