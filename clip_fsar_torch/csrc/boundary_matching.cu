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
//   row_ptr [N*T + 1], row_cell, row_w [nnz]
//                        row (n, t') = n * T + t': its entries (cell, w), cell ascending (CSR)
//
// What bounds it on an H100.  Forward: P read and out written once (0.76 GB at
// the preset B 8, C3 512, N 32, D = T 200) and 2 operations for each nonzero
// and (b, o) (20 GFLOP of fp32 at 67 TFLOP/s): about 0.3 ms either way.
// Backward: out and dout read, dP written (1.4 GB).  Design: the lists are the
// same for every (b, o), so a forward block takes one b and OB output channels,
// holds those channels' P in shared memory (OB * N * T floats: 25.6 KB a
// channel at the preset) and walks a run of cells, one thread a cell, reading
// each column entry once from device memory for all OB channels.  The backward
// first writes dyt [cells, B*C3] = (out > 0 ? dout : 0) transposed (a scratch
// buffer the wrapper allocates), so that one cell's channels lie side by side;
// then a thread owns one channel of 8 consecutive rows (n, t') and walks each
// row's entries in ascending order: the block's threads read the same entry
// and neighbouring channels of its cell, one line a warp, and rows t' and
// t' + 1 touch neighbouring cells (the mask is nearly invariant to a shift of
// t' and t together), so a cell's line is read again from L1.  No atomics; the
// kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kFwdCellsPerThread = 4;  // a block's run of cells: P is loaded once for 2048 cells
constexpr int kBwdThreads = 256;  // channels a backward block takes
constexpr int kBwdRows = 8;  // (n, t') rows a backward thread takes
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

// The backward's first pass: dyt [cells, BO] = (out > 0 ? dout : 0) transposed from [BO, cells], through a
// 32 x 33 tile in shared memory, so that the gather reads a cell's BO channels from one row.
__global__ void __launch_bounds__(32 * 8) bm_mask_transpose_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                                                    float* __restrict__ dyt, int BO, int cells) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, ch0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int ch = ch0 + j, cell = c0 + threadIdx.x;
    if (ch < BO && cell < cells) {
      const int64_t at = (int64_t)ch * cells + cell;
      tile[j][threadIdx.x] = out[at] > 0.f ? dout[at] : 0.f;
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int cell = c0 + j, ch = ch0 + threadIdx.x;
    if (ch < BO && cell < cells) dyt[(int64_t)cell * BO + ch] = tile[threadIdx.x][j];
  }
}

// The backward's gather: thread = one channel ch of BO and kBwdRows consecutive rows; each row's entries in
// ascending order, four loads in flight; the block's threads read the same entry (a broadcast) and neighbouring
// channels of its cell (one line per warp).
__global__ void __launch_bounds__(kBwdThreads) bm_gather_bwd_kernel(const float* __restrict__ dyt, const int32_t* __restrict__ row_ptr,
                                                                     const int32_t* __restrict__ row_cell, const float* __restrict__ row_w,
                                                                     float* __restrict__ dp, int BO, int rows) {
  const int ch = blockIdx.y * kBwdThreads + threadIdx.x;
  const int r0 = blockIdx.x * kBwdRows;
  if (ch >= BO) return;
  const float* g = dyt + ch;
  float acc[kBwdRows];
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j) {
    float a = 0.f;
    if (r0 + j < rows) {
      int e = row_ptr[r0 + j];
      const int end = row_ptr[r0 + j + 1];
      for (; e + 4 <= end; e += 4) {
        const float v0 = g[(int64_t)row_cell[e] * BO], v1 = g[(int64_t)row_cell[e + 1] * BO];
        const float v2 = g[(int64_t)row_cell[e + 2] * BO], v3 = g[(int64_t)row_cell[e + 3] * BO];
        a = __fadd_rn(a, __fmul_rn(row_w[e], v0));
        a = __fadd_rn(a, __fmul_rn(row_w[e + 1], v1));
        a = __fadd_rn(a, __fmul_rn(row_w[e + 2], v2));
        a = __fadd_rn(a, __fmul_rn(row_w[e + 3], v3));
      }
      for (; e < end; ++e) a = __fadd_rn(a, __fmul_rn(row_w[e], g[(int64_t)row_cell[e] * BO]));
    }
    acc[j] = a;
  }
  float* dst = dp + (int64_t)ch * rows + r0;
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j)
    if (r0 + j < rows) dst[j] = acc[j];
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

// out, dout [B, O, cells], dyt [cells, B * O] (scratch), dp [B, O, N * T] float32, contiguous; the row lists (CSR over
// N * T rows) as above.  Launches the masked transpose, then the gather.  Returns a cudaError_t (0 = launched).
extern "C" int bm_gather_bwd(const void* out, const void* dout, void* dyt, const void* row_ptr, const void* row_cell, const void* row_w,
                             void* dp, int B, int O, int N, int T, int cells, void* stream) {
  const int64_t bo = (int64_t)B * O;
  if (B < 0 || O < 0 || N < 1 || T < 1 || cells < 0 || bo > INT32_MAX || (bo + 31) / 32 > 65535 || (bo + kBwdThreads - 1) / kBwdThreads > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = N * T;
  if (bo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(dyt);
  if (cells > 0) {
    const dim3 tgrid((cells + 31) / 32, (unsigned)((bo + 31) / 32));
    bm_mask_transpose_kernel<<<tgrid, dim3(32, 8), 0, s>>>(static_cast<const float*>(out), static_cast<const float*>(dout), g, (int)bo, cells);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((rows + kBwdRows - 1) / kBwdRows, (unsigned)((bo + kBwdThreads - 1) / kBwdThreads));
  bm_gather_bwd_kernel<<<grid, kBwdThreads, 0, s>>>(g, static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(row_cell),
                                                    static_cast<const float*>(row_w), static_cast<float*>(dp), (int)bo, rows);
  return (int)cudaGetLastError();
}
