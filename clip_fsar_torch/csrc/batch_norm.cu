// BatchNorm of the CLIP RN towers (models/clip/model.py BatchNorm: the ModifiedResNet, the
// torchvision-style trunks of models/resnet.py, MoLo's decoder) for sm_90a, forward and backward.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is plain jnp that XLA fuses.  It replaces the
// port's chain of plain PyTorch ops (ops/batch_norm.py batch_norm_reference), which ran each step of
// the expression as its own kernel over the whole activation in fp32: about 22 kernels a forward and
// 25 a backward, 44 and 88 bytes moved an element.  Same function, per (group g, channel c) of
// x [G, M, C] (channels innermost), all arithmetic in fp32:
//
//   batch statistics:   mean = sum(x) / M, raw = sum(x*x) / M - mean*mean, var = max(raw, 0)
//   running statistics: mean, var = the running buffers
//   a = w * rsqrt(var + eps), b = beta - mean * a, y = x * a + b                  (x's dtype)
//   the running update: step = keep * prev + take * (mean, var)        (keep = 0.9, take = 0.1)
//   backward:  d_b = sum(dy), d_a = sum(dy * x) - d_b * mean
//              batch:   d_var = d_a * w * -0.5 * rsqrt(var + eps) / (var + eps) * [raw > 0]
//                       d_mean = -d_b * a - 2 * mean * d_var
//                       dx = dy * a + (d_mean + 2 * d_var * x) / M                  (x's dtype)
//              running: dx = dy * a
//              dw = sum_g(d_a * rsqrt(var + eps)), dbeta = sum_g(d_b)                (fp32)
//
// Each per-(g, c) step is rounded as the chain rounds it (__fmul_rn, __fadd_rn, no contraction into
// a fused multiply-add), so y has the chain's bits wherever a and b do; only the sums' order differs.
//
// What bounds it on an H100: bytes.  A few operations an element against 3.35 TB/s: the least the
// work needs is one read of x for the statistics, then a read of x and a write of y (forward on batch
// statistics); a read and a write (running statistics); x and dy read for the two sums, then x and dy
// read again and dx written (backward).
//
// Design:
//   * three kinds of pass over the activation, each reading it with 16-byte loads (8 bf16 or 4 fp32
//     channels a thread; one channel a thread where C is no multiple of that), neighbouring threads on
//     neighbouring channels: a sum pass (x, x*x; or dy, dy*x), an affine pass (y; or dx), and between
//     them a small combine of the per-tile sums into the [G, C] coefficients.  Forward on batch
//     statistics: sum, combine, affine (3 launches); running statistics: the affine alone, a and b
//     formed from the buffers in its registers (1); backward on batch statistics: sum, combine, dx
//     (3); on running statistics the sum pass writes dx = dy * a as it reads, then the combine (2);
//   * the tile plan comes from the host (ops/batch_norm.py tile_plan) and depends on the shape alone:
//     a block takes `lanes` vector columns of one band of channels and `rows` row lanes, thread (r, l)
//     the rows tile * rows * run + k * rows + r for k < run.  Where G * C is small and M large (the
//     stem) the plan cuts M into many tiles; where C is large and M small (stage 4) into bands of
//     channels; at least 4 blocks per SM wherever the shape has them;
//   * sums: each thread sums its run of at most 32 rows in registers, the block's row lanes are then
//     added as a tree through shared memory, and each tile writes its own [C] partials; the combine
//     adds a group's tiles in 32 strided runs and those as a tree.  No float atomics, a fixed order:
//     the same bits on every run, and the precision of a cascaded sum rather than of one serial sum
//     over half a million rows;
//   * the kernels allocate nothing and do not synchronise; they run on the stream they are given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the most threads a sum or affine block has (lanes * rows)
constexpr int kMaxVec = 8;         // channels a thread loads at once (8 bf16 in 16 bytes)
constexpr int kMaxRun = 32;        // rows a thread sums in registers before the tree
constexpr int kCombine = 32;       // the combine: channels a block (x) and tile lanes (y)

struct Plan {
  int groups;
  int64_t m;  // rows a group
  int c;
  int lanes, bands, rows, run, tiles;
};

// ---- loads and stores of V channels ----
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) { v[0] = __bfloat162float(*p); }

__device__ __forceinline__ void store(float* p, const float (&v)[4]) { *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) { *p = __float2bfloat16_rn(v[0]); }

// a and b of the affine from the running buffers, rounded step by step as the chain rounds them
__device__ __forceinline__ void running_affine(const float* __restrict__ w, const float* __restrict__ beta, const float* __restrict__ rmean,
                                               const float* __restrict__ rvar, int c, float eps, float& a, float& b) {
  const float rstd = rsqrtf(__fadd_rn(rvar[c], eps));
  a = __fmul_rn(w[c], rstd);
  b = __fsub_rn(beta[c], __fmul_rn(rmean[c], a));
}

// The block's place in the plan: its group, the first channel of this thread's vector and whether it
// lies inside C, the first row of its tile, and the thread's row lane and channel lane.
struct Place {
  int g, c0, r, lane;
  bool live;
  int64_t row0;
};
__device__ __forceinline__ Place place(const Plan& p, int vec) {
  Place q;
  q.lane = threadIdx.x % p.lanes;
  q.r = threadIdx.x / p.lanes;
  int64_t b = blockIdx.x;
  const int tile = (int)(b % p.tiles);
  b /= p.tiles;
  const int band = (int)(b % p.bands);
  q.g = (int)(b / p.bands);
  q.c0 = (band * p.lanes + q.lane) * vec;
  q.live = q.c0 < p.c;
  q.row0 = (int64_t)tile * p.rows * p.run;
  return q;
}

enum Kind { kStats = 0, kGrad = 1, kGradRunning = 2 };

// ---- the sum pass ----
// kStats: (sum x, sum x*x); kGrad: (sum dy, sum dy*x); kGradRunning: the same, and dx = dy * a written.
// part: [2][G][tiles][C] fp32, the block writing row (g, tile) of both halves for its channels.
template <typename T, int V, int KIND>
__global__ void __launch_bounds__(kThreads) sum_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                                                       const float* __restrict__ w, const float* __restrict__ rmean,
                                                       const float* __restrict__ rvar, float eps, float* __restrict__ part, Plan p) {
  __shared__ float red[2 * kMaxVec * kThreads];  // [2][V][rows][lanes]
  const Place q = place(p, V);
  float s1[V], s2[V], a[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = a[e] = 0.f;
  if (q.live) {
    if (KIND == kGradRunning) {
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = __fmul_rn(w[q.c0 + e], rsqrtf(__fadd_rn(rvar[q.c0 + e], eps)));
    }
    const int64_t base = (int64_t)q.g * p.m * p.c + q.c0;
#pragma unroll 4
    for (int k = 0; k < p.run; ++k) {
      const int64_t row = q.row0 + (int64_t)k * p.rows + q.r;
      if (row >= p.m) break;
      const int64_t off = base + row * p.c;
      float xv[V];
      load(x + off, xv);
      if (KIND == kStats) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1[e] += xv[e];
          s2[e] = fmaf(xv[e], xv[e], s2[e]);
        }
      } else {
        float dv[V];
        load(dy + off, dv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1[e] += dv[e];
          s2[e] = fmaf(dv[e], xv[e], s2[e]);
        }
        if (KIND == kGradRunning) {
          float out[V];
#pragma unroll
          for (int e = 0; e < V; ++e) out[e] = __fmul_rn(dv[e], a[e]);
          store(dx + off, out);
        }
      }
    }
  }
  // the row lanes' sums as a tree, lane by lane: row r takes row r + s for s = 2^k, ..., 1
  const int plane = p.rows * p.lanes;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[e * plane + q.r * p.lanes + q.lane] = s1[e];
    red[(V + e) * plane + q.r * p.lanes + q.lane] = s2[e];
  }
  __syncthreads();
  int half = 1;
  while (half < p.rows) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (q.r < half && q.r + half < p.rows) {
#pragma unroll
      for (int e = 0; e < 2 * V; ++e) red[e * plane + q.r * p.lanes + q.lane] += red[e * plane + (q.r + half) * p.lanes + q.lane];
    }
    __syncthreads();
  }
  if (q.r == 0 && q.live) {
    const int tile = (int)(blockIdx.x % p.tiles);
    float* p1 = part + ((int64_t)q.g * p.tiles + tile) * p.c + q.c0;
    float* p2 = p1 + (int64_t)p.groups * p.tiles * p.c;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p1[e] = red[e * plane + q.lane];
      p2[e] = red[(V + e) * plane + q.lane];
    }
  }
}

// One group's two sums for channel blockIdx.x * 32 + threadIdx.x: tile lane ty adds the tiles ty, ty + 32,
// ... in that order, and the 32 lanes are added as a tree.  Every thread of the block calls it.
__device__ __forceinline__ void combine_sums(const float* __restrict__ part, const Plan& p, int g, int ch, float (&r1)[kCombine][kCombine + 1],
                                             float (&r2)[kCombine][kCombine + 1], float& s1, float& s2) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  float a1 = 0.f, a2 = 0.f;
  if (ch < p.c) {
    const float* p1 = part + (int64_t)g * p.tiles * p.c + ch;
    const float* p2 = p1 + (int64_t)p.groups * p.tiles * p.c;
    for (int t = ty; t < p.tiles; t += kCombine) {
      a1 += p1[(int64_t)t * p.c];
      a2 += p2[(int64_t)t * p.c];
    }
  }
  __syncthreads();  // the previous group's sums have been read
  r1[ty][tx] = a1;
  r2[ty][tx] = a2;
  __syncthreads();
  for (int half = kCombine / 2; half > 0; half >>= 1) {
    if (ty < half) {
      r1[ty][tx] += r1[ty + half][tx];
      r2[ty][tx] += r2[ty + half][tx];
    }
    __syncthreads();
  }
  s1 = r1[0][tx];
  s2 = r2[0][tx];
}

// ---- the forward's combine: statistics, a, b and the running update ----
// st: [6][G][C] (mean, var, rstd, a, b, [raw > 0]); step: [G][2][C]; prev_mean / prev_var: [C] at group
// stride prev_stride (0: one vector for every group).
__global__ void __launch_bounds__(kCombine * kCombine) combine_fwd_kernel(const float* __restrict__ part, const float* __restrict__ w,
                                                                          const float* __restrict__ beta, const float* __restrict__ prev_mean,
                                                                          const float* __restrict__ prev_var, int64_t prev_stride,
                                                                          float* __restrict__ st, float* __restrict__ step, Plan p, float eps,
                                                                          float keep, float take) {
  __shared__ float r1[kCombine][kCombine + 1], r2[kCombine][kCombine + 1];
  const int ch = blockIdx.x * kCombine + threadIdx.x;
  const float count = (float)p.m;
  const int64_t gc = (int64_t)p.groups * p.c;
  for (int g = 0; g < p.groups; ++g) {
    float s1, s2;
    combine_sums(part, p, g, ch, r1, r2, s1, s2);
    if (threadIdx.y == 0 && ch < p.c) {
      const float mean = __fdiv_rn(s1, count);
      const float raw = __fsub_rn(__fdiv_rn(s2, count), __fmul_rn(mean, mean));
      const float var = raw < 0.f ? 0.f : raw;  // max(raw, 0), a NaN kept as the chain's clamp keeps it
      const float rstd = rsqrtf(__fadd_rn(var, eps));
      const float a = __fmul_rn(w[ch], rstd);
      const float b = __fsub_rn(beta[ch], __fmul_rn(mean, a));
      const int64_t at = (int64_t)g * p.c + ch;
      st[at] = mean;
      st[gc + at] = var;
      st[2 * gc + at] = rstd;
      st[3 * gc + at] = a;
      st[4 * gc + at] = b;
      st[5 * gc + at] = raw > 0.f ? 1.f : 0.f;
      const float pm = prev_mean[g * prev_stride + ch], pv = prev_var[g * prev_stride + ch];
      step[(int64_t)(2 * g) * p.c + ch] = __fadd_rn(__fmul_rn(keep, pm), __fmul_rn(take, mean));
      step[(int64_t)(2 * g + 1) * p.c + ch] = __fadd_rn(__fmul_rn(keep, pv), __fmul_rn(take, var));
    }
  }
}

// ---- the backward's combine: the dx coefficients and the weight and bias gradients ----
// batch: co [3][G][C] (a, 2 * d_var, d_mean) from st; running: mean and var from the buffers, no co.
__global__ void __launch_bounds__(kCombine * kCombine) combine_bwd_kernel(const float* __restrict__ part, const float* __restrict__ w,
                                                                          const float* __restrict__ st, const float* __restrict__ rmean,
                                                                          const float* __restrict__ rvar, float* __restrict__ co,
                                                                          float* __restrict__ dw, float* __restrict__ dbeta, Plan p, float eps,
                                                                          int batch) {
  __shared__ float r1[kCombine][kCombine + 1], r2[kCombine][kCombine + 1];
  const int ch = blockIdx.x * kCombine + threadIdx.x;
  const int64_t gc = (int64_t)p.groups * p.c;
  float sum_w = 0.f, sum_b = 0.f;
  for (int g = 0; g < p.groups; ++g) {
    float d_b, sdx;
    combine_sums(part, p, g, ch, r1, r2, d_b, sdx);
    if (threadIdx.y == 0 && ch < p.c) {
      const int64_t at = (int64_t)g * p.c + ch;
      float mean, rstd;
      if (batch) {
        mean = st[at], rstd = st[2 * gc + at];
      } else {
        mean = rmean[ch], rstd = rsqrtf(__fadd_rn(rvar[ch], eps));
      }
      const float d_a = __fsub_rn(sdx, __fmul_rn(d_b, mean));
      if (batch) {
        const float var_eps = __fadd_rn(st[gc + at], eps), a = st[3 * gc + at], live = st[5 * gc + at];
        const float d_var = __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(d_a, w[ch]), -0.5f), rstd), var_eps), live);
        const float d_mean = __fsub_rn(__fmul_rn(-d_b, a), __fmul_rn(__fmul_rn(2.f, mean), d_var));
        co[at] = a;
        co[gc + at] = __fmul_rn(2.f, d_var);
        co[2 * gc + at] = d_mean;
      }
      sum_w = __fadd_rn(sum_w, __fmul_rn(d_a, rstd));
      sum_b = __fadd_rn(sum_b, d_b);
    }
  }
  if (threadIdx.y == 0 && ch < p.c) {
    dw[ch] = sum_w;
    dbeta[ch] = sum_b;
  }
}

// ---- the affine pass ----
// FWD_BATCH: y = x * a + b, a and b from st; FWD_RUNNING: a and b from the running buffers;
// BWD: dx = dy * a + (d_mean + 2 d_var * x) / M, the coefficients from co.
enum Affine { kFwdBatch = 0, kFwdRunning = 1, kBwd = 2 };

template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads) affine_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ out,
                                                          const float* __restrict__ coef, const float* __restrict__ w,
                                                          const float* __restrict__ beta, const float* __restrict__ rmean,
                                                          const float* __restrict__ rvar, float eps, Plan p) {
  const Place q = place(p, V);
  if (!q.live) return;
  const int64_t gc = (int64_t)p.groups * p.c;
  const int64_t at = (int64_t)q.g * p.c + q.c0;
  float k0[V], k1[V], k2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (MODE == kFwdRunning) {
      running_affine(w, beta, rmean, rvar, q.c0 + e, eps, k0[e], k1[e]);
      k2[e] = 0.f;
    } else if (MODE == kFwdBatch) {
      k0[e] = coef[3 * gc + at + e], k1[e] = coef[4 * gc + at + e], k2[e] = 0.f;
    } else {
      k0[e] = coef[at + e], k1[e] = coef[gc + at + e], k2[e] = coef[2 * gc + at + e];
    }
  }
  const float inv_m = __fdiv_rn(1.f, (float)p.m);  // the chain's division by M, a multiplication by its reciprocal on the card
  const int64_t base = (int64_t)q.g * p.m * p.c + q.c0;
#pragma unroll 4
  for (int k = 0; k < p.run; ++k) {
    const int64_t row = q.row0 + (int64_t)k * p.rows + q.r;
    if (row >= p.m) break;
    const int64_t off = base + row * p.c;
    float xv[V], o[V];
    load(x + off, xv);
    if (MODE == kBwd) {
      float dv[V];
      load(dy + off, dv);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = __fadd_rn(__fmul_rn(dv[e], k0[e]), __fmul_rn(__fadd_rn(k2[e], __fmul_rn(k1[e], xv[e])), inv_m));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = __fadd_rn(__fmul_rn(xv[e], k0[e]), k1[e]);
    }
    store(out + off, o);
  }
}

bool plan_ok(const Plan& p, int vec) {
  if (p.groups < 1 || p.m < 1 || p.c < 1 || p.lanes < 1 || p.rows < 1 || p.run < 1 || p.run > kMaxRun || p.tiles < 1 || p.bands < 1) return false;
  if (vec < 1 || vec > kMaxVec || p.c % vec || p.lanes * p.rows > kThreads) return false;
  const int64_t width = (int64_t)p.lanes * vec, tile_rows = (int64_t)p.rows * p.run;
  if (p.bands * width < p.c || (p.bands - 1) * width >= p.c) return false;  // every channel in exactly one band
  if (p.tiles * tile_rows < p.m || (p.tiles - 1) * tile_rows >= p.m) return false;  // every row in exactly one tile
  return (int64_t)p.groups * p.bands * p.tiles < ((int64_t)1 << 31);
}

unsigned grid(const Plan& p) { return (unsigned)((int64_t)p.groups * p.bands * p.tiles); }
unsigned combine_grid(const Plan& p) { return (unsigned)((p.c + kCombine - 1) / kCombine); }

template <typename T, int V>
int launch_fwd(const void* x, void* y, const float* w, const float* beta, const float* rmean, const float* rvar, const float* prev_mean,
               const float* prev_var, int64_t prev_stride, float* st, float* step, float* part, const Plan& p, int batch, float eps,
               float keep, float take, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int threads = p.lanes * p.rows;
  if (!batch) {
    affine_kernel<T, V, kFwdRunning><<<grid(p), threads, 0, s>>>(xt, nullptr, yt, nullptr, w, beta, rmean, rvar, eps, p);
    return (int)cudaGetLastError();
  }
  sum_kernel<T, V, kStats><<<grid(p), threads, 0, s>>>(xt, nullptr, nullptr, nullptr, nullptr, nullptr, eps, part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_fwd_kernel<<<combine_grid(p), dim3(kCombine, kCombine), 0, s>>>(part, w, beta, prev_mean, prev_var, prev_stride, st, step, p, eps,
                                                                          keep, take);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  affine_kernel<T, V, kFwdBatch><<<grid(p), threads, 0, s>>>(xt, nullptr, yt, st, nullptr, nullptr, nullptr, nullptr, eps, p);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* x, const void* dy, void* dx, const float* w, const float* rmean, const float* rvar, const float* st, float* co,
               float* part, float* dw, float* dbeta, const Plan& p, int batch, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int threads = p.lanes * p.rows;
  if (batch) {
    sum_kernel<T, V, kGrad><<<grid(p), threads, 0, s>>>(xt, dyt, nullptr, nullptr, nullptr, nullptr, eps, part, p);
  } else {
    sum_kernel<T, V, kGradRunning><<<grid(p), threads, 0, s>>>(xt, dyt, dxt, w, rmean, rvar, eps, part, p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_bwd_kernel<<<combine_grid(p), dim3(kCombine, kCombine), 0, s>>>(part, w, st, rmean, rvar, co, dw, dbeta, p, eps, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess || !batch) return (int)err;
  affine_kernel<T, V, kBwd><<<grid(p), threads, 0, s>>>(xt, dyt, dxt, co, nullptr, nullptr, nullptr, nullptr, eps, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The four builds: fp32 and bf16, 16-byte vectors or one channel a thread.
#define BN_DISPATCH(CALL)                                         \
  if (dtype == 0 && vec == 4) return CALL(float, 4);              \
  if (dtype == 0 && vec == 1) return CALL(float, 1);              \
  if (dtype == 1 && vec == 8) return CALL(__nv_bfloat16, 8);      \
  if (dtype == 1 && vec == 1) return CALL(__nv_bfloat16, 1);      \
  return (int)cudaErrorInvalidValue;

// The forward: on batch statistics (batch = 1) the sum pass into part [2, G, tiles, C], the combine into st
// [6, G, C] and step [G, 2, C], and the affine into y; on running statistics the affine alone (st, step,
// part, prev unused).  x, y: [G, M, C] contiguous in one dtype (0 = float32, 1 = bfloat16), 16-byte aligned
// where vec > 1; every vector float32.  Returns a cudaError_t (0 = launched).
extern "C" int batch_norm_fwd(const void* x, void* y, const float* w, const float* beta, const float* rmean, const float* rvar,
                              const float* prev_mean, const float* prev_var, int64_t prev_stride, float* st, float* step, float* part,
                              int groups, int64_t m, int c, int vec, int lanes, int bands, int rows, int run, int tiles, int batch,
                              float eps, float keep, float take, int dtype, void* stream) {
  const Plan p{groups, m, c, lanes, bands, rows, run, tiles};
  if (!plan_ok(p, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BN_FWD(T, V) launch_fwd<T, V>(x, y, w, beta, rmean, rvar, prev_mean, prev_var, prev_stride, st, step, part, p, batch, eps, keep, take, s)
  BN_DISPATCH(BN_FWD)
#undef BN_FWD
}

// The backward: the sum pass over x and dy into part, the combine into dw, dbeta [C] (and on batch statistics
// the dx coefficients co [3, G, C] from st), then on batch statistics the dx pass; on running statistics the
// sum pass writes dx itself (st and co unused).
extern "C" int batch_norm_bwd(const void* x, const void* dy, void* dx, const float* w, const float* rmean, const float* rvar, const float* st,
                              float* co, float* part, float* dw, float* dbeta, int groups, int64_t m, int c, int vec, int lanes, int bands,
                              int rows, int run, int tiles, int batch, float eps, int dtype, void* stream) {
  const Plan p{groups, m, c, lanes, bands, rows, run, tiles};
  if (!plan_ok(p, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BN_BWD(T, V) launch_bwd<T, V>(x, dy, dx, w, rmean, rvar, st, co, part, dw, dbeta, p, batch, eps, s)
  BN_DISPATCH(BN_BWD)
#undef BN_BWD
}
