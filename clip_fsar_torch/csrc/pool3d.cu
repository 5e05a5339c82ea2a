// 3-D max-pool and average-pool backward as gathers over tiles staged in shared memory, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package pools with flax's nn.max_pool
// (clip_fsar_tpu/models/video/blocks.py DownSampleStem, meta.py Inception3D)
// and nn.avg_pool (branches.py TAdaConvBlockAvgPool), and XLA computes their
// gradients deterministically.  PyTorch's CUDA backwards of max_pool3d and
// avg_pool3d scatter into the input gradient with atomics, so where the
// windows overlap the sums land in an order that changes from run to run and
// the port's train steps (MoSI's R-2D3D, S3D-G, TAdaConv's pooled branch) did
// not repeat bit for bit.  This kernel gives every input element one owner.
//
//   max:  dx[n, c, i] = sum over the windows w that cover i, in a fixed order,
//                       of dy[n, c, w] where argmax[n, c, w] == i
//   avg:  dx[n, c, i] = sum over the same windows of dy[n, c, w] / (kd*kh*kw)
//         (count_include_pad: the divisor is the window's whole volume)
//
// argmax is the forward's flat index d*H*W + h*W + w within the (n, c) plane,
// as F.max_pool3d(..., return_indices=True) gives it: ATen's forward picks the
// first maximum of a window in window order, the rule XLA's select_and_scatter
// follows too.  Padding is by -inf (max) or zeros (avg), never selected.  The
// wrapper refuses planes of 2^31 elements or more, so the kernel compares the
// argmax's low 32 bits.
//
// The order of the sum is the window offset (kd, kh, kw) ascending, which is
// the covering window (od, oh, ow) descending; the plain version in
// ops/pool3d.py adds its strided slices in the same order, in fp32, so the
// two agree to the bit.  Sums are fp32 and rounded once to the output's dtype
// (fp32 or bf16).
//
// Layout.  The kernel reads dy and argmax in dx's own layout, which the
// wrapper makes them take: channels-last (n, d, h, w, c), the layout of the
// port's channels_last_3d activations, or NCDHW, which is the channels-last
// layout of N*C planes of one channel.  So the kernel sees one layout,
// [N', D, H, W, C'].
//
// What bounds it on an H100: bytes.  dy and argmax are read, dx written (1.30
// GB at MoSI's stem, 0.39 ms at 3.35 TB/s).  The first design (one thread an
// input element, 5.40 ms there) was held by integer work, not bytes: every
// thread placed itself by four div/mod pairs by runtime extents, found its
// covering windows by six divisions by the stride, and read each window's
// argmax and dy on its own through L1/L2, again for every element the window
// covers (2.25 times on average at (1,3,3)/(1,2,2), 27 at (3,3,3)/1).
//
// Design: a block owns a tile of dx: TD x TH x TW positions of one n and CB
// channels (the host picks the tile, ops/pool3d.py tile_plan, so that the
// block's box fits its shared memory).  It places itself from blockIdx once,
// computes once the covering windows of each of its positions along each axis
// (tables in shared memory, relative to the box), and copies the box of dy and
// argmax that those windows span, halo included, into shared memory as
// coalesced 16-byte cp.async copies: each window's dy and argmax come from
// device memory once per block.  Threads then walk the tile's (position,
// channel vector) elements, split by multiply-high divisions fixed for the
// launch, each owning 16 bytes of channels (8 bf16 or 4 fp32; one element
// where C' is not a multiple of that or a pointer is not 16-byte aligned), and
// read every covering window from shared memory; the argmax reads start at a
// lane-rotated 16-byte word so that a quarter-warp's loads hit distinct banks.
// dx is written as one 16-byte vector a thread.  No atomics; the kernel
// allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMax = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kPlanInts = 24;

// Division by a divisor fixed for the launch as a multiply-high and a shift (dividends in [0, 2^31)).
struct FastDiv {
  unsigned d, mul, shift;
};

FastDiv fast_div(int d) {
  FastDiv f{(unsigned)d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < (unsigned)d) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
    f.shift = p - 32;
  }
  return f;
}

__device__ __forceinline__ int divmod(int x, const FastDiv& f, int& rem) {
  const int q = f.d > 1 ? (int)(__umulhi((unsigned)x, f.mul) >> f.shift) : x;
  rem = x - q * (int)f.d;
  return q;
}

struct Geo {
  int C, D, H, W;  // the channels-last view [N', D, H, W, C']
  int OD, OH, OW;
  int kd, kh, kw, sd, sh, sw, pd, ph, pw;
  int TD, TH, TW, CB;  // a block's tile: TD x TH x TW positions of one n', CB channels
  int BD, BH, BW;  // the box in shared memory: the most covering windows of a tile along each axis
  int tile_elems;  // TD * TH * TW * (CB / VEC)
  FastDiv tiles_w, tiles_h, tiles_d, tiles_c;  // blockIdx -> (n', c-block, d, h, w tile)
  FastDiv nv, tw, th;  // tile element -> (channel vector, w, h, d)
  FastDiv chunks_y, chunks_i, bw, bh;  // staged copy -> (box row, position, channel chunk)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive elements of T as floats, and back (16 bytes when VEC > 1).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 two = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      f[2 * i] = two.x, f[2 * i + 1] = two.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) p[0] = f[0];
    else p[0] = __float2bfloat16(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint4 v;
    unsigned* words = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      words[i] = *reinterpret_cast<const unsigned*>(&two);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory"); }

// The windows o along one axis that cover input position i: o*s - p <= i <= o*s - p + k - 1.
__device__ __forceinline__ void covering(int i, int k, int s, int p, int out, int& lo, int& hi) {
  const int a = i + p - k + 1;
  lo = a <= 0 ? 0 : (a + s - 1) / s;
  hi = min((i + p) / s, out - 1);
}

// Copy the box rows [lo, lo + count) along each axis of one tensor ([N', OD, OH, OW, C'] elements of E) into
// shared memory [BD][BH][BW][CB], CPC elements a copy (16 bytes by cp.async when CPC > 1, else one element).
template <typename E, int CPC>
__device__ __forceinline__ void stage(E* dst, const E* src, const Geo& g, const FastDiv& chunks, int n, int c0, int nc, int od0, int bd,
                                      int oh0, int bh, int ow0, int bw) {
  const int total = g.BD * g.BH * g.BW * (int)chunks.d;
  for (int j = threadIdx.x; j < total; j += kThreads) {
    int q, rw, rh;
    const int pos = divmod(j, chunks, q);
    const int row = divmod(pos, g.bw, rw);
    const int rd = divmod(row, g.bh, rh);
    if (rd >= bd || rh >= bh || rw >= bw || q * CPC >= nc) continue;
    const int64_t at = ((((int64_t)n * g.OD + od0 + rd) * g.OH + oh0 + rh) * g.OW + ow0 + rw) * g.C + c0 + q * CPC;
    E* to = dst + pos * g.CB + q * CPC;
    if constexpr (CPC > 1) {
      cp_async_16(to, src + at);
    } else {
      *to = src[at];
    }
  }
}

template <typename T, bool kMax, int VEC>
__global__ void __launch_bounds__(kThreads) pool3d_bwd_kernel(const T* __restrict__ dy, const int64_t* __restrict__ argmax,
                                                              T* __restrict__ dx, Geo g, float volume) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int box = g.BD * g.BH * g.BW * g.CB;
  int64_t* s_arg = reinterpret_cast<int64_t*>(smem);  // [BD][BH][BW][CB] (max only)
  T* s_dy = reinterpret_cast<T*>(smem + (kMax ? (size_t)box * 8 : 0));  // [BD][BH][BW][CB]
  int2* tab = reinterpret_cast<int2*>(smem + (kMax ? (size_t)box * 8 : 0) + (((size_t)box * sizeof(T) + 15) & ~(size_t)15));

  // place the block once: blockIdx.x = (((n' * tiles_c + c-block) * tiles_d + d tile) * tiles_h + h tile) * tiles_w + w tile
  int tw_i, th_i, td_i, tc_i;
  int r = divmod((int)blockIdx.x, g.tiles_w, tw_i);
  r = divmod(r, g.tiles_h, th_i);
  r = divmod(r, g.tiles_d, td_i);
  const int n = divmod(r, g.tiles_c, tc_i);
  const int d0 = td_i * g.TD, h0 = th_i * g.TH, w0 = tw_i * g.TW, c0 = tc_i * g.CB;
  const int nd = min(g.TD, g.D - d0), nh = min(g.TH, g.H - h0), nw = min(g.TW, g.W - w0), nc = min(g.CB, g.C - c0);

  // the box: the windows that cover the tile's first to last position along each axis
  int od0, od1, oh0, oh1, ow0, ow1, unused;
  covering(d0, g.kd, g.sd, g.pd, g.OD, od0, unused);
  covering(d0 + nd - 1, g.kd, g.sd, g.pd, g.OD, unused, od1);
  covering(h0, g.kh, g.sh, g.ph, g.OH, oh0, unused);
  covering(h0 + nh - 1, g.kh, g.sh, g.ph, g.OH, unused, oh1);
  covering(w0, g.kw, g.sw, g.pw, g.OW, ow0, unused);
  covering(w0 + nw - 1, g.kw, g.sw, g.pw, g.OW, unused, ow1);
  const int bd = od1 - od0 + 1, bh = oh1 - oh0 + 1, bw = ow1 - ow0 + 1;

  if (bd > 0 && bh > 0 && bw > 0) {
    if (kMax) stage<int64_t, (VEC > 1 ? 2 : 1)>(s_arg, argmax, g, g.chunks_i, n, c0, nc, od0, bd, oh0, bh, ow0, bw);
    stage<T, VEC>(s_dy, dy, g, g.chunks_y, n, c0, nc, od0, bd, oh0, bh, ow0, bw);
  }
  // each position's covering windows along each axis, relative to the box: (first, last)
  for (int i = threadIdx.x; i < g.TD + g.TH + g.TW; i += kThreads) {
    int lo, hi;
    if (i < g.TD) {
      covering(d0 + i, g.kd, g.sd, g.pd, g.OD, lo, hi);
      tab[i] = make_int2(lo - od0, hi - od0);
    } else if (i < g.TD + g.TH) {
      covering(h0 + i - g.TD, g.kh, g.sh, g.ph, g.OH, lo, hi);
      tab[i] = make_int2(lo - oh0, hi - oh0);
    } else {
      covering(w0 + i - g.TD - g.TH, g.kw, g.sw, g.pw, g.OW, lo, hi);
      tab[i] = make_int2(lo - ow0, hi - ow0);
    }
  }
  if (VEC > 1) cp_async_wait_all();
  __syncthreads();

  const int rot = (threadIdx.x * VEC) >> 4;  // a quarter-warp's argmax loads start on distinct 16-byte words
  for (int j = threadIdx.x; j < g.tile_elems; j += kThreads) {
    int v, w, h;
    int rest = divmod(j, g.nv, v);
    rest = divmod(rest, g.tw, w);
    const int d = divmod(rest, g.th, h);
    if (d >= nd || h >= nh || w >= nw || v * VEC >= nc) continue;
    const int2 cd = tab[d], ch = tab[g.TD + h], cw = tab[g.TD + g.TH + w];
    const int flat = ((d0 + d) * g.H + h0 + h) * g.W + w0 + w;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int od = cd.y; od >= cd.x; --od) {
      for (int oh = ch.y; oh >= ch.x; --oh) {
        const int row = (od * g.BH + oh) * g.BW;
        for (int ow = cw.y; ow >= cw.x; --ow) {
          const int at = (row + ow) * g.CB + v * VEC;
          float y[VEC];
          load_vec<T, VEC>(s_dy + at, y);
          if (kMax) {
            unsigned hits = 0;
            if constexpr (VEC > 1) {
#pragma unroll
              for (int p = 0; p < VEC / 2; ++p) {
                const int q = (p + rot) & (VEC / 2 - 1);
                const int4 m = *reinterpret_cast<const int4*>(s_arg + at + 2 * q);
                hits |= (unsigned)(m.x == flat) << (2 * q) | (unsigned)(m.z == flat) << (2 * q + 1);
              }
            } else {
              hits = (int)s_arg[at] == flat;
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] += (hits >> i & 1u) ? y[i] : 0.f;
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] += y[i] / volume;  // IEEE division (no fast math), as the plain version's
          }
        }
      }
    }
    store_vec<T, VEC>(dx + ((((int64_t)n * g.D + d0 + d) * g.H + h0 + h) * g.W + w0 + w) * g.C + c0 + v * VEC, acc);
  }
}

// The dynamic shared memory one kernel instance was allowed on each device so far.
struct SharedAllowance {
  static constexpr int kDevices = 64;
  std::mutex lock;
  int bytes[kDevices] = {};
};

// Allow `kernel` `smem` bytes of dynamic shared memory on the current device.  cudaFuncSetAttribute is called only
// where a launch needs more than the instance was allowed there before: the call costs the launch thread
// microseconds, as long as the card takes for a small pool.
cudaError_t allow_shared(const void* kernel, SharedAllowance& allowed, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(allowed.lock);
  if (dev < SharedAllowance::kDevices && allowed.bytes[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < SharedAllowance::kDevices) allowed.bytes[dev] = smem;
  return err;
}

template <typename T, bool kMax, int VEC>
int launch_typed(const void* dy, const void* argmax, void* dx, const Geo& g, int blocks, int smem, float volume, cudaStream_t stream) {
  auto kernel = pool3d_bwd_kernel<T, kMax, VEC>;
  static SharedAllowance allowed;  // one for each instance
  const cudaError_t err = allow_shared(reinterpret_cast<const void*>(kernel), allowed, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(dy), static_cast<const int64_t*>(argmax), static_cast<T*>(dx), g, volume);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, int vec, const void* dy, const void* argmax, void* dx, const Geo& g, int blocks, int smem, cudaStream_t stream) {
  const float volume = (float)(g.kd * g.kh * g.kw);
  constexpr int kVec = 16 / (int)sizeof(T);
  if (mode == 0) {
    return vec == 1 ? launch_typed<T, true, 1>(dy, argmax, dx, g, blocks, smem, 1.f, stream)
                    : launch_typed<T, true, kVec>(dy, argmax, dx, g, blocks, smem, 1.f, stream);
  }
  return vec == 1 ? launch_typed<T, false, 1>(dy, argmax, dx, g, blocks, smem, volume, stream)
                  : launch_typed<T, false, kVec>(dy, argmax, dx, g, blocks, smem, volume, stream);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// mode: 0 = max (argmax read), 1 = average (count_include_pad; argmax unused).  dtype: 0 = float32, 1 = bfloat16.
// vec: the elements a thread owns, 16 / sizeof(dtype) or 1.  plan (host memory, 24 ints): the channels-last view
// (N', C', D, H, W) of dx, dy and argmax, all three dense in it; the output's (OD, OH, OW); kernel, stride and
// padding (d, h, w); the tile (TD, TH, TW, CB) and its box (BD, BH, BW), as ops/pool3d.py tile_plan gives them.
// Returns a cudaError_t (0 = launched).
extern "C" int pool3d_bwd(const void* dy, const void* argmax, void* dx, int mode, int dtype, int vec, const int* plan, void* stream) {
  int p[kPlanInts];
  for (int i = 0; i < kPlanInts; ++i) p[i] = plan[i];
  const int N = p[0];
  Geo g{};
  g.C = p[1], g.D = p[2], g.H = p[3], g.W = p[4], g.OD = p[5], g.OH = p[6], g.OW = p[7];
  g.kd = p[8], g.kh = p[9], g.kw = p[10], g.sd = p[11], g.sh = p[12], g.sw = p[13], g.pd = p[14], g.ph = p[15], g.pw = p[16];
  g.TD = p[17], g.TH = p[18], g.TW = p[19], g.CB = p[20], g.BD = p[21], g.BH = p[22], g.BW = p[23];
  const int esize = dtype == 0 ? 4 : 2;
  const bool bad_geometry = (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1) || N < 0 || g.C < 1 || g.D < 1 || g.H < 1 || g.W < 1 ||
                            g.OD < 1 || g.OH < 1 || g.OW < 1 || g.kd < 1 || g.kh < 1 || g.kw < 1 || g.sd < 1 || g.sh < 1 ||
                            g.sw < 1 || g.pd < 0 || g.ph < 0 || g.pw < 0 || g.TD < 1 || g.TH < 1 || g.TW < 1 || g.CB < 1 ||
                            g.BD < 1 || g.BH < 1 || g.BW < 1 || (int64_t)g.D * g.H * g.W >= INT32_MAX;
  if (bad_geometry) return (int)cudaErrorInvalidValue;
  // the box must hold the covering windows of any TD (TH, TW) consecutive positions
  if (g.BD < (int)std::min<int64_t>(g.OD, (g.TD + g.kd - 2) / g.sd + 1) || g.BH < (int)std::min<int64_t>(g.OH, (g.TH + g.kh - 2) / g.sh + 1) ||
      g.BW < (int)std::min<int64_t>(g.OW, (g.TW + g.kw - 2) / g.sw + 1))
    return (int)cudaErrorInvalidValue;
  const bool vector_ok = vec == 16 / esize && g.C % vec == 0 && g.CB % vec == 0 && ((uintptr_t)dy & 15) == 0 && ((uintptr_t)dx & 15) == 0 &&
                         (mode != 0 || ((uintptr_t)argmax & 15) == 0);
  if (vec != 1 && !vector_ok) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int64_t box = (int64_t)g.BD * g.BH * g.BW * g.CB;
  const int64_t smem = (mode == 0 ? box * 8 : 0) + ((box * esize + 15) & ~(int64_t)15) + (int64_t)(g.TD + g.TH + g.TW) * 8;
  const int64_t tiles_c = ceil_div(g.C, g.CB), tiles_d = ceil_div(g.D, g.TD), tiles_h = ceil_div(g.H, g.TH), tiles_w = ceil_div(g.W, g.TW);
  const int64_t blocks = (int64_t)N * tiles_c * tiles_d * tiles_h * tiles_w;
  const int64_t elems = (int64_t)g.TD * g.TH * g.TW * (g.CB / vec);
  if (smem > kSharedMax || blocks >= INT32_MAX || elems >= INT32_MAX || box >= INT32_MAX) return (int)cudaErrorInvalidValue;
  g.tile_elems = (int)elems;
  g.tiles_w = fast_div((int)tiles_w), g.tiles_h = fast_div((int)tiles_h), g.tiles_d = fast_div((int)tiles_d), g.tiles_c = fast_div((int)tiles_c);
  g.nv = fast_div(g.CB / vec), g.tw = fast_div(g.TW), g.th = fast_div(g.TH);
  g.chunks_y = fast_div(g.CB / vec), g.chunks_i = fast_div(vec > 1 ? g.CB / 2 : g.CB), g.bw = fast_div(g.BW), g.bh = fast_div(g.BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(mode, vec, dy, argmax, dx, g, (int)blocks, (int)smem, s);
  return launch<__nv_bfloat16>(mode, vec, dy, argmax, dx, g, (int)blocks, (int)smem, s);
}
