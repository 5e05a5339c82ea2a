// 3-D max-pool and average-pool backward as gathers, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package pools with flax's nn.max_pool
// (clip_fsar_tpu/models/video/blocks.py DownSampleStem, meta.py Inception3D)
// and nn.avg_pool (branches.py TAdaConvBlockAvgPool), and XLA computes their
// gradients deterministically.  PyTorch's CUDA backwards of max_pool3d and
// avg_pool3d scatter into the input gradient with atomics, so where the
// windows overlap the sums land in an order that changes from run to run and
// the port's train steps (MoSI's R-2D3D, S3D-G, TAdaConv's pooled branch) did
// not repeat bit for bit.  These kernels give every input element one owner.
//
//   max:  dx[n, c, i] = sum over the windows w that cover i, in a fixed order,
//                       of dy[n, c, w] where argmax[n, c, w] == i
//   avg:  dx[n, c, i] = sum over the same windows of dy[n, c, w] / (kd*kh*kw)
//         (count_include_pad: the divisor is the window's whole volume)
//
// argmax is the forward's flat index d*H*W + h*W + w within the (n, c) plane,
// as F.max_pool3d(..., return_indices=True) gives it: ATen's forward picks the
// first maximum of a window in window order, the rule XLA's select_and_scatter
// follows too.  Padding is by -inf (max) or zeros (avg), never selected.
//
// The order of the sum is the window offset (kd, kh, kw) ascending, which is
// the covering window (od, oh, ow) descending; the plain version in
// ops/pool3d.py adds its strided slices in the same order, in fp32, so the
// two agree to the bit in fp32.  Sums are fp32 and rounded once to the
// output's dtype (fp32 or bf16).
//
// What bounds it on an H100: bytes.  dy and argmax are read, dx written; a
// window's dy and argmax are read again by each input element it covers
// (2.25 times on average at (1,3,3)/(1,2,2), 27 times at (3,3,3)/1), but
// those repeats come from L1/L2, so the least time is dy + argmax + dx over
// the memory rate.
//
// Design: one thread per input element, in the memory order of dx (the
// channels-last order (n, d, h, w, c) for the port's channels_last_3d
// activations, else (n, c, d, h, w)), so that a warp's reads of dy and argmax
// and its write of dx fall on neighbouring addresses when those tensors share
// dx's layout.  dy and argmax are read at any strides; dy only where the
// argmax matches.  Index arithmetic is 32-bit wherever every offset fits.  No
// atomics, no shared memory; the kernel allocates nothing and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 64;  // grid-stride above this: 64 blocks for each of the card's SMs

struct Shape {
  int64_t n, c, d, h, w;
};
struct Strides {
  int64_t n, c, d, h, w;
};
struct Window {
  int od, oh, ow;  // output extents
  int kd, kh, kw, sd, sh, sw, pd, ph, pw;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The windows o along one axis that cover input position i: o*s - p <= i <= o*s - p + k - 1.
__device__ __forceinline__ void covering(int i, int k, int s, int p, int out, int& lo, int& hi) {
  const int a = i + p - k + 1;
  lo = a <= 0 ? 0 : (a + s - 1) / s;
  hi = min((i + p) / s, out - 1);
}

// Index is int32_t when every element offset fits (the div/mod that place a thread are then 32-bit: 64-bit division
// is emulated in software and would dominate the kernel), else int64_t.
template <typename T, bool kMax, typename Index>
__global__ void __launch_bounds__(kThreads) pool3d_bwd_kernel(const T* __restrict__ dy, const int64_t* __restrict__ argmax,
                                                              T* __restrict__ dx, Shape x64, Window win, Strides sy64,
                                                              Strides si64, Strides sx64, int channels_last, float volume) {
  const Index N = (Index)x64.n, C = (Index)x64.c, D = (Index)x64.d, H = (Index)x64.h, W = (Index)x64.w;
  const Index total = N * C * D * H * W;
  const Index syn = (Index)sy64.n, syc = (Index)sy64.c, syd = (Index)sy64.d, syh = (Index)sy64.h, syw = (Index)sy64.w;
  const Index sin = (Index)si64.n, sic = (Index)si64.c, sid = (Index)si64.d, sih = (Index)si64.h, siw = (Index)si64.w;
  const Index sxn = (Index)sx64.n, sxc = (Index)sx64.c, sxd = (Index)sx64.d, sxh = (Index)sx64.h, sxw = (Index)sx64.w;
  for (Index e = (Index)blockIdx.x * kThreads + threadIdx.x; e < total; e += (Index)gridDim.x * kThreads) {
    Index r = e, n, c, d, h, w;
    if (channels_last) {
      c = r % C, r /= C;
      w = r % W, r /= W;
      h = r % H, r /= H;
      d = r % D, n = r / D;
    } else {
      w = r % W, r /= W;
      h = r % H, r /= H;
      d = r % D, r /= D;
      c = r % C, n = r / C;
    }
    int d0, d1, h0, h1, w0, w1;
    covering((int)d, win.kd, win.sd, win.pd, win.od, d0, d1);
    covering((int)h, win.kh, win.sh, win.ph, win.oh, h0, h1);
    covering((int)w, win.kw, win.sw, win.pw, win.ow, w0, w1);
    const int64_t flat = ((int64_t)d * H + h) * W + w;
    const T* gy = dy + (n * syn + c * syc);
    const int64_t* gi = kMax ? argmax + (n * sin + c * sic) : nullptr;
    float acc = 0.f;
    for (int od = d1; od >= d0; --od) {
      for (int oh = h1; oh >= h0; --oh) {
        for (int ow = w1; ow >= w0; --ow) {
          const Index at_y = od * syd + oh * syh + ow * syw;
          if (kMax) {
            if (gi[od * sid + oh * sih + ow * siw] == flat) acc += to_float(gy[at_y]);  // dy is read only where it lands
          } else {
            acc += to_float(gy[at_y]) / volume;  // IEEE division (no fast math), as the plain version's
          }
        }
      }
    }
    store(dx + (n * sxn + c * sxc + d * sxd + h * sxh + w * sxw), acc);
  }
}

template <typename T, typename Index>
void launch_typed(int mode, const void* dy, const void* argmax, void* dx, Shape x, Window win, Strides sy, Strides si,
                  Strides sx, int channels_last, int blocks, cudaStream_t stream) {
  const T* y = static_cast<const T*>(dy);
  T* out = static_cast<T*>(dx);
  if (mode == 0) {
    pool3d_bwd_kernel<T, true, Index><<<blocks, kThreads, 0, stream>>>(y, static_cast<const int64_t*>(argmax), out, x, win, sy, si,
                                                                        sx, channels_last, 1.f);
  } else {
    const float volume = (float)(win.kd * win.kh * win.kw);
    pool3d_bwd_kernel<T, false, Index><<<blocks, kThreads, 0, stream>>>(y, nullptr, out, x, win, sy, si, sx, channels_last, volume);
  }
}

// the largest element offset a tensor of these extents and strides reaches
int64_t reach(Shape x, int od, int oh, int ow, Strides s, bool input) {
  const int64_t d = input ? x.d : od, h = input ? x.h : oh, w = input ? x.w : ow;
  return (x.n - 1) * s.n + (x.c - 1) * s.c + (d - 1) * s.d + (h - 1) * s.h + (w - 1) * s.w;
}

template <typename T>
int launch(int mode, const void* dy, const void* argmax, void* dx, Shape x, Window win, Strides sy, Strides si, Strides sx,
           int channels_last, cudaStream_t stream) {
  const int64_t total = x.n * x.c * x.d * x.h * x.w;
  if (total == 0) return 0;
  const int64_t need = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(need < kMaxBlocks ? need : kMaxBlocks);
  const int64_t limit = INT32_MAX - (int64_t)kMaxBlocks * kThreads;  // e and its grid-stride step stay below 2^31
  const bool small = total < limit && reach(x, win.od, win.oh, win.ow, sy, false) < limit && reach(x, 0, 0, 0, sx, true) < limit &&
                     (mode != 0 || reach(x, win.od, win.oh, win.ow, si, false) < limit);
  if (small) {
    launch_typed<T, int32_t>(mode, dy, argmax, dx, x, win, sy, si, sx, channels_last, blocks, stream);
  } else {
    launch_typed<T, int64_t>(mode, dy, argmax, dx, x, win, sy, si, sx, channels_last, blocks, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 = max (argmax read), 1 = average (count_include_pad; argmax unused).  dtype: 0 = float32, 1 = bfloat16.
// x: the input's (N, C, D, H, W); out: the output's (D, H, W); then kernel, stride, padding (d, h, w); then the
// (n, c, d, h, w) element strides of dy, argmax and dx.  Returns a cudaError_t (0 = launched).
extern "C" int pool3d_bwd(const void* dy, const void* argmax, void* dx, int mode, int dtype, int64_t n, int64_t c, int64_t d,
                          int64_t h, int64_t w, int od, int oh, int ow, int kd, int kh, int kw, int sd, int sh, int sw, int pd,
                          int ph, int pw, int64_t sy_n, int64_t sy_c, int64_t sy_d, int64_t sy_h, int64_t sy_w, int64_t si_n,
                          int64_t si_c, int64_t si_d, int64_t si_h, int64_t si_w, int64_t sx_n, int64_t sx_c, int64_t sx_d,
                          int64_t sx_h, int64_t sx_w, int channels_last, void* stream) {
  if ((mode != 0 && mode != 1) || kd < 1 || kh < 1 || kw < 1 || sd < 1 || sh < 1 || sw < 1 || pd < 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  const Shape x{n, c, d, h, w};
  const Window win{od, oh, ow, kd, kh, kw, sd, sh, sw, pd, ph, pw};
  const Strides sy{sy_n, sy_c, sy_d, sy_h, sy_w}, si{si_n, si_c, si_d, si_h, si_w}, sx{sx_n, sx_c, sx_d, sx_h, sx_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(mode, dy, argmax, dx, x, win, sy, si, sx, channels_last, s);
  if (dtype == 1) return launch<__nv_bfloat16>(mode, dy, argmax, dx, x, win, sy, si, sx, channels_last, s);
  return (int)cudaErrorInvalidValue;
}
