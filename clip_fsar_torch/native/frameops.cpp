// Fused video-frame preprocessing for the host input pipeline.
//
// Replaces the per-frame Python/cv2 loop in the episode loader with one
// C++ pass over a whole [T, H, W, 3] uint8 clip: separable fixed-point
// bilinear resize (cv2 half-pixel convention) fused with crop and
// optional horizontal flip — only pixels inside the crop window are ever
// computed, and the horizontal pass is cached per source row.
// Parallelized over frames with OpenMP when cores are available.
//
// Copy of clip_fsar_tpu/native/frameops.cpp, so that the port needs nothing of
// that package.  It stands in for the reference's native decode/transform
// dependencies (decord + torchvision _transforms_video).
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp frameops.cpp -o libframeops.so
// Binding: ctypes (clip_fsar_torch/native/frameops.py, which also builds it).

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kFracBits = 8;          // 8-bit fixed-point weights
constexpr int kOne = 1 << kFracBits;  // 256

struct Tap {
    int32_t lo3;   // source index * 3 (lo)
    int32_t hi3;   // source index * 3 (hi)
    int32_t w_hi;  // fixed-point weight of hi in [0, 256]
};

static void make_taps(int src, int dst, int begin, int count, Tap* taps) {
    const double scale = static_cast<double>(src) / static_cast<double>(dst);
    for (int i = 0; i < count; ++i) {
        double s = (static_cast<double>(begin + i) + 0.5) * scale - 0.5;
        if (s < 0.0) s = 0.0;
        int lo = static_cast<int>(s);
        if (lo > src - 1) lo = src - 1;
        int hi = std::min(lo + 1, src - 1);
        int w = static_cast<int>((s - lo) * kOne + 0.5);
        taps[i] = Tap{lo * 3, hi * 3, w};
    }
}

// Horizontal pass: one source row [w*3] u8 -> cropped resized row
// [crop_w*3] u16 (value * 256).
static void hresize_row(const uint8_t* src, const Tap* xtaps, int crop_w, uint16_t* dst) {
    for (int x = 0; x < crop_w; ++x) {
        const Tap t = xtaps[x];
        const int wl = kOne - t.w_hi, wh = t.w_hi;
        const uint8_t* pl = src + t.lo3;
        const uint8_t* ph = src + t.hi3;
        uint16_t* o = dst + x * 3;
        o[0] = static_cast<uint16_t>(wl * pl[0] + wh * ph[0]);
        o[1] = static_cast<uint16_t>(wl * pl[1] + wh * ph[1]);
        o[2] = static_cast<uint16_t>(wl * pl[2] + wh * ph[2]);
    }
}

}  // namespace

extern "C" {

// Resize a [T, H, W, 3] uint8 clip to [T, out_h, out_w, 3], take the
// [crop_h, crop_w] window at (crop_y, crop_x), optionally flip
// horizontally.  out must hold T * crop_h * crop_w * 3 bytes.
int clip_resize_crop_flip(const uint8_t* in, int t, int h, int w,
                          int out_h, int out_w,
                          int crop_y, int crop_x, int crop_h, int crop_w,
                          int flip, uint8_t* out) {
    if (crop_y < 0 || crop_x < 0 || crop_y + crop_h > out_h || crop_x + crop_w > out_w)
        return -1;

    Tap* ytaps = new Tap[crop_h];
    Tap* xtaps = new Tap[crop_w];
    make_taps(h, out_h, crop_y, crop_h, ytaps);
    make_taps(w, out_w, crop_x, crop_w, xtaps);
    // fold the horizontal flip into the x taps (output written in order)
    if (flip) std::reverse(xtaps, xtaps + crop_w);
    // ytaps carry row indices (not *3)
    for (int y = 0; y < crop_h; ++y) {
        ytaps[y].lo3 /= 3;
        ytaps[y].hi3 /= 3;
    }

    const int64_t in_frame = static_cast<int64_t>(h) * w * 3;
    const int64_t out_frame = static_cast<int64_t>(crop_h) * crop_w * 3;
    const int row_elems = crop_w * 3;

#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (t > 1)
#endif
    for (int f = 0; f < t; ++f) {
        const uint8_t* src = in + f * in_frame;
        uint8_t* dst = out + f * out_frame;
        // rolling cache of two horizontally-resized source rows
        uint16_t* rows = new uint16_t[2 * row_elems];
        int cached[2] = {-1, -1};
        for (int y = 0; y < crop_h; ++y) {
            const int slo = ytaps[y].lo3, shi = ytaps[y].hi3;
            uint16_t* rlo;
            uint16_t* rhi;
            // find/compute the two source rows in the cache
            int slot_lo = (cached[0] == slo) ? 0 : (cached[1] == slo ? 1 : -1);
            if (slot_lo < 0) {
                slot_lo = (cached[0] == shi) ? 1 : 0;  // don't evict shi
                hresize_row(src + static_cast<int64_t>(slo) * w * 3, xtaps, crop_w, rows + slot_lo * row_elems);
                cached[slot_lo] = slo;
            }
            rlo = rows + slot_lo * row_elems;
            int slot_hi = (cached[0] == shi) ? 0 : (cached[1] == shi ? 1 : -1);
            if (slot_hi < 0) {
                slot_hi = 1 - slot_lo;
                hresize_row(src + static_cast<int64_t>(shi) * w * 3, xtaps, crop_w, rows + slot_hi * row_elems);
                cached[slot_hi] = shi;
            }
            rhi = rows + slot_hi * row_elems;

            const uint32_t wy = static_cast<uint32_t>(ytaps[y].w_hi);
            const uint32_t wly = kOne - wy;
            uint8_t* orow = dst + static_cast<int64_t>(y) * row_elems;
            // contiguous u16 blend — autovectorizes
            for (int i = 0; i < row_elems; ++i) {
                uint32_t v = wly * rlo[i] + wy * rhi[i];  // value * 256 * 256
                orow[i] = static_cast<uint8_t>((v + (1u << 15)) >> 16);
            }
        }
        delete[] rows;
    }

    delete[] ytaps;
    delete[] xtaps;
    return 0;
}

// Plain whole-clip resize (crop == full output).
int clip_resize(const uint8_t* in, int t, int h, int w, int out_h, int out_w, uint8_t* out) {
    return clip_resize_crop_flip(in, t, h, w, out_h, out_w, 0, 0, out_h, out_w, 0, out);
}

int frameops_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
