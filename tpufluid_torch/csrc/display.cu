// The display composite, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/display.py:262 `_kernel` (entered through
// display_pallas, :387, and resample_shade_pallas, :518). The TPU kernel
// streams source row windows through VMEM per output row tile and gathers
// columns within 128-lane groups, so it refuses output widths that are not a
// multiple of 128; here one thread per output texel reads global memory
// where its taps land, at any output size (the demo's 512x910 capture, the
// server's 360x640 tick).
//
// Per output texel, C <= 4 dye channels (read in their storage type, which
// widens to float32 exactly):
//   1. the dye's center tap; with shading, the diffuse term of the four
//      1-display-texel neighbors' channel norms (ops/display.shaded_base).
//      Stage order per tap, as the plain version: center, left and right
//      take rows first, then columns; top and bottom columns first, then
//      rows; every other sample (bloom, sunrays, dither, the unshaded
//      center) columns first. tx, ty and nz = sqrt(float32(tx^2 + ty^2))
//      come from the caller, computed as the plain version computes them;
//      1/sqrt, not rsqrtf, as the plain version.
//   2. compose = 1 (ops/display.display_composite): x sunrays; bloom x
//      sunrays + (2 * dither - 1) / 255 (dither 64x64 REPEAT at
//      uv * target/texture size, scales from the caller), then
//      max(1.055 * powf(b, 0.416666667) - 0.055, 0); added to the color;
//      alpha = max over channels -> (C + 1, oh, ow) premultiplied RGBA.
//      compose = 0: the (C, oh, ow) shaded center alone.
// Every sampling coordinate is recomputed per thread (common.cuh axis_tap).
//
// Bound: bytes. Demo (f32 dye 1024x1820 -> 720x1280): 22.4 MB of dye,
// 1.4 MB of bloom, 0.27 MB of sunrays, 14.7 MB of RGBA written, 38.8 MB in
// all (11.6 us at 3.35 TB/s); 1024x1024 (bf16 dye): 6.3 + 0.8 + 0.15 +
// 16.8 = 24 MB (7.2 us). About 410 float32 operations per texel with
// every option on (5.6 us of the 67 TFLOP/s at 720x1280). The shading taps
// of neighbouring threads share corners, which L1 serves. Left for later:
// staging the dye rows of a block in shared memory and vector loads.
#include "common.cuh"

constexpr int kMaxChannels = 4;
constexpr float kGammaExponent = 0.416666667f;

template <typename T>
struct Plane {
    const T* p;
    int w;
    __device__ __forceinline__ float operator()(int y, int x) const {
        return to_f32(p[y * w + x]);
    }
};

__device__ __forceinline__ float linear_to_gamma(float c) {
    c = fmaxf(c, 0.0f);
    return fmaxf(1.055f * powf(c, kGammaExponent) - 0.055f, 0.0f);
}

struct Extras {
    const float* bloom;  // (3, bh, bw) or null
    int bh, bw;
    const float* sunrays;  // (sh, sw) or null
    int sh, sw;
    const float* dither;  // (dh, dw) or null; used only with bloom
    int dh, dw;
    float dsu, dsv;  // dither scales, out_w / dw and out_h / dh
};

template <typename T>
__global__ void display_kernel(const T* __restrict__ dye, int C, int H, int W,
                               float* __restrict__ out, int oh, int ow, int shading,
                               int compose, float tx, float ty, float nz, Extras ex) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= oh || j >= ow) return;
    const int hw = H * W, ohw = oh * ow, at = i * ow + j;

    const AxisTap row = axis_tap(i, H, oh, 1.0f, 0.0f, false);
    const AxisTap col = axis_tap(j, W, ow, 1.0f, 0.0f, false);
    float c[kMaxChannels];
    if (!shading) {
        for (int k = 0; k < C; ++k) c[k] = sample_cols_rows(Plane<T>{dye + k * hw, W}, row, col);
    } else {
        const AxisTap left = axis_tap(j, W, ow, 1.0f, -tx, false);
        const AxisTap right = axis_tap(j, W, ow, 1.0f, tx, false);
        const AxisTap above = axis_tap(i, H, oh, 1.0f, ty, false);
        const AxisTap below = axis_tap(i, H, oh, 1.0f, -ty, false);
        float nl = 0.0f, nr = 0.0f, nt = 0.0f, nb = 0.0f;
        for (int k = 0; k < C; ++k) {
            const Plane<T> plane{dye + k * hw, W};
            c[k] = sample_rows_cols(plane, row, col);
            const float l = sample_rows_cols(plane, row, left);
            const float r = sample_rows_cols(plane, row, right);
            const float t = sample_cols_rows(plane, above, col);
            const float b = sample_cols_rows(plane, below, col);
            // channel 0 starts each sum: x0*x0, then + xk*xk in order
            nl = k ? nl + l * l : l * l;
            nr = k ? nr + r * r : r * r;
            nt = k ? nt + t * t : t * t;
            nb = k ? nb + b * b : b * b;
        }
        const float dx = sqrtf(nr) - sqrtf(nl);
        const float dy = sqrtf(nt) - sqrtf(nb);
        const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + nz * nz);
        const float diffuse = fminf(fmaxf(nz * inv_len + 0.7f, 0.7f), 1.0f);
        for (int k = 0; k < C; ++k) c[k] = c[k] * diffuse;
    }

    if (!compose) {
        for (int k = 0; k < C; ++k) out[k * ohw + at] = c[k];
        return;
    }

    float bl[3];
    if (ex.bloom) {
        const AxisTap brow = axis_tap(i, ex.bh, oh, 1.0f, 0.0f, false);
        const AxisTap bcol = axis_tap(j, ex.bw, ow, 1.0f, 0.0f, false);
        for (int k = 0; k < 3; ++k)
            bl[k] = sample_cols_rows(Plane<float>{ex.bloom + k * ex.bh * ex.bw, ex.bw}, brow, bcol);
    }
    if (ex.sunrays) {
        const AxisTap srow = axis_tap(i, ex.sh, oh, 1.0f, 0.0f, false);
        const AxisTap scol = axis_tap(j, ex.sw, ow, 1.0f, 0.0f, false);
        const float rays = sample_cols_rows(Plane<float>{ex.sunrays, ex.sw}, srow, scol);
        for (int k = 0; k < C; ++k) c[k] = c[k] * rays;
        if (ex.bloom)
            for (int k = 0; k < 3; ++k) bl[k] = bl[k] * rays;
    }
    if (ex.bloom) {
        if (ex.dither) {
            const AxisTap drow = axis_tap(i, ex.dh, oh, ex.dsv, 0.0f, true);
            const AxisTap dcol = axis_tap(j, ex.dw, ow, ex.dsu, 0.0f, true);
            const float noise = sample_cols_rows(Plane<float>{ex.dither, ex.dw}, drow, dcol);
            const float d = (noise * 2.0f - 1.0f) / 255.0f;
            for (int k = 0; k < 3; ++k) bl[k] = bl[k] + d;
        }
        for (int k = 0; k < 3; ++k) c[k] = c[k] + linear_to_gamma(bl[k]);
    }
    float a = c[0];
    for (int k = 0; k < C; ++k) {
        out[k * ohw + at] = c[k];
        a = fmaxf(a, c[k]);
    }
    out[C * ohw + at] = a;
}

extern "C" {

// dye (C, H, W) in storage type `dtype`, C in 1..4 (3 with bloom); out
// float32, (C + 1, oh, ow) with compose = 1, else (C, oh, ow). bloom
// (3, bh, bw), sunrays (sh, sw) and dither (dh, dw) are float32 or null and
// read only with compose = 1; the dither only with bloom.
int display_frame(const void* dye, int C, int H, int W, int dtype, void* out, int oh, int ow,
                  int shading, int compose, float tx, float ty, float nz, const void* bloom,
                  int bh, int bw, const void* sunrays, int sh, int sw, const void* dither,
                  int dh, int dw, float dsu, float dsv, void* stream) {
    if (C < 1 || C > kMaxChannels || (compose && bloom && C != 3))
        return (int)cudaErrorInvalidValue;
    const Extras ex{compose ? (const float*)bloom : nullptr, bh, bw,
                    compose ? (const float*)sunrays : nullptr, sh, sw,
                    compose && bloom ? (const float*)dither : nullptr, dh, dw, dsu, dsv};
    DISPATCH_STORAGE(dtype, T,
        display_kernel<T><<<grid_for(oh, ow), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
            (const T*)dye, C, H, W, (float*)out, oh, ow, shading, compose, tx, ty, nz, ex));
    return (int)cudaGetLastError();
}

}  // extern "C"
