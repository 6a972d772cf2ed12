// One stage of the bloom mip chain, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/bloom.py:91 `_kernel` (entered through
// bloom_pyramid_pallas, :132), which runs the whole pyramid as one
// VMEM-resident program with every blur stage as two bilinear "hat" matrix
// products on the MXU. Here the pyramid is 2 * mips launches of this kernel
// (14 at the demo and 1024x1024 configs: 7 down, 6 up, 1 final), one thread
// per output texel, each reading global memory where its taps land. The
// dye -> base resample stays outside (ops/cuda/bloom.py), as on the TPU.
//
// Per output texel (i, j), each of the 3 channels:
//   out = [dst +] 0.25 * (((tap(-tx, 0) + tap(+tx, 0)) + tap(0, -ty)) + tap(0, +ty))
//         [* intensity]
// with tx = 1/sw, ty = 1/sh one source texel (Python doubles rounded to
// float32 by the caller) and each tap a bilinear CLAMP_TO_EDGE sample taken
// column stage first, then row stage (ops/sampling.sample_affine), lerps
// a*(1-f) + b*f, the sum in the order of ops/bloom.blur4. The first down
// stage prefilters its source on read: each corner texel is multiplied by
// the soft-knee scale of its own 3 channels (ops/bloom.knee_threshold), with the
// knee's curve constants computed in Python doubles by the caller.
//
// Bound: bytes. The largest stage (the first down stage at the demo: base
// 256x455, mip 128x227, float32) moves 1.75 MB (0.52 us at 3.35 TB/s); the
// whole chain 5.1 MB at the demo and 2.9 MB at 1024x1024 (1.5 and 0.9 us),
// against 14 launches of a few microseconds each: launch latency, not bytes,
// sets its time. Left for later: the whole pyramid in one launch (a
// cooperative grid or a cluster, every mip of a 256-scale pyramid fits in
// one SM's shared memory below the first two levels).
#include "common.cuh"

struct Knee {
    int on;
    float threshold, curve0, curve1, curve2;
};

// Source texel (y, x) of channel c, prefiltered when knee.on.
struct BloomSource {
    const float* src;
    int h, w, c;
    Knee knee;

    __device__ __forceinline__ float operator()(int y, int x) const {
        const int hw = h * w, at = y * w + x;
        const float v = src[c * hw + at];
        if (!knee.on) return v;
        const float r = src[at], g = src[hw + at], b = src[2 * hw + at];
        const float br = fmaxf(fmaxf(r, g), b);
        float rq = fminf(fmaxf(br - knee.curve0, 0.0f), knee.curve1);
        rq = knee.curve2 * rq * rq;
        const float scale = fmaxf(rq, br - knee.threshold) / fmaxf(br, 1e-4f);
        return v * scale;
    }
};

__global__ void bloom_blur4_kernel(const float* __restrict__ src, int sh, int sw,
                                   const float* __restrict__ dst, float* __restrict__ out,
                                   int oh, int ow, float tx, float ty, Knee knee, int scaled,
                                   float intensity) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= oh || j >= ow) return;
    const AxisTap row = axis_tap(i, sh, oh, 1.0f, 0.0f, false);
    const AxisTap col = axis_tap(j, sw, ow, 1.0f, 0.0f, false);
    const AxisTap left = axis_tap(j, sw, ow, 1.0f, -tx, false);
    const AxisTap right = axis_tap(j, sw, ow, 1.0f, tx, false);
    const AxisTap below = axis_tap(i, sh, oh, 1.0f, -ty, false);
    const AxisTap above = axis_tap(i, sh, oh, 1.0f, ty, false);
    const int ohw = oh * ow, at = i * ow + j;
    for (int c = 0; c < 3; ++c) {
        const BloomSource plane{src, sh, sw, c, knee};
        float s = sample_cols_rows(plane, row, left);
        s = s + sample_cols_rows(plane, row, right);
        s = s + sample_cols_rows(plane, below, col);
        s = s + sample_cols_rows(plane, above, col);
        s = s * 0.25f;
        if (dst) s = dst[c * ohw + at] + s;
        if (scaled) s = s * intensity;
        out[c * ohw + at] = s;
    }
}

extern "C" {

// src (3, sh, sw), dst (3, oh, ow) or null, out (3, oh, ow), all float32;
// out may be dst (each thread reads only its own dst texel). prefilter = 1
// applies the soft knee to src on read; scaled = 1 multiplies by intensity.
int bloom_blur4(const void* src, int sh, int sw, const void* dst, void* out, int oh, int ow,
                float tx, float ty, int prefilter, float threshold, float curve0, float curve1,
                float curve2, int scaled, float intensity, void* stream) {
    if (sh < 1 || sw < 1 || oh < 1 || ow < 1) return (int)cudaErrorInvalidValue;
    const Knee knee{prefilter, threshold, curve0, curve1, curve2};
    bloom_blur4_kernel<<<grid_for(oh, ow), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
        (const float*)src, sh, sw, (const float*)dst, (float*)out, oh, ow, tx, ty, knee, scaled,
        intensity);
    return (int)cudaGetLastError();
}

}  // extern "C"
