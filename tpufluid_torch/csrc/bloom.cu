// The bloom mip pyramid, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/bloom.py:91 `_kernel` (entered through
// bloom_pyramid_pallas, :132), which runs the whole pyramid as one
// VMEM-resident program with every blur stage as two bilinear "hat" matrix
// products on the MXU. The dye -> base resample stays outside
// (ops/cuda/bloom.py), as on the TPU.
//
// Stages, in the order of ops/bloom.pyramid (n mips m0..m{n-1}, base b):
//   down D_k: m{k-1} (b for k = 0, prefiltered on read) -> m_k,
//   up U_k (k = n-2 .. 0): m_k + blur(m{k+1}) -> m_k, in place,
//   final F: blur(m0) * intensity -> the output, base-sized.
// Per output texel (i, j) of a stage, each of the 3 channels:
//   out = [dst +] 0.25 * (((tap(-tx, 0) + tap(+tx, 0)) + tap(0, -ty)) + tap(0, +ty))
//         [* intensity]
// with tx = 1/sw, ty = 1/sh one source texel (doubles rounded to float32, as
// the plain version's Python floats) and each tap a bilinear CLAMP_TO_EDGE
// sample taken column stage first, then row stage (ops/sampling
// .sample_affine), lerps a*(1-f) + b*f, the sum in the order of
// ops/bloom.blur4. D_0 multiplies each corner texel by the soft-knee scale
// of its own 3 channels (ops/bloom.knee_threshold), the curve's constants
// computed in Python doubles by the caller.
//
// Bound: the pyramid as a function reads its base and writes its output,
// 2.8 MB at the demo (base 256x455) and 1.6 MB at 1024x1024 (base 256x256):
// under 1 us at 3.35 TB/s. Its 14 stages depend one on the next, and each is
// small (m1 is 7232 texels at the demo), so their chain of dependencies sets
// the time: one launch per stage took about 6 us a stage. The design: one
// cooperative launch of one 1024-thread block an SM. The large levels (more
// than `small` texels: m0, m1 and m2 at both configs) run grid-wide with a
// grid barrier after each stage (about 1.1 us each on the H100), in work
// items of one tap and channel (12 a texel, the 4 taps of a channel in 4
// lanes, summed by shuffles) where they take no more rounds of the threads
// than items of one channel (3 a texel), for the shortest chain of
// dependent loads a round. Every level from the first small one down, and
// back up to it, lives in one block's shared memory (at most ~8 KB for 512
// texels) and runs with block barriers while the other blocks wait at the
// next grid barrier: 7 grid barriers a frame at both configs instead of 13
// launch boundaries. Levels live in one float32 scratch buffer, m0 first.
//
// A batch of B sims (tpufluid/batch.py's vmap, which adds a batch grid axis
// to the TPU kernel) is one launch too: the grid cannot grow with B, since a
// cooperative launch holds only the co-resident blocks. So the grid-wide
// stages stride over the work items of every sim: level k of the batch is
// one (B, 3, h, w) array in the scratch buffer, a work item's plane is
// sim * 3 + channel, and its index is the single-sim index of that plane
// (only the prefilter adds the first plane of its sim). In the block phase
// each block takes whole sims, block b the sims b, b + gridDim.x, ..., each
// in the same shared memory as one sim: one sim's time while B is at most the
// grid's blocks. Still 7 grid barriers a frame whatever B is; the knee and
// the intensity are the same for every sim. Indices are int wherever the
// batch's work items fit (every single-sim launch), else 64-bit
// (common.cuh DISPATCH_INDEX).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxMips = 24;
constexpr int kBlockThreads = 1024;

struct Knee {
    float threshold, curve0, curve1, curve2;
};

struct Level {
    int h, w, off;   // off: float offset of the level in one sim's levels
    float tx, ty;    // one texel of this level as a source: 1/w, 1/h
};

struct Pyramid {
    const float* base;  // (B, 3, bh, bw)
    float* mips;        // every level, m0 first; level k of the batch (B, 3, h, w) at B * off
    float* out;         // (B, 3, bh, bw)
    int batch, n, small;  // sims, mips; levels >= small run in one block
    Level b;
    Level lv[kMaxMips];
    Knee knee;
    float intensity;
};

// One blur stage over `sims` sims: source and output planes (sims * 3, h, w),
// an optional dst added texel for texel (it may be the output), the knee on
// the source, a scale.
struct Stage {
    const float* src;
    Level s;
    const float* dst;
    float* out;
    Level o;
    int sims, knee, scaled;
};

// Source texel (y, x) of plane `plane` (sim * 3 + channel), prefiltered by
// the channels of its sim, planes first .. first + 2, when KNEE.
template <bool KNEE, typename I>
struct BloomSource {
    const float* src;
    int h, w;
    I plane, first;
    Knee knee;

    __device__ __forceinline__ float operator()(int y, int x) const {
        const I hw = (I)h * w, at = (I)y * w + x;
        const float v = src[plane * hw + at];
        if (!KNEE) return v;
        const I at0 = first * hw + at;
        const float r = src[at0], g = src[hw + at0], b = src[2 * hw + at0];
        const float br = fmaxf(fmaxf(r, g), b);
        float rq = fminf(fmaxf(br - knee.curve0, 0.0f), knee.curve1);
        rq = knee.curve2 * rq * rq;
        const float scale = fmaxf(rq, br - knee.threshold) / fmaxf(br, 1e-4f);
        return v * scale;
    }
};

// One work item: taps [k0, k0 + TAPS) of the 4 of output texel (i, j),
// plane `plane` (0 row/-tx, 1 row/+tx, 2 -ty/column, 3 +ty/column; offset 0
// where the tap has none, as the plain version's center plan). With all 4
// taps, their sum in ops/bloom.blur4's order; with one, the tap alone.
template <bool KNEE, int TAPS, typename I>
__device__ __forceinline__ float blur_item(const Stage& st, const Knee& knee, I plane, int i,
                                           int j, int k0) {
    const int sh = st.s.h, sw = st.s.w, oh = st.o.h, ow = st.o.w;
    AxisTap rows[TAPS], cols[TAPS];
    if (TAPS == 4) {
        const AxisTap row = axis_tap(i, sh, oh, 1.0f, 0.0f, false);
        const AxisTap col = axis_tap(j, sw, ow, 1.0f, 0.0f, false);
        rows[0] = row;
        rows[1 % TAPS] = row;
        rows[2 % TAPS] = axis_tap(i, sh, oh, 1.0f, -st.s.ty, false);
        rows[3 % TAPS] = axis_tap(i, sh, oh, 1.0f, st.s.ty, false);
        cols[0] = axis_tap(j, sw, ow, 1.0f, -st.s.tx, false);
        cols[1 % TAPS] = axis_tap(j, sw, ow, 1.0f, st.s.tx, false);
        cols[2 % TAPS] = col;
        cols[3 % TAPS] = col;
    } else {
        const float ox = k0 == 0 ? -st.s.tx : (k0 == 1 ? st.s.tx : 0.0f);
        const float oy = k0 == 2 ? -st.s.ty : (k0 == 3 ? st.s.ty : 0.0f);
        rows[0] = axis_tap(i, sh, oh, 1.0f, oy, false);
        cols[0] = axis_tap(j, sw, ow, 1.0f, ox, false);
    }
    const BloomSource<KNEE, I> src{st.src, sh, sw, plane, KNEE ? plane / 3 * 3 : plane, knee};
    float s = sample_cols_rows(src, rows[0], cols[0]);
#pragma unroll
    for (int k = 1; k < TAPS; ++k) s = s + sample_cols_rows(src, rows[k], cols[k]);
    return s;
}

// One stage over work items e = (plane * texels + texel) * (4 / TAPS) +
// tap, from `first` in steps of `stride` (both multiples of 32 apart from
// the lane, so the taps of one texel's plane sit in neighbouring lanes of
// one warp, and the loop's condition is the same across a warp). With one
// tap an item, the first tap's lane sums the 4 by shuffles, in blur4's
// order. An item's plane * texels + texel is its output's index.
template <bool KNEE, int TAPS, typename I>
__device__ __forceinline__ void run_stage(const Stage& st, const Pyramid& p, I first, I stride) {
    constexpr int kSplit = 4 / TAPS;
    const I texels = (I)st.o.h * st.o.w, n = 3 * kSplit * st.sims * texels;
    const int lane = threadIdx.x & 31;
    for (I e = first; e - lane < n; e += stride) {
        const bool valid = e < n;
        const I g = e / kSplit, plane = g / texels;
        const int k0 = (int)(e - g * kSplit), t = (int)(g - plane * texels);
        const bool writes = valid && k0 == 0;
        const float dst = writes && st.dst ? st.dst[g] : 0.0f;
        float s = 0.0f;
        if (valid) {
            const int i = t / st.o.w;
            s = blur_item<KNEE, TAPS, I>(st, p.knee, plane, i, t - i * st.o.w, k0);
        }
        if (TAPS == 1) {
            const float v1 = __shfl_down_sync(0xffffffffu, s, 1);
            const float v2 = __shfl_down_sync(0xffffffffu, s, 2);
            const float v3 = __shfl_down_sync(0xffffffffu, s, 3);
            s = s + v1;
            s = s + v2;
            s = s + v3;
        }
        s = s * 0.25f;
        if (st.dst) s = dst + s;
        if (st.scaled) s = s * p.intensity;
        if (writes) st.out[g] = s;
    }
}

// A stage with one work item a tap and plane (12 a texel of a sim) where
// that takes no more rounds of the threads (`stride`) than one a plane (3 a
// texel), else one a plane; the items of every sim of the stage count.
template <bool KNEE, typename I>
__device__ __forceinline__ void run_stage(const Stage& st, const Pyramid& p, I first, I stride) {
    const I items = 3 * st.sims * ((I)st.o.h * st.o.w), rounds = (items + stride - 1) / stride;
    if (4 * items <= rounds * stride)
        run_stage<KNEE, 1, I>(st, p, first, stride);
    else
        run_stage<KNEE, 4, I>(st, p, first, stride);
}

template <typename I>
__device__ __forceinline__ void run_stage(const Stage& st, const Pyramid& p, I first, I stride) {
    if (st.knee)
        run_stage<true, I>(st, p, first, stride);
    else
        run_stage<false, I>(st, p, first, stride);
}

__device__ __forceinline__ Level level(const Pyramid& p, int k) {
    return k < 0 || k >= p.n ? p.b : p.lv[k];
}

// Planes of level k (-1 the base, n the output) of every sim (sim < 0), or
// of sim `sim` alone; its levels >= p.small from `smem` where it is given.
__device__ __forceinline__ float* level_ptr(const Pyramid& p, int k, float* smem, int sim) {
    if (smem && k >= p.small && k < p.n) return smem + (p.lv[k].off - p.lv[p.small].off);
    float* all = k < 0 ? const_cast<float*>(p.base)
                       : (k >= p.n ? p.out : p.mips + (size_t)p.batch * p.lv[k].off);
    const Level l = level(p, k);
    return sim < 0 ? all : all + (size_t)sim * 3 * l.h * l.w;
}

__device__ __forceinline__ Stage down_stage(const Pyramid& p, int k, float* smem, int sim) {
    return Stage{level_ptr(p, k - 1, smem, sim), level(p, k - 1), nullptr,
                 level_ptr(p, k, smem, sim), p.lv[k], sim < 0 ? p.batch : 1, k == 0 ? 1 : 0, 0};
}

__device__ __forceinline__ Stage up_stage(const Pyramid& p, int k, float* smem, int sim) {
    float* m = level_ptr(p, k, smem, sim);
    return Stage{level_ptr(p, k + 1, smem, sim), p.lv[k + 1], m, m, p.lv[k],
                 sim < 0 ? p.batch : 1, 0, 0};
}

__device__ __forceinline__ Stage final_stage(const Pyramid& p) {
    return Stage{level_ptr(p, 0, nullptr, -1), p.lv[0], nullptr, p.out, p.b, p.batch, 0, 1};
}

// The small levels, a sim at a time in one block (block b the sims b,
// b + gridDim.x, ...): D_small .. D_{n-1}, U_{n-2} .. U_small in shared
// memory, then level `small` of the sim written to the scratch buffer.
template <typename I>
__device__ void small_levels(const Pyramid& p, float* smem) {
    for (int sim = blockIdx.x; sim < p.batch; sim += gridDim.x) {
        for (int k = p.small; k < p.n; ++k) {
            run_stage<I>(down_stage(p, k, smem, sim), p, threadIdx.x, blockDim.x);
            __syncthreads();
        }
        for (int k = p.n - 2; k >= p.small; --k) {
            run_stage<I>(up_stage(p, k, smem, sim), p, threadIdx.x, blockDim.x);
            __syncthreads();
        }
        const Level& m = p.lv[p.small];
        float* to = level_ptr(p, p.small, nullptr, sim);
        for (int t = threadIdx.x; t < 3 * m.h * m.w; t += blockDim.x) to[t] = smem[t];
        __syncthreads();  // the next sim's stages write the same shared memory
    }
}

// The whole pyramid of every sim in one cooperative launch. Scratch levels
// are written and read inside the launch: plain loads, no __restrict__.
template <typename I>
__global__ void __launch_bounds__(kBlockThreads, 1) bloom_pyramid_kernel(Pyramid p) {
    extern __shared__ float smem[];
    cg::grid_group grid = cg::this_grid();
    const I first = (I)grid.thread_rank(), stride = (I)grid.size();
    const int grid_down = min(p.small, p.n), grid_up = min(p.small, p.n - 1);
    for (int k = 0; k < grid_down; ++k) {
        run_stage<I>(down_stage(p, k, nullptr, -1), p, first, stride);
        grid.sync();
    }
    if (p.small < p.n) {
        small_levels<I>(p, smem);
        grid.sync();
    }
    for (int k = grid_up - 1; k >= 0; --k) {
        run_stage<I>(up_stage(p, k, nullptr, -1), p, first, stride);
        grid.sync();
    }
    run_stage<I>(final_stage(p), p, first, stride);
}

// Shared memory bytes of the small levels of one sim, m[small] .. m[n-1].
static int small_bytes(const int* sizes, int n, int small) {
    long bytes = 0;
    for (int k = small; k < n; ++k) bytes += 3L * sizes[2 * k] * sizes[2 * k + 1] * 4;
    return (int)bytes;
}

// One cooperative launch of at most the co-resident blocks, and no more
// than 12 work items of the largest level of every sim need.
template <typename I>
static cudaError_t launch(Pyramid& p, int smem, long long texels, cudaStream_t stream) {
    const auto kernel = bloom_pyramid_kernel<I>;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, smem);
    if (err != cudaSuccess) return err;
    const long long wanted = (12LL * p.batch * texels + kBlockThreads - 1) / kBlockThreads;
    const int blocks = (int)(wanted < (long long)per_sm * sms ? wanted : (long long)per_sm * sms);
    if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&p};
    return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kBlockThreads), args,
                                       smem, stream);
}

extern "C" {

// base (B, 3, bh, bw) float32; mips: the scratch, B * 3 * sum(h * w)
// float32; out (B, 3, bh, bw) float32; B in 1..kMaxBatch. sizes: n (h, w)
// pairs on the host, each level at least 1x1; levels >= small run in one
// block's shared memory, a sim at a time. Returns the launch's error: a
// cooperative launch larger than the card holds at once, or shared memory
// past the block's limit, is refused.
int bloom_pyramid(const void* base, int batch, int bh, int bw, void* mips, void* out,
                  const int* sizes, int n, int small, float threshold, float curve0,
                  float curve1, float curve2, float intensity, void* stream) {
    if (batch < 1 || batch > kMaxBatch || n < 2 || n > kMaxMips || small < 0 || bh < 1 ||
        bw < 1)
        return (int)cudaErrorInvalidValue;
    Pyramid p{};
    p.base = (const float*)base;
    p.mips = (float*)mips;
    p.out = (float*)out;
    p.batch = batch;
    p.n = n;
    p.small = min(small, n);
    p.b = Level{bh, bw, 0, (float)(1.0 / bw), (float)(1.0 / bh)};
    int off = 0;
    long long texels = (long long)bh * bw;
    for (int k = 0; k < n; ++k) {
        const int h = sizes[2 * k], w = sizes[2 * k + 1];
        if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
        p.lv[k] = Level{h, w, off, (float)(1.0 / w), (float)(1.0 / h)};
        off += 3 * h * w;
        if ((long long)h * w > texels) texels = (long long)h * w;
    }
    p.knee = Knee{threshold, curve0, curve1, curve2};
    p.intensity = intensity;
    const int smem = p.small < n ? small_bytes(sizes, n, p.small) : 0;
    // Every index of a launch, items and strides past the last included
    // (at most 2048 threads an SM), in 32 bits where they fit.
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const bool wide = 12LL * batch * texels + 2048LL * sms > (long long)INT_MAX;
    if (err == cudaSuccess) {
        DISPATCH_INDEX(wide, I, err = launch<I>(p, smem, texels, (cudaStream_t)stream));
    }
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, so that it is not reported by a later launch
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
