// The display composite, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/display.py:262 `_kernel` (entered through
// display_pallas, :387, and resample_shade_pallas, :518). The TPU kernel
// streams source row windows through VMEM per output row tile and gathers
// columns within 128-lane groups, so it refuses output widths that are not a
// multiple of 128; here any output size is taken (the demo's 512x910
// capture, the server's 360x640 tick).
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
//
// Bound: instructions, not bytes. The demo (f32 dye 1024x1820 -> 720x1280)
// moves 38.8 MB (11.6 us at 3.35 TB/s), 1024x1024 (bf16 dye) 24 MB (7.2
// us); one thread per texel recomputing 12 sampling coordinates (an IEEE
// division each) and issuing ~80 scalar loads took longer at 1024x1024 than
// at the demo, following the output texels, not the bytes; 3 powf, 5 sqrtf
// and 2 IEEE divisions a texel stay. So a block owns a 16x64 output tile,
// 4 texels a thread along a row:
//   * tap tables: each row and column coordinate of the tile (dye center,
//     above/below, left/right; bloom, sunrays, dither) computed once, by
//     common.cuh axis_tap, into shared memory;
//   * the dye window the tile's taps touch, clamped at the grid's edge,
//     copied into shared memory in its storage type by 4-byte asynchronous
//     copies (cp.async); its largest extent over the tiles comes from the
//     caller (ops/cuda/display.py window, the same axis math), and a tile
//     past it traps;
//   * while the window arrives, the part of the composite that does not
//     read the dye: bloom, sunrays, dither and the gamma's powf;
//   * the separable stages shared: the column stage at the tile's 64
//     columns for every window row (the unshaded center, top, bottom), and
//     with shading the row stage at the tile's 16 rows for every window
//     column (center, left, right), so a texel's dye taps are one lerp each
//     from shared memory; the values, and so the bits, are the per-texel
//     samples';
//   * 16-byte stores of each plane where the width is a multiple of 4.
//
// The direct form (display_frame_direct) is the same kernel for a window
// that does not fit a block's shared memory: a canvas much smaller than its
// dye (at a 64x downsample one output row with shading spans ~128 dye rows,
// so no smaller tile fits either). It keeps the tap tables in shared memory
// and the same stage order per tap, and reads each tap's two rows and two
// columns straight from device memory through the read-only cache; it
// stages nothing of the dye. The same float32 operations in the same order
// give the staged form's, and the plain version's, bits. The wrapper picks
// the form from the shape before the launch (ops/cuda/display.py form):
// staged where its shared memory fits the device's opt-in limit.
//
// A batch of B sims (tpufluid/batch.py's vmap, which adds a batch grid axis
// to the TPU kernel) is one launch: grid z is the sim, whose dye, bloom,
// sunrays and output a block offsets by its sim (common.cuh sim_offset, in
// the launch's index type: int wherever the whole batch fits, as every
// single-sim launch does). The dither tile and the window's extent are
// the same for every sim.
#include <cuda_pipeline.h>

#include "common.cuh"

constexpr float kGammaExponent = 0.416666667f;
constexpr int kTileH = 16, kTileW = 64, kVec = 4;
constexpr int kThreadsX = kTileW / kVec;
constexpr int kThreads = kTileH * kThreadsX;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Plane {
    const T* p;
    int w;
    __device__ __forceinline__ float operator()(int y, int x) const {
        return to_f32(p[y * w + x]);
    }
};

// A dye plane in device memory, read through the read-only cache (the
// direct form).
template <typename T>
struct Global {
    const T* p;
    int w;
    __device__ __forceinline__ float operator()(int y, int x) const {
        return to_f32(__ldg(p + y * w + x));
    }
};

// Rows first, then columns: the staged form's row stage, then its lerp
// along the row (sample_cols_rows is the other order).
template <typename Fetch>
__device__ __forceinline__ float sample_rows_cols(Fetch plane, AxisTap row, AxisTap col) {
    const float a = lerp_ab(plane(row.i0, col.i0), plane(row.i1, col.i0), row.f);
    const float b = lerp_ab(plane(row.i0, col.i1), plane(row.i1, col.i1), row.f);
    return lerp_ab(a, b, col.f);
}

__device__ __forceinline__ float linear_to_gamma(float c) {
    c = fmaxf(c, 0.0f);
    return fmaxf(1.055f * powf(c, kGammaExponent) - 0.055f, 0.0f);
}

struct Extras {
    const float* bloom;  // (B, 3, bh, bw) or null
    int bh, bw;
    const float* sunrays;  // (B, sh, sw) or null
    int sh, sw;
    const float* dither;  // (dh, dw) or null, one for every sim; used only with bloom
    int dh, dw;
    float dsu, dsv;  // dither scales, out_w / dw and out_h / dh
};

// Shared memory of a block, in bytes: the dye window in its storage type,
// (C, win_h, pitch) with pitch = win_w + 1 rounded up to even (a 16-bit
// window starts on an even column, so that it copies in 4-byte pairs),
// padded to 16 bytes; then in float32 the column stage (C, win_h, kTileW)
// and, with shading, the row stage (C, kTileH, pitch). A size past the
// block's limit is refused at the launch.
__host__ __device__ inline int win_pitch(int win_w) { return (win_w + 2) & ~1; }
__host__ __device__ inline int hc_offset(int C, int win_h, int win_w, int item) {
    return (C * win_h * win_pitch(win_w) * item + 15) / 16 * 16;
}
__host__ __device__ inline int vr_offset(int C, int win_h, int win_w, int item) {
    return hc_offset(C, win_h, win_w, item) + 4 * C * win_h * kTileW;
}
__host__ __device__ inline int display_smem_bytes(int C, int win_h, int win_w, int shading,
                                                  int item) {
    return vr_offset(C, win_h, win_w, item) + (shading ? 4 * C * kTileH * win_pitch(win_w) : 0);
}

// Elements of T a window copy moves at once: 4 bytes (one float32, or a
// pair of 16-bit values in rows of even width from a 4-byte aligned start),
// else one 16-bit element. The window's first column is rounded down to a
// multiple of it.
template <typename T>
__device__ __forceinline__ int copy_unit(const T* dye, int W) {
    constexpr int pair = 4 / sizeof(T);
    return W % pair == 0 && reinterpret_cast<size_t>(dye) % 4 == 0 ? pair : 1;
}

// Starts the copy of the window's rows [oy, oy + wh) x [ox, ox + ww) into
// `win` (ox a multiple of `unit`): 4-byte asynchronous copies, or, for
// single 16-bit elements, plain loads.
template <typename T>
__device__ __forceinline__ void copy_window(const T* __restrict__ dye, int C, int H, int W,
                                            int oy, int wh, int ox, int ww, int unit, T* win,
                                            int win_h, int pitch, int warp, int lane) {
    const int units = (ww + unit - 1) / unit;
    const bool async = unit * sizeof(T) == 4;
    for (int e = warp; e < C * wh; e += kWarps) {
        const int c = e / wh, y = e - c * wh;
        const T* src = dye + ((size_t)c * H + oy + y) * W + ox;
        T* dst = win + (c * win_h + y) * pitch;
        for (int m = lane; m < units; m += 32) {
            if (async)
                __pipeline_memcpy_async(dst + m * unit, src + m * unit, 4);
            else
                dst[m] = src[m];
        }
    }
    __pipeline_commit();
}

// kDirect: the direct form, which takes no window (win_h, win_w unused)
// and no dynamic shared memory; it holds every tap of its 4 texels in
// registers, so it is built for 2 blocks an SM (128 registers), the staged
// form for 4.
template <typename T, int C, typename I, bool kDirect>
__global__ void __launch_bounds__(kThreads, kDirect ? 2 : 4) display_kernel(
        const T* __restrict__ dye, int H, int W, float* __restrict__ out, int oh, int ow,
        int shading, int compose, float tx, float ty, float nz, Extras ex, int win_h,
        int win_w) {
    // Tap tables: rows 0 center, 1 above (+ty), 2 below (-ty); columns 0
    // center, 1 right (+tx), 2 left (-tx); extras 0 bloom, 1 sunrays, 2
    // dither. Entries past the output's edge repeat its last row or column.
    __shared__ AxisTap rows[3][kTileH], cols[3][kTileW], xrows[3][kTileH], xcols[3][kTileW];
    extern __shared__ float4 dyn[];
    const int pitch = win_pitch(win_w);
    T* win = reinterpret_cast<T*>(dyn);
    float* hc = reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) +
                                         hc_offset(C, win_h, win_w, sizeof(T)));
    float* vr = reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) +
                                         vr_offset(C, win_h, win_w, sizeof(T)));

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int r0 = blockIdx.y * kTileH, q0 = blockIdx.x * kTileW;
    const int nr = min(kTileH, oh - r0), nq = min(kTileW, ow - q0);

    for (int e = tid; e < 3 * kTileH; e += kThreads) {
        const int t = e / kTileH, r = e % kTileH, i = min(r0 + r, oh - 1);
        rows[t][r] = axis_tap(i, H, oh, 1.0f, t == 0 ? 0.0f : (t == 1 ? ty : -ty), false);
        if (t == 0 && ex.bloom) xrows[0][r] = axis_tap(i, ex.bh, oh, 1.0f, 0.0f, false);
        if (t == 1 && ex.sunrays) xrows[1][r] = axis_tap(i, ex.sh, oh, 1.0f, 0.0f, false);
        if (t == 2 && ex.dither) xrows[2][r] = axis_tap(i, ex.dh, oh, ex.dsv, 0.0f, true);
    }
    for (int e = tid; e < 3 * kTileW; e += kThreads) {
        const int t = e / kTileW, q = e % kTileW, j = min(q0 + q, ow - 1);
        cols[t][q] = axis_tap(j, W, ow, 1.0f, t == 0 ? 0.0f : (t == 1 ? tx : -tx), false);
        if (t == 0 && ex.bloom) xcols[0][q] = axis_tap(j, ex.bw, ow, 1.0f, 0.0f, false);
        if (t == 1 && ex.sunrays) xcols[1][q] = axis_tap(j, ex.sw, ow, 1.0f, 0.0f, false);
        if (t == 2 && ex.dither) xcols[2][q] = axis_tap(j, ex.dw, ow, ex.dsu, 0.0f, true);
    }
    __syncthreads();

    // The window: every coordinate is monotone in its index and its offset,
    // so the lowest corner is the first row's lowest tap, the highest the
    // last row's highest. The window starts on a multiple of the copy's unit.
    const T* sim_dye = dye + sim_offset<I>((I)C * H * W);
    int oy = 0, wh = 0, ox = 0, ww = 0;
    if constexpr (!kDirect) {
        const int lo = shading ? 2 : 0, hi = shading ? 1 : 0;
        oy = rows[lo][0].i0;
        wh = rows[hi][nr - 1].i1 - oy + 1;
        const int ox_tap = cols[lo][0].i0, ww_tap = cols[hi][nq - 1].i1 - ox_tap + 1;
        if (wh > win_h || ww_tap > win_w) __trap();
        const int unit = copy_unit(sim_dye, W);
        ox = ox_tap / unit * unit;
        ww = ox_tap + ww_tap - ox;
        copy_window(sim_dye, C, H, W, oy, wh, ox, ww, unit, win, win_h, pitch, warp, lane);
    }

    // While the window arrives: the part of the composite that does not
    // read the dye, for this thread's 4 texels along its row.
    const int r = tid / kThreadsX, qb = (tid % kThreadsX) * kVec;
    const bool active = r < nr && qb < nq;
    float rays[kVec], glow[3][kVec];
    if (compose && active) {
        const float* bloom =
            ex.bloom ? ex.bloom + sim_offset<I>((I)3 * ex.bh * ex.bw) : nullptr;
        const float* sunrays =
            ex.sunrays ? ex.sunrays + sim_offset<I>((I)ex.sh * ex.sw) : nullptr;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
            const int q = qb + u;
            float bl[3];
            if (bloom) {
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    bl[k] = sample_cols_rows(Plane<float>{bloom + k * ex.bh * ex.bw, ex.bw},
                                             xrows[0][r], xcols[0][q]);
            }
            if (sunrays) {
                rays[u] = sample_cols_rows(Plane<float>{sunrays, ex.sw}, xrows[1][r],
                                           xcols[1][q]);
                if (bloom)
#pragma unroll
                    for (int k = 0; k < 3; ++k) bl[k] = bl[k] * rays[u];
            }
            if (bloom) {
                if (ex.dither) {
                    const float noise = sample_cols_rows(Plane<float>{ex.dither, ex.dw},
                                                         xrows[2][r], xcols[2][q]);
                    const float d = (noise * 2.0f - 1.0f) / 255.0f;
#pragma unroll
                    for (int k = 0; k < 3; ++k) bl[k] = bl[k] + d;
                }
#pragma unroll
                for (int k = 0; k < 3; ++k) glow[k][u] = linear_to_gamma(bl[k]);
            }
        }
    }
    if constexpr (!kDirect) {
        __pipeline_wait_prior(0);
        __syncthreads();

        // The column stage at the tile's columns (2 a lane) for every window row.
        const AxisTap ca = cols[0][lane], cb = cols[0][lane + 32];
        const int a0 = ca.i0 - ox, a1 = ca.i1 - ox, b0 = cb.i0 - ox, b1 = cb.i1 - ox;
#pragma unroll 4
        for (int e = warp; e < C * wh; e += kWarps) {
            const int c = e / wh, y = e - c * wh;
            const T* src = win + (c * win_h + y) * pitch;
            float* dst = hc + (c * win_h + y) * kTileW;
            dst[lane] = lerp_ab(to_f32(src[a0]), to_f32(src[a1]), ca.f);
            dst[lane + 32] = lerp_ab(to_f32(src[b0]), to_f32(src[b1]), cb.f);
        }
        // With shading, the row stage at the tile's rows for every window column.
        if (shading) {
            for (int e = warp; e < C * kTileH; e += kWarps) {
                const int c = e / kTileH, rr = e - c * kTileH;
                const AxisTap t = rows[0][rr];
                const T* a = win + (c * win_h + t.i0 - oy) * pitch;
                const T* b = win + (c * win_h + t.i1 - oy) * pitch;
                float* dst = vr + (c * kTileH + rr) * pitch;
#pragma unroll 4
                for (int x = lane; x < ww; x += 32)
                    dst[x] = lerp_ab(to_f32(a[x]), to_f32(b[x]), t.f);
            }
        }
        __syncthreads();
    }
    if (!active) return;
    const int i = r0 + r;

    // Columns first at rows t.i0, t.i1 for this thread's 4 columns, then
    // the rows: the staged form's column stage (shared), or the taps from
    // device memory.
    auto col_then_row = [&](int c, AxisTap t, float v[kVec]) {
        if constexpr (kDirect) {
            const Global<T> plane{sim_dye + (size_t)c * H * W, W};
#pragma unroll
            for (int u = 0; u < kVec; ++u) v[u] = sample_cols_rows(plane, t, cols[0][qb + u]);
        } else {
            const float4 a =
                *reinterpret_cast<const float4*>(hc + (c * win_h + t.i0 - oy) * kTileW + qb);
            const float4 b =
                *reinterpret_cast<const float4*>(hc + (c * win_h + t.i1 - oy) * kTileW + qb);
            v[0] = lerp_ab(a.x, b.x, t.f);
            v[1] = lerp_ab(a.y, b.y, t.f);
            v[2] = lerp_ab(a.z, b.z, t.f);
            v[3] = lerp_ab(a.w, b.w, t.f);
        }
    };
    // Rows first at this row, then the columns at column table `k`: the
    // staged form's row stage (shared), or the taps from device memory.
    auto row_then_col = [&](int c, int k, float v[kVec]) {
        if constexpr (kDirect) {
            const Global<T> plane{sim_dye + (size_t)c * H * W, W};
#pragma unroll
            for (int u = 0; u < kVec; ++u)
                v[u] = sample_rows_cols(plane, rows[0][r], cols[k][qb + u]);
        } else {
            const float* rowv = vr + (c * kTileH + r) * pitch;
#pragma unroll
            for (int u = 0; u < kVec; ++u) {
                const AxisTap t = cols[k][qb + u];
                v[u] = lerp_ab(rowv[t.i0 - ox], rowv[t.i1 - ox], t.f);
            }
        }
    };

    float res[C + 1][kVec];
    if (!shading) {
#pragma unroll
        for (int c = 0; c < C; ++c) col_then_row(c, rows[0][r], res[c]);
    } else {
        float nl[kVec], nr_[kVec], nt[kVec], nb[kVec];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float l[kVec], rt[kVec], t[kVec], b[kVec];
            row_then_col(c, 0, res[c]);
            row_then_col(c, 2, l);
            row_then_col(c, 1, rt);
            col_then_row(c, rows[1][r], t);
            col_then_row(c, rows[2][r], b);
            // channel 0 starts each sum: x0*x0, then + xk*xk in order
#pragma unroll
            for (int u = 0; u < kVec; ++u) {
                nl[u] = c ? nl[u] + l[u] * l[u] : l[u] * l[u];
                nr_[u] = c ? nr_[u] + rt[u] * rt[u] : rt[u] * rt[u];
                nt[u] = c ? nt[u] + t[u] * t[u] : t[u] * t[u];
                nb[u] = c ? nb[u] + b[u] * b[u] : b[u] * b[u];
            }
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
            const float dx = sqrtf(nr_[u]) - sqrtf(nl[u]);
            const float dy = sqrtf(nt[u]) - sqrtf(nb[u]);
            const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + nz * nz);
            const float diffuse = fminf(fmaxf(nz * inv_len + 0.7f, 0.7f), 1.0f);
#pragma unroll
            for (int c = 0; c < C; ++c) res[c][u] = res[c][u] * diffuse;
        }
    }

    int planes = C;
    if (compose) {
        planes = C + 1;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
            if (ex.sunrays)
#pragma unroll
                for (int c = 0; c < C; ++c) res[c][u] = res[c][u] * rays[u];
            if (ex.bloom)
#pragma unroll
                for (int c = 0; c < C; ++c)
                    if (c < 3) res[c][u] = res[c][u] + glow[c][u];
            float a = res[0][u];
#pragma unroll
            for (int c = 0; c < C; ++c) a = fmaxf(a, res[c][u]);
            res[C][u] = a;
        }
    }

    const size_t ohw = (size_t)oh * ow, at = (size_t)i * ow + q0 + qb;
    out += sim_offset<I>((I)planes * oh * ow);
    if (ow % kVec == 0) {
#pragma unroll
        for (int k = 0; k < C + 1; ++k)
            if (k < planes)
                *reinterpret_cast<float4*>(out + k * ohw + at) =
                    make_float4(res[k][0], res[k][1], res[k][2], res[k][3]);
    } else {
        const int n = min(kVec, nq - qb);
#pragma unroll
        for (int k = 0; k < C + 1; ++k)
            if (k < planes)
                for (int u = 0; u < n; ++u) out[k * ohw + at + u] = res[k][u];
    }
}

template <typename T, int C, typename I, bool kDirect>
static int launch(const void* dye, int B, int H, int W, void* out, int oh, int ow, int shading,
                  int compose, float tx, float ty, float nz, const Extras& ex, int win_h,
                  int win_w, cudaStream_t stream) {
    const auto kernel = display_kernel<T, C, I, kDirect>;
    const int smem = kDirect ? 0 : display_smem_bytes(C, win_h, win_w, shading, sizeof(T));
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, so that it is not reported by a later launch
            return (int)err;
        }
    }
    const dim3 grid((ow + kTileW - 1) / kTileW, (oh + kTileH - 1) / kTileH, B);
    kernel<<<grid, kThreads, smem, stream>>>((const T*)dye, H, W, (float*)out, oh, ow, shading,
                                             compose, tx, ty, nz, ex, win_h, win_w);
    return (int)cudaGetLastError();
}

template <bool kDirect>
static int frame(const void* dye, int B, int C, int H, int W, int dtype, void* out, int oh,
                 int ow, int shading, int compose, float tx, float ty, float nz,
                 const void* bloom, int bh, int bw, const void* sunrays, int sh, int sw,
                 const void* dither, int dh, int dw, float dsu, float dsv, int win_h, int win_w,
                 void* stream) {
    if (B < 1 || B > kMaxBatch || C < 1 || C > 4 || (compose && bloom && C != 3) || oh < 1 ||
        ow < 1 || (!kDirect && (win_h < 1 || win_w < 1)))
        return (int)cudaErrorInvalidValue;
    const Extras ex{compose ? (const float*)bloom : nullptr, bh, bw,
                    compose ? (const float*)sunrays : nullptr, sh, sw,
                    compose && bloom ? (const float*)dither : nullptr, dh, dw, dsu, dsv};
    const cudaStream_t s = (cudaStream_t)stream;
    // The largest element count of one sim's tensors, in 32 bits where the
    // batch's fits.
    size_t per_sim = (size_t)(C + 1) * oh * ow;
    per_sim = per_sim > (size_t)C * H * W ? per_sim : (size_t)C * H * W;
    per_sim = per_sim > (size_t)3 * bh * bw ? per_sim : (size_t)3 * bh * bw;
    per_sim = per_sim > (size_t)sh * sw ? per_sim : (size_t)sh * sw;
#define DISPLAY_ARGS dye, B, H, W, out, oh, ow, shading, compose, tx, ty, nz, ex, win_h, win_w, s
    DISPATCH_STORAGE(dtype, T,
        DISPATCH_INDEX(wide_batch(B, per_sim), I,
            switch (C) {
                case 1: return launch<T, 1, I, kDirect>(DISPLAY_ARGS);
                case 2: return launch<T, 2, I, kDirect>(DISPLAY_ARGS);
                case 3: return launch<T, 3, I, kDirect>(DISPLAY_ARGS);
                default: return launch<T, 4, I, kDirect>(DISPLAY_ARGS);
            }));
#undef DISPLAY_ARGS
    return (int)cudaErrorInvalidValue;
}

extern "C" {

// B sims, B in 1..kMaxBatch: dye (B, C, H, W) in storage type `dtype`, C in
// 1..4 (3 with bloom); out float32, (B, C + 1, oh, ow) with compose = 1, else
// (B, C, oh, ow). bloom (B, 3, bh, bw), sunrays (B, sh, sw) and dither
// (dh, dw), one for every sim, are float32 or null and read only with
// compose = 1; the dither only with bloom. win_h x win_w: the largest dye
// window of a tile (ops/cuda/display.py window); shared memory past the
// block's limit is refused at the launch.
int display_frame(const void* dye, int B, int C, int H, int W, int dtype, void* out, int oh,
                  int ow, int shading, int compose, float tx, float ty, float nz,
                  const void* bloom, int bh, int bw, const void* sunrays, int sh, int sw,
                  const void* dither, int dh, int dw, float dsu, float dsv, int win_h, int win_w,
                  void* stream) {
    return frame<false>(dye, B, C, H, W, dtype, out, oh, ow, shading, compose, tx, ty, nz, bloom,
                        bh, bw, sunrays, sh, sw, dither, dh, dw, dsu, dsv, win_h, win_w, stream);
}

// The direct form: display_frame's arguments but the window, which it does
// not stage, at any size.
int display_frame_direct(const void* dye, int B, int C, int H, int W, int dtype, void* out,
                         int oh, int ow, int shading, int compose, float tx, float ty, float nz,
                         const void* bloom, int bh, int bw, const void* sunrays, int sh, int sw,
                         const void* dither, int dh, int dw, float dsu, float dsv,
                         void* stream) {
    return frame<true>(dye, B, C, H, W, dtype, out, oh, ow, shading, compose, tx, ty, nz, bloom,
                       bh, bw, sunrays, sh, sw, dither, dh, dw, dsu, dsv, 0, 0, stream);
}

}  // extern "C"
