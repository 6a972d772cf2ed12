// Semi-Lagrangian advection, for Hopper (sm_90a): a prepare kernel and a
// gather kernel.
//
// Replaces tpufluid/ops/pallas/advect.py:301 `_advect_kernel` (entered
// through advect_pallas, :567) AND tpufluid/ops/pallas/advect_hbm.py:108
// `_kernel` (entered through advect_pallas_hbm, :419). The TPU needs two
// kernels because its gather reads a VMEM window sized from the displacement
// bound; here every thread reads global memory wherever its backtrace lands,
// so one gather covers velocity self-advection, same-grid dye and dye on a
// grid finer than the velocity. It clamps a backtrace at the grid's edge, as
// the jnp oracle does, never at a window's edge. No hardware texture
// filtering: its 8-bit fixed-point weights would break parity with the plain
// version.
//
// What bounds it. The function moves each input once and each output once:
// 1024x1024 bf16 reads 2s of velocity for the self-advection and writes 2s,
// then reads 2s of velocity and 3s of dye and writes 3s (s = storage bytes;
// 25 MB with the splat factors, 7.5 us at 3.35 TB/s); the demo's f32 dye on
// 1024x1820 reads 3s and writes 3s per texel plus the 128x228 velocity
// (45 MB, 13.4 us). The gather's corners are neighbours of the texel's own
// row and come from L1/L2. What the first design lost was arithmetic and
// instructions, not bytes: for each of 4 corners and C channels it recomputed
// the splat bump (S rows, 3 loads each) and the RGB9E5 round trip, each of
// them ~4 times per source texel, kept the corners in a local-memory array
// indexed under a runtime channel loop, and loaded C scalars per corner.
//
// The design:
//   1. advect_prepare_kernel, once per SOURCE texel (dye only: the splat
//      bump, the quantization or both): adds the separable bump in the plain
//      version's order (s = 0..S-1, (gy * amt) * gx, no FMA), rounds to
//      storage, then writes either one RGB9E5 word (bf16 with RGB9E5 on; the
//      layout of ops/quant.py rgb9e5_pack, whose unpacked values are exactly
//      the round trip's) or the C storage values interleaved and padded to 4
//      (one corner = one 8-byte or 16-byte load).
//   2. advect_kernel, one thread per TARGET texel, templated on the storage
//      type, the channel count, the source layout (planes, quads, words) and
//      same grid against a coarser velocity, so every corner and channel
//      lives in registers: read the velocity once, backtrace with the same
//      float32 operations as the plain version, load the 4 corners, lerp in
//      the plain order, divide by 1 + k * dt and round once.
// The velocity self-advection has no bump and no quantization: its gather
// reads the two planes directly and no prepare runs. A prepare thread takes
// two texels, kBlockX apart along the row, and computes their row's
// gy * amt once for both; the gather takes one texel a thread. Measured on
// the H100 (PERF.md), two texels made the prepare faster and the gather no
// faster.
//
// Both kernels take a batch of B independent sims in one launch (the
// counterpart of jax.vmap over the TPU kernels, tpufluid/batch.py): the
// grid's z axis is the sim, each block adds its sim's offset to the index
// of every field, factor and prepared source (32-bit where the batch fits,
// else 64: common.cuh DISPATCH_INDEX; here left to the optimizer, which
// measured faster than sim_offset's opaque term), and the gather reads its
// sim's dt and decay from a (B, 2) table that the host computed (or the
// scalars, for lock-step). The single-sim advection is B = 1 with the
// scalars; each sim of a batch runs the operations of its own launch, bit
// for bit.
//
// Both kernels also read and write the lane-packed fleet's layout (common.cuh
// FieldLayout: (C, H, B*W) fields, the sim on grid z, same grid only). The
// prepare reads the packed source and writes its private prepared source as
// for a batch, (B, H, W[, 4]); the gather reads the packed velocity (and a
// packed planes source) and writes the packed output. A thread's backtrace
// stays in its sim's own float coordinates and clamps to that sim's
// columns [0, W - 1]: the TPU kernel's per-lane clamp at its sim's walls
// (tpufluid/ops/pallas/advect.py:450-461), without its packed-column
// coordinates (:442-447), so a packed sim equals its batched sim bit for bit.
//
// Extra bytes of the design, beyond the function's: the prepared source,
// written once and read back by the gather (mostly from L2). 1024x1024 bf16
// RGB9E5: 4 B a texel, 4.2 MB written and read. Demo f32: 16 B a texel on
// 1024x1820, 29.8 MB written and read.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

constexpr float kMaxRgb9e5 = 65408.0f;  // (511 / 512) * 2^16

// Source layouts of the gather (ops/cuda/advect.py LAYOUTS).
enum Layout { kPlanes = 0, kQuads = 1, kWords = 2 };

// One prepared texel of the kQuads layout: C <= 3 storage values and a pad,
// loaded and stored as one vector (16 bytes in f32, 8 in 16-bit storage).
template <typename T> struct QuadVec { using type = uint2; };
template <> struct QuadVec<float> { using type = float4; };
template <typename T> union Quad {
    typename QuadVec<T>::type vec;
    T v[4];
};

// Pack (r, g, b) into one RGB9E5 word, bit for bit ops/quant.py rgb9e5_pack.
__device__ __forceinline__ uint32_t rgb9e5_pack(float r, float g, float b) {
    r = fminf(fmaxf(r, 0.0f), kMaxRgb9e5);
    g = fminf(fmaxf(g, 0.0f), kMaxRgb9e5);
    b = fminf(fmaxf(b, 0.0f), kMaxRgb9e5);
    const float maxc = fmaxf(r, fmaxf(g, b));
    const int e = (int)(__float_as_uint(maxc) >> 23) - 127;
    int E = min(max(e + 16, 0), 31);
    const float scale = __uint_as_float((unsigned)(151 - E) << 23);  // 2^(24 - E)
    int mr = (int)floorf(r * scale + 0.5f);
    int mg = (int)floorf(g * scale + 0.5f);
    int mb = (int)floorf(b * scale + 0.5f);
    if (max(mr, max(mg, mb)) > 511) {  // round-up overflow: re-round at E + 1
        const float half = scale * 0.5f;
        mr = (int)floorf(r * half + 0.5f);
        mg = (int)floorf(g * half + 0.5f);
        mb = (int)floorf(b * half + 0.5f);
        E = E + 1;
    }
    return (uint32_t)mr | ((uint32_t)mg << 9) | ((uint32_t)mb << 18) |
           ((uint32_t)(E & 31) << 27);
}

// ops/quant.py rgb9e5_unpack: channel i is m_i * 2^(E - 24).
__device__ __forceinline__ void rgb9e5_unpack(uint32_t w, float* rgb) {
    const float s = __uint_as_float(((w >> 27) + 103u) << 23);
    rgb[0] = (float)(w & 0x1FFu) * s;
    rgb[1] = (float)((w >> 9) & 0x1FFu) * s;
    rgb[2] = (float)((w >> 18) & 0x1FFu) * s;
}

// The C float32 values of source texel `at` (its sim's offset included) in
// layout LAYOUT; `hw` is a plane's stride (H * B * W in the packed layout).
template <typename T, int C, int LAYOUT, typename I, typename S>
__device__ __forceinline__ void fetch(const void* src, I at, S hw, float* val) {
    if constexpr (LAYOUT == kPlanes) {
#pragma unroll
        for (int c = 0; c < C; ++c) val[c] = to_f32(static_cast<const T*>(src)[c * hw + at]);
    } else if constexpr (LAYOUT == kQuads) {
        Quad<T> q;
        q.vec = static_cast<const typename QuadVec<T>::type*>(src)[at];
#pragma unroll
        for (int c = 0; c < C; ++c) val[c] = to_f32(q.v[c]);
    } else {
        static_assert(C == 3, "RGB9E5 words hold three channels");
        rgb9e5_unpack(static_cast<const uint32_t*>(src)[at], val);
    }
}

// Bilinear sample at pixel-space (x, y) = uv * size - 0.5 of the (h, w)
// plane that starts at index `base` of `field`.
template <typename T, typename I>
__device__ __forceinline__ float sample_plane(const T* field, I base, float x, float y, int h,
                                              int w) {
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix0 = min(max((int)x0, 0), w - 1), ix1 = min(max((int)x0 + 1, 0), w - 1);
    const int iy0 = min(max((int)y0, 0), h - 1), iy1 = min(max((int)y0 + 1, 0), h - 1);
    const float a = to_f32(field[base + iy0 * w + ix0]), b = to_f32(field[base + iy0 * w + ix1]);
    const float c = to_f32(field[base + iy1 * w + ix0]), d = to_f32(field[base + iy1 * w + ix1]);
    const float top = a + (b - a) * fx;
    const float bot = c + (d - c) * fx;
    return top + (bot - top) * fy;
}

constexpr int kPrepareTexels = 2;  // texels a prepare thread, kBlockX apart

template <typename T, int C, bool WORDS, typename I, bool PACKED>
__global__ void advect_prepare_kernel(const T* __restrict__ src, void* __restrict__ prep, int H,
                                      int W, const float* __restrict__ gy,
                                      const float* __restrict__ gx,
                                      const float* __restrict__ amt, int S) {
    constexpr int TPT = kPrepareTexels;
    const int j0 = blockIdx.x * (kBlockX * TPT) + threadIdx.x;
    const int i = (PACKED ? blockIdx.z : blockIdx.y) * blockDim.y + threadIdx.y;
    if (i >= H || j0 >= W) return;
    const int hw = H * W;
    // The block's sim: its offset in each array, added to every index
    // (packed: grid y, packed_grid_for's order).
    const I sim = PACKED ? blockIdx.y : blockIdx.z;
    const I sb = sim * C * hw, pb = sim * hw, fy = sim * H * S, fx = sim * S * W;
    const I fa = sim * S * C;
    int j[TPT];  // the thread's texels, kBlockX apart; past the edge: the last column
    float val[TPT][C];
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
        j[t] = min(j0 + t * kBlockX, W - 1);
        if constexpr (PACKED) {  // the source (C, H, B*W); the prepared (B, H, W[, 4])
            const Packed<I> f(H, W, blockIdx.y, gridDim.y);
#pragma unroll
            for (int c = 0; c < C; ++c) val[t][c] = to_f32(src[f.at(c, i, j[t])]);
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c) val[t][c] = to_f32(src[sb + c * hw + i * W + j[t]]);
        }
    }
    if (S > 0) {
        float acc[TPT][C];
#pragma unroll
        for (int t = 0; t < TPT; ++t)
#pragma unroll
            for (int c = 0; c < C; ++c) acc[t][c] = 0.0f;
        for (int s = 0; s < S; ++s) {
            const float a = gy[fy + i * S + s];
            float ga[C];  // gy * amt: the row's factor, shared by the thread's texels
#pragma unroll
            for (int c = 0; c < C; ++c) ga[c] = a * amt[fa + s * C + c];
#pragma unroll
            for (int t = 0; t < TPT; ++t) {
                const float b = gx[fx + s * W + j[t]];
#pragma unroll
                for (int c = 0; c < C; ++c) acc[t][c] = acc[t][c] + ga[c] * b;
            }
        }
#pragma unroll
        for (int t = 0; t < TPT; ++t)
#pragma unroll
            for (int c = 0; c < C; ++c) val[t][c] = round_to<T>(val[t][c] + acc[t][c]);
    }
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
        if (j0 + t * kBlockX >= W) break;
        const I at = pb + i * W + j[t];
        if constexpr (WORDS) {
            static_assert(C == 3, "RGB9E5 packs three channels");
            static_cast<uint32_t*>(prep)[at] = rgb9e5_pack(val[t][0], val[t][1], val[t][2]);
        } else {
            Quad<T> q;
#pragma unroll
            for (int c = 0; c < 4; ++c) q.v[c] = from_f32<T>(c < C ? val[t][c] : 0.0f);
            static_cast<typename QuadVec<T>::type*>(prep)[at] = q.vec;
        }
    }
}

template <typename T, int C, int LAYOUT, bool SAME_GRID, typename I, bool PACKED>
__global__ void advect_kernel(const T* __restrict__ vel, int hv, int wv,
                              const void* __restrict__ src, T* __restrict__ out, int H, int W,
                              float dt, float decay, const float* __restrict__ dts) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = (PACKED ? blockIdx.z : blockIdx.y) * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const int hw = H * W;
    // The block's sim (packed: grid y, packed_grid_for's order): its
    // offsets, added to every index (the source's in texels for quads and
    // words, in values for planes), its dt and decay.
    const unsigned bz = PACKED ? blockIdx.y : blockIdx.z;
    const I sim = bz;
    const I vb = sim * 2 * hv * wv, ob = sim * C * hw;
    const I sb = LAYOUT == kPlanes ? ob : sim * hw;
    // PACKED (same grid only): the velocity, a planes source and the output
    // are (C, H, B*W); a prepared source stays (B, H, W[, 4]).
    static_assert(!PACKED || SAME_GRID, "a packed fleet has the velocity on the source's grid");
    const Packed<I> f(H, W, bz, gridDim.y);
    const I pitch = f.pitch, plane = f.plane, fb = f.sim;
    if (dts != nullptr) {
        dt = dts[2 * bz];
        decay = dts[2 * bz + 1];
    }
    const float u = ((float)j + 0.5f) / (float)W;
    const float v = ((float)i + 0.5f) / (float)H;
    float vu, vv;
    if constexpr (PACKED) {
        vu = to_f32(vel[fb + i * pitch + j]);
        vv = to_f32(vel[fb + plane + i * pitch + j]);
    } else if constexpr (SAME_GRID) {
        vu = to_f32(vel[vb + i * W + j]);
        vv = to_f32(vel[vb + hw + i * W + j]);
    } else {
        const float x = u * (float)wv - 0.5f, y = v * (float)hv - 0.5f;
        vu = sample_plane(vel, vb, x, y, hv, wv);
        vv = sample_plane(vel, vb + hv * wv, x, y, hv, wv);
    }
    const float cu = u - (dt * vu) / (float)wv;
    const float cv = v - (dt * vv) / (float)hv;
    const float x = cu * (float)W - 0.5f, y = cv * (float)H - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int q0 = min(max((int)x0, 0), W - 1), q1 = min(max((int)x0 + 1, 0), W - 1);
    const int r0 = min(max((int)y0, 0), H - 1), r1 = min(max((int)y0 + 1, 0), H - 1);
    float a[C], b[C], c[C], d[C];  // the lerp's corners
    if constexpr (PACKED && LAYOUT == kPlanes) {
        fetch<T, C, LAYOUT>(src, fb + r0 * pitch + q0, plane, a);
        fetch<T, C, LAYOUT>(src, fb + r0 * pitch + q1, plane, b);
        fetch<T, C, LAYOUT>(src, fb + r1 * pitch + q0, plane, c);
        fetch<T, C, LAYOUT>(src, fb + r1 * pitch + q1, plane, d);
    } else {
        fetch<T, C, LAYOUT>(src, sb + r0 * W + q0, hw, a);
        fetch<T, C, LAYOUT>(src, sb + r0 * W + q1, hw, b);
        fetch<T, C, LAYOUT>(src, sb + r1 * W + q0, hw, c);
        fetch<T, C, LAYOUT>(src, sb + r1 * W + q1, hw, d);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const float top = a[k] + (b[k] - a[k]) * fx;
        const float bot = c[k] + (d[k] - c[k]) * fx;
        const float value = (top + (bot - top) * fy) / decay;
        if constexpr (PACKED)
            out[fb + k * plane + i * pitch + j] = from_f32<T>(value);
        else
            out[ob + k * hw + i * W + j] = from_f32<T>(value);
    }
}

template <typename T, int C, bool WORDS>
static int launch_prepare(const void* src, void* prep, int B, int H, int W, const float* gy,
                          const float* gx, const float* amt, int S, bool packed,
                          cudaStream_t stream) {
    constexpr int cols = kBlockX * kPrepareTexels;
    const dim3 grid((W + cols - 1) / cols, (H + kBlockY - 1) / kBlockY, B);
    const size_t most = std::max({(size_t)C * H * W, (size_t)H * S, (size_t)S * W});
    DISPATCH_INDEX(wide_batch(B, most), I,
        if (packed)
            advect_prepare_kernel<T, C, WORDS, I, true><<<dim3(grid.x, B, grid.y),
                                                          dim3(kBlockX, kBlockY), 0, stream>>>(
                (const T*)src, prep, H, W, gy, gx, amt, S);
        else
            advect_prepare_kernel<T, C, WORDS, I, false><<<grid, dim3(kBlockX, kBlockY), 0,
                                                           stream>>>(
                (const T*)src, prep, H, W, gy, gx, amt, S));
    return (int)cudaGetLastError();
}

template <typename T, int C, int LAYOUT>
static int launch_gather(const void* vel, int hv, int wv, const void* src, void* out, int B,
                         int H, int W, float dt, float decay, const float* dts, bool packed,
                         cudaStream_t stream) {
    const dim3 grid = grid_for(H, W, B), block(kBlockX, kBlockY);
    const bool same = hv == H && wv == W;
    if (packed && !same) return (int)cudaErrorInvalidValue;
    DISPATCH_INDEX(wide_batch(B, std::max(2 * (size_t)hv * wv, (size_t)C * H * W)), I,
        if (packed)
            advect_kernel<T, C, LAYOUT, true, I, true><<<packed_grid_for(H, W, B), block, 0,
                                                         stream>>>(
                (const T*)vel, hv, wv, src, (T*)out, H, W, dt, decay, dts);
        else if (same)
            advect_kernel<T, C, LAYOUT, true, I, false><<<grid, block, 0, stream>>>(
                (const T*)vel, hv, wv, src, (T*)out, H, W, dt, decay, dts);
        else
            advect_kernel<T, C, LAYOUT, false, I, false><<<grid, block, 0, stream>>>(
                (const T*)vel, hv, wv, src, (T*)out, H, W, dt, decay, dts));
    return (int)cudaGetLastError();
}

template <typename T, int C>
static int launch_c(const void* vel, int hv, int wv, const void* src, int layout, void* out,
                    int B, int H, int W, float dt, float decay, const float* dts, bool packed,
                    cudaStream_t stream) {
    if (layout == kPlanes)
        return launch_gather<T, C, kPlanes>(vel, hv, wv, src, out, B, H, W, dt, decay, dts,
                                            packed, stream);
    if (layout == kQuads)
        return launch_gather<T, C, kQuads>(vel, hv, wv, src, out, B, H, W, dt, decay, dts,
                                           packed, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" {

// B sims: src (B, C, H, W) storage `dtype`, or (C, H, B*W) when `fields`
// is kPacked (common.cuh FieldLayout) -> prep: (B, H, W) uint32 RGB9E5
// words when words = 1 (bf16, C = 3), else (B, H, W, 4) storage quads. gy
// (B, H, S), gx (B, S, W), amt (B, S, C) float32 when S > 0.
int fluid_advect_prepare(const void* src, void* prep, int B, int C, int H, int W,
                         const void* gy, const void* gx, const void* amt, int S, int words,
                         int fields, int dtype, void* stream) {
    if (B < 1 || B > kMaxBatch || C < 1 || C > 3 || (words && (C != 3 || dtype != kBF16)) ||
        (fields != kBatched && fields != kPacked))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const float *fy = (const float*)gy, *fx = (const float*)gx, *fa = (const float*)amt;
    const bool pk = fields == kPacked;
    if (words)
        return launch_prepare<__nv_bfloat16, 3, true>(src, prep, B, H, W, fy, fx, fa, S, pk, s);
    DISPATCH_STORAGE(dtype, T,
        if (C == 1)
            return launch_prepare<T, 1, false>(src, prep, B, H, W, fy, fx, fa, S, pk, s);
        if (C == 2)
            return launch_prepare<T, 2, false>(src, prep, B, H, W, fy, fx, fa, S, pk, s);
        return launch_prepare<T, 3, false>(src, prep, B, H, W, fy, fx, fa, S, pk, s));
    return (int)cudaErrorInvalidValue;
}

// B sims: vel (B, 2, hv, wv) storage `dtype`; src in `layout`: kPlanes
// (B, C, H, W) storage, kQuads (B, H, W, 4) storage, kWords (B, H, W) uint32
// (bf16, C = 3); out (B, C, H, W). dts: a (B, 2) float32 table of (clamped
// dt, decay) a sim, or null for the scalars dt and decay of every sim.
// `fields` kPacked (common.cuh FieldLayout; hv = H and wv = W only): vel
// (2, H, B*W), a kPlanes source (C, H, B*W) and out (C, H, B*W); a prepared
// source keeps its (B, H, W[, 4]).
int fluid_advect(const void* vel, int hv, int wv, const void* src, int layout, void* out, int B,
                 int C, int H, int W, float dt, float decay, const void* dts, int fields,
                 int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float* d = (const float*)dts;
    if (B < 1 || B > kMaxBatch || C < 1 || C > 3 || (fields != kBatched && fields != kPacked))
        return (int)cudaErrorInvalidValue;
    const bool pk = fields == kPacked;
    if (layout == kWords) {
        if (C != 3 || dtype != kBF16) return (int)cudaErrorInvalidValue;
        return launch_gather<__nv_bfloat16, 3, kWords>(vel, hv, wv, src, out, B, H, W, dt,
                                                       decay, d, pk, s);
    }
    DISPATCH_STORAGE(dtype, T,
        if (C == 1)
            return launch_c<T, 1>(vel, hv, wv, src, layout, out, B, H, W, dt, decay, d, pk, s);
        if (C == 2)
            return launch_c<T, 2>(vel, hv, wv, src, layout, out, B, H, W, dt, decay, d, pk, s);
        return launch_c<T, 3>(vel, hv, wv, src, layout, out, B, H, W, dt, decay, d, pk, s));
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
