// Semi-Lagrangian advection, for Hopper (sm_90a): the velocity's gather and
// the dye's windowed kernel.
//
// Replaces tpufluid/ops/pallas/advect.py:301 `_advect_kernel` (entered
// through advect_pallas, :567) AND tpufluid/ops/pallas/advect_hbm.py:108
// `_kernel` (entered through advect_pallas_hbm, :419): advect_kernel on the
// velocity's self-advection, advect_dye_kernel on every dye call (a splat
// bump, an RGB9E5 quantization or both), same grid or on a grid finer than
// the velocity. Both clamp a backtrace at the grid's edge, as the jnp oracle
// does. No hardware texture filtering: its 8-bit fixed-point weights would
// break parity with the plain version.
//
// What bounds them. The function moves each input once and each output
// once: 1024x1024 bf16 reads 2s of velocity for the self-advection and
// writes 2s, then reads 2s of velocity and 3s of dye and writes 3s (s =
// storage bytes; 16.8 MB for the dye with the splat factors, 5.0 us at
// 3.35 TB/s); the demo's f32 dye on 1024x1820 reads 3s and writes 3s per
// texel plus the 128x228 velocity (45.1 MB, 13.4 us). Bytes, not
// operations: the dye's bump and RGB9E5 round trip are ~40-120 float32
// operations a source texel, ~2 us of the card's float32 rate at 1024^2.
//
// advect_kernel, one thread per target texel, templated on the storage
// type, the channel count and same grid against a coarser velocity, so
// every corner and channel lives in registers: read the velocity once,
// backtrace with the same float32 operations as the plain version, load the
// 4 corners from the source planes, lerp in the plain order, divide by
// 1 + k * dt and round once.
//
// advect_dye_kernel, the dye. Its source texels are not the stored ones:
// each gets the separable splat bump (s = 0..S-1, (gy * amt) * gx, no FMA),
// is rounded to storage and, for bf16 with RGB9E5, goes through the RGB9E5
// round trip. A source texel is a bilinear corner of ~4 target texels, so
// preparing it for each corner costs ~4 times the work, and preparing the
// whole source in a launch of its own writes it to device memory and reads
// it back (+132% of the function's bytes at the demo) in a launch more a
// step. So, the TPU kernel's plan, one kernel that bumps and packs its
// staged window (advect.py:331-400, advect_hbm.py:318-345):
//   1. A block owns a 32 x 32 target tile (256 threads, 4 rows each; a
//      square tile's window has the least halo for its texels, and
//      measured faster than 64 x 16 on random and flow states, PERF.md). Every
//      thread backtraces its texels, as advect_kernel does, and the block
//      reduces their clamped corners to the bounding box of the tile's
//      source footprint (warp shuffles, then one shared-memory step).
//   2. Where the box, with the splat factors of its rows and columns, fits
//      kDyeSmem bytes of shared memory, the block stages it: gy * amt of
//      the box's rows, gx of its columns, then every box texel's prepared
//      value, computed once (RGB9E5 words, 4 bytes a texel, else the
//      rounded storage values). The 4 corners of each target texel then
//      come from shared memory. The bump sums only the sim's active splat
//      rows (amt not all zero), which the block lists first: a step of a
//      trace has one or two of its 8 or 16 rows on.
//   3. A box that does not fit (a velocity that is not smooth across the
//      tile: random noise, or a displacement gradient past ~50 texels
//      across a tile) is not staged: each corner's prepared value is
//      computed from device memory, in the same kernel.
// Both paths call one function, prepared_texel, so they agree bit for bit
// by construction, and both equal the plain version. A flow's velocity is
// smooth across a tile, so its boxes are the tile and a few texels of halo
// (ops/cuda/advect.py dye_window_plan counts the share that fits).
// The window is read with element loads, kDyeStage a thread at once, not
// cp.async: each value is bumped, rounded and packed in registers before it
// is stored. The velocity may be float32 beside a 16-bit dye (VT): the
// sharded step's velocity resampled on the dye's grid is not rounded to
// storage.
//
// Measured on the H100 (PERF.md, tools/dye_variants.py): on flow states
// nearly every window fits, yet the kernel takes about as long as the
// former prepare + gather pair or longer. Its phases (backtraces and box,
// staging, gather) follow one another behind barriers in each block, at 32
// warps an SM (64 registers a thread), so their latencies add up:
// knocking out the staging or the gather leaves about two thirds of the
// time. Where no window fits (noise at the demo's 8x ratio) each corner is
// prepared anew, 2-3x the former pair.
//
// Both kernels take a batch of B independent sims in one launch (the
// counterpart of jax.vmap over the TPU kernels, tpufluid/batch.py): the
// grid's z axis is the sim, each block adds its sim's offset to the index
// of every field and factor (32-bit where the batch fits, else 64:
// common.cuh DISPATCH_INDEX; here left to the optimizer, which measured
// faster than sim_offset's opaque term), and reads its sim's dt and decay
// from a (B, 2) table that the host computed (or the scalars, for
// lock-step). The single-sim advection is B = 1 with the scalars; each sim
// of a batch runs the operations of its own launch, bit for bit.
//
// Both kernels also read and write the lane-packed fleet's layout
// (common.cuh FieldLayout: (C, H, B*W) fields, the sim on grid y, same grid
// only). A thread's backtrace stays in its sim's own float coordinates and
// clamps to that sim's columns [0, W - 1], so a dye window never leaves its
// sim: the TPU kernel's per-lane clamp at its sim's walls
// (tpufluid/ops/pallas/advect.py:450-461), without its packed-column
// coordinates (:442-447), so a packed sim equals its batched sim bit for bit.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

constexpr float kMaxRgb9e5 = 65408.0f;  // (511 / 512) * 2^16

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

// The C float32 values of source texel `at` (its sim's offset included) of
// C planes `hw` apart (H * B * W in the packed layout).
template <typename T, int C, typename I, typename S>
__device__ __forceinline__ void fetch(const void* src, I at, S hw, float* val) {
#pragma unroll
    for (int c = 0; c < C; ++c) val[c] = to_f32(static_cast<const T*>(src)[c * hw + at]);
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

template <typename T, int C, bool SAME_GRID, typename I, bool PACKED>
__global__ void advect_kernel(const T* __restrict__ vel, int hv, int wv,
                              const void* __restrict__ src, T* __restrict__ out, int H, int W,
                              float dt, float decay, const float* __restrict__ dts) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = (PACKED ? blockIdx.z : blockIdx.y) * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const int hw = H * W;
    // The block's sim (packed: grid y, packed_grid_for's order): its
    // offsets, added to every index, its dt and decay.
    const unsigned bz = PACKED ? blockIdx.y : blockIdx.z;
    const I sim = bz;
    const I vb = sim * 2 * hv * wv, ob = sim * C * hw;
    // PACKED (same grid only): the velocity, the source and the output are
    // (C, H, B*W).
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
    if constexpr (PACKED) {
        fetch<T, C>(src, fb + r0 * pitch + q0, plane, a);
        fetch<T, C>(src, fb + r0 * pitch + q1, plane, b);
        fetch<T, C>(src, fb + r1 * pitch + q0, plane, c);
        fetch<T, C>(src, fb + r1 * pitch + q1, plane, d);
    } else {
        fetch<T, C>(src, ob + r0 * W + q0, hw, a);
        fetch<T, C>(src, ob + r0 * W + q1, hw, b);
        fetch<T, C>(src, ob + r1 * W + q0, hw, c);
        fetch<T, C>(src, ob + r1 * W + q1, hw, d);
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

// ---- the dye ----------------------------------------------------------

// The dye kernel's target tile, threads and shared-memory budget
// (ops/cuda/advect.py DYE_TILE, DYE_SMEM). 24 KB a block and 64 registers
// a thread (the launch bounds) leave 4 blocks of 256 threads an SM; the
// budget holds a 32 x 32 tile's box with a halo of ~45 texels in RGB9E5
// words, ~13 in f32, and measured faster than 48 KB at 3 blocks an SM on
// random and flow states alike (PERF.md). A staging thread loads kDyeStage
// window texels before it prepares any of them.
constexpr int kDyeTileW = 32;
constexpr int kDyeTileH = 32;
constexpr int kDyeThreadsY = 8;
constexpr int kDyeRows = kDyeTileH / kDyeThreadsY;  // target rows a thread
constexpr int kDyeThreads = kDyeTileW * kDyeThreadsY;
constexpr int kDyeWarps = kDyeThreads / 32;
constexpr int kDyeSmem = 24 * 1024;
constexpr int kDyeStage = 4;

// The prepared value of a source texel: its C values rounded to storage, or
// (WORDS) the RGB9E5 word they pack into.
template <int C, bool WORDS> struct Prepared {
    float v[C];
    __device__ __forceinline__ void decode(float* out) const {
#pragma unroll
        for (int c = 0; c < C; ++c) out[c] = v[c];
    }
};
template <> struct Prepared<3, true> {
    uint32_t word;
    __device__ __forceinline__ void decode(float* out) const { rgb9e5_unpack(word, out); }
};

// The prepared value of one source texel, from its C storage values `v`
// (float32): the splat bump added in the plain version's order (the splat
// rows in ascending order, acc + (gy * amt) * gx, no FMA) and rounded to
// storage, then (WORDS) packed to RGB9E5, whose unpacked values are exactly
// the round trip's. The sum runs over the `n` rows whose amt is not all
// zero: a zero row adds +-0 to an accumulator that starts at +0, which
// leaves it as it is. `row(a, c)` is gy[i, s] * amt[s, c] of the a-th such
// row s and the texel's row i, `col(a)` gx[s, j] of its column j: staged in
// shared memory or read from device memory, the same float32 values. Every
// prepared texel of advect_dye_kernel comes from here, so its two paths
// agree bit for bit.
template <typename T, int C, bool WORDS, typename Row, typename Col>
__device__ __forceinline__ Prepared<C, WORDS> prepared_texel(float* v, int n, Row row, Col col,
                                                             bool bump) {
    if (bump) {
        float acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.0f;
        for (int a = 0; a < n; ++a) {
            const float b = col(a);
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = acc[c] + row(a, c) * b;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = round_to<T>(v[c] + acc[c]);
    }
    Prepared<C, WORDS> p;
    if constexpr (WORDS) {
        static_assert(C == 3, "RGB9E5 packs three channels");
        p.word = rgb9e5_pack(v[0], v[1], v[2]);
    } else {
#pragma unroll
        for (int c = 0; c < C; ++c) p.v[c] = v[c];
    }
    return p;
}

// One block: a kDyeTileH x kDyeTileW target tile of one sim. VT: the
// velocity's type, T's or float32. Dynamic shared memory, kDyeSmem bytes:
// the active splat rows (S ints) and their amt (S x C), then, where the
// window fits, its rows' and columns' factors and its prepared texels.
template <typename T, int C, bool WORDS, bool SAME_GRID, typename VT, typename I, bool PACKED>
__global__ void __launch_bounds__(kDyeThreads, 4)
advect_dye_kernel(const VT* __restrict__ vel, int hv, int wv, const T* __restrict__ src,
                  T* __restrict__ out, int H, int W, float dt, float decay,
                  const float* __restrict__ dts, const float* __restrict__ gy,
                  const float* __restrict__ gx, const float* __restrict__ amt, int S) {
    static_assert(!PACKED || SAME_GRID, "a packed fleet has the velocity on the source's grid");
    extern __shared__ float4 dye_smem[];
    __shared__ int warp_box[kDyeWarps][4];
    __shared__ int n_active;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kDyeTileW + tx;
    const int warp = tid >> 5, lane = tid & 31;
    // The block's sim (packed: grid y, rows on grid z) and its offsets.
    const unsigned bz = PACKED ? blockIdx.y : blockIdx.z;
    const int i0 = (PACKED ? blockIdx.z : blockIdx.y) * kDyeTileH + ty;
    const int j = blockIdx.x * kDyeTileW + tx;
    const int hw = H * W;
    const I sim = bz;
    const I vb = sim * 2 * hv * wv, ob = sim * C * hw;
    const I fy = sim * H * S, fx = sim * S * W;
    const Packed<I> f(H, W, bz, gridDim.y);
    if (dts != nullptr) {
        dt = dts[2 * bz];
        decay = dts[2 * bz + 1];
    }
    // Source texel (i, j) of the block's sim, channel c.
    const auto source = [&](int c, int i, int jj) -> float {
        if constexpr (PACKED)
            return to_f32(src[f.at(c, i, jj)]);
        else
            return to_f32(src[ob + c * hw + i * W + jj]);
    };
    int* act = reinterpret_cast<int*>(dye_smem);  // the active rows s, ascending
    float* amt_act = reinterpret_cast<float*>(act + S);  // their amt, (n, C)
    // Warp 0: the amt of splat rows 0-31, loaded before the backtraces.
    float amt0[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
        amt0[c] = warp == 0 && lane < S ? amt[sim * S * C + lane * C + c] : 0.0f;

    // 1. The backtraces, advect_kernel's operations, and their box. A
    // texel's corners are kept as its floor column and row clamped to
    // [-1, W - 1] and [-1, H - 1], plus one, 16 bits each in one register
    // (H, W <= 65535; clamps of them to [0, N - 1] give advect_kernel's
    // corners).
    unsigned corner[kDyeRows];
    float wx[kDyeRows], wy[kDyeRows];
    int lo_r = INT_MAX, hi_r = INT_MIN, lo_q = INT_MAX, hi_q = INT_MIN;
    const float u = ((float)j + 0.5f) / (float)W;
#pragma unroll
    for (int t = 0; t < kDyeRows; ++t) {
        const int i = i0 + t * kDyeThreadsY;
        corner[t] = 0;
        wx[t] = wy[t] = 0.0f;
        if (i >= H || j >= W) continue;
        const float v = ((float)i + 0.5f) / (float)H;
        float vu, vv;
        if constexpr (PACKED) {
            vu = to_f32(vel[f.sim + i * f.pitch + j]);
            vv = to_f32(vel[f.sim + f.plane + i * f.pitch + j]);
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
        wx[t] = x - x0;
        wy[t] = y - y0;
        const int xc = min(max((int)x0, -1), W - 1), yc = min(max((int)y0, -1), H - 1);
        corner[t] = (unsigned)(xc + 1) | ((unsigned)(yc + 1) << 16);
        lo_r = min(lo_r, max(yc, 0));
        hi_r = max(hi_r, min(yc + 1, H - 1));
        lo_q = min(lo_q, max(xc, 0));
        hi_q = max(hi_q, min(xc + 1, W - 1));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        lo_r = min(lo_r, __shfl_xor_sync(0xffffffffu, lo_r, o));
        hi_r = max(hi_r, __shfl_xor_sync(0xffffffffu, hi_r, o));
        lo_q = min(lo_q, __shfl_xor_sync(0xffffffffu, lo_q, o));
        hi_q = max(hi_q, __shfl_xor_sync(0xffffffffu, hi_q, o));
    }
    if (lane == 0) {
        warp_box[warp][0] = lo_r;
        warp_box[warp][1] = hi_r;
        warp_box[warp][2] = lo_q;
        warp_box[warp][3] = hi_q;
    }
    // 2. The sim's active splat rows (warp 0, a ballot over 32 rows at a time).
    if (warp == 0) {
        int n = 0;
        for (int s0 = 0; s0 < S; s0 += 32) {
            const int s = s0 + lane;
            float m[C];
            bool on = false;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                m[c] = s0 == 0 ? amt0[c] : s < S ? amt[sim * S * C + s * C + c] : 0.0f;
                on = on || m[c] != 0.0f;
            }
            const unsigned ballot = __ballot_sync(0xffffffffu, on);
            if (on) {
                const int at = n + __popc(ballot & ((1u << lane) - 1u));
                act[at] = s;
#pragma unroll
                for (int c = 0; c < C; ++c) amt_act[at * C + c] = m[c];
            }
            n += __popc(ballot);
        }
        if (lane == 0) n_active = n;
    }
    __syncthreads();
    int R0 = INT_MAX, R1 = INT_MIN, Q0 = INT_MAX, Q1 = INT_MIN;
#pragma unroll
    for (int w = 0; w < kDyeWarps; ++w) {  // every tile holds a texel: the box is not empty
        R0 = min(R0, warp_box[w][0]);
        R1 = max(R1, warp_box[w][1]);
        Q0 = min(Q0, warp_box[w][2]);
        Q1 = max(Q1, warp_box[w][3]);
    }
    const int bh = R1 - R0 + 1, bw = Q1 - Q0 + 1, n = n_active;
    const bool bump = S > 0;

    // The target texels of the thread, their corners from `fetch(i, j,
    // values)`: lerped in the plain order, divided by the decay, rounded once.
    const auto gather = [&](auto fetch) {
#pragma unroll
        for (int t = 0; t < kDyeRows; ++t) {
            const int i = i0 + t * kDyeThreadsY;
            if (i >= H || j >= W) continue;
            const int xc = (int)(corner[t] & 0xffffu) - 1, yc = (int)(corner[t] >> 16) - 1;
            const int q0 = max(xc, 0), q1 = min(xc + 1, W - 1);
            const int r0 = max(yc, 0), r1 = min(yc + 1, H - 1);
            float a[C], b[C], c[C], d[C];
            fetch(r0, q0, a);
            fetch(r0, q1, b);
            fetch(r1, q0, c);
            fetch(r1, q1, d);
#pragma unroll
            for (int k = 0; k < C; ++k) {
                const float top = a[k] + (b[k] - a[k]) * wx[t];
                const float bot = c[k] + (d[k] - c[k]) * wx[t];
                const float value = (top + (bot - top) * wy[t]) / decay;
                if constexpr (PACKED)
                    out[f.at(k, i, j)] = from_f32<T>(value);
                else
                    out[ob + k * hw + i * W + j] = from_f32<T>(value);
            }
        }
    };

    using Stored = typename std::conditional<WORDS, uint32_t, T>::type;
    constexpr long long kTexelBytes = WORDS ? 4 : C * (long long)sizeof(T);
    const long long fixed = 4LL * S * (1 + C);  // the active rows and their amt
    const long long factors = 4LL * n * ((long long)bh * C + bw);
    if (fixed + factors + (long long)bh * bw * kTexelBytes <= kDyeSmem) {
        // 3. The window: gy * amt of its rows (bh, n, C), gx of its columns
        // (n, bw), then its prepared texels, (bh, bw) words or (C, bh, bw).
        // A thread's texels k0 + tid + kDyeThreads * m of the window, read
        // kDyeStage at a time (the whole window of a flow's tile at once),
        // the first ones before the factors are staged.
        float* row_f = amt_act + S * C;
        float* col_f = row_f + bh * n * C;
        Stored* win = reinterpret_cast<Stored*>(col_f + n * bw);
        const int texels = bh * bw;
        const float inv_bw = 1.0f / (float)bw;
        const auto row_of = [&](int k) {  // k / bw: the estimate is within one
            int r = (int)((float)k * inv_bw);
            r -= r * bw > k ? 1 : 0;
            r += (r + 1) * bw <= k ? 1 : 0;
            return r;
        };
        for (int k0 = 0; k0 < texels; k0 += kDyeThreads * kDyeStage) {  // uniform trips
            float v[kDyeStage][C];
#pragma unroll
            for (int m = 0; m < kDyeStage; ++m) {
                const int k = k0 + tid + kDyeThreads * m;
                const int r = row_of(k), q = k - r * bw;
#pragma unroll
                for (int c = 0; c < C; ++c)
                    v[m][c] = k < texels ? source(c, R0 + r, Q0 + q) : 0.0f;
            }
            if (k0 == 0) {
                for (int k = tid; k < bh * n * C; k += kDyeThreads) {
                    const int r = k / (n * C), ac = k - r * (n * C), a = ac / C;
                    row_f[k] = gy[fy + (R0 + r) * S + act[a]] * amt_act[ac];
                }
                for (int k = tid; k < n * bw; k += kDyeThreads) {
                    const int a = k / bw;
                    col_f[k] = gx[fx + act[a] * W + Q0 + (k - a * bw)];
                }
                __syncthreads();
            }
#pragma unroll
            for (int m = 0; m < kDyeStage; ++m) {
                const int k = k0 + tid + kDyeThreads * m;
                if (k >= texels) break;
                const int r = row_of(k), q = k - r * bw;
                const Prepared<C, WORDS> p = prepared_texel<T, C, WORDS>(
                    v[m], n, [&](int a, int c) { return row_f[(r * n + a) * C + c]; },
                    [&](int a) { return col_f[a * bw + q]; }, bump);
                if constexpr (WORDS) {
                    win[k] = p.word;
                } else {
#pragma unroll
                    for (int c = 0; c < C; ++c) win[c * texels + k] = from_f32<T>(p.v[c]);
                }
            }
        }
        __syncthreads();
        gather([&](int i, int jj, float* val) {
            const int at = (i - R0) * bw + (jj - Q0);
            if constexpr (WORDS) {
                rgb9e5_unpack(win[at], val);
            } else {
#pragma unroll
                for (int c = 0; c < C; ++c) val[c] = to_f32(win[c * texels + at]);
            }
        });
    } else {
        // 4. A window past the budget: each corner prepared from device
        // memory (the active rows' amt from shared memory).
        gather([&](int i, int jj, float* val) {
            float v[C];
#pragma unroll
            for (int c = 0; c < C; ++c) v[c] = source(c, i, jj);
            prepared_texel<T, C, WORDS>(
                v, n, [&](int a, int c) { return gy[fy + i * S + act[a]] * amt_act[a * C + c]; },
                [&](int a) { return gx[fx + act[a] * W + jj]; }, bump).decode(val);
        });
    }
}

template <typename T, int C>
static int launch_gather(const void* vel, int hv, int wv, const void* src, void* out, int B,
                         int H, int W, float dt, float decay, const float* dts, bool packed,
                         cudaStream_t stream) {
    const dim3 grid = grid_for(H, W, B), block(kBlockX, kBlockY);
    const bool same = hv == H && wv == W;
    if (packed && !same) return (int)cudaErrorInvalidValue;
    DISPATCH_INDEX(wide_batch(B, std::max(2 * (size_t)hv * wv, (size_t)C * H * W)), I,
        if (packed)
            advect_kernel<T, C, true, I, true><<<packed_grid_for(H, W, B), block, 0, stream>>>(
                (const T*)vel, hv, wv, src, (T*)out, H, W, dt, decay, dts);
        else if (same)
            advect_kernel<T, C, true, I, false><<<grid, block, 0, stream>>>(
                (const T*)vel, hv, wv, src, (T*)out, H, W, dt, decay, dts);
        else
            advect_kernel<T, C, false, I, false><<<grid, block, 0, stream>>>(
                (const T*)vel, hv, wv, src, (T*)out, H, W, dt, decay, dts));
    return (int)cudaGetLastError();
}

// One advect_dye_kernel instance on `grid`, its shared-memory budget
// granted once per instance and device (a budget that, with the static box, passes
// the default 48 KB needs it; tools/dye_variants.py builds such budgets).
template <typename T, int C, bool WORDS, bool SAME_GRID, typename VT, typename I, bool PACKED>
static int launch_dye_instance(dim3 grid, const void* vel, int hv, int wv, const void* src,
                               void* out, int H, int W, float dt, float decay, const float* dts,
                               const float* gy, const float* gx, const float* amt, int S,
                               cudaStream_t stream) {
    const auto kernel = advect_dye_kernel<T, C, WORDS, SAME_GRID, VT, I, PACKED>;
    static unsigned long long granted = 0;
    const cudaError_t err = opt_in_smem(kernel, kDyeSmem, granted);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, dim3(kDyeTileW, kDyeThreadsY), kDyeSmem, stream>>>(
        (const VT*)vel, hv, wv, (const T*)src, (T*)out, H, W, dt, decay, dts, gy, gx, amt, S);
    return (int)cudaGetLastError();
}

template <typename T, int C, bool WORDS, typename VT>
static int launch_dye(const void* vel, int hv, int wv, const void* src, void* out, int B, int H,
                      int W, float dt, float decay, const float* dts, const float* gy,
                      const float* gx, const float* amt, int S, bool packed,
                      cudaStream_t stream) {
    const bool same = hv == H && wv == W;
    const dim3 tiles((W + kDyeTileW - 1) / kDyeTileW, (H + kDyeTileH - 1) / kDyeTileH, B);
    const size_t most = std::max({2 * (size_t)hv * wv, (size_t)C * H * W, (size_t)H * S,
                                  (size_t)S * W});
    if (packed) {  // same grid, the velocity in storage (ops/cuda/advect.py refuses others)
        if (!same || !std::is_same<VT, T>::value) return (int)cudaErrorInvalidValue;
        const dim3 grid(tiles.x, B, tiles.y);  // packed_grid_for's order
        DISPATCH_INDEX(wide_batch(B, most), I,
            return launch_dye_instance<T, C, WORDS, true, T, I, true>(
                grid, vel, hv, wv, src, out, H, W, dt, decay, dts, gy, gx, amt, S, stream));
    }
    DISPATCH_INDEX(wide_batch(B, most), I,
        if (same)
            return launch_dye_instance<T, C, WORDS, true, VT, I, false>(
                tiles, vel, hv, wv, src, out, H, W, dt, decay, dts, gy, gx, amt, S, stream);
        return launch_dye_instance<T, C, WORDS, false, VT, I, false>(
            tiles, vel, hv, wv, src, out, H, W, dt, decay, dts, gy, gx, amt, S, stream));
}

// The dye's storage forms, with the velocity in storage or float32.
template <typename T, int C>
static int launch_dye_c(int vel_dtype, const void* vel, int hv, int wv, const void* src,
                        void* out, int B, int H, int W, float dt, float decay, const float* dts,
                        const float* gy, const float* gx, const float* amt, int S, bool packed,
                        cudaStream_t stream) {
    if constexpr (!std::is_same<T, float>::value) {
        if (vel_dtype == kF32)
            return launch_dye<T, C, false, float>(vel, hv, wv, src, out, B, H, W, dt, decay,
                                                  dts, gy, gx, amt, S, packed, stream);
    }
    return launch_dye<T, C, false, T>(vel, hv, wv, src, out, B, H, W, dt, decay, dts, gy, gx,
                                      amt, S, packed, stream);
}

extern "C" {

// B sims: vel (B, 2, hv, wv) storage `dtype`; src and out (B, C, H, W).
// dts: a (B, 2) float32 table of (clamped dt, decay) a sim, or null for the
// scalars dt and decay of every sim. `fields` kPacked (common.cuh
// FieldLayout; hv = H and wv = W only): vel (2, H, B*W), src and out
// (C, H, B*W).
int fluid_advect(const void* vel, int hv, int wv, const void* src, void* out, int B, int C,
                 int H, int W, float dt, float decay, const void* dts, int fields, int dtype,
                 void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float* d = (const float*)dts;
    if (B < 1 || B > kMaxBatch || C < 1 || C > 3 || (fields != kBatched && fields != kPacked))
        return (int)cudaErrorInvalidValue;
    const bool pk = fields == kPacked;
    DISPATCH_STORAGE(dtype, T,
        if (C == 1)
            return launch_gather<T, 1>(vel, hv, wv, src, out, B, H, W, dt, decay, d, pk, s);
        if (C == 2)
            return launch_gather<T, 2>(vel, hv, wv, src, out, B, H, W, dt, decay, d, pk, s);
        return launch_gather<T, 3>(vel, hv, wv, src, out, B, H, W, dt, decay, d, pk, s));
    return (int)cudaErrorInvalidValue;
}

// The dye: B sims, src and out (B, C, H, W) storage `dtype`, vel (B, 2, hv,
// wv) of `vel_dtype` (`dtype`, or float32 beside a 16-bit dye in the
// batched layout); gy (B, H, S), gx (B, S, W), amt (B, S, C) float32 when
// S > 0; words = 1: through RGB9E5 (bf16, C = 3). dts as fluid_advect's.
// `fields` kPacked: vel (2, H, B*W), src and out (C, H, B*W), the factors
// a batch's.
int fluid_advect_dye(const void* vel, int hv, int wv, int vel_dtype, const void* src, void* out,
                     int B, int C, int H, int W, float dt, float decay, const void* dts,
                     const void* gy, const void* gx, const void* amt, int S, int words,
                     int fields, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float *d = (const float*)dts, *fy = (const float*)gy, *fx = (const float*)gx,
                *fa = (const float*)amt;
    if (B < 1 || B > kMaxBatch || C < 1 || C > 3 || S < 0 || 8LL * S * (1 + C) > kDyeSmem ||
        H > 65535 || W > 65535 ||
        (fields != kBatched && fields != kPacked) || (words && (C != 3 || dtype != kBF16)) ||
        (vel_dtype != dtype && (vel_dtype != kF32 || dtype == kF32 || fields == kPacked)))
        return (int)cudaErrorInvalidValue;
    const bool pk = fields == kPacked;
    if (words) {
        if (vel_dtype == kF32)
            return launch_dye<__nv_bfloat16, 3, true, float>(vel, hv, wv, src, out, B, H, W, dt,
                                                             decay, d, fy, fx, fa, S, pk, s);
        return launch_dye<__nv_bfloat16, 3, true, __nv_bfloat16>(
            vel, hv, wv, src, out, B, H, W, dt, decay, d, fy, fx, fa, S, pk, s);
    }
    DISPATCH_STORAGE(dtype, T,
        if (C == 1)
            return launch_dye_c<T, 1>(vel_dtype, vel, hv, wv, src, out, B, H, W, dt, decay, d,
                                      fy, fx, fa, S, pk, s);
        if (C == 2)
            return launch_dye_c<T, 2>(vel_dtype, vel, hv, wv, src, out, B, H, W, dt, decay, d,
                                      fy, fx, fa, S, pk, s);
        return launch_dye_c<T, 3>(vel_dtype, vel, hv, wv, src, out, B, H, W, dt, decay, d, fy,
                                  fx, fa, S, pk, s));
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
