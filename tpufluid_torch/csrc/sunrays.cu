// The sunrays (mask, march, separable blur), for Hopper (sm_90a).
//
// Replaces no TPU kernel: tpufluid/ops/sunrays.py:70 apply_sunrays is jnp
// ops, and so is its plain version here, ops/sunrays.apply_sunrays, whose
// float32 operations this file runs in the same order (-fmad=false):
//   1. mask: 1 - min(max(max_c(dye) * 20, 0), 0.8) over the dye, computed
//      from the three channels at each corner a tap reads; NaN propagates
//      as PyTorch's amax and clamp propagate it (fminf / fmaxf would drop
//      it);
//   2. march: 17 bilinear taps at the sunrays grid (h, w), tap k at the
//      affine map uv * (1 - 0.01875 k) + 0.009375 k, each a column stage
//      at its two mask rows, then the row stage; color = tap 0, then
//      color = color + tap_k * decay_k in tap order, decay_k the float32 of
//      0.95^(k-1) * weight; the sum times 0.7;
//   3. blur: the separable 3-tap blur at the sunrays grid, first along the
//      columns, then along the rows: out = (c * 0.29411764 + m * 0.35294117)
//      + p * 0.35294117, each tap (c, m, p) a two-stage sample whose other
//      axis is the identity map. That map, (k + 0.5) / n * n - 0.5 in
//      float32, need not land on k, so those stages still lerp.
// Every lerp is a * (1 - f) + b * f, each product and the sum rounded. Each
// stage's corner indices and weights come from tables that the wrapper
// builds once per geometry from ops/sampling.affine_axis_plan, the plain
// version's own plans, with 1 - f computed as the plain version computes it
// (ops/cuda/sunrays.py tables): one row of (i0, i1, 1 - f, f) an output
// index, 16 bytes, loaded in one instruction.
//
// Bound: bytes. The pass reads the dye once and writes the rays: at the
// fleet (16 sessions, a 1820x1024 float32 dye, 348x196 rays) 357.8 MB and
// 4.4 MB, 0.108 ms at 3.35 TB/s. The plain version's chain of 324 PyTorch
// launches wrote the mask (119 MB) and 46 separable stages to device memory
// and read them back: 4.1 ms a fleet frame. Here the mask and the stages
// never leave the SM, and the dye is read once:
//   * sunrays_kernel (the march) owns a band of the dye, 16 rows by 256
//     columns of one sim a block (grid z the sim): it reads the band and
//     the next row and column once, in 16-byte loads where the width and
//     the base allow, forms their mask in shared memory, then takes every
//     tap whose first corner row and column lie in the band, 2 x 2 corners
//     from shared memory (the second corners are the same or the next row
//     and column). The output texels of tap k in a band are a rectangle,
//     from tables of each band's first output row and column (the plans'
//     corners rise with the output index). It writes each tap's sample to
//     a (B, 17, h, w) scratch, 74 MB at the fleet: a texel's taps lie in up
//     to 17 bands, so their decay-weighted sum, in tap order, waits for the
//     next launch.
//   * sunrays_blur_kernel: a 16 x 32 output tile a block; the rays window
//     it reaches, the tile and 3 texels around (a column pass's tap reaches
//     2 texels and the row pass's identity column stage 1 more, likewise
//     for rows: the wrapper checks the tables against kHalo), is summed
//     from the scratch into shared memory, then each stage of the two
//     passes runs over the part of the window the next stage reads.
// At the fleet on the H100 the pair takes 0.242 ms, the march 0.188 of it
// (PERF.md). The designs not kept: the march one thread an output texel,
// each tap's 2 x 2 corners' three channels read through the read-only
// cache, 17 taps of whole sectors of every sampled dye row from L2 (0.374
// ms, with the blur 0.405); that march computed into the blur's window, one
// launch, every 64 x 16 tile marching its halo too, 1.5 times the texels
// (0.947 ms); the banded march with 4-byte loads (0.235 ms), unrolled by 4
// (0.236); the blur's tile 8 x 32 (0.059 ms) or 16 x 64 (0.061) against
// 16 x 32's 0.054.
// Indices inside a sim are int (the wrapper refuses a sim of 2^31 elements
// or more); a sim's base pointer is formed once a thread in 64 bits.
#include "common.cuh"

constexpr int kTaps = 17;        // the march: the identity tap and 16 steps
constexpr int kBlurStages = 3;   // a blur pass's taps: center, -1.333, +1.333 texels
constexpr int kHalo = 3;         // rays texels the blurred texel reaches, each way
constexpr float kExposure = 0.7f;
constexpr float kBlurCenter = 0.29411764f, kBlurSide = 0.35294117f;

// One output index of one separable stage: corners i0, i1 and the weights
// g = 1 - f and f, as float bits.
struct Tap {
    int i0, i1;
    float g, f;
};

__device__ __forceinline__ Tap load_tap(const int4* table, int k) {
    const int4 v = __ldg(table + k);
    return Tap{v.x, v.y, __int_as_float(v.z), __int_as_float(v.w)};
}

__device__ __forceinline__ float lerp_tap(float a, float b, const Tap& t) {
    return a * t.g + b * t.f;
}

// PyTorch's amax: a NaN anywhere gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// The tables, rows of (i0, i1, 1 - f, f): the march's column stages (kTaps
// x w) and row stages (kTaps x h), then the blur's (kBlurStages x w, then
// kBlurStages x h), stage 0 the identity map.
struct Tables {
    const int4* march_cols;
    const int4* march_rows;
    const int4* blur_cols;
    const int4* blur_rows;
};

// The march's bands: a block masks kBandRows + 1 dye rows by kBandCols + 1
// columns (a band and the next row and column, which its taps' second
// corners may read) into shared memory.
constexpr int kBandRows = 16, kBandCols = 256;

struct Sunrays {
    const float* dye;    // (B, 3, H, W)
    float* taps;         // (B, kTaps, h, w): each tap's sample, the march's scratch
    float* out;          // (B, h, w)
    Tables tab;
    // Tap k's output rows whose first corner row lies in band j are
    // [rows[k][j], rows[k][j + 1]); its columns in column band i likewise.
    const int* band_rows;  // kTaps x (row bands + 1)
    const int* band_cols;  // kTaps x (column bands + 1)
    int H, W, h, w;
    float decay[kTaps];  // decay[k], k >= 1: float32(0.95^(k-1) * weight)
};

// The mask of one texel's three channels.
__device__ __forceinline__ float mask_of(float r, float g, float b) {
    float t = max_nan(max_nan(r, g), b) * 20.0f;
    t = t < 0.0f ? 0.0f : t;  // clamp_min, NaN kept
    t = t > 0.8f ? 0.8f : t;  // clamp_max, NaN kept
    return 1.0f - t;
}

// The mask at dye texel (r, c) of one sim's planes.
__device__ __forceinline__ float mask_at(const float* __restrict__ dye, int plane, int r, int c,
                                         int W) {
    const int at = r * W + c;
    return mask_of(__ldg(dye + at), __ldg(dye + plane + at), __ldg(dye + 2 * plane + at));
}

// The march's taps: block (i, j) of sim z masks dye rows kBandRows * j ..
// and columns kBandCols * i .. (and one more of each) once, from coalesced
// reads, then samples every tap k at the output texels whose first corner
// row and column lie in its band: their second corners are the same or the
// next row and column. Each (k, y, x) falls in one block, which writes its
// sample to taps[z][k][y][x].
__global__ void __launch_bounds__(kBlockX * kBlockY) sunrays_kernel(Sunrays p) {
    __shared__ float mask[kBandRows + 1][kBandCols + 1];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, n = blockDim.x * blockDim.y;
    const int r0 = blockIdx.y * kBandRows, c0 = blockIdx.x * kBandCols;
    const size_t sim = blockIdx.z;
    const float* dye = p.dye + sim * 3 * p.H * p.W;
    // The band's mask: 4 columns a thread from 16-byte loads where every
    // row of every sim starts 16-byte aligned, the band's last column
    // apart; else a column a thread.
    const int plane = p.H * p.W;
    if ((p.W & 3) == 0 && ((size_t)p.dye & 15) == 0) {
        constexpr int kQuads = kBandCols / 4;
        for (int t = tid; t < (kBandRows + 1) * kQuads; t += n) {
            const int r = t / kQuads, c = (t - r * kQuads) * 4, y = r0 + r, x = c0 + c;
            if (y >= p.H || x >= p.W) continue;
            const int at = y * p.W + x;
            const float4 a = __ldg((const float4*)(dye + at));
            const float4 g = __ldg((const float4*)(dye + plane + at));
            const float4 b = __ldg((const float4*)(dye + 2 * plane + at));
            mask[r][c] = mask_of(a.x, g.x, b.x);
            mask[r][c + 1] = mask_of(a.y, g.y, b.y);
            mask[r][c + 2] = mask_of(a.z, g.z, b.z);
            mask[r][c + 3] = mask_of(a.w, g.w, b.w);
        }
        for (int r = tid; r <= kBandRows; r += n)
            if (r0 + r < p.H && c0 + kBandCols < p.W)
                mask[r][kBandCols] = mask_at(dye, plane, r0 + r, c0 + kBandCols, p.W);
    } else {
        for (int t = tid; t < (kBandRows + 1) * (kBandCols + 1); t += n) {
            const int r = t / (kBandCols + 1), c = t - r * (kBandCols + 1);
            if (r0 + r < p.H && c0 + c < p.W) mask[r][c] = mask_at(dye, plane, r0 + r, c0 + c, p.W);
        }
    }
    __syncthreads();
    float* taps = p.taps + sim * kTaps * p.h * p.w;
    const int row_bands = gridDim.y + 1, col_bands = gridDim.x + 1;
    for (int k = 0; k < kTaps; ++k) {
        const int* rows = p.band_rows + k * row_bands + blockIdx.y;
        const int* cols = p.band_cols + k * col_bands + blockIdx.x;
        const int y0 = rows[0], x0 = cols[0], nx = cols[1] - x0, items = (rows[1] - y0) * nx;
        for (int t = tid; t < items; t += n) {
            const int dy = t / nx, y = y0 + dy, x = x0 + t - dy * nx;
            const Tap cx = load_tap(p.tab.march_cols + k * p.w, x);
            const Tap ry = load_tap(p.tab.march_rows + k * p.h, y);
            const int a = ry.i0 - r0, b = ry.i1 - r0, c = cx.i0 - c0, d = cx.i1 - c0;
            const float top = lerp_tap(mask[a][c], mask[a][d], cx);
            const float bot = lerp_tap(mask[b][c], mask[b][d], cx);
            taps[((size_t)k * p.h + y) * p.w + x] = lerp_tap(top, bot, ry);
        }
    }
}

// The march's rays at output texel (y, x) of one sim from its taps: color =
// tap 0, then color + tap_k * decay_k in tap order, times the exposure.
__device__ __forceinline__ float rays_at(const Sunrays& p, const float* taps, int y, int x) {
    const int at = y * p.w + x, stride = p.h * p.w;
    float color = taps[at];
#pragma unroll
    for (int k = 1; k < kTaps; ++k) color = color + taps[k * stride + at] * p.decay[k];
    return color * kExposure;
}

// A blur tile of kTileH x kTileW output texels a block of kBlockY x
// kBlockX threads, in shared memory: the rays window (the tile and kHalo
// around), the column pass's three column stages at the columns the row
// pass reads (the tile's and 1 around) for every window row, the column
// pass's result at those columns for the rows the row pass reads (the
// tile's and 2 around), and its identity column stage at the tile's columns
// for those rows.
constexpr int kTileH = 16, kTileW = 32;
constexpr int kWinH = kTileH + 2 * kHalo, kWinW = kTileW + 2 * kHalo;
constexpr int kMidH = kTileH + 4, kMidW = kTileW + 2;

struct BlurTile {
    float rays[kWinH][kWinW];
    float cols[kBlurStages][kWinH][kMidW];
    float pass1[kMidH][kMidW];
    float pass1_cols[kMidH][kTileW];
};

__global__ void __launch_bounds__(kBlockX * kBlockY) sunrays_blur_kernel(Sunrays p) {
    __shared__ BlurTile s;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, n = blockDim.x * blockDim.y;
    const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW, h = p.h, w = p.w;
    const size_t sim = blockIdx.z;
    const float* taps = p.taps + sim * kTaps * h * w;

    // The rays window, summed from the march's taps: rows y0 - kHalo ..,
    // columns x0 - kHalo ..; outside the grid 0, which no stage reads
    // (every index is clamped into it).
    for (int t = tid; t < kWinH * kWinW; t += n) {
        const int r = t / kWinW, c = t - r * kWinW, y = y0 - kHalo + r, x = x0 - kHalo + c;
        float v = 0.0f;
        if (y >= 0 && y < h && x >= 0 && x < w) v = rays_at(p, taps, y, x);
        s.rays[r][c] = v;
    }
    __syncthreads();
    // The column pass's column stages at columns x0 - 1 .. x0 + kTileW.
    for (int t = tid; t < kBlurStages * kWinH * kMidW; t += n) {
        const int k = t / (kWinH * kMidW), rc = t - k * (kWinH * kMidW);
        const int r = rc / kMidW, c = rc - r * kMidW, y = y0 - kHalo + r, x = x0 - 1 + c;
        if (y < 0 || y >= h || x < 0 || x >= w) continue;
        const Tap q = load_tap(p.tab.blur_cols + k * w, x);
        const int a = q.i0 - (x0 - kHalo), b = q.i1 - (x0 - kHalo);
        s.cols[k][r][c] = lerp_tap(s.rays[r][a], s.rays[r][b], q);
    }
    __syncthreads();
    // The column pass at rows y0 - 2 .. y0 + kTileH + 1: each tap's
    // identity row stage, then the weighted sum.
    for (int t = tid; t < kMidH * kMidW; t += n) {
        const int r = t / kMidW, c = t - r * kMidW, y = y0 - 2 + r, x = x0 - 1 + c;
        if (y < 0 || y >= h || x < 0 || x >= w) continue;
        const Tap q = load_tap(p.tab.blur_rows, y);
        const int a = q.i0 - (y0 - kHalo), b = q.i1 - (y0 - kHalo);
        const float center = lerp_tap(s.cols[0][a][c], s.cols[0][b][c], q);
        const float minus = lerp_tap(s.cols[1][a][c], s.cols[1][b][c], q);
        const float plus = lerp_tap(s.cols[2][a][c], s.cols[2][b][c], q);
        s.pass1[r][c] = (center * kBlurCenter + minus * kBlurSide) + plus * kBlurSide;
    }
    __syncthreads();
    // The row pass's identity column stage at the tile's columns.
    for (int t = tid; t < kMidH * kTileW; t += n) {
        const int r = t / kTileW, c = t - r * kTileW, y = y0 - 2 + r, x = x0 + c;
        if (y < 0 || y >= h || x >= w) continue;
        const Tap q = load_tap(p.tab.blur_cols, x);
        s.pass1_cols[r][c] = lerp_tap(s.pass1[r][q.i0 - (x0 - 1)], s.pass1[r][q.i1 - (x0 - 1)], q);
    }
    __syncthreads();
    // The row pass's three row stages and the weighted sum.
    float* out = p.out + sim * h * w;
    for (int t = tid; t < kTileH * kTileW; t += n) {
        const int r = t / kTileW, c = t - r * kTileW, y = y0 + r, x = x0 + c;
        if (y >= h || x >= w) continue;
        float tap[kBlurStages];
#pragma unroll
        for (int k = 0; k < kBlurStages; ++k) {
            const Tap q = load_tap(p.tab.blur_rows + k * h, y);
            const int a = q.i0 - (y0 - 2), b = q.i1 - (y0 - 2);
            tap[k] = lerp_tap(s.pass1_cols[a][c], s.pass1_cols[b][c], q);
        }
        out[y * w + x] = (tap[0] * kBlurCenter + tap[1] * kBlurSide) + tap[2] * kBlurSide;
    }
}

static inline dim3 bands(int H, int W, int batch) {
    return dim3((W + kBandCols - 1) / kBandCols, (H + kBandRows - 1) / kBandRows, batch);
}

static int make_params(Sunrays& p, const void* dye, void* taps, void* out, int batch, int H,
                       int W, int h, int w, const void* tables, const void* band_bounds,
                       const float* decay) {
    if (batch < 1 || batch > kMaxBatch || H < 1 || W < 1 || h < 1 || w < 1 ||
        3LL * H * W > INT_MAX || (long long)kTaps * h * w > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const int4* t = (const int4*)tables;
    p.dye = (const float*)dye;
    p.taps = (float*)taps;
    p.out = (float*)out;
    p.tab = Tables{t, t + kTaps * w, t + kTaps * (w + h), t + kTaps * (w + h) + kBlurStages * w};
    p.band_rows = (const int*)band_bounds;
    p.band_cols = p.band_rows + kTaps * (bands(H, W, 1).y + 1);
    p.H = H;
    p.W = W;
    p.h = h;
    p.w = w;
    for (int k = 0; k < kTaps; ++k) p.decay[k] = decay ? decay[k] : 0.0f;
    return 0;
}

extern "C" {

// The march: dye (B, 3, H, W) float32 -> taps (B, kTaps, h, w) float32, B
// in 1..kMaxBatch. tables: int32 rows of 4 on the device, in the order of
// Tables; band_bounds: int32 on the device, the bands' output rows, then
// columns, of each tap (ops/cuda/sunrays.py tables and band_bounds).
int sunrays_march(const void* dye, void* taps, int batch, int H, int W, int h, int w,
                  const void* tables, const void* band_bounds, void* stream) {
    Sunrays p{};
    const int bad = make_params(p, dye, taps, nullptr, batch, H, W, h, w, tables, band_bounds,
                                nullptr);
    if (bad) return bad;
    sunrays_kernel<<<bands(H, W, batch), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// The rays and their blur: taps (B, kTaps, h, w) -> out (B, h, w), both
// float32; the march's tables (H and W locate the blur's); decay: kTaps
// floats on the host, decay[0] unused.
int sunrays_blur(const void* taps, void* out, int batch, int H, int W, int h, int w,
                 const void* tables, const float* decay, void* stream) {
    Sunrays p{};
    const int bad = make_params(p, nullptr, const_cast<void*>(taps), out, batch, H, W, h, w,
                                tables, nullptr, decay);
    if (bad) return bad;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
    sunrays_blur_kernel<<<grid, dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
