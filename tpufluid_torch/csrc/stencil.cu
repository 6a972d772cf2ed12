// Pre-pressure chain and the gradient subtract, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/stencil.py:98 `_kernel` (entered through
// curl_vorticity_divergence, :335) and :218 `_gs_kernel` (entered through
// gradient_subtract, :297).
//
// pre_pressure is ONE tiled kernel: separable splat bump (rounded to
// storage, as the TPU kernel does) -> curl -> vorticity confinement (clamp
// to +/-1000) -> divergence with -C wall reflection from the unrounded
// float32 velocity -> velocity (storage), divergence (storage).
//
// A block owns a TH x TW output tile. The divergence on the tile needs the
// confined velocity on tile+1, which needs the curl on tile+2, which needs
// the bumped velocity on tile+3: the block keeps a window of the tile and a
// 3-texel halo in shared memory and runs the chain there in four stages,
// each over the ring it needs, with a barrier between them:
//   0. loads: the two velocity planes of the window in storage type, by
//      16-byte cp.async copies (rows of 16-byte units from a column 16 bytes
//      left of the tile; plain loads where the width leaves rows unaligned);
//      meanwhile the splat factors of the window's rows (gy[i, s] * amt[s, c],
//      the plain version's first product) and columns (gx[s, j]), and the
//      list of the splat rows whose amount is not zero (the step always
//      passes MAX_SPLATS rows and zeroes the inactive ones; a zero row adds
//      +/-0 to a sum that starts at +0, which changes no bit);
//   1. bump on tile+3, once per texel and channel, summed over the listed
//      rows in order, rounded to storage, kept as float32; four rows a
//      thread, so one 16-byte load brings the row factors of four texels;
//   2. curl on tile+2 (float32, over the dead velocity window);
//   3. confined, clamped velocity on tile+1, in place over the bump (a
//      texel reads its own bumped value and the curl only): one sqrtf and
//      one IEEE division a texel;
//   4. the tile's velocity and divergence, each rounded to storage once.
// Every neighbour index is the clamped GLOBAL coordinate less the buffer's
// origin, so an edge tile needs no special values: a stage writes only the
// texels inside the grid and none reads another. A block whose window lies
// inside the grid runs the stages without the clamps, walls and skips. The
// rounding points are the TPU kernel's and the plain version's, so in
// float32, bfloat16 and float16 the kernel equals pre_pressure_plain bit
// for bit.
//
// What bounds it. The function reads the velocity and the factors once and
// writes the velocity and the divergence once: 5 storage values a texel
// (s bytes each) plus gy and gx. Demo (sim 128x228 f32): 0.595 MB, 0.18 us
// at 3.35 TB/s; 1024x1024 bf16: 10.55 MB, 3.15 us; 4096x4096 bf16: 168 MB,
// 50 us. Its 69 + 4 x active splats float32 operations a texel (a sqrtf
// and a division counted at 16 and 18, ops/cuda/check.py) stay under the
// bytes at every grid. The kernel does more: the halo's overcompute,
// (TH+6)(TW+6) / (TH TW) of the bump's work (1.30 on the 32x64 tiles, 2.08
// on 8x32), the window's re-read of its neighbours' edges (1.3-1.5x the
// velocity's bytes on 32x64, mostly from L2), and some 25 shared-memory
// accesses a texel across the stages. Measured (PERF.md), it is bound by
// the instructions of its stages, not by the bytes. ops/cuda/stencil.py
// plan picks the tile from the grid and the SM count.
//
// Both kernels take a batch of B independent sims in one launch, the
// counterpart of jax.vmap over the TPU kernels (tpufluid/batch.py): the
// grid's z axis is the sim, every block adds its sim's offset to the index
// of each field and splat factor it reads (in 64 bits, or for the gradient
// subtract in 32 where the batch fits: common.cuh DISPATCH_INDEX), and
// pre_pressure reads its dt either from the scalar (lock-step) or from
// dts[2 sim] of a (B, 2) table of (clamped dt, decay) that the host
// computed. The single-sim step is B = 1 with the scalar dt. Sims never read each other, and each sim's blocks run the very
// operations of a single-sim launch, so every sim equals its own launch bit
// for bit on either tile.
//
// pre_pressure runs on a WINDOW of its arrays: rows r0w .. r0w + H - 1 and
// columns c0w .. c0w + W - 1 of Hs x Ws planes (the whole planes, where the
// step calls it). Its tiles, clamps and -C walls are the window's: a shard of
// the sharded step (tpufluid_torch/parallel) passes its halo-padded block and
// the grid's true walls inside it (tpufluid/ops/pallas/stencil.py:116-130
// takes them as four bounds), and the wrapper clips them to the window. Every
// address is the sim's planes, plus the window's base r0w * Ws + c0w, plus a
// window row times the pitch Ws; the splat factors are those of the whole
// planes, read at rows r0w + i and columns c0w + j. No copy of the window is
// made, and the kernel on a window equals it on a copy of that window bit for
// bit: nothing outside the window is read into a result. The 16-byte window
// loads need the pitch, the base and the planes in whole 16-byte units.
//
// Both kernels also take the lane-packed fleet's layout (tpufluid/
// batch_packed.py; common.cuh FieldLayout): B sims side by side along the
// rows of (C, H, B*W) fields, the sim on grid z as in a batch. A packed sim
// is pre_pressure's window at column b*W of the fleet's planes (pitch B*W,
// plane H*B*W), with its own splat factors, (B, H, S), (B, S, W), (B, S, 2);
// the gradient subtract forms the same strides. A block's clamps and -C
// walls are then its sim's: the TPU kernels' walls every sim_w columns
// (stencil.py:121-126, :238-241). The window loads of a packed sim are
// whole 16-byte units where W is (W * itemsize a multiple of 16); other
// widths take the element loads, with the same result.
#include <cuda_pipeline.h>

#include "common.cuh"

constexpr int kPreThreads = 256;
constexpr int kHalo = 3;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// The shared-memory plan of one TH x TW tile of storage type T.
template <typename T, int TH, int TW>
struct PreTile {
    static constexpr int U = 16 / (int)sizeof(T);   // elements of a 16-byte copy
    static constexpr int WH = TH + 2 * kHalo;       // window rows (tile+3)
    static constexpr int WW = TW + 2 * kHalo;       // window columns (tile+3)
    static constexpr int WHP = round_up(WH, 4);     // rows of the row factors
    static constexpr int LW = TW + 2 * U;           // loaded columns: tile +/- U
    static constexpr int CH = TH + 4, CW = TW + 4;  // curl (tile+2)
    static constexpr int kLoad = 2 * WH * LW * (int)sizeof(T);
    static constexpr int kA = round_up(max_int(kLoad, 4 * CH * CW), 16);  // window, then curl
    static constexpr int kB = 2 * WH * WW * 4;                            // bump, then confined
    static_assert(TW % U == 0 && U >= kHalo, "a tile row is whole 16-byte units");
    // ... then the row and column factors of S splat rows and the list of
    // the rows that move the field (S + 1 ints).
    static int bytes(int S) { return kA + kB + 4 * S * (2 * WHP + WW) + 4 * (S + 1); }
};

// Stages 1-4 of a block (the header), on the splat rows listed in
// `moving` (S = 0: no factors, and no rounding after the bump), writing the
// sim whose velocity and divergence start at vb and db. EDGE: the
// window reaches past the grid, so neighbours clamp, the walls reflect and
// the texels outside the grid are skipped; in an interior block every
// neighbour is the texel beside.
template <bool EDGE, typename T, int TH, int TW>
__device__ __forceinline__ void pre_pressure_stages(
        const T* win, float* curl, float* bu, float* bv, const float* ga, const float* gxs,
        const int* moving, int S, float cs, float dt, T* __restrict__ vel_out,
        T* __restrict__ div_out, size_t vb, size_t db, size_t plane, int pitch, int H, int W,
        int ti0, int tj0) {
    using L = PreTile<T, TH, TW>;
    constexpr int WH = L::WH, WW = L::WW, WHP = L::WHP, LW = L::LW, U = L::U;
    constexpr int CH = L::CH, CW = L::CW;
    const int tid = threadIdx.x;
    const int r0 = ti0 - kHalo, c0 = tj0 - kHalo;
    const auto row = [&](int g) { return EDGE ? min(max(g, 0), H - 1) : g; };
    const auto col = [&](int g) { return EDGE ? min(max(g, 0), W - 1) : g; };
    const auto out_rows = [&](int gi) { return EDGE && (gi < 0 || gi >= H); };
    const auto out_cols = [&](int gj) { return EDGE && (gj < 0 || gj >= W); };

    // Stage 1. Bumped velocity on the window, four rows a thread.
    const int n = S > 0 ? moving[S] : 0;
    for (int e = tid; e < (WHP / 4) * WW; e += kPreThreads) {
        const int y0 = 4 * (e / WW), x = e % WW;
        if (out_cols(c0 + x)) continue;
        float au[4] = {0.0f, 0.0f, 0.0f, 0.0f}, av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < n; ++k) {
            const int s = moving[k];
            const float g = gxs[s * WW + x];
            const float4 a = *reinterpret_cast<const float4*>(ga + s * WHP + y0);
            const float4 b = *reinterpret_cast<const float4*>(ga + (S + s) * WHP + y0);
            au[0] = au[0] + a.x * g;
            au[1] = au[1] + a.y * g;
            au[2] = au[2] + a.z * g;
            au[3] = au[3] + a.w * g;
            av[0] = av[0] + b.x * g;
            av[1] = av[1] + b.y * g;
            av[2] = av[2] + b.z * g;
            av[3] = av[3] + b.w * g;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int y = y0 + r;
            if (y >= WH || out_rows(r0 + y)) continue;
            float u = to_f32(win[y * LW + x + U - kHalo]);
            float v = to_f32(win[(WH + y) * LW + x + U - kHalo]);
            if (S > 0) {
                u = round_to<T>(u + au[r]);
                v = round_to<T>(v + av[r]);
            }
            bu[y * WW + x] = u;
            bv[y * WW + x] = v;
        }
    }
    __syncthreads();

    // Stage 2. Curl on tile+2, origin (ti0 - 2, tj0 - 2).
    for (int e = tid; e < CH * CW; e += kPreThreads) {
        const int gi = ti0 - 2 + e / CW, gj = tj0 - 2 + e % CW;
        if (out_rows(gi) || out_cols(gj)) continue;
        const int y = gi - r0, x = gj - c0;
        const float vR = bv[y * WW + col(gj + 1) - c0];
        const float vL = bv[y * WW + col(gj - 1) - c0];
        const float uT = bu[(row(gi + 1) - r0) * WW + x];
        const float uB = bu[(row(gi - 1) - r0) * WW + x];
        curl[e] = 0.5f * (((vR - vL) - uT) + uB);
    }
    __syncthreads();

    // Stage 3. Confined, clamped velocity on tile+1, in place.
    for (int e = tid; e < (TH + 2) * (TW + 2); e += kPreThreads) {
        const int gi = ti0 - 1 + e / (TW + 2), gj = tj0 - 1 + e % (TW + 2);
        if (out_rows(gi) || out_cols(gj)) continue;
        const int cy = gi - (ti0 - 2), cx = gj - (tj0 - 2);
        const float c = curl[cy * CW + cx];
        const float cT = curl[(row(gi + 1) - (ti0 - 2)) * CW + cx];
        const float cB = curl[(row(gi - 1) - (ti0 - 2)) * CW + cx];
        const float cR = curl[cy * CW + col(gj + 1) - (tj0 - 2)];
        const float cL = curl[cy * CW + col(gj - 1) - (tj0 - 2)];
        float fx = 0.5f * (fabsf(cT) - fabsf(cB));
        float fy = 0.5f * (fabsf(cR) - fabsf(cL));
        const float inv_len = 1.0f / (sqrtf(fx * fx + fy * fy) + 1e-4f);
        const float scale = (cs * c) * inv_len;
        fx = fx * scale;
        fy = -(fy * scale);
        const int at = (gi - r0) * WW + gj - c0;
        bu[at] = fminf(fmaxf(bu[at] + fx * dt, -1000.0f), 1000.0f);
        bv[at] = fminf(fmaxf(bv[at] + fy * dt, -1000.0f), 1000.0f);
    }
    __syncthreads();

    // Stage 4. The tile: velocity and divergence (-C reflection at the walls).
    for (int e = tid; e < TH * TW; e += kPreThreads) {
        const int gi = ti0 + e / TW, gj = tj0 + e % TW;
        if (EDGE && (gi >= H || gj >= W)) continue;
        const int at = (gi - r0) * WW + gj - c0;
        const float u = bu[at], v = bv[at];
        const float Lu = !EDGE || gj > 0 ? bu[at - 1] : -u;
        const float Ru = !EDGE || gj < W - 1 ? bu[at + 1] : -u;
        const float Bv = !EDGE || gi > 0 ? bv[at - WW] : -v;
        const float Tv = !EDGE || gi < H - 1 ? bv[at + WW] : -v;
        const size_t o = (size_t)gi * pitch + gj;
        vel_out[vb + o] = from_f32<T>(u);
        vel_out[vb + plane + o] = from_f32<T>(v);
        div_out[db + o] = from_f32<T>(0.5f * (((Ru - Lu) + Tv) - Bv));
    }
}

template <typename T, int TH, int TW, bool PACKED>
__global__ void __launch_bounds__(kPreThreads)
pre_pressure_kernel(const T* __restrict__ vel, const float* __restrict__ gy,
                    const float* __restrict__ gx, const float* __restrict__ amt, int S,
                    float cs, float dt, const float* __restrict__ dts,
                    T* __restrict__ vel_out, T* __restrict__ div_out, int Hs, int Ws,
                    int r0w, int c0w, int H, int W, int aligned) {
    using L = PreTile<T, TH, TW>;
    constexpr int WH = L::WH, WW = L::WW, WHP = L::WHP, LW = L::LW, U = L::U;
    extern __shared__ __align__(16) unsigned char smem[];
    T* win = reinterpret_cast<T*>(smem);                  // (2, WH, LW), stages 0-1
    float* curl = reinterpret_cast<float*>(smem);         // (CH, CW), stages 2-3
    float* bu = reinterpret_cast<float*>(smem + L::kA);   // (WH, WW) u, then v
    float* bv = bu + WH * WW;
    float* ga = bv + WH * WW;                             // (2, S, WHP) row factors
    float* gxs = ga + 2 * S * WHP;                        // (S, WW) column factors
    int* moving = reinterpret_cast<int*>(gxs + S * WW);   // rows that move, then their count
    const int tid = threadIdx.x;
    const int ti0 = blockIdx.y * TH, tj0 = blockIdx.x * TW;
    const int r0 = ti0 - kHalo, c0 = tj0 - kHalo;         // the block's window origin
    const size_t plane = (size_t)Hs * Ws;
    // The block's sim: its offsets, added to every index, and its dt. The
    // fields' offsets start at the window's base. PACKED: the planes are
    // the fleet's (Hs = H, Ws = B*W) and the sim is the window at column
    // b*W; its column factors are (B, S, W).
    size_t vb, db;
    if constexpr (PACKED) {
        vb = db = sim_offset((size_t)W);
    } else {
        const size_t wbase = (size_t)r0w * Ws + c0w, sp = sim_offset(plane);
        vb = 2 * sp + wbase;
        db = sp + wbase;
    }
    const int fpitch = PACKED ? W : Ws;  // a row of the column factors
    const size_t fy = sim_offset((size_t)Hs * S) + (size_t)r0w * S;
    const size_t fx = sim_offset((size_t)S * fpitch) + c0w, fa = sim_offset(2 * (size_t)S);
    if (dts != nullptr) dt = dts[2 * blockIdx.z];

    // Stage 0. The velocity window, rows r0.., columns tj0 - U.. (aligned:
    // the units start at multiples of U in the planes, and one that starts
    // inside the window ends inside the planes).
    if (aligned) {
        constexpr int units = LW / U;
        for (int e = tid; e < 2 * WH * units; e += kPreThreads) {
            const int m = e % units, row = e / units;     // row: c * WH + y
            const int gi = r0 + row % WH, gj = tj0 - U + m * U;
            if (gi < 0 || gi >= H || gj < 0 || gj >= W) continue;
            __pipeline_memcpy_async(win + row * LW + m * U,
                                    vel + vb + (row / WH) * plane + (size_t)gi * Ws + gj, 16);
        }
    } else {
        for (int e = tid; e < 2 * WH * LW; e += kPreThreads) {
            const int x = e % LW, row = e / LW;
            const int gi = r0 + row % WH, gj = tj0 - U + x;
            if (gi < 0 || gi >= H || gj < 0 || gj >= W) continue;
            win[e] = vel[vb + (row / WH) * plane + (size_t)gi * Ws + gj];
        }
    }
    __pipeline_commit();
    for (int e = tid; e < WH * S; e += kPreThreads) {
        const int y = e / S, s = e - y * S, gi = r0 + y;
        if (gi < 0 || gi >= H) continue;
        const float g = gy[fy + gi * S + s];
        ga[s * WHP + y] = g * amt[fa + 2 * s];
        ga[(S + s) * WHP + y] = g * amt[fa + 2 * s + 1];
    }
    for (int e = tid; e < S * WW; e += kPreThreads) {
        const int s = e / WW, x = e - s * WW, gj = c0 + x;
        if (gj < 0 || gj >= W) continue;
        gxs[e] = gx[fx + s * fpitch + gj];
    }
    // The splat rows whose amount is not zero, in order: another row adds
    // (gy * 0) * gx = +/-0 to a sum that starts at +0, which changes no bit.
    if (tid < 32) {
        int n = 0;
        for (int base = 0; base < S; base += 32) {
            const int s = base + tid;
            const bool on = s < S && (amt[fa + 2 * s] != 0.0f || amt[fa + 2 * s + 1] != 0.0f);
            const unsigned mask = __ballot_sync(0xffffffffu, on);
            if (on) moving[n + __popc(mask & ((1u << tid) - 1u))] = s;
            n += __popc(mask);
        }
        if (tid == 0) moving[S] = n;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    if (r0 >= 0 && c0 >= 0 && r0 + WH <= H && c0 + WW <= W)
        pre_pressure_stages<false, T, TH, TW>(win, curl, bu, bv, ga, gxs, moving, S, cs, dt,
                                              vel_out, div_out, vb, db, plane, Ws, H, W, ti0,
                                              tj0);
    else
        pre_pressure_stages<true, T, TH, TW>(win, curl, bu, bv, ga, gxs, moving, S, cs, dt,
                                             vel_out, div_out, vb, db, plane, Ws, H, W, ti0,
                                             tj0);
}

template <typename T, int TH, int TW, bool PACKED>
static int launch_pre(const void* vel, const void* gy, const void* gx, const void* amt, int S,
                      float cs, float dt, const float* dts, void* vel_out, void* div_out,
                      int B, int Hs, int Ws, int r0w, int c0w, int H, int W,
                      cudaStream_t stream) {
    using L = PreTile<T, TH, TW>;
    const auto kernel = pre_pressure_kernel<T, TH, TW, PACKED>;
    const int smem = L::bytes(S);
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, so that it is not reported by a later launch
            return (int)err;
        }
    }
    // Packed, a sim's window starts at column b*W: its units are whole
    // where W is (c0w is 0).
    const int aligned = Ws % L::U == 0 && c0w % L::U == 0 && (!PACKED || W % L::U == 0) &&
                        reinterpret_cast<size_t>(vel) % 16 == 0;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    kernel<<<grid, kPreThreads, smem, stream>>>(
        (const T*)vel, (const float*)gy, (const float*)gx, (const float*)amt, S, cs, dt, dts,
        (T*)vel_out, (T*)div_out, Hs, Ws, r0w, c0w, H, W, aligned);
    return (int)cudaGetLastError();
}

// The compiled tiles (TH, TW), in the order of ops/cuda/stencil.py TILES.
template <typename T, bool PACKED>
static int launch_pre_tiles(int tiles, const void* vel, const void* gy, const void* gx,
                            const void* amt, int S, float cs, float dt, const float* dts,
                            void* vel_out, void* div_out, int B, int Hs, int Ws, int r0w,
                            int c0w, int H, int W, cudaStream_t s) {
#define PRE_ARGS vel, gy, gx, amt, S, cs, dt, dts, vel_out, div_out, B, Hs, Ws, r0w, c0w, H, W, s
    switch (tiles) {
        case 0: return launch_pre<T, 32, 64, PACKED>(PRE_ARGS);
        case 1: return launch_pre<T, 8, 32, PACKED>(PRE_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef PRE_ARGS
}

template <typename T, typename I, bool PACKED>
__global__ void gradient_subtract_kernel(const T* __restrict__ vel, const T* __restrict__ p,
                                         T* __restrict__ out, int H, int W) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = (PACKED ? blockIdx.z : blockIdx.y) * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    if constexpr (PACKED) {  // p (H, B*W), vel and out (2, H, B*W): one sim offset and pitch
        const Packed<I> f(H, W, blockIdx.y, gridDim.y);  // packed_grid_for
        const float pL = to_f32(p[f.at(0, i, max(j - 1, 0))]);
        const float pR = to_f32(p[f.at(0, i, min(j + 1, W - 1))]);
        const float pB = to_f32(p[f.at(0, max(i - 1, 0), j)]);
        const float pT = to_f32(p[f.at(0, min(i + 1, H - 1), j)]);
        const I at = f.at(0, i, j);
        out[at] = from_f32<T>(to_f32(vel[at]) - (pR - pL));
        out[at + f.plane] = from_f32<T>(to_f32(vel[at + f.plane]) - (pT - pB));
        return;
    }
    const I hw = (I)H * W, pb = sim_offset(hw), vb = sim_offset(2 * hw);  // the sim's planes
    const float pL = to_f32(p[pb + i * W + max(j - 1, 0)]);
    const float pR = to_f32(p[pb + i * W + min(j + 1, W - 1)]);
    const float pB = to_f32(p[pb + max(i - 1, 0) * W + j]);
    const float pT = to_f32(p[pb + min(i + 1, H - 1) * W + j]);
    out[vb + i * W + j] = from_f32<T>(to_f32(vel[vb + i * W + j]) - (pR - pL));
    out[vb + hw + i * W + j] = from_f32<T>(to_f32(vel[vb + hw + i * W + j]) - (pT - pB));
}

extern "C" {

// B sims: vel (B, 2, Hs, Ws) and the outputs in storage type `dtype`; gy
// (B, Hs, S), gx (B, S, Ws), amt (B, S, 2) float32, or null with S = 0 (no
// splats); dts a (B, 2) float32 table of (clamped dt, decay), or null for
// the scalar dt of every sim. The kernel writes the H x W window at row
// r0w, column c0w of the outputs and nothing else. `tiles`: the tile of
// ops/cuda/stencil.py plan. A launch past the block's shared memory (a very
// large S) is refused and returns its error. The packed layout: vel and
// the velocity out (2, H, B*W), the divergence (H, B*W), gx (B, S, W), with
// Hs = H, Ws = B*W and the window the whole sim (r0w = c0w = 0).
int fluid_pre_pressure(const void* vel, const void* gy, const void* gx, const void* amt, int S,
                       float cs, float dt, const void* dts, void* vel_out, void* div_out, int B,
                       int Hs, int Ws, int r0w, int c0w, int H, int W, int tiles, int layout,
                       int dtype, void* stream) {
    if (S < 0 || B < 1 || B > kMaxBatch || H < 1 || W < 1 || r0w < 0 || c0w < 0 ||
        r0w + H > Hs || c0w + W > Ws)
        return (int)cudaErrorInvalidValue;
    if (layout == kPacked && (Hs != H || Ws != B * W || r0w != 0 || c0w != 0))
        return (int)cudaErrorInvalidValue;
    if (layout != kBatched && layout != kPacked) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const float* d = (const float*)dts;
    DISPATCH_STORAGE(dtype, T,
        if (layout == kPacked)
            return launch_pre_tiles<T, true>(tiles, vel, gy, gx, amt, S, cs, dt, d, vel_out,
                                             div_out, B, Hs, Ws, r0w, c0w, H, W, s);
        return launch_pre_tiles<T, false>(tiles, vel, gy, gx, amt, S, cs, dt, d, vel_out,
                                          div_out, B, Hs, Ws, r0w, c0w, H, W, s));
    return (int)cudaErrorInvalidValue;
}

// B sims: vel and out (B, 2, H, W), p (B, H, W); in the packed layout vel
// and out (2, H, B*W), p (H, B*W).
int fluid_gradient_subtract(const void* vel, const void* p, void* out, int B, int H, int W,
                            int layout, int dtype, void* stream) {
    if (B < 1 || B > kMaxBatch || (layout != kBatched && layout != kPacked))
        return (int)cudaErrorInvalidValue;
    const dim3 grid = grid_for(H, W, B), block(kBlockX, kBlockY);
    const cudaStream_t s = (cudaStream_t)stream;
    DISPATCH_STORAGE(dtype, T, DISPATCH_INDEX(wide_batch(B, 2 * (size_t)H * W), I,
        if (layout == kPacked)
            gradient_subtract_kernel<T, I, true><<<packed_grid_for(H, W, B), block, 0, s>>>(
                (const T*)vel, (const T*)p, (T*)out, H, W);
        else
            gradient_subtract_kernel<T, I, false><<<grid, block, 0, s>>>(
                (const T*)vel, (const T*)p, (T*)out, H, W)));
    return (int)cudaGetLastError();
}

}  // extern "C"
