// Semi-Lagrangian advection, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/advect.py:301 `_advect_kernel` (entered
// through advect_pallas, :567) AND tpufluid/ops/pallas/advect_hbm.py:108
// `_kernel` (entered through advect_pallas_hbm, :419). The TPU needs two
// kernels because its gather reads a VMEM window sized from the displacement
// bound; here every thread reads global memory wherever its backtrace lands,
// so one kernel covers velocity self-advection, same-grid dye and dye on a
// grid finer than the velocity.
//
// Per target texel (i, j), all C <= 3 channels:
//   1. uv = ((j + 0.5) / W, (i + 0.5) / H);
//   2. velocity: the texel itself on the same grid, else a bilinear sample of
//      the coarser velocity at uv (no resampled field is materialised);
//   3. backtrace coord = uv - dt * vel / sim_size;
//   4. bilinear clamp-to-edge gather of the source over the FULL grid, in
//      float32. Each corner texel optionally gets the splat bump (rounded to
//      storage, as the splat pass would store it) and, for bf16 dye with
//      RGB9E5 on, the shared-exponent round trip (ops/quant.py);
//   5. divide by 1 + k * dt (computed by the caller in float32), round once.
// The TPU kernels clamp a backtrace at their window's edge when it leaves the
// window; this one clamps at the grid's edge, as the jnp oracle does.
// No hardware texture filtering: its 8-bit fixed-point weights would break
// parity with the plain version.
//
// Bytes per launch (s = storage bytes). Demo default, f32: velocity
// self-advection on 128x228 reads 2s, writes 2s per texel (0.47 MB,
// 0.14 us at 3.35 TB/s); dye on 1024x1820 reads 3s + writes 3s per texel
// plus the 128x228 velocity (45 MB, 13.4 us). 1024x1024 bf16: velocity
// 8.4 MB (2.5 us); dye on the same grid reads 2s of velocity and 3s of dye,
// writes 3s per texel (16.8 MB, 5.0 us). HBM bytes bound it; the gather's
// corners are neighbours of the texel's own row and hit L1/L2. Left for
// later: staging source rows in shared memory and vector loads.
#include "common.cuh"

constexpr float kMaxRgb9e5 = 65408.0f;  // (511 / 512) * 2^16

// Quantize (r, g, b) through RGB9E5 storage, bit for bit the procedure of
// ops/quant.py (pack, then unpack).
__device__ __forceinline__ void rgb9e5_roundtrip(float* rgb) {
    float r = fminf(fmaxf(rgb[0], 0.0f), kMaxRgb9e5);
    float g = fminf(fmaxf(rgb[1], 0.0f), kMaxRgb9e5);
    float b = fminf(fmaxf(rgb[2], 0.0f), kMaxRgb9e5);
    const float maxc = fmaxf(r, fmaxf(g, b));
    const int e = (int)(__float_as_uint(maxc) >> 23) - 127;
    int E = min(max(e + 16, 0), 31);
    const float scale = __uint_as_float((unsigned)(151 - E) << 23);  // 2^(24 - E)
    int mr = (int)floorf(r * scale + 0.5f);
    int mg = (int)floorf(g * scale + 0.5f);
    int mb = (int)floorf(b * scale + 0.5f);
    if (max(mr, max(mg, mb)) > 511) {
        const float half = scale * 0.5f;
        mr = (int)floorf(r * half + 0.5f);
        mg = (int)floorf(g * half + 0.5f);
        mb = (int)floorf(b * half + 0.5f);
        E = E + 1;
    }
    const float us = __uint_as_float((unsigned)((E & 31) + 103) << 23);  // 2^(E - 24)
    rgb[0] = (float)mr * us;
    rgb[1] = (float)mg * us;
    rgb[2] = (float)mb * us;
}

// Bilinear sample of one (h, w) plane at pixel-space (x, y) = uv * size - 0.5.
template <typename T>
__device__ __forceinline__ float sample_plane(const T* plane, float x, float y, int h, int w) {
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix0 = min(max((int)x0, 0), w - 1), ix1 = min(max((int)x0 + 1, 0), w - 1);
    const int iy0 = min(max((int)y0, 0), h - 1), iy1 = min(max((int)y0 + 1, 0), h - 1);
    const float a = to_f32(plane[iy0 * w + ix0]), b = to_f32(plane[iy0 * w + ix1]);
    const float c = to_f32(plane[iy1 * w + ix0]), d = to_f32(plane[iy1 * w + ix1]);
    const float top = a + (b - a) * fx;
    const float bot = c + (d - c) * fx;
    return top + (bot - top) * fy;
}

template <typename T>
__global__ void advect_kernel(const T* __restrict__ vel, int hv, int wv,
                              const T* __restrict__ src, T* __restrict__ out, int C, int H,
                              int W, float dt, float decay, const float* __restrict__ gy,
                              const float* __restrict__ gx, const float* __restrict__ amt,
                              int S, int quant) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const int hw = H * W;
    const float u = ((float)j + 0.5f) / (float)W;
    const float v = ((float)i + 0.5f) / (float)H;

    float vu, vv;
    if (hv == H && wv == W) {
        vu = to_f32(vel[i * W + j]);
        vv = to_f32(vel[hw + i * W + j]);
    } else {
        const float x = u * (float)wv - 0.5f, y = v * (float)hv - 0.5f;
        vu = sample_plane(vel, x, y, hv, wv);
        vv = sample_plane(vel + hv * wv, x, y, hv, wv);
    }
    const float cu = u - (dt * vu) / (float)wv;
    const float cv = v - (dt * vv) / (float)hv;

    const float x = cu * (float)W - 0.5f, y = cv * (float)H - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix[2] = {min(max((int)x0, 0), W - 1), min(max((int)x0 + 1, 0), W - 1)};
    const int iy[2] = {min(max((int)y0, 0), H - 1), min(max((int)y0 + 1, 0), H - 1)};

    // corner[k][c], k = 2 * row + column: a, b, c, d of the lerp.
    float corner[4][3];
    for (int k = 0; k < 4; ++k) {
        const int r = iy[k >> 1], q = ix[k & 1];
        for (int c = 0; c < C; ++c) {
            float val = to_f32(src[c * hw + r * W + q]);
            if (S > 0) val = round_to<T>(val + splat_bump(gy, gx, amt, S, C, c, r, q, W));
            corner[k][c] = val;
        }
        if (quant) rgb9e5_roundtrip(corner[k]);
    }
    for (int c = 0; c < C; ++c) {
        const float top = corner[0][c] + (corner[1][c] - corner[0][c]) * fx;
        const float bot = corner[2][c] + (corner[3][c] - corner[2][c]) * fx;
        out[c * hw + i * W + j] = from_f32<T>((top + (bot - top) * fy) / decay);
    }
}

extern "C" {

// vel (2, hv, wv) and src (C, H, W) share the storage type `dtype`; gy (H, S),
// gx (S, W), amt (S, C) float32 when S > 0. quant = 1: RGB9E5 (C must be 3).
int fluid_advect(const void* vel, int hv, int wv, const void* src, void* out, int C, int H,
                 int W, float dt, float decay, const void* gy, const void* gx, const void* amt,
                 int S, int quant, int dtype, void* stream) {
    if (C < 1 || C > 3 || (quant && C != 3)) return (int)cudaErrorInvalidValue;
    DISPATCH_STORAGE(dtype, T,
        advect_kernel<T><<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
            (const T*)vel, hv, wv, (const T*)src, (T*)out, C, H, W, dt, decay,
            (const float*)gy, (const float*)gx, (const float*)amt, S, quant));
    return (int)cudaGetLastError();
}

}  // extern "C"
