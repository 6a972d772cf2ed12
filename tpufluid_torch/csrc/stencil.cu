// Pre-pressure stencils and the gradient subtract, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/stencil.py:98 `_kernel` (entered through
// curl_vorticity_divergence, :335) and :218 `_gs_kernel` (entered through
// gradient_subtract, :297).
//
// pre_pressure is TWO kernels, split at the curl:
//   splat_curl          velocity + separable splat bump (rounded to storage,
//                       as the TPU kernel does) -> bumped velocity (storage)
//                       and curl (float32 scratch);
//   confine_divergence  vorticity confinement at the texel and at its four
//                       neighbours, clamp to +/-1000, divergence with -C wall
//                       reflection from the unrounded float32 velocity ->
//                       velocity (storage), divergence (storage).
// Why split: the divergence needs the confined velocity at the 4 neighbours,
// each of which needs the curl at ITS 4 neighbours, each of which needs the
// velocity at 4 more: one kernel without shared memory would recompute the
// curl 25 times and the bump ~100 times per texel. The split recomputes only
// the confinement (5x per texel) and keeps the curl in float32, so the result
// equals the fused TPU kernel's, which never rounds the curl either.
//
// Bytes per launch (s = storage bytes; sim grid 128x228 f32 demo default,
// 1024x1024 bf16 headline):
//   splat_curl          read 2s + write 2s + 4 per texel, plus gy, gx:
//                       0.59 MB (0.18 us at 3.35 TB/s) / 12.7 MB (3.8 us)
//   confine_divergence  read 2s + 4, write 3s per texel:
//                       0.70 MB (0.21 us) / 14.7 MB (4.4 us)
//   gradient_subtract   read 3s, write 2s per texel:
//                       0.58 MB (0.17 us) / 10.5 MB (3.1 us)
// All three are bound by HBM bytes; the fused TPU kernel moves 5s per texel
// for the whole pre-pressure chain, the split 9s + 8 (the bumped velocity
// and the curl go through memory). Left for later: one tiled kernel with the
// curl in shared memory, which takes back those bytes; at the demo's 29K
// texels the launches, not the bytes, are the cost.
#include "common.cuh"

template <typename T>
__device__ __forceinline__ float bumped(const T* plane, const float* gy, const float* gx,
                                        const float* amt, int S, int c, int i, int j, int W) {
    float x = to_f32(plane[i * W + j]);
    if (S == 0) return x;
    return round_to<T>(x + splat_bump(gy, gx, amt, S, 2, c, i, j, W));
}

template <typename T>
__global__ void splat_curl_kernel(const T* __restrict__ vel, const float* __restrict__ gy,
                                  const float* __restrict__ gx, const float* __restrict__ amt,
                                  int S, T* __restrict__ vel_out, float* __restrict__ curl,
                                  int H, int W) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const T* u = vel;
    const T* v = vel + H * W;
    const int jl = max(j - 1, 0), jr = min(j + 1, W - 1);
    const int ib = max(i - 1, 0), it = min(i + 1, H - 1);
    const float vR = bumped(v, gy, gx, amt, S, 1, i, jr, W);
    const float vL = bumped(v, gy, gx, amt, S, 1, i, jl, W);
    const float uT = bumped(u, gy, gx, amt, S, 0, it, j, W);
    const float uB = bumped(u, gy, gx, amt, S, 0, ib, j, W);
    curl[i * W + j] = 0.5f * (((vR - vL) - uT) + uB);
    vel_out[i * W + j] = from_f32<T>(bumped(u, gy, gx, amt, S, 0, i, j, W));
    vel_out[H * W + i * W + j] = from_f32<T>(bumped(v, gy, gx, amt, S, 1, i, j, W));
}

// Confined, clamped velocity at texel (a, b), in float32.
template <typename T>
__device__ __forceinline__ void confine(const T* vel, const float* curl, float cs, float dt,
                                        int a, int b, int H, int W, float& uo, float& vo) {
    const float c = curl[a * W + b];
    const float cT = curl[min(a + 1, H - 1) * W + b];
    const float cB = curl[max(a - 1, 0) * W + b];
    const float cR = curl[a * W + min(b + 1, W - 1)];
    const float cL = curl[a * W + max(b - 1, 0)];
    float fx = 0.5f * (fabsf(cT) - fabsf(cB));
    float fy = 0.5f * (fabsf(cR) - fabsf(cL));
    const float inv_len = 1.0f / (sqrtf(fx * fx + fy * fy) + 1e-4f);
    const float scale = (cs * c) * inv_len;
    fx = fx * scale;
    fy = -(fy * scale);
    uo = fminf(fmaxf(to_f32(vel[a * W + b]) + fx * dt, -1000.0f), 1000.0f);
    vo = fminf(fmaxf(to_f32(vel[H * W + a * W + b]) + fy * dt, -1000.0f), 1000.0f);
}

template <typename T>
__global__ void confine_divergence_kernel(const T* __restrict__ vel, const float* __restrict__ curl,
                                          float cs, float dt, T* __restrict__ vel_out,
                                          T* __restrict__ div_out, int H, int W) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    float u, v, un, vn;
    confine(vel, curl, cs, dt, i, j, H, W, u, v);
    float Lu = -u, Ru = -u, Bv = -v, Tv = -v;  // -C reflection at the walls
    if (j > 0) { confine(vel, curl, cs, dt, i, j - 1, H, W, un, vn); Lu = un; }
    if (j < W - 1) { confine(vel, curl, cs, dt, i, j + 1, H, W, un, vn); Ru = un; }
    if (i > 0) { confine(vel, curl, cs, dt, i - 1, j, H, W, un, vn); Bv = vn; }
    if (i < H - 1) { confine(vel, curl, cs, dt, i + 1, j, H, W, un, vn); Tv = vn; }
    vel_out[i * W + j] = from_f32<T>(u);
    vel_out[H * W + i * W + j] = from_f32<T>(v);
    div_out[i * W + j] = from_f32<T>(0.5f * (((Ru - Lu) + Tv) - Bv));
}

template <typename T>
__global__ void gradient_subtract_kernel(const T* __restrict__ vel, const T* __restrict__ p,
                                         T* __restrict__ out, int H, int W) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const float pL = to_f32(p[i * W + max(j - 1, 0)]);
    const float pR = to_f32(p[i * W + min(j + 1, W - 1)]);
    const float pB = to_f32(p[max(i - 1, 0) * W + j]);
    const float pT = to_f32(p[min(i + 1, H - 1) * W + j]);
    out[i * W + j] = from_f32<T>(to_f32(vel[i * W + j]) - (pR - pL));
    out[H * W + i * W + j] = from_f32<T>(to_f32(vel[H * W + i * W + j]) - (pT - pB));
}

extern "C" {

int fluid_splat_curl(const void* vel, const void* gy, const void* gx, const void* amt, int S,
                     void* vel_out, void* curl, int H, int W, int dtype, void* stream) {
    DISPATCH_STORAGE(dtype, T,
        splat_curl_kernel<T><<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
            (const T*)vel, (const float*)gy, (const float*)gx, (const float*)amt, S,
            (T*)vel_out, (float*)curl, H, W));
    return (int)cudaGetLastError();
}

int fluid_confine_divergence(const void* vel, const void* curl, float cs, float dt,
                             void* vel_out, void* div_out, int H, int W, int dtype,
                             void* stream) {
    DISPATCH_STORAGE(dtype, T,
        confine_divergence_kernel<T><<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
                                       (cudaStream_t)stream>>>(
            (const T*)vel, (const float*)curl, cs, dt, (T*)vel_out, (T*)div_out, H, W));
    return (int)cudaGetLastError();
}

int fluid_gradient_subtract(const void* vel, const void* p, void* out, int H, int W, int dtype,
                            void* stream) {
    DISPATCH_STORAGE(dtype, T,
        gradient_subtract_kernel<T><<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
                                      (cudaStream_t)stream>>>(
            (const T*)vel, (const T*)p, (T*)out, H, W));
    return (int)cudaGetLastError();
}

}  // extern "C"
