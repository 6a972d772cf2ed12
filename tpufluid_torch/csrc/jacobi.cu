// One Jacobi sweep of the pressure solve, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/jacobi.py:139 `_jacobi_chunk_kernel` (entered
// through jacobi_pressure, :281, via _jacobi_chunk, :235). That kernel runs
// up to 20 sweeps per memory pass inside a VMEM window; here each launch is
// one sweep, p' = (((L + R) + T) + B - div) * 0.25 with clamp-to-edge
// neighbours — the jnp oracle's sum order (the TPU kernel's exact path sums
// ((L + R) + B) + T, which is not bit-equal to it in float32).
//
// The wrapper (ops/cuda/jacobi.py) ping-pongs two float32 buffers: the first
// sweep reads the stored pressure times `prescale` (the 0.8 warm start,
// applied at the load and not rounded on its own), the last writes storage.
// So a solve rounds once, after its last sweep, like the TPU kernel's chunk.
//
// Bytes per sweep (s = storage bytes): read p (4 or s) + div (s), write p'
// (4 or s). Sim grid 128x228 f32: 0.35 MB a sweep, 7.0 MB for 20 sweeps
// (2.1 us at 3.35 TB/s). 1024x1024 bf16: 10.5 MB a middle sweep, ~210 MB
// for 20 (63 us at HBM rate; the 10 MB working set fits the 50 MB L2, so
// the launches mostly read L2). The solve as a function moves only 3s per
// texel (0.1 us / 1.9 us): the bound is set by the 20 passes this design
// makes, and several sweeps per launch in shared-memory tiles (the TPU
// kernel's chunking) are left for later.
#include "common.cuh"

template <typename TIn, typename TOut, typename TD>
__global__ void jacobi_sweep_kernel(const TIn* __restrict__ p, const TD* __restrict__ div,
                                    TOut* __restrict__ out, float prescale, int H, int W) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    const float L = to_f32(p[i * W + max(j - 1, 0)]) * prescale;
    const float R = to_f32(p[i * W + min(j + 1, W - 1)]) * prescale;
    const float T = to_f32(p[min(i + 1, H - 1) * W + j]) * prescale;
    const float B = to_f32(p[max(i - 1, 0) * W + j]) * prescale;
    const float acc = ((L + R) + T) + B;
    out[i * W + j] = from_f32<TOut>((acc - to_f32(div[i * W + j])) * 0.25f);
}

template <typename TIn, typename TOut, typename TD>
static void launch(const void* p, const void* div, void* out, float prescale, int H, int W,
                   cudaStream_t stream) {
    jacobi_sweep_kernel<TIn, TOut, TD><<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(
        (const TIn*)p, (const TD*)div, (TOut*)out, prescale, H, W);
}

extern "C" {

// p_f32 / out_f32: 1 when that buffer is a float32 scratch buffer, 0 when it
// holds the storage type `dtype` (which the divergence always does).
int fluid_jacobi_sweep(const void* p, int p_f32, const void* div, void* out, int out_f32,
                       float prescale, int H, int W, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    DISPATCH_STORAGE(dtype, T,
        if (p_f32 && out_f32) launch<float, float, T>(p, div, out, prescale, H, W, s);
        else if (p_f32) launch<float, T, T>(p, div, out, prescale, H, W, s);
        else if (out_f32) launch<T, float, T>(p, div, out, prescale, H, W, s);
        else launch<T, T, T>(p, div, out, prescale, H, W, s));
    return (int)cudaGetLastError();
}

}  // extern "C"
