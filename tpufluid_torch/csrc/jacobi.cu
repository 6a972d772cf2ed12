// Jacobi pressure solve, several sweeps per launch, for Hopper (sm_90a).
//
// Replaces tpufluid/ops/pallas/jacobi.py:139 `_jacobi_chunk_kernel` (entered
// through jacobi_pressure, :281, via _jacobi_chunk, :235), which runs up to
// 20 sweeps per memory pass inside a VMEM window. Each sweep is
// p' = ((((L + R) + T) + B) - div) * 0.25 with clamp-to-edge neighbours, T
// the row below (i + 1): the jnp oracle's sum order (the TPU kernel's exact
// path sums ((L + R) + B) + T, which is not bit-equal to it in float32).
//
// What bounds it. The solve as a function reads p and div once and writes p
// once: 3 storage values a cell (0.1 us on the demo's 128x228 f32 grid, 1.9 us
// on 1024x1024 bf16, at 3.35 TB/s). One launch per sweep, the first design,
// moved the field through L2 20 times and paid 20 launch latencies
// (2.4 us a sweep at the demo, 4.2 us at 1024^2).
//
// The design: jacobi_chunk_kernel runs K sweeps per launch on a region of
// RH = NY * R rows by RW columns that one block holds on chip: a tile plus
// a K-deep halo, loaded from global memory (out-of-grid cells hold the
// clamped edge values and are never read by a cell of the grid, whose
// neighbours clamp at the grid's edge). Each thread owns one column and R
// consecutive rows of it in registers (its p and its div); a sweep writes
// the block's values to one of two shared-memory buffers, synchronises once,
// and reads the left and right neighbours and the two rows beyond the
// thread's strip from there; the rows inside the strip are registers. The
// valid part shrinks by one cell a sweep; after K sweeps the block writes
// its central tile. Between launches the field goes through float32
// scratch, so a solve of N sweeps is ceil(N / K) launches.
// Measured on the H100 (PERF.md), the step runs 10 sweeps a launch on one
// of two geometries (ops/cuda/jacobi.py TILES, chosen by its plan): 64x128
// regions, two blocks an SM, where they give every SM a block (1024^2 and
// larger); else 32x64 regions (the demo's 128x228 keeps 66 SMs busy). A
// thread block cluster that held the demo's grid in distributed shared
// memory and ran all 20 sweeps in one launch was slower there: 16 SMs and
// 20 cluster barriers.
// The first launch loads the stored pressure times `prescale` (the 0.8 warm
// start, not rounded on its own); only the last writes storage. So a solve
// rounds once, after its last sweep, and equals jacobi_plain bit for bit
// for every K.
// A launch takes B independent sims (the grid's z axis, each block adding
// its sim's offset to every index: common.cuh DISPATCH_INDEX), the
// counterpart of jax.vmap over the TPU kernel; the single-sim solve is
// B = 1. A sim's blocks run the operations of a single-sim launch, so each
// sim equals its own solve bit for bit.
// The lane-packed fleet's layout (common.cuh FieldLayout: (H, B*W), the sims
// side by side along the rows, the sim on grid z) changes only the strides:
// a block's region lies in one sim, so its clamps are that sim's walls, the
// TPU kernel's wall every sim_w columns (tpufluid/ops/pallas/jacobi.py:
// 181-209), and no region straddles two sims. The float32 scratch between
// the launches of a packed solve is packed too.
#include "common.cuh"

template <typename TIn, typename TOut, typename TD, int RW, int NY, int R, int MINB, typename I,
          bool PACKED>
__global__ void __launch_bounds__(RW * NY, MINB)
jacobi_chunk_kernel(const TIn* __restrict__ p, const TD* __restrict__ div, TOut* __restrict__ out,
                    float prescale, int H, int W, int K) {
    constexpr int RH = NY * R;
    extern __shared__ float buf[];  // two RH x RW buffers, one per sweep parity
    const int tx = threadIdx.x, ty = threadIdx.y;
    // Region origin: the tile's, less the K-deep halo on every side.
    const int r0 = blockIdx.y * (RH - 2 * K) - K;
    const int c0 = blockIdx.x * (RW - 2 * K) - K;
    const int gj = c0 + tx;
    const int cj = min(max(gj, 0), W - 1);
    // The column in the block's sim; packed, rows of the fleet's pitch B*W.
    const I col = PACKED ? sim_offset((I)W) + cj : sim_offset((I)H * W) + cj;
    // Region columns of the left and right neighbours: clamped at the grid's
    // edge, then into the region (a region-edge cell is outside the valid
    // part after its first sweep).
    const int jl = min(max(max(gj - 1, 0) - c0, 0), RW - 1);
    const int jr = min(max(min(gj + 1, W - 1) - c0, 0), RW - 1);
    const int row0 = ty * R;  // the strip's first region row

    float v[R], d[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int r = min(max(r0 + row0 + k, 0), H - 1);
        const I at = PACKED ? r * ((I)gridDim.z * W) + col : r * W + col;
        v[k] = to_f32(p[at]) * prescale;
        d[k] = to_f32(div[at]);
    }

    for (int s = 0; s < K; ++s) {
        float* cur = buf + (s & 1) * (RH * RW);
#pragma unroll
        for (int k = 0; k < R; ++k) cur[(row0 + k) * RW + tx] = v[k];
        __syncthreads();
        // The rows just beyond the strip: another strip of this block, or the
        // region's own edge row (a cell of the grid that reads it there is
        // either at the grid's edge, where it reads itself instead, or
        // outside the valid part).
        const float hi = ty + 1 < NY ? cur[(row0 + R) * RW + tx] : cur[(RH - 1) * RW + tx];
        const float lo = ty > 0 ? cur[(row0 - 1) * RW + tx] : cur[tx];
        float below = lo;  // the old value of the row above k (i - 1)
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int gi = r0 + row0 + k;
            const float* row = cur + (row0 + k) * RW;
            const float T = gi + 1 < H ? (k + 1 < R ? v[min(k + 1, R - 1)] : hi) : v[k];
            const float B = gi > 0 ? below : v[k];
            below = v[k];
            v[k] = ((((row[jl] + row[jr]) + T) + B) - d[k]) * 0.25f;
        }
    }

    const bool col_out = tx >= K && tx < RW - K && gj < W;
    // formed anew after the sweeps
    const I col_at = PACKED ? sim_offset((I)W) + gj : sim_offset((I)H * W) + gj;
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int lr = row0 + k, gi = r0 + lr;
        if (col_out && lr >= K && lr < RH - K && gi < H) {
            if constexpr (PACKED)
                out[gi * ((I)gridDim.z * W) + col_at] = from_f32<TOut>(v[k]);
            else
                out[gi * W + col_at] = from_f32<TOut>(v[k]);
        }
    }
}

template <typename TIn, typename TOut, typename TD, int RW, int NY, int R, int MINB, typename I,
          bool PACKED>
static int launch(const void* p, const void* div, void* out, float prescale, int B, int H, int W,
                  int K, cudaStream_t stream) {
    constexpr int RH = NY * R;
    if (K < 1 || RH - 2 * K < 1 || RW - 2 * K < 1 || B < 1 || B > kMaxBatch)
        return (int)cudaErrorInvalidValue;
    auto kernel = jacobi_chunk_kernel<TIn, TOut, TD, RW, NY, R, MINB, I, PACKED>;
    const size_t smem = 2 * RH * RW * sizeof(float);
    static bool configured = false;  // per instance: the attribute is set once
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((W + RW - 2 * K - 1) / (RW - 2 * K), (H + RH - 2 * K - 1) / (RH - 2 * K), B);
    kernel<<<grid, dim3(RW, NY), smem, stream>>>((const TIn*)p, (const TD*)div, (TOut*)out,
                                                 prescale, H, W, K);
    return (int)cudaGetLastError();
}

// The compiled geometries: (RW, NY, R, blocks an SM must hold), in the
// order of ops/cuda/jacobi.py TILES; I the index type (common.cuh).
template <typename TIn, typename TOut, typename TD, bool PACKED>
static int launch_tiles(int tiles, const void* p, const void* div, void* out, float prescale,
                        int B, int H, int W, int K, cudaStream_t s) {
    DISPATCH_INDEX(wide_batch(B, (size_t)H * W), I,
        switch (tiles) {
            case 0:
                return launch<TIn, TOut, TD, 128, 4, 16, 2, I, PACKED>(p, div, out, prescale, B,
                                                                       H, W, K, s);
            case 1:
                return launch<TIn, TOut, TD, 64, 4, 8, 1, I, PACKED>(p, div, out, prescale, B, H,
                                                                     W, K, s);
            default: return (int)cudaErrorInvalidValue;
        });
    return (int)cudaErrorInvalidValue;
}

template <typename TIn, typename TOut, typename TD>
static int launch_layout(int layout, int tiles, const void* p, const void* div, void* out,
                         float prescale, int B, int H, int W, int K, cudaStream_t s) {
    if (layout == kPacked)
        return launch_tiles<TIn, TOut, TD, true>(tiles, p, div, out, prescale, B, H, W, K, s);
    if (layout == kBatched)
        return launch_tiles<TIn, TOut, TD, false>(tiles, p, div, out, prescale, B, H, W, K, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" {

// K sweeps of B (H, W) fields, (B, H, W) each buffer, or (H, B*W) in the
// packed layout (the float32 scratch too), in one launch on geometry
// `tiles`. p_f32 / out_f32: 1 when that buffer is a float32 scratch buffer,
// 0 when it holds the storage type `dtype` (which the divergence always
// does).
int fluid_jacobi_chunk(const void* p, int p_f32, const void* div, void* out, int out_f32,
                       float prescale, int B, int H, int W, int K, int tiles, int layout,
                       int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define CHUNK_ARGS layout, tiles, p, div, out, prescale, B, H, W, K, s
    DISPATCH_STORAGE(dtype, T,
        if (p_f32 && out_f32) return launch_layout<float, float, T>(CHUNK_ARGS);
        if (p_f32) return launch_layout<float, T, T>(CHUNK_ARGS);
        if (out_f32) return launch_layout<T, float, T>(CHUNK_ARGS);
        return launch_layout<T, T, T>(CHUNK_ARGS));
#undef CHUNK_ARGS
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
