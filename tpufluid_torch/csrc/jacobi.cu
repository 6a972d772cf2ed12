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
// The step's solve ends in jacobi_project_kernel, the same region and sweeps
// with the gradient subtract fused in: tpufluid/ops/pallas/jacobi.py:139 on
// its last chunk, then tpufluid/ops/pallas/stencil.py:218 `_gs_kernel`,
// vel - (p[j+1] - p[j-1], p[i+1] - p[i-1]), un-halved, clamped at the
// grid's edge. Its halo is K + 1 deep, so that after the K-th sweep the
// valid part is the tile and a ring of one cell: the tile's neighbours. The
// standalone kernel reads the stored pressure, so the valid part is rounded
// to storage and back before the gradient reads it from shared memory; the
// tile's pressure is written in storage and the projected velocity to a new
// buffer. One launch and one read of the pressure fewer a step than the
// chunk and stencil.cu's gradient_subtract, and the same bits. K = 0 is a
// launch too (a solve of no sweeps): the warm start, rounded, then the
// gradient. The sharded step exchanges its pressure between the solve and
// the gradient, so it keeps the two apart.
// The velocity: after the sweeps each thread asks for its strip's tile
// cells, both planes, before the barrier that publishes the rounded
// pressure, from indices formed once for the strip, so that the loads are
// in flight together. Measured on the H100 (PERF.md section 6):
// loading each row just before its stores made the loads wait one after
// another, and the fused solve slower than the pair it replaces at 4096^2
// and in the fleets; prefetching the velocity into L2 (before the sweeps or
// at the last one) and staging it in shared memory by cp.async were slower
// than this form at every cell timed. It was still about 1% slower than
// the pair at 16 sims of 256^2, where the deeper halo takes 7 tiles of 42
// rows a sim for the chunk's 6 of 44; so the fused launch is a programmatic
// dependent launch: the chunk before it lets it start once the chunk's last
// blocks have started, and its blocks wait for the chunk's writes on SMs
// the chunk's last wave leaves idle, which hides the gap between the two
// launches (0.7-3.5 us a solve on the H100, faster than the pair at every
// cell timed).
#include "common.cuh"

// One block's region: load, K sweeps, then the tile. PROJECT: the halo is
// K + 1 deep and the tile's velocity is projected on the rounded pressure
// (vel and vel_out hold (2, H, W) a sim, in the layout's strides).
template <typename TIn, typename TOut, typename TD, int RW, int NY, int R, typename I,
          bool PACKED, bool PROJECT>
__device__ __forceinline__ void jacobi_region(const TIn* __restrict__ p,
                                              const TD* __restrict__ div,
                                              TOut* __restrict__ out,
                                              const TOut* __restrict__ vel,
                                              TOut* __restrict__ vel_out, float prescale, int H,
                                              int W, int K, float* buf) {
    constexpr int RH = NY * R;
    const int G = PROJECT ? K + 1 : K;  // the halo
    const int tx = threadIdx.x, ty = threadIdx.y;
    // Region origin: the tile's, less the G-deep halo on every side.
    const int r0 = blockIdx.y * (RH - 2 * G) - G;
    const int c0 = blockIdx.x * (RW - 2 * G) - G;
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

    const bool col_out = tx >= G && tx < RW - G && gj < W;
    if constexpr (!PROJECT) {
        // formed anew after the sweeps
        const I col_at = PACKED ? sim_offset((I)W) + gj : sim_offset((I)H * W) + gj;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int lr = row0 + k, gi = r0 + lr;
            if (col_out && lr >= G && lr < RH - G && gi < H) {
                const I at = PACKED ? gi * ((I)gridDim.z * W) + col_at : gi * W + col_at;
                out[at] = from_f32<TOut>(v[k]);
            }
        }
    } else {
        // The pressure as stored, in the buffer the last sweep did not read
        // (every thread has passed that sweep's barrier, after its reads of
        // this one); the tile reads itself and its neighbours there.
        float* const pr = buf + (K & 1) * (RH * RW);
#pragma unroll
        for (int k = 0; k < R; ++k) pr[(row0 + k) * RW + tx] = round_to<TOut>(v[k]);
        // The strip's rows in the tile, [k_lo, k_hi); the index of its first
        // row's pressure (the sim's plane, or the fleet's rows) and velocity
        // (plane 0 of the sim's (2, H, W) block, or of the fleet's; plane 1
        // a plane on), a row `step` on.
        const int k_lo = max(G - row0, 0), k_hi = min(min(RH - G, H - r0) - row0, R);
        const I step = PACKED ? (I)gridDim.z * W : (I)W, plane = (I)H * step;
        const I p0 = (I)(r0 + row0) * step + sim_offset(PACKED ? (I)W : (I)H * W) + gj;
        const I v0 = PACKED ? p0 : p0 + sim_offset((I)H * W);
        // The strip's velocity, all of it asked for before the barrier: the
        // loads are in flight together while the block waits, not one row
        // after another behind the stores.
        float vx[R], vy[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            if (col_out && k >= k_lo && k < k_hi) {
                vx[k] = to_f32(vel[v0 + k * step]);
                vy[k] = to_f32(vel[v0 + k * step + plane]);
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int lr = row0 + k, gi = r0 + lr;
            if (col_out && k >= k_lo && k < k_hi) {
                // stencil.cu gradient_subtract_kernel's reads, clamps and
                // arithmetic, on the rounded pressure of the tile and ring
                const float* row = pr + lr * RW;
                const float pL = row[jl], pR = row[jr];
                const float pB = pr[(gi > 0 ? lr - 1 : lr) * RW + tx];
                const float pT = pr[(gi + 1 < H ? lr + 1 : lr) * RW + tx];
                out[p0 + k * step] = from_f32<TOut>(row[tx]);
                vel_out[v0 + k * step] = from_f32<TOut>(vx[k] - (pR - pL));
                vel_out[v0 + k * step + plane] = from_f32<TOut>(vy[k] - (pT - pB));
            }
        }
    }
}

template <typename TIn, typename TOut, typename TD, int RW, int NY, int R, int MINB, typename I,
          bool PACKED>
__global__ void __launch_bounds__(RW * NY, MINB)
jacobi_chunk_kernel(const TIn* __restrict__ p, const TD* __restrict__ div, TOut* __restrict__ out,
                    float prescale, int H, int W, int K) {
    extern __shared__ float buf[];  // two RH x RW buffers, one per sweep parity
    // A solve's fused last launch, launched to depend on this one
    // programmatically, may take the SMs this launch leaves idle once its
    // last blocks have started.
    asm volatile("griddepcontrol.launch_dependents;");
    jacobi_region<TIn, TOut, TD, RW, NY, R, I, PACKED, false>(p, div, out, nullptr, nullptr,
                                                               prescale, H, W, K, buf);
}

// The solve's last launch, the gradient subtract fused in: the pressure and
// the velocity in storage type T.
template <typename TIn, typename T, typename TD, int RW, int NY, int R, int MINB, typename I,
          bool PACKED>
__global__ void __launch_bounds__(RW * NY, MINB)
jacobi_project_kernel(const TIn* __restrict__ p, const TD* __restrict__ div, T* __restrict__ out,
                      const T* __restrict__ vel, T* __restrict__ vel_out, float prescale, int H,
                      int W, int K) {
    extern __shared__ float buf[];
    // Launched with programmatic stream serialization: wait here until the
    // previous launch on the stream (the solve's last chunk, or whatever
    // wrote the pressure and the velocity) has finished and its writes are
    // visible. Before this line no memory is touched.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    jacobi_region<TIn, T, TD, RW, NY, R, I, PACKED, true>(p, div, out, vel, vel_out, prescale,
                                                           H, W, K, buf);
}

template <typename TIn, typename TOut, typename TD, int RW, int NY, int R, int MINB, typename I,
          bool PACKED, bool PROJECT>
static int launch(const void* p, const void* div, void* out, const void* vel, void* vel_out,
                  float prescale, int B, int H, int W, int K, cudaStream_t stream) {
    constexpr int RH = NY * R;
    const int G = PROJECT ? K + 1 : K;
    if (K < (PROJECT ? 0 : 1) || RH - 2 * G < 1 || RW - 2 * G < 1 || B < 1 || B > kMaxBatch)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * RH * RW * sizeof(float);
    const dim3 grid((W + RW - 2 * G - 1) / (RW - 2 * G), (H + RH - 2 * G - 1) / (RH - 2 * G), B);
    const dim3 block(RW, NY);
    cudaError_t err;
    if constexpr (PROJECT) {
        auto kernel = jacobi_project_kernel<TIn, TOut, TD, RW, NY, R, MINB, I, PACKED>;
        static unsigned long long granted = 0;  // per instance and device
        err = opt_in_smem(kernel, (int)smem, granted);
        if (err != cudaSuccess) return (int)err;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = block;
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        err = cudaLaunchKernelEx(&cfg, kernel, (const TIn*)p, (const TD*)div, (TOut*)out,
                                 (const TOut*)vel, (TOut*)vel_out, prescale, H, W, K);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return (int)err;
        }
    } else {
        auto kernel = jacobi_chunk_kernel<TIn, TOut, TD, RW, NY, R, MINB, I, PACKED>;
        static unsigned long long granted = 0;
        err = opt_in_smem(kernel, (int)smem, granted);
        if (err != cudaSuccess) return (int)err;
        kernel<<<grid, block, smem, stream>>>((const TIn*)p, (const TD*)div, (TOut*)out,
                                              prescale, H, W, K);
    }
    return (int)cudaGetLastError();
}

// The compiled geometries: (RW, NY, R, blocks an SM must hold), in the
// order of ops/cuda/jacobi.py TILES; I the index type (common.cuh), wide
// where a sim's elements (2 planes with the velocity) reach past int.
template <typename TIn, typename TOut, typename TD, bool PACKED, bool PROJECT>
static int launch_tiles(int tiles, const void* p, const void* div, void* out, const void* vel,
                        void* vel_out, float prescale, int B, int H, int W, int K,
                        cudaStream_t s) {
#define TILE_ARGS p, div, out, vel, vel_out, prescale, B, H, W, K, s
    DISPATCH_INDEX(wide_batch(B, (PROJECT ? 2 : 1) * (size_t)H * W), I,
        switch (tiles) {
            case 0: return launch<TIn, TOut, TD, 128, 4, 16, 2, I, PACKED, PROJECT>(TILE_ARGS);
            case 1: return launch<TIn, TOut, TD, 64, 4, 8, 1, I, PACKED, PROJECT>(TILE_ARGS);
            default: return (int)cudaErrorInvalidValue;
        });
#undef TILE_ARGS
    return (int)cudaErrorInvalidValue;
}

template <typename TIn, typename TOut, typename TD, bool PROJECT>
static int launch_layout(int layout, int tiles, const void* p, const void* div, void* out,
                         const void* vel, void* vel_out, float prescale, int B, int H, int W,
                         int K, cudaStream_t s) {
#define LAYOUT_ARGS tiles, p, div, out, vel, vel_out, prescale, B, H, W, K, s
    if (layout == kPacked) return launch_tiles<TIn, TOut, TD, true, PROJECT>(LAYOUT_ARGS);
    if (layout == kBatched) return launch_tiles<TIn, TOut, TD, false, PROJECT>(LAYOUT_ARGS);
#undef LAYOUT_ARGS
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
#define CHUNK_ARGS layout, tiles, p, div, out, nullptr, nullptr, prescale, B, H, W, K, s
    DISPATCH_STORAGE(dtype, T,
        if (p_f32 && out_f32) return launch_layout<float, float, T, false>(CHUNK_ARGS);
        if (p_f32) return launch_layout<float, T, T, false>(CHUNK_ARGS);
        if (out_f32) return launch_layout<T, float, T, false>(CHUNK_ARGS);
        return launch_layout<T, T, T, false>(CHUNK_ARGS));
#undef CHUNK_ARGS
    return (int)cudaErrorInvalidValue;
}

// The solve's last launch: K >= 0 sweeps as fluid_jacobi_chunk's (p a
// float32 scratch buffer where p_f32), the pressure written in storage
// type `dtype` to `out`, and vel - grad(pressure) to `vel_out`; vel and
// vel_out (B, 2, H, W), or (2, H, B*W) packed.
int fluid_jacobi_project(const void* p, int p_f32, const void* div, const void* vel, void* out,
                         void* vel_out, float prescale, int B, int H, int W, int K, int tiles,
                         int layout, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define PROJECT_ARGS layout, tiles, p, div, out, vel, vel_out, prescale, B, H, W, K, s
    DISPATCH_STORAGE(dtype, T,
        if (p_f32) return launch_layout<float, T, T, true>(PROJECT_ARGS);
        return launch_layout<T, T, T, true>(PROJECT_ARGS));
#undef PROJECT_ARGS
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
