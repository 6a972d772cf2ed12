// Reference-rate microbenchmarks of the profiling path, for Hopper (sm_90a).
//
// Replace the three kernels of tpufluid/ops/pallas/floors.py, each a bare
// copy of one inner loop of the step's kernels, timed beside them by the
// floor report (ops/cuda/floors.py):
//   floor_taa   <- `_taa_kernel` (:92, measure_taa_row_rate :109): seed plus
//                  trips * reps * n_idx * planes gathered (64, 128) rows;
//   floor_roll  <- `_roll_kernel` (:133, measure_roll_rate :143): seed plus
//                  sum over k < trips of roll(op, k mod nrk, axis=1);
//   floor_sweep <- `_sweep_kernel` (:163, measure_sweep_rate :181):
//                  chunks * sweeps clamped-edge Jacobi sweeps.
// Words are uint32 and wrap on overflow, as on the TPU; the sweep sums in
// floors.py:171-175's order and multiplies by 0.25 (-fmad=false).
//
// Bounds on this card (each input read once, each output written once):
// all three are bound by operations, not bytes. At the defaults the gather
// reads 96 KB of operand for 33.6 M adds; the roll 295 KB for 18.9 M adds at
// (2, 96, 384); the sweep 2 MB for 419 M float32 operations. The designs are
// the simplest right ones: one thread per output word, the operand read
// through L1, and for the sweep one cooperative launch that keeps the TPU
// kernel's single program over all sweeps, ping-ponging two float32 buffers
// of 1 MB (in L2) with a grid-wide barrier between sweeps.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;

// One thread per output word (r, c) of the (rows, lanes) tile. Out-of-range
// indices clamp to the row (the plain version raises on them).
__global__ void floor_taa_kernel(const uint32_t* __restrict__ seed, const int* __restrict__ idx,
                                 const uint32_t* __restrict__ op, uint32_t* __restrict__ out,
                                 int trips, int planes, int n_idx, int reps, int rows, int lanes) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * lanes) return;
    const int r = t / lanes;
    const int op_rows = rows + reps;
    uint32_t acc = seed[t];
#pragma unroll 1
    for (int k = 0; k < trips; ++k) {
        for (int rep = 0; rep < reps; ++rep) {
            for (int j = 0; j < n_idx; ++j) {
                const int col = min(max(idx[j * rows * lanes + t], 0), lanes - 1);
                for (int ch = 0; ch < planes; ++ch) {
                    acc += op[(ch * op_rows + rep + r) * lanes + col];
                }
            }
        }
    }
    out[t] = acc;
}

// One thread per word (p, i, c) of the (planes, nrk, cbw) operand:
// roll(x, s)[i] = x[(i - s) mod nrk], the direction of pltpu.roll.
__global__ void floor_roll_kernel(const uint32_t* __restrict__ seed,
                                  const uint32_t* __restrict__ op, uint32_t* __restrict__ out,
                                  int planes, int nrk, int cbw, int trips) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= planes * nrk * cbw) return;
    const int c = t % cbw;
    const int i = (t / cbw) % nrk;
    const int plane = t / (nrk * cbw);
    uint32_t acc = seed[t];
    for (int k = 0; k < trips; ++k) {
        int src = i - k % nrk;
        if (src < 0) src += nrk;
        acc += op[(plane * nrk + src) * cbw + c];
    }
    out[t] = acc;
}

// All `total` sweeps in one cooperative launch: a grid-stride pass per sweep
// from `src` into the next buffer, then a grid-wide barrier. The buffers are
// written and read inside the launch, so they are not read-only (no
// __restrict__ const, no non-coherent loads).
__global__ void floor_sweep_kernel(const float* seed, const float* __restrict__ x, float* buf0,
                                   float* buf1, float* out, int H, int W, int total) {
    cg::grid_group grid = cg::this_grid();
    const int n = H * W;
    const int stride = (int)grid.size();
    const float* src = seed;
    for (int s = 0; s < total; ++s) {
        float* dst = s == total - 1 ? out : (s % 2 == 0 ? buf0 : buf1);
        for (int t = (int)grid.thread_rank(); t < n; t += stride) {
            const int i = t / W;
            const int j = t - i * W;
            const float L = src[i * W + max(j - 1, 0)];
            const float R = src[i * W + min(j + 1, W - 1)];
            const float B = src[max(i - 1, 0) * W + j];
            const float T = src[min(i + 1, H - 1) * W + j];
            dst[t] = ((((L + R) + B) + T) - x[t]) * 0.25f;
        }
        grid.sync();
        src = dst;
    }
}

extern "C" {

// seed, out (rows, lanes) uint32; idx (n_idx, rows, lanes) int32 in [0, lanes);
// op (planes, rows + reps, lanes) uint32.
int floor_taa(const void* seed, const void* idx, const void* op, void* out, int trips,
              int planes, int n_idx, int reps, int rows, int lanes, void* stream) {
    const int n = rows * lanes;
    floor_taa_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed, (const int*)idx, (const uint32_t*)op, (uint32_t*)out, trips,
        planes, n_idx, reps, rows, lanes);
    return (int)cudaGetLastError();
}

// seed, op, out (planes, nrk, cbw) uint32.
int floor_roll(const void* seed, const void* op, void* out, int planes, int nrk, int cbw,
               int trips, void* stream) {
    const int n = planes * nrk * cbw;
    floor_roll_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed, (const uint32_t*)op, (uint32_t*)out, planes, nrk, cbw, trips);
    return (int)cudaGetLastError();
}

// seed, x, buf0, buf1, out (H, W) float32; total >= 1 sweeps. The grid is
// the smaller of one thread per cell and the blocks that fit on the card at
// once (a cooperative launch larger than that is refused); a refused launch
// returns its error.
int floor_sweep(const void* seed, const void* x, void* buf0, void* buf1, void* out, int H,
                int W, int total, void* stream) {
    if (total < 1) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, floor_sweep_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const int blocks = min((H * W + kThreads - 1) / kThreads, per_sm * sms);
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&seed, &x, &buf0, &buf1, &out, &H, &W, &total};
    err = cudaLaunchCooperativeKernel((const void*)floor_sweep_kernel, dim3(blocks),
                                      dim3(kThreads), args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, so that it is not reported by a later launch
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
