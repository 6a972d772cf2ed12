// Shared helpers of the simulation kernels: storage-type conversion, the
// dtype switch of the C entry points, and the launch shape.
//
// Every kernel stores float32, bfloat16 or float16 and computes in float32,
// rounding to storage (round to nearest even, as torch's .to()) only where
// its output is written. The files are compiled with -fmad=false: a fused
// multiply-add rounds once where the plain PyTorch versions round twice, and
// an ulp moved in a sampling coordinate can pick another bilinear corner.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
    return __float2half_rn(x);
}

// Round a float32 value through storage type T.
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f32(from_f32<T>(x));
}

// Storage type codes shared with ops/cuda/build.py.
enum StorageCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Runs BODY with T bound to the storage type of CODE; an unknown code returns
// cudaErrorInvalidValue from the enclosing C entry point.
#define DISPATCH_STORAGE(CODE, T, ...)                                  \
    switch (CODE) {                                                     \
        case kF32: { using T = float; __VA_ARGS__; break; }             \
        case kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; }    \
        case kF16: { using T = __half; __VA_ARGS__; break; }            \
        default: return (int)cudaErrorInvalidValue;                     \
    }

// One thread per output texel, 32 threads along W (coalesced) by 8 rows.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// The grid of an (h, w) field, and of `sims` of them along z (blockIdx.z =
// the sim; a batched kernel offsets its fields by it).
inline dim3 grid_for(int h, int w, int sims = 1) {
    return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, sims);
}

// Most sims a batched launch takes: the grid's z axis holds at most 65535.
constexpr int kMaxBatch = 65535;

// Grants `kernel` `bytes` of dynamic shared memory on the current device,
// once a device: the attribute is the device's own, so a flag kept for the
// whole process would leave a second card's launches without it. `done` is
// the caller's mask of the devices already granted (one a kernel instance).
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes, unsigned long long& done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (done & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done |= bit;
    return err;
}

// The index type of a batched launch. A block adds its sim's offset,
// blockIdx.z times the elements of one sim, to every index inside the sim,
// in type I: int where every element of the batch has a 32-bit index (every
// single-sim launch), so that an address forms as in a single-sim kernel;
// long long past that. A 64-bit offset on every index, or a per-sim base
// pointer held in registers, cost the single-sim launches up to 30% of their
// time on the H100 (PERF.md).
inline bool wide_batch(int B, size_t elements_per_sim) {
    return (size_t)B * elements_per_sim > (size_t)INT_MAX;
}

#define DISPATCH_INDEX(WIDE, I, ...)                  \
    if (WIDE) {                                       \
        using I = long long;                          \
        __VA_ARGS__;                                  \
    } else {                                          \
        using I = int;                                \
        __VA_ARGS__;                                  \
    }

// The offset of this block's sim, `per_sim` elements a sim, opaque to the
// optimizer: it is added to each index as one term instead of being folded
// into the index's own products. blockIdx.z is read anew at every call, so
// an offset needed only after a kernel's main loop is formed there, not
// held in a register across it. Measured on the H100 (PERF.md), it
// suits the stencils and the Jacobi chunk; the advection's kernels were
// faster with a plain blockIdx.z product.
template <typename I>
__device__ __forceinline__ I sim_offset(I per_sim) {
    unsigned z;
    asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
    I off = (I)z * per_sim;
    if constexpr (sizeof(I) == 8)
        asm("" : "+l"(off));
    else
        asm("" : "+r"(off));
    return off;
}

// Field layouts of a batch of B sims, each C planes of H x W (ops/cuda/
// build.py BATCHED, PACKED). Element (b, c, i, j) of a batched field
// (B, C, H, W) is at b*C*H*W + c*H*W + i*W + j; of a packed field
// (C, H, B*W), the lane-packed fleet's sims side by side along the rows
// (tpufluid/batch_packed.py), at b*W + c*H*B*W + i*B*W + j. Both are
// b*S_sim + c*S_plane + i*P + j. A kernel takes the layout as a template
// parameter, so its batched instances compile as before. A packed launch
// keeps a sim's blocks apart (the tiled kernels' sim on grid z, the
// one-thread-a-texel ones' on grid y: packed_grid_for), and a block's (i, j)
// are its sim's own: its clamps and walls are the sim's, as the TPU kernels'
// wall every sim_w columns puts them.
enum FieldLayout { kBatched = 0, kPacked = 1 };

// The strides of a packed field for sim b of B, in index type I: `sim` =
// b*W, `pitch` = B*W, `plane` = H*B*W. DISPATCH_INDEX counts a packed
// field's whole extent, C*H*B*W, as it counts a batched one's.
template <typename I>
struct Packed {
    I sim, pitch, plane;
    __device__ __forceinline__ Packed(int H, int W, unsigned b, unsigned B)
        : sim((I)b * W), pitch((I)B * W), plane((I)H * pitch) {}
    __device__ __forceinline__ I at(int c, int i, int j) const {
        return sim + c * plane + i * pitch + j;
    }
};

// The grid of a one-thread-a-texel launch (grid_for) in the packed layout:
// (columns, sim, rows), so that the blocks that run at once hold the same
// rows of every sim, a contiguous span of the fleet's rows, as a batched
// launch's hold one sim's contiguous rows. Grid z (rows) is then a block's
// row strip and grid y its sim.
inline dim3 packed_grid_for(int h, int w, int sims) {
    const dim3 g = grid_for(h, w);
    return dim3(g.x, sims, g.y);
}

// One axis of a separable affine bilinear sample (ops/sampling.py
// affine_axis_plan) for output index k: p = ((k + 0.5) / n_out) * scale + off,
// x = p * n_in - 0.5, corners floor(x) and +1 clamped to [0, n_in - 1] (or
// wrapped by floor modulo for REPEAT: -1 -> n_in - 1, where C's % gives -1),
// weight f = x - floor(x). The render kernels recompute the plan per thread
// instead of reading it as data: with IEEE division and -fmad=false these
// are the very float32 operations of the plain version's plan.
struct AxisTap {
    int i0, i1;
    float f;
};

__device__ __forceinline__ int floor_mod(int a, int n) {
    const int r = a % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ AxisTap axis_tap(int k, int n_in, int n_out, float scale, float off,
                                            bool wrap) {
    const float p = ((float)k + 0.5f) / (float)n_out * scale + off;
    const float x = p * (float)n_in - 0.5f;
    const float x0 = floorf(x);
    const int i = (int)x0;
    AxisTap t;
    t.f = x - x0;
    if (wrap) {
        t.i0 = floor_mod(i, n_in);
        t.i1 = floor_mod(i + 1, n_in);
    } else {
        t.i0 = min(max(i, 0), n_in - 1);
        t.i1 = min(max(i + 1, 0), n_in - 1);
    }
    return t;
}

// The separable stages' lerp, a*(1-f) + b*f (not a + (b-a)*f).
__device__ __forceinline__ float lerp_ab(float a, float b, float f) {
    return a * (1.0f - f) + b * f;
}

// Bilinear sample of plane(y, x) at one (row, column) tap pair, column stage
// first, then the row stage: ops/sampling.sample_affine's order.
template <typename Fetch>
__device__ __forceinline__ float sample_cols_rows(Fetch plane, AxisTap row, AxisTap col) {
    const float top = lerp_ab(plane(row.i0, col.i0), plane(row.i0, col.i1), col.f);
    const float bot = lerp_ab(plane(row.i1, col.i0), plane(row.i1, col.i1), col.f);
    return lerp_ab(top, bot, row.f);
}
