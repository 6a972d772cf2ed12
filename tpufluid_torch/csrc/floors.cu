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
// (2, 96, 384); the sweep 3 MB for 419 M float32 operations. What each
// design does about it:
//
// floor_taa: every add needs one gathered word, so the SMs' shared memory
// (32 words a clock each) is the limit. The sum is in uint32, whose adds
// commute, so the (trip, rep) terms of a word are split over `splits`
// threads of one block (ops/cuda/floors.py taa_plan), enough for every SM
// to hold a block. A block stages the operand rows its words read, (planes,
// its rows + reps - 1, lanes), in shared memory once by cp.async, keeps
// each thread's n_idx * planes gather offsets in registers (16 at a time),
// sums into four accumulators, and the
// splits' partials meet in shared memory, where one thread a word adds them
// to the seed: one launch, no atomics, no copy of the seed beforehand. Its
// words' indices are staged too, so each is read from device memory once.
// A launch lets the next one on the stream take its SMs early
// (programmatic dependent launch): a chain of calls, as the reference rate
// runs, pays the launch's latency once.
// Every trip issues its loads again: a compiler barrier at the top of each
// trip's run keeps them from being hoisted and the trips folded into a
// multiply.
//
// floor_roll: every add reads one operand word, and the words a column's
// rows read are the same words shifted by a row a trip, so the limit is
// the SMs' instruction issue, not bytes. A block stages one plane's strip
// of 32 columns, all nrk rows of it, in shared memory by cp.async, once. A
// thread owns R consecutive rows of one column (R = 4 or 8) and a share of
// the trips: the word trip k + 1 needs for row i + 1 is the one trip k used
// for row i, so the thread keeps its R rows' words in a register window
// that slides by one row a trip, and a trip costs one shared-memory load
// and R adds; the row wraps by a compare, not a modulo, and the trip loop
// is unrolled R times, so the window's slots are registers named at
// compile time. Where the words are too few to fill the card, a word's
// trips are cut over S threads of the block (S splits) whose partials meet
// in shared memory, where split 0, which started from the seed, adds them
// (ops/cuda/floors.py roll_plan). Programmatic dependent launch, as
// floor_taa. Every trip loads its word anew: a compiler barrier at the top
// of each trip keeps trips k and k + nrk, which read the same word, from
// being folded into a multiply.
//
// floor_sweep: one cooperative launch, a block or two an SM, each block
// holding its tile of the field and a K-deep halo (a region of RH = NY * R
// rows by RW columns, R = 4 or 8, a plan's geometry: ops/cuda/floors.py
// sweep_plan) on chip for
// the whole run: its x in registers, loaded once, and its p in registers,
// a thread a column and R rows, as jacobi_chunk's sweep (csrc/jacobi.cu):
// the left and right neighbours and the rows beyond the thread's strip come
// from a shared buffer, one __syncthreads a sweep. Every K sweeps the block
// publishes the K-deep bands along its tile's edges to global memory, the
// grid synchronises, and the block copies its ring (the neighbours' bands)
// back by cp.async; the valid part of the region shrinks by one cell a
// sweep, to the tile after K. So a run of `total` sweeps takes
// ceil(total / K) - 1 grid barriers, and between them only the bands leave
// the SMs. Cells outside the grid clamp at the grid's edge, never at the
// region's, so the result equals sweep_plain bit for bit for every K.
// Slower on the H100, and gone: one cluster of 16 blocks holding the field
// in distributed shared memory with a cluster barrier a sweep, and
// exchanges that wait on the neighbours' flags instead of the grid
// (PERF.md §6).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

// ---- floor_taa ----------------------------------------------------------

constexpr int kTaaGroup = 16;   // gather offsets a thread keeps at once
constexpr int kTaaMaxThreads = 512;
constexpr int kTaaMaxSmem = 232448;

// A thread's terms [q_lo, q_hi) of one group of gather offsets, one trip's
// run of reps at a time: the first `ng` of the kTaaGroup offsets, all of
// them unless kSome (a group short of kTaaGroup tests each offset; a full
// one runs unpredicated).
template <bool kSome>
__device__ __forceinline__ void taa_terms(uint32_t (&acc)[4], const int (&off)[kTaaGroup],
                                          int ng, const uint32_t* smem, int rl, int lanes,
                                          int reps, int q_lo, int q_hi) {
    for (int q = q_lo; q < q_hi;) {
        // Every trip gathers anew: nothing loaded above this line is reused
        // below it.
        asm volatile("" ::: "memory");
        const int rep0 = q % reps;
        const int n = min(reps - rep0, q_hi - q);
        const uint32_t* row = smem + (rl + rep0) * lanes;
#pragma unroll 2
        for (int i = 0; i < n; ++i, row += lanes) {
#pragma unroll
            for (int g = 0; g < kTaaGroup; ++g)
                if (!kSome || g < ng) acc[g & 3] += row[off[g]];
        }
        q += n;
    }
}

// Block b: the words [b * words_b, ...) of the flattened (rows, lanes) tile,
// each taken by `splits` threads (thread t: word t % words_b, split
// t / words_b); split s sums the flattened (trip, rep) terms [s * P / splits,
// (s + 1) * P / splits), P = trips * reps (as taa_plan.parts). The block
// stages the operand rows its words read, (planes, its rows + reps - 1,
// lanes), and its words' indices, (n_idx, words_b); gather offsets: the
// flat index o < n_idx * planes is (j, ch) = (o / planes, o % planes),
// kTaaGroup of them at a time, the last group's beyond n_idx * planes
// skipped. Out-of-range indices clamp to the row (the plain version raises
// on them).
// The splits' partials meet in shared memory; split 0 adds them to the
// seed in order and writes the word.
__global__ void __launch_bounds__(kTaaMaxThreads, 2) floor_taa_kernel(
        const uint32_t* __restrict__ seed, const int* __restrict__ idx,
        const uint32_t* __restrict__ op, uint32_t* __restrict__ out, int trips, int planes,
        int n_idx, int reps, int rows, int lanes, int words_b, int splits) {
    extern __shared__ uint32_t smem[];
    // Launched with programmatic stream serialization: wait here until the
    // previous launch on the stream (which may have written this one's
    // inputs) has finished and its writes are visible. Before this line no
    // memory is touched.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int w_lo = blockIdx.x * words_b;
    const int w_hi = min(w_lo + words_b, rows * lanes);
    const int row_first = w_lo / lanes;
    const int srows = (w_hi - 1) / lanes - row_first + reps;   // its rows + reps - 1
    const int words = srows * lanes;                           // staged words a plane
    int* s_idx = (int*)smem + planes * words;                  // (n_idx, words_b)
    uint32_t* part = (uint32_t*)s_idx + n_idx * words_b;       // (splits, words_b)

    // Stage op[ch, row_first + q, :] for q < srows: one contiguous run of
    // srows * lanes words a plane.
    for (int ch = 0; ch < planes; ++ch) {
        const uint32_t* src = op + ((size_t)ch * (rows + reps) + row_first) * lanes;
        uint32_t* dst = smem + ch * words;
        if ((lanes & 3) == 0 && ((uintptr_t)op & 15) == 0) {
            for (int m = threadIdx.x; m < words / 4; m += blockDim.x)
                __pipeline_memcpy_async(dst + 4 * m, src + 4 * m, 16);
        } else {
            for (int m = threadIdx.x; m < words; m += blockDim.x)
                __pipeline_memcpy_async(dst + m, src + m, 4);
        }
    }
    const int nw = w_hi - w_lo;
    for (int m = threadIdx.x; m < n_idx * nw; m += blockDim.x) {
        const int j = m / nw, k = m - j * nw;
        __pipeline_memcpy_async(s_idx + j * words_b + k, idx + (size_t)j * rows * lanes + w_lo + k,
                                4);
    }
    __pipeline_commit();

    const int wl = threadIdx.x % words_b, s = threadIdx.x / words_b;
    const int wi = w_lo + wl;
    const bool active = wi < w_hi;
    const int r = active ? wi / lanes : row_first;
    const int c = active ? wi - r * lanes : 0;
    const int rl = r - row_first;   // staged row of rep 0
    const int n_off = n_idx * planes;
    int off[kTaaGroup];
    // The thread's gather offsets, from its word's staged indices (past the
    // last, a repeat of it, never gathered).
    auto load_offsets = [&](int o0) {
#pragma unroll
        for (int g = 0; g < kTaaGroup; ++g) {
            const int o = min(o0 + g, n_off - 1);
            const int j = o / planes, ch = o - j * planes;
            const int col = min(max(s_idx[j * words_b + wl], 0), lanes - 1);
            off[g] = ch * words + col;
        }
    };
    __pipeline_wait_prior(0);
    __syncthreads();
    load_offsets(0);

    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    const long long terms = (long long)trips * reps;
    const int q_lo = (int)(s * terms / splits), q_hi = (int)((s + 1) * terms / splits);
    if (active) {
        for (int o0 = 0; o0 < n_off; o0 += kTaaGroup) {
            if (o0 > 0) load_offsets(o0);
            const int ng = n_off - o0;   // offsets of this group: kTaaGroup but the last
            if (ng >= kTaaGroup)
                taa_terms<false>(acc, off, ng, smem, rl, lanes, reps, q_lo, q_hi);
            else
                taa_terms<true>(acc, off, ng, smem, rl, lanes, reps, q_lo, q_hi);
        }
    }
    // The gathers are done: the next launch on the stream may take the SMs
    // as this one's blocks finish.
    asm volatile("griddepcontrol.launch_dependents;");
    part[s * words_b + wl] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();
    if (s == 0 && active) {
        uint32_t sum = seed[wi];
        for (int k = 0; k < splits; ++k) sum += part[k * words_b + wl];
        out[wi] = sum;
    }
}

static int launch_taa(const void* seed, const void* idx, const void* op, void* out, int trips,
                      int planes, int n_idx, int reps, int rows, int lanes, int words_b,
                      int splits, int smem, cudaStream_t stream) {
    auto kernel = floor_taa_kernel;
    static unsigned long long granted = 0;   // per instance and device
    const cudaError_t granted_err = opt_in_smem(kernel, kTaaMaxSmem, granted);
    if (granted_err != cudaSuccess) return (int)granted_err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((rows * lanes + words_b - 1) / words_b);
    cfg.blockDim = dim3(words_b * splits);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, (const uint32_t*)seed, (const int*)idx, (const uint32_t*)op,
        (uint32_t*)out, trips, planes, n_idx, reps, rows, lanes, words_b, splits);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// ---- floor_roll ---------------------------------------------------------

constexpr int kRollStrip = 32;          // columns a block stages: a warp's lanes
constexpr int kRollMaxThreads = 1024;
constexpr int kRollMaxSmem = 232448;

// Block b takes plane b / (strips * chunks), strip (b / chunks) % strips and
// row-group chunk b % chunks: groups_b groups of R rows, the rows
// [(chunk * groups_b + g) * R, ... + R) of its 32 columns. Thread t: lane
// t % 32 is the column, warp t / 32 = split * groups_b + g; split s sums
// the trips [s * trips / splits, (s + 1) * trips / splits).
// roll(x, s)[i] = x[(i - s) mod nrk], the direction of pltpu.roll.
template <int R>
__global__ void __launch_bounds__(kRollMaxThreads) floor_roll_kernel(
        const uint32_t* __restrict__ seed, const uint32_t* __restrict__ op,
        uint32_t* __restrict__ out, int nrk, int cbw, int trips, int groups_b, int splits) {
    extern __shared__ uint32_t smem[];
    // Launched with programmatic stream serialization, as floor_taa: no
    // memory is touched before the previous launch on the stream is done.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    uint32_t* strip = smem;                                  // (nrk, kRollStrip)
    uint32_t* part = smem + nrk * kRollStrip;                // (splits - 1, groups_b, R, 32)
    const int strips = (cbw + kRollStrip - 1) / kRollStrip;
    const int ngroups = (nrk + R - 1) / R;
    const int chunks = (ngroups + groups_b - 1) / groups_b;
    const int chunk = blockIdx.x % chunks;
    const int s_idx = (blockIdx.x / chunks) % strips;
    const int plane = blockIdx.x / (chunks * strips);
    const int col0 = s_idx * kRollStrip;
    const int ncol = min(kRollStrip, cbw - col0);
    const uint32_t* src = op + (size_t)plane * nrk * cbw + col0;

    // Stage the strip: nrk rows of ncol words, 16 bytes at a time where the
    // rows allow it.
    if (ncol == kRollStrip && cbw % 4 == 0 && ((uintptr_t)src & 15) == 0) {
        for (int m = threadIdx.x; m < nrk * (kRollStrip / 4); m += blockDim.x) {
            const int y = m / (kRollStrip / 4), q = m % (kRollStrip / 4);
            __pipeline_memcpy_async(strip + y * kRollStrip + 4 * q,
                                    src + (size_t)y * cbw + 4 * q, 16);
        }
    } else {
        for (int m = threadIdx.x; m < nrk * kRollStrip; m += blockDim.x) {
            const int y = m / kRollStrip, x = m % kRollStrip;
            if (x < ncol) __pipeline_memcpy_async(strip + m, src + (size_t)y * cbw + x, 4);
        }
    }
    __pipeline_commit();

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int split = warp / groups_b, g = warp % groups_b;
    const int group = chunk * groups_b + g;
    const int i0 = group * R;
    const bool active = group < ngroups && lane < ncol;
    const int k_lo = (int)((long long)split * trips / splits);
    const int n = (int)((long long)(split + 1) * trips / splits) - k_lo;
    uint32_t acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0u;
    // Split 0 starts from the seed, read while the strip arrives.
    if (split == 0 && active) {
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (i0 + j < nrk) acc[j] = seed[((size_t)plane * nrk + i0 + j) * cbw + col0 + lane];
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    if (active) {
        // w[j]: the word of row i0 + j at the split's first trip, k_lo;
        // `off` walks the strip's rows downward, one a trip, wrapping.
        const int wrap = nrk * kRollStrip;
        int row = (i0 - k_lo) % nrk;
        if (row < 0) row += nrk;
        uint32_t w[R];
#pragma unroll
        for (int j = 0; j < R; ++j) w[j] = strip[((row + j) % nrk) * kRollStrip + lane];
        int off = row * kRollStrip + lane;
        // Trip u of a run of R: row j adds slot (j - u) mod R, then the
        // next trip's row-0 word goes into slot (R - 1 - u).
        auto trip = [&](auto u_const) {
            constexpr int u = decltype(u_const)::value;
            asm volatile("" ::: "memory");
#pragma unroll
            for (int j = 0; j < R; ++j) acc[j] += w[(j - u + R) % R];
            off -= kRollStrip;
            if (off < 0) off += wrap;
            w[R - 1 - u] = strip[off];
        };
        int t = 0;
        for (; t + R <= n; t += R) {
            trip(std::integral_constant<int, 0>{});
            trip(std::integral_constant<int, 1>{});
            trip(std::integral_constant<int, 2>{});
            trip(std::integral_constant<int, 3>{});
            if constexpr (R == 8) {
                trip(std::integral_constant<int, 4>{});
                trip(std::integral_constant<int, 5>{});
                trip(std::integral_constant<int, 6>{});
                trip(std::integral_constant<int, 7>{});
            }
        }
        // The last n mod R trips.
        if (t < n) trip(std::integral_constant<int, 0>{});
        if (t + 1 < n) trip(std::integral_constant<int, 1>{});
        if (t + 2 < n) trip(std::integral_constant<int, 2>{});
        if constexpr (R == 8) {
            if (t + 3 < n) trip(std::integral_constant<int, 3>{});
            if (t + 4 < n) trip(std::integral_constant<int, 4>{});
            if (t + 5 < n) trip(std::integral_constant<int, 5>{});
            if (t + 6 < n) trip(std::integral_constant<int, 6>{});
        }
        if (split > 0) {
#pragma unroll
            for (int j = 0; j < R; ++j)
                part[(((split - 1) * groups_b + g) * R + j) * 32 + lane] = acc[j];
        }
    }
    // The trips are done: the next launch on the stream may take the SMs
    // as this one's blocks finish.
    asm volatile("griddepcontrol.launch_dependents;");
    __syncthreads();
    if (split == 0 && active) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
            if (i0 + j >= nrk) break;
            uint32_t sum = acc[j];
            for (int k = 1; k < splits; ++k)
                sum += part[(((k - 1) * groups_b + g) * R + j) * 32 + lane];
            out[((size_t)plane * nrk + i0 + j) * cbw + col0 + lane] = sum;
        }
    }
}

template <int R>
static int launch_roll(const void* seed, const void* op, void* out, int planes, int nrk, int cbw,
                       int trips, int groups_b, int splits, int smem, cudaStream_t stream) {
    auto kernel = floor_roll_kernel<R>;
    static unsigned long long granted = 0;   // per instance and device
    const cudaError_t granted_err = opt_in_smem(kernel, kRollMaxSmem, granted);
    if (granted_err != cudaSuccess) return (int)granted_err;
    const int strips = (cbw + kRollStrip - 1) / kRollStrip;
    const int chunks = ((nrk + R - 1) / R + groups_b - 1) / groups_b;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(planes * strips * chunks);
    cfg.blockDim = dim3(32 * groups_b * splits);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)seed,
                                               (const uint32_t*)op, (uint32_t*)out, nrk, cbw,
                                               trips, groups_b, splits);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// ---- floor_sweep --------------------------------------------------------

constexpr int kSweepMaxRows = 8;       // R: rows a thread keeps in registers (4 or 8)
constexpr int kSweepMaxThreads = 1024;
constexpr int kSweepMaxSmem = 2 * kSweepMaxThreads * kSweepMaxRows * (int)sizeof(float);

// Block b holds tile (b / tiles_x, b % tiles_x): the region's rows
// [r0, r0 + RH) and columns [c0, c0 + RW), r0 = ty * (RH - 2K) - K,
// c0 = tx * (RW - 2K) - K; its tile is the region less K cells on every
// side. Phase n runs min(K, total - n * K) sweeps and publishes into
// bands[n & 1]; phase n + 1 copies its ring from there. The band buffers
// are written and read inside the launch, so they are not read-only.
template <int R>
__global__ void __launch_bounds__(kSweepMaxThreads, 1)
floor_sweep_kernel(const float* __restrict__ seed, const float* __restrict__ x, float* band0,
                   float* band1, float* __restrict__ out, int H, int W, int total, int K,
                   int tiles_x) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float buf[];   // two RH x RW buffers, one per sweep parity
    const int RW = blockDim.x, NY = blockDim.y, RH = NY * R;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int r0 = ((int)blockIdx.x / tiles_x) * (RH - 2 * K) - K;
    const int c0 = ((int)blockIdx.x % tiles_x) * (RW - 2 * K) - K;
    const int gj = c0 + tx;
    const int cj = min(max(gj, 0), W - 1);
    // Region columns of the left and right neighbours: clamped at the grid's
    // edge, then into the region (a region-edge cell is outside the valid
    // part after its first sweep).
    const int jl = min(max(max(gj - 1, 0) - c0, 0), RW - 1);
    const int jr = min(max(min(gj + 1, W - 1) - c0, 0), RW - 1);
    const int row0 = ty * R;   // the strip's first region row
    const bool col_in = gj >= 0 && gj < W;
    const bool col_tile = tx >= K && tx < RW - K;
    const bool col_band = tx < 2 * K || tx >= RW - 2 * K;

    float v[R], d[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int at = min(max(r0 + row0 + k, 0), H - 1) * W + cj;
        v[k] = seed[at];
        d[k] = x[at];
    }

    for (int done = 0, phase = 0;; ++phase) {
        if (phase > 0) {
            // The ring: cells of the grid outside the tile, which the
            // neighbours published (each within K of its own tile's edge).
            const float* src = (phase & 1) ? band0 : band1;
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int lr = row0 + k, gi = r0 + lr;
                const bool ring = !(col_tile && lr >= K && lr < RH - K);
                if (ring && col_in && gi >= 0 && gi < H)
                    __pipeline_memcpy_async(buf + lr * RW + tx, src + (size_t)gi * W + gj, 4);
            }
            __pipeline_commit();
            __pipeline_wait_prior(0);
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int lr = row0 + k, gi = r0 + lr;
                const bool ring = !(col_tile && lr >= K && lr < RH - K);
                if (ring && col_in && gi >= 0 && gi < H) v[k] = buf[lr * RW + tx];
            }
        }
        const int m = min(K, total - done);
        for (int s = 0; s < m; ++s) {
            float* cur = buf + (s & 1) * (RH * RW);
#pragma unroll
            for (int k = 0; k < R; ++k) cur[(row0 + k) * RW + tx] = v[k];
            __syncthreads();
            // The rows just beyond the strip: another strip of this block, or
            // the region's own edge row (a cell of the grid that reads it
            // there is at the grid's edge, where it reads itself instead, or
            // outside the valid part).
            const float hi = ty + 1 < NY ? cur[(row0 + R) * RW + tx] : cur[(RH - 1) * RW + tx];
            const float lo = ty > 0 ? cur[(row0 - 1) * RW + tx] : cur[tx];
            float below = lo;   // the old value of row i - 1
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int gi = r0 + row0 + k;
                const float* row = cur + (row0 + k) * RW;
                const float T = gi + 1 < H ? (k + 1 < R ? v[min(k + 1, R - 1)] : hi) : v[k];
                const float B = gi > 0 ? below : v[k];
                below = v[k];
                v[k] = ((((row[jl] + row[jr]) + B) + T) - d[k]) * 0.25f;
            }
        }
        done += m;
        if (done == total) break;
        float* dst = (phase & 1) ? band1 : band0;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int lr = row0 + k, gi = r0 + lr;
            const bool band = col_band || lr < 2 * K || lr >= RH - 2 * K;
            if (col_tile && lr >= K && lr < RH - K && band && col_in && gi < H)
                dst[(size_t)gi * W + gj] = v[k];
        }
        grid.sync();
    }

#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int lr = row0 + k, gi = r0 + lr;
        if (col_tile && lr >= K && lr < RH - K && col_in && gi < H)
            out[(size_t)gi * W + gj] = v[k];
    }
}

template <int R>
static int launch_sweep(const void* seed, const void* x, void* band0, void* band1, void* out,
                        int H, int W, int total, int K, int rw, int ny, int tiles_y,
                        int tiles_x, cudaStream_t stream) {
    auto kernel = floor_sweep_kernel<R>;
    static unsigned long long granted = 0;   // per instance and device
    const cudaError_t granted_err = opt_in_smem(kernel, kSweepMaxSmem, granted);
    if (granted_err != cudaSuccess) return (int)granted_err;
    const size_t smem = 2 * (size_t)ny * R * rw * sizeof(float);
    void* args[] = {&seed, &x, &band0, &band1, &out, &H, &W, &total, &K, &tiles_x};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(tiles_y * tiles_x),
                                                  dim3(rw, ny), args, smem, stream);
    if (err != cudaSuccess) {
        cudaGetLastError();   // clear it, so that it is not reported by a later launch
        return (int)err;
    }
    return (int)cudaGetLastError();
}

extern "C" {

// seed, out (rows, lanes) uint32; idx (n_idx, rows, lanes) int32 in
// [0, lanes); op (planes, rows + reps, lanes) uint32. A plan's blocks:
// words_b words of the tile a block, each summed by `splits` threads;
// smem: the largest block's staging and partials, in bytes.
int floor_taa(const void* seed, const void* idx, const void* op, void* out, int trips,
              int planes, int n_idx, int reps, int rows, int lanes, int words_b, int splits,
              int smem, void* stream) {
    if (trips < 1 || reps < 1 || rows < 1 || lanes < 1 || planes < 1 || n_idx < 1 ||
        words_b < 1 || splits < 1 || words_b * splits > kTaaMaxThreads ||
        (long long)trips * reps < splits || smem > kTaaMaxSmem)
        return (int)cudaErrorInvalidValue;
    return launch_taa(seed, idx, op, out, trips, planes, n_idx, reps, rows, lanes, words_b,
                      splits, smem, (cudaStream_t)stream);
}

// seed, op, out (planes, nrk, cbw) uint32; trips >= 1. A plan's blocks
// (ops/cuda/floors.py roll_plan): `rows` rows a thread (4 or 8), groups_b
// row groups a block, each word's trips cut over `splits` threads; smem: the
// strip and the splits' partials, in bytes.
int floor_roll(const void* seed, const void* op, void* out, int planes, int nrk, int cbw,
               int trips, int rows, int groups_b, int splits, int smem, void* stream) {
    if (planes < 1 || nrk < 1 || cbw < 1 || trips < 1 || groups_b < 1 || splits < 1 ||
        splits > trips || 32 * groups_b * splits > kRollMaxThreads || smem > kRollMaxSmem ||
        smem < 4 * (nrk * kRollStrip + (splits - 1) * groups_b * rows * 32))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (rows == 4)
        return launch_roll<4>(seed, op, out, planes, nrk, cbw, trips, groups_b, splits, smem, s);
    if (rows == 8)
        return launch_roll<8>(seed, op, out, planes, nrk, cbw, trips, groups_b, splits, smem, s);
    return (int)cudaErrorInvalidValue;
}

// seed, x, band0, band1, out (H, W) float32; total >= 1 sweeps, K a phase;
// blocks of rw x ny threads, each thread `rows` rows (4 or 8; regions of
// ny * rows rows by rw columns), a grid of tiles_y x tiles_x tiles that
// covers the field. A cooperative launch that the card cannot hold at once
// is refused; a refused launch returns its error.
int floor_sweep(const void* seed, const void* x, void* band0, void* band1, void* out, int H,
                int W, int total, int K, int rows, int rw, int ny, int tiles_y, int tiles_x,
                void* stream) {
    const int rh = ny * rows;
    if (total < 1 || K < 1 || rw < 1 || ny < 1 || rw * ny > kSweepMaxThreads ||
        rh - 2 * K < 1 || rw - 2 * K < 1 || tiles_x * (rw - 2 * K) < W ||
        tiles_y * (rh - 2 * K) < H)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (rows == 4)
        return launch_sweep<4>(seed, x, band0, band1, out, H, W, total, K, rw, ny, tiles_y,
                               tiles_x, s);
    if (rows == 8)
        return launch_sweep<8>(seed, x, band0, band1, out, H, W, total, K, rw, ny, tiles_y,
                               tiles_x, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
