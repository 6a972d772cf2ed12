#!/usr/bin/env python3
"""Smoke test of tpufluid_torch on one NVIDIA GPU (sm_90a): the quickest
proof that the port builds and runs its simulation step and its render on
the card.

    python3 chip_smoke.py

1. Setup: builds the CUDA kernels from tpufluid_torch/csrc (one nvcc per
   source, all at once) and prints the card's name and power limit.
   Sums up the ptxas report (registers, static shared memory, stack
   frame, spills) of every pre_pressure, gradient_subtract, advect,
   jacobi_chunk, jacobi_project, bloom_pyramid and display instance and
   names any with a stack frame or spills.
2. Kernel phase: every kernel call of a step (check.step_cases: the
   solve's is jacobi_project, its chunks and then the fused last launch,
   which subtracts the gradient; the dye's is advect_dye), then the
   standalone solve and gradient subtract that the fused launch replaces
   and the sharded step still runs, against their plain PyTorch
   versions on the same inputs, at the main path's shapes — demo default
   (sim 128x228, dye 1024x1820) and 1024x1024 — in float32, bfloat16 with
   and without RGB9E5, and float16. Prints each max error beside its
   tolerance and fails past it; pre_pressure, jacobi_project and advect_dye
   must equal their plain versions bit for bit (max abs error 0). Then the
   fused solve alone at N = 0, 1, 9, 10, 11, 20 and 23 sweeps, in the three
   storage types, on one sim, batches of 3 and 16 and packed fleets
   (project_phase, both tiles): every pressure and velocity bit-equal to
   jacobi_plain then gradient_subtract_plain.
3. Path phase: the port's make_multi_step over a swirl_trace, 300 steps
   each: the demo default in float32 and 1024x1024 in bfloat16 (RGB9E5 on).
   Launch counts are zeroed just before each run and read just after; each
   kernel must have launched its expected count per step (5 launches a
   step: expected_per_step) and no other kernel. The first 3 steps
   must match the plain step run on the same GPU tensors, and the state must
   stay finite with dye >= 0.
4. Timing: steps/s of the last 200 steps of each run, stepped one
   make_step call at a time with a CUDA event between steps (median and
   95th percentile of the 200 step times beside the rate), then
   each kernel's device time per step on the run's final state (launches
   queued behind a spin kernel, so host launch cost is hidden) beside its
   plain version's time and its bound: max(bytes / 3.35 TB/s,
   float32 operations / 67 TFLOP/s), the H100 SXM's published peaks; the
   share of advect_dye's tiles whose window fits its shared memory on that
   state (advect.dye_window_plan); one torch grid_sample call on the dye
   and one on the velocity (bilinear, border, the source's shape and
   storage type, on the backtraced coordinates: check.grid_sample_ms) as
   the two advection kernels' library yardsticks; the fused jacobi_project
   beside the pair it replaces (the standalone solve and gradient
   subtract, spin-queued on the same inputs); last the host time of the
   step's Python layers under cProfile.
5. Render kernel phase: every kernel call of a frame (check.render_cases:
   the whole bloom pyramid, one launch; the sunrays, the march and blur
   launches; and the display) against its plain version, with max abs
   error 0 required,
   at both grids' canvas in every dtype of phase 2; then, in float32 and
   bf16 (RGB9E5), the flag variants (SHADING, BLOOM, SUNRAYS each off), the
   display without dither and with compose=False, the capture size and the
   server's 360x640 tick. Prints each max error beside its tolerance and
   fails past it. Then canvases much smaller than their dye, the server's
   CLI dye (512) at 200x112 and the app's (1024) at 256x256, f32 and bf16
   RGB9E5, shaded, unshaded and compose=False: the display's launches of
   each form (display, display_direct) printed, each the form the wrapper
   picks (in f32 the direct form every time: the staged window does not
   fit a block), every one bit-equal.
6. Render path phase, on each path's final state: one make_render frame
   with the launch counts zeroed just before and read just after (1
   bloom_pyramid, 1 display, no step kernel), held against the plain
   render on the same GPU tensors; the frame must be finite, opaque and not
   all background, and a transparent capture must have alpha = max(rgb).
   Then frames/s of make_render over 200 frames and ticks/s of
   make_step_and_render over 200 ticks (counts zeroed before each run and
   checked after), each with its median and p95 and its device time per
   frame (queued behind a spin kernel, so the idle share is 1 - device /
   frame time), each render kernel's device time per frame beside its
   plain version's and its bound, the host time of the render's Python
   layers under cProfile, and profile_frame_kernels (torch.profiler over 30
   frames: each render kernel's device time a frame, its event count equal
   to its launch count, and the rest of the frame's device time by PyTorch
   op).
6b. Small-canvas phase, the display's direct form on the entry points:
   FluidServer at its CLI defaults (sim 128, dye 512, 640x360) ticks 5
   times, then takes a 200x112 canvas as a small browser window posts it
   (reconfigure) and ticks 20 times with pointer events, launch counts
   zeroed just before and read just after: 5 step launches, 1 bloom_pyramid
   and 1 display_direct a tick, no staged display; its frame against the
   plain render, and the frame's kernel calls against their plain versions
   (0). tpufluid_torch.app.main at --canvas 256x256 (dye 1024), 20 steps, a
   frame every 10 (1 display_direct a frame). The direct form's device time
   on the server's state beside its bound (the dye bytes its taps touch)
   and its plain version's; both forms at the demo and 1024x1024, where
   the wrapper picks the staged one, bit-equal and timed in turns.
7. Floors kernel phase: the three microbenchmark kernels (floor_taa,
   floor_roll, floor_sweep; check.floors_cases) against their plain
   versions at the TPU microbenchmarks' default shapes (measure_roll_rate
   at (2, 96, 384)) and at ragged ones, on the microbenchmarks' inputs and
   on random ones (check.random_floors_cases: row-varying gather indices,
   a sweep field that is not uniform): every one bit-equal (max abs error
   0, the float32 sweep too), each launch counted.
8. Floors phase, on the 1024x1024 bfloat16 (RGB9E5) path's final state
   (bench.py config 3), launch counts zeroed just before and read just
   after: the card's memory bandwidth, the three reference rates,
   profile_step_kernels (torch.profiler over 30 steps: each kernel's own
   device time a step, printed beside phase 4's spin-queued time, its event
   count equal to its launch count) and one `floors {...}` JSON line of
   floor_report; then the three kernels' device time beside their plain
   version's and their bound; floor_taa at twice the trips and floor_sweep
   at twice the chunks, spin-queued beside their defaults, each ratio held
   to 1.6-2.4 (every gather and every sweep runs), and floor_roll at 256,
   512 and 1024 trips, the time added by the second doubling over that of
   the first held to 1.6-2.4 (linear: 2), each time the least of three
   runs taken in turns; and one line a kernel with its
   ms beside its bound, its SM-level floor (floor_sweep: its operations
   over the SMs' float32 lanes, none a fused multiply-add, plus its grid
   barriers; floor_taa: one shared-memory word an add at 32 words a clock
   an SM; floor_roll: its adds over 64 int32 lanes an SM plus one
   shared-memory word for each R adds) at the SM clock nvidia-smi reads
   under load, and its earlier time (PERF.md §6 rows 8-10).
9. Long-horizon phase: tpufluid_torch.tools.long_horizon at 4096x4096
   bfloat16 (RGB9E5), 1500 steps (300 with splats) in chunks of 50, launch
   counts zeroed before and checked after; it must report ok with no
   non-finite value (its output goes to out/long_horizon_4096/). Then, at
   the same config on a random state: every kernel call of a step against
   its plain version (as phase 2), their device time beside their bound
   (as phase 4), and profile_step_kernels over 30 steps (each kernel's
   device time a step, its events equal to its launches).

10. Batched phase (tpufluid_torch.batch, the serving mode of bench.py
   config 7): at serving_256_b16 (16 sims of 256^2) and serving_1024_b8 (8
   sims of 1024^2), bf16 with the RGB9E5 dye, 20 sweeps, MAX_SPLATS=8.
   Every batched kernel call of a step (check.batched_step_cases: random
   per-sim states and splats, sim 0 without an active splat row, sim 1 with
   all 8) against its plain version in both forms of dt (lock-step 1/60 and
   per sim linspace(1/90, 1/60, B)), max abs error 0 required; the same at
   the demo's cross grid (128/1024) with B = 4. Then make_batched_multi_step
   over each sim's own swirl_trace (seed 42 + i), per-sim dts: launch counts
   zeroed before and read after 3 steps (5 launches a batched step), each
   sim equal bit for bit to make_step on that sim alone and the batch to
   the plain batched step; then 100 warm-up and 200 timed steps, lock-step
   and per sim (aggregate sim-steps/s), the batched step's median and p95
   over 200 make_batched_step calls, the batched kernels' spin-queued ms
   beside each kernel's single-sim ms x B, the idle share, the profiled
   batched step (torch.profiler, 30 steps) and the same rates at B = 1
   beside make_step.
11. Batched frame phase (tpufluid_torch.batch.make_batched_render and
   serve_batch.make_batched_tick, the multi-tenant server's frame): at the
   demo's cross grid with B = 4 in float32 and at serving_256_b16 and
   serving_1024_b8 (canvas = grid, bloom base 256^2 with 7 mips, sunrays
   196^2). The batched bloom pyramid, sunrays and display (check.
   batched_render_cases, one call each for the B sims) against their
   plain versions on a random batch, max abs error 0 required; then, on a
   batch stepped BATCH_FRAME_WARM steps over each sim's own swirl_trace:
   one make_batched_render frame (launch counts zeroed before and read
   after: 1 bloom_pyramid, 1 sunrays, 1 sunrays_blur and 1 display) equal
   to the plain batched render and, sim by sim, to make_render; 3
   make_batched_tick ticks with a dt a sim (5 + 4 launches each), each
   sim's state and uint8 frame equal to make_step_and_render's on it
   alone. Then aggregate sim-frames/s and
   sim-ticks/s (B x 200 / wall, one call a frame or tick with a CUDA event
   after each; the timed ticks lock-step, the server's one clock) with their
   median and p95 and the idle share (1 - the spin-queued device time of
   the same call / the median), each batched render kernel's
   spin-queued ms beside its single-sim launches summed over the B sims,
   the same frame rate at B = 1 beside make_render, and
   profile_frame_kernels on the batch (torch.profiler, 30 batched frames:
   one event of each render kernel a frame).
12. Sharded phase (tpufluid_torch.parallel, BASELINE.md config #5): the
   meshes put their shards on the cards torch.cuda.device_count() reports,
   round robin (on one card all on cuda:0: a line says so). pre_pressure's
   true-wall form (check.bounded_cases: the walls of a top, bottom, corner,
   middle and single shard, walls inside the first tile and on each tile's
   edge) against its plain version in float32, bfloat16 and float16, max abs
   error 0 required, and advect_dye with the float32 velocity the sharded
   step gives a 16-bit dye (check.f32_velocity_dye_cases at the demo's
   geometry in bf16, RGB9E5 and not: the coarse velocity and the velocity
   resampled on the dye's grid), max abs error 0 required. Then 3
   make_sharded_step steps through the kernels
   against 3 through the plain versions (check.py's tolerances, launches
   counted: 6 a shard a step, 18 where every phase splits) at demo_float32
   on a 2x2 mesh, 4096^2 bf16 (RGB9E5) on (4, 1) and on 2x2 with
   OVERLAP_HALO, and at sharded_16384_bf16_2x2 itself (sim = dye = canvas
   16384^2, bf16 RGB9E5, 20 sweeps, MAX_SPLATS=8, swirl_trace seed 42,
   OVERLAP_HALO by default, so on: the kernels on its padded blocks and
   split bands); there also 3 make_multi_step steps at 16384^2 (launches
   counted) against plain_step. The sharded step against make_step:
   demo_float32 2x2 after 4 steps within 4e-4 of each field's scale, and
   sharded_16384_bf16_2x2 after 3 steps within 1e-2, each with its largest
   difference and the share of texels that differ. Then, the main path of
   this phase with the launch counts zeroed just before and read just
   after: make_sharded_multi_step over 20 steps at sharded_16384_bf16_2x2
   beside make_multi_step's 20 at 16384^2 on the same card and the sharded
   step's 20 with OVERLAP_HALO=False (steps/s; the kernels' and the other
   device time a step under torch.profiler over 3 steps; the idle share),
   the launches against 72 a sharded step (24 without the split), the
   bytes the halos moved in one step against overhead_report, and the
   bounded pre_pressure on a corner shard's padded block (compared inside
   its walls) beside the unbounded launch on a copy of the same window,
   its bound and its plain time.

13. Packed phase (tpufluid_torch.batch_packed, bench.py --config 7
   --packed): the lane-packed fleet at serving_256_b16 (16 sims of 256^2,
   the batched phase's cell, packed) and packed_288_b64 (64 sims of 288^2,
   the geometry tpufluid/batch_packed.py was built for), bf16 with the
   RGB9E5 dye, 20 sweeps, MAX_SPLATS=8, each sim its own swirl_trace (seed
   42 + i). Every packed kernel call of a step (check.packed_step_cases:
   random sims that differ, the lock-step dt 1/60) against its plain
   version in float32 and in bf16 (RGB9E5), max abs error 0 required. Then,
   the launch counts zeroed just before and read just after,
   make_packed_multi_step over 3 lock-step steps (5 launches a step,
   whatever B is): unpacked, every field of every sim equal to
   make_batched_multi_step's (max abs error 0), and the fleet equal to 3
   plain_packed_step steps (0). Then aggregate sim-steps/s of 200 steps in
   one call, make_batched_multi_step and make_packed_multi_step on the same
   sequences in the order batched, packed, packed, batched (the packed runs'
   launches counted); each packed kernel's spin-queued ms beside its batched
   form's on the same sims, with its bound and plain ms; the idle share (1 -
   the packed kernels' device ms / the packed step's wall ms); one batched
   torch grid_sample call on the dye as the advection's library yardstick;
   and profile_step_kernels on the packed state (torch.profiler, 30 steps:
   each kernel's device us a step, events = launches).

14. App and server phase (the port's user-facing entry points, at their
   defaults). tpufluid_torch.app.main at the demo geometry (f32,
   MAX_SPLATS 16): a straight run of 600 steps with checkpoints every 300,
   metrics every 60, 3 PNG frames, a GIF and a capture; a run resumed from
   its step-300 checkpoint, whose step-600 checkpoint must equal the
   straight run's bit for bit; a run with no output, the app's loop rate.
   Each prints the app's own steps/s line; the launch counts, zeroed
   before each run, must be 5 a step and 2 a frame. Then FluidServer
   (sim 128, dye 512, 640x360) on the card with its sim thread and a
   ThreadingHTTPServer on 127.0.0.1: drag and burst events, /frame until
   200 frames were served (the tick's ms median and p95, the JPEG encode's,
   frames/s, paced near 60 by MAX_DT), /stats, /config, /screenshot.png,
   /trace.npz; paused, /checkpoint.npz, which resumes a second server whose
   state must equal the checkpointed one (0); a live POST /config to
   bfloat16 and dye 256. Last the resumed server's own ticks, in turn with
   no HTTP traffic: 20 counted (9 launches a tick, timed), and one whose
   frame is held to the plain render of the state it leaves (phase 6's
   bound; 0).

15. Fleet server phase (tpufluid_torch.serve_batch, the multi-tenant
   server). a. make_tick_program at fleet_256_b16 (16 sessions of 256²,
   bf16 RGB9E5, each its own swirl_trace) for 'scalar', 'vector' (dt
   linspace(1/90, 1/60)) and K = 4 (speeds linspace(0.5, 4.0)): each
   equal to its plain passes on the card (0), each sim of the K = 4 tick
   equal to its iterated make_step_and_render ticks (0), 9, 9 and 24
   launches a tick (counted again over 200 timed ticks each: ticks/s,
   sim-ticks/s, median, p95), the kernels' spin-queued device time a tick
   and the idle share. b. 5 sessions in a padded 8 driven by hand: pad rows
   exactly 0 after 50 ticks, evicted rows exactly 0 after resize_fleet(2)'s
   zero tail, then the swap and resize_fleet(5). c. BatchFluidServer at its
   CLI defaults with its sim thread and an HTTP server on 127.0.0.1: every
   endpoint, speeds 0.25 and 2.5 (the per-sim program, then K = 3),
   /sessions 4 -> 6 -> 3, a paused /checkpoint.npz resuming a second
   server whose state equals the checkpointed one (0); steps served a
   second, tick ms with and without HTTP traffic, JPEG encode ms. d.
   tpufluid_torch/tools/serve_soak.py in process for 45 s (its default
   600 s, cut for time) at the CLI geometry: its p99s beside its bars,
   every bar must hold.

16. Batch-mesh phase (tpufluid_torch.batch's mesh half, serve_batch's
   make_batch_sharded_substepped_tick, dryrun, parallel.auto, the drift
   tool), every mesh on the cards there are, round robin. a. Batch DP at
   fleet_256_b16 on a (4, 1) mesh: 200 make_batch_sharded_multi_step steps
   lock-step and per sim, each equal to make_batched_multi_step (0), 20
   launches a step, no halo byte; the K = 4 make_batch_sharded_substepped_tick
   (speeds as 15a's), state and frames equal to make_substepped_tick (0),
   88 launches; sim-steps/s and sim-ticks/s beside the unsharded calls' in
   the same run, each with its idle share (torch.profiler over 3 calls). b.
   The two new kernel forms against their plain versions, max abs error 0
   (check.batched_bounded_cases in f32, bf16, f16; batched_f32_velocity_dye_cases
   at the demo in bf16 RGB9E5, bf16, f16), with times beside bounds; then
   make_batch_spatial_multi_step at the demo's cross grid in f32 and bf16
   RGB9E5 on (2, 2, 2) and (4, 2, 1) (2 sims a group, per-sim dts, 4 steps)
   and at 256/512 f32 with every phase split on (2, 2, 1): through the
   kernels against the plain passes (0, launches counted), each sim against
   its single-sim sharded step on its group's mesh (0), the batch against
   make_batched_multi_step: each unsharded sim equal to make_multi_step (0),
   so the difference is the sharded step's own, held under 1e-2 (f32) or
   0.08 (bf16) and printed beside phase 12's bound (which phase 12 holds on
   its one trace). c. sharded_16384_bf16_2x2 with 2 tenants a group on
   (2, 2, 2), 3 steps, per-sim dts: each sim against its single-sim sharded
   step (0), the batch against make_batched_multi_step as in b (under
   0.08, beside phase 12's 1e-2), sim-steps/s (then again from the state
   reached, with torch.profiler's device time over 3 steps) beside phase
   12's sharded rate, the launches of a step (2 x a sharded step's) and the
   peak memory; then the batched true-wall pre_pressure on a corner shard's
   padded block, timed. d. dryrun_multichip(8), and
   make_auto_sharded_step against make_step over 5 steps at demo_float32
   (0). e. tools/fidelity_drift.run() at its defaults: every summary finite.

17. Batch demo phase (tpufluid_torch.tools.batch_demo, the port of
   tools/batch_demo.py): the tool's main() at its defaults (4 sims at
   speeds 0.25-1 of 1/60 s sharing swirl_trace seed 11, 96^2 sim, 192^2 dye
   and canvas, f32, 360 steps, a frame every 6) into out/batch_demo/, with
   the launches counted over its run (5 a step, 4 a frame: 2,040) and the
   display form it took; its GIF (60 frames of 384x384); its 60 frames and
   its final state bit-equal to the same loop through plain_batched_step
   and the plain batched render with contiguous splat rows a sim (the first
   10 frames and the state at step 60 alone where the plain run's pace
   would pass 30 s); each step and frame kernel at the demo's last state
   against its plain version (max abs err 0) and timed beside its bound;
   the tool's wall time, sim-steps/s and frames/s beside the card's name
   and power limit.

Prints a JSON line {"kernels": [...]}, the card's name and power limit, and
last {"ok": true, "device": {...}}; writes details to
out/chip_smoke.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores

PATH_STEPS = 300               # per config; steps/s over the last TIMED_STEPS
TIMED_STEPS = 200
CHECK_STEPS = 3                # compared against the plain step
RENDER_KERNELS = ("bloom_pyramid", "sunrays", "sunrays_blur", "display")
PTXAS_LIBRARIES = ("stencil", "advect", "jacobi", "bloom", "display", "sunrays")
# The step's timed calls (check.step_cases before the standalone pair): the solve's
# case, jacobi_project, covers its chunks before the fused launch.
MAIN_STEP_KERNELS = ("pre_pressure", "jacobi_project", "advect", "advect_dye")
# The fused solve's own phase: every sweep count around the chunks' 10, on
# ((H, W), B, packed): the demo's grid alone (small tiles), 3 of it, 16 of
# it (large tiles), 1024^2 (large), 288^2 fleets packed.
PROJECT_SWEEPS = (0, 1, 9, 10, 11, 20, 23)
PROJECT_CELLS = (((128, 228), 1, False), ((128, 228), 3, False), ((128, 228), 16, False),
                 ((1024, 1024), 1, False), ((288, 288), 3, True), ((288, 288), 16, True))
TIMED_FRAMES = 200             # make_render frames and make_step_and_render ticks
FLOORS_KERNELS = ("floor_taa", "floor_roll", "floor_sweep")
FLOORS_CONFIG = "1024_bfloat16_rgb9e5"    # bench.py config 3, where bench.py reports floors
# The floors kernels' spin-queued ms before their redesigns (PERF.md §6
# rows 8-10), printed beside this run's.
FLOORS_EARLIER_MS = {"floor_taa": 0.2860, "floor_roll": 0.0320, "floor_sweep": 1.1699}
FLOORS_SCALING = (1.6, 2.4)    # time at twice the work over the default's
F32_LANES_PER_SM = 128         # H100 SXM: float32 adds a clock an SM
INT32_LANES_PER_SM = 64        # H100 SXM: int32 adds a clock an SM
SMEM_WORDS_PER_SM = 32         # H100 SXM: shared-memory words a clock an SM
ROLL_TRIPS = (256, 512, 1024)  # floor_roll's linearity: each doubling's added time a trip
PROFILE_STEPS = 30                        # profile_step_kernels' default
PROFILE_FRAMES = 30                       # profile_frame_kernels' default
LONG_HORIZON_STEPS = 1500
JACOBI_SWEEPS_A_LAUNCH = 10    # the chunk kernel's design: a solve of N sweeps is ceil(N / 10)
# kernels held to max abs error 0 in check_cases (the step's, and the sunrays)
EXACT_KERNELS = ("pre_pressure", "jacobi_project", "advect_dye", "sunrays")
LONG_HORIZON_OUT = Path("out/long_horizon_4096")
# The batched serving cells (bench.py config 7 at --serve-res 256 and 1024):
# (resolution, sims); each sim replays its own swirl_trace(seed 42 + i).
BATCH_CONFIGS = {"serving_256_b16": (256, 16), "serving_1024_b8": (1024, 8)}
BATCH_WARM, BATCH_TIMED = 100, 200
CROSS_GRID_BATCH = 4           # the demo's 128/1024 cross grid, batched
BATCH_FRAME_WARM = 50          # steps before the batched frames are compared and timed
PER_FRAME = {"bloom_pyramid": 1, "sunrays": 1, "sunrays_blur": 1, "display": 1}
# The display's direct form on the entry points (phase 6b): the server at
# its CLI defaults, its canvas posted down to a small browser window's, and
# the app at --canvas 256x256 with its default dye (check.DIRECT_GEOMETRIES).
SMALL_SERVER_CANVAS = "server_cli_200x112"
SMALL_APP_CANVAS = "app_canvas_256x256"
SMALL_TICKS = 20
SMALL_APP_STEPS, SMALL_APP_RENDER_EVERY = 20, 10
SHARDED_MESH = (2, 2)
SHARDED_RES = 16384            # sharded_16384_bf16_2x2: BASELINE.md config #5
SHARDED_CHECK_RES = 4096       # the kernels-against-plain cells
SHARDED_RATE_STEPS = 20
SHARDED_PROFILE_STEPS = 3
SHARDED_16K_BOUND = 1e-2       # of each field's scale after 3 steps: about 2.5 bf16 ulps
SHARDED_DEMO_BOUND = 4e-4      # tests/test_sharding.py's, after 4 steps
# The packed fleet's cells: (resolution, sims), bf16 RGB9E5, 20 sweeps.
PACKED_CONFIGS = {"serving_256_b16": (256, 16), "packed_288_b64": (288, 64)}
PACKED_MAIN = "packed_288_b64"   # whose numbers the kernels line carries
PACKED_TIMED = 200
APP_OUT = Path("out/chip_smoke_app")
APP_STEPS = 600                # the straight run; resumed from its checkpoint at half
APP_RENDER_EVERY = 200         # the straight run's frames (3) and one capture
SERVER_FRAMES = 200            # frames the HTTP phase serves
SERVER_TICKS = 20              # the resumed server's counted ticks
SERVER_DYE_SWITCH = 256        # the live /config switch's dye resolution
# Phase 15, the fleet server. fleet_256_b16: serving_256_b16's geometry
# (16 sims of 256², bf16 RGB9E5, 20 sweeps, MAX_SPLATS 8, swirl_trace seed
# 42 + i) through make_tick_program; the server's own cell is its CLI
# defaults (tpufluid_torch.serve_batch.build_argparser).
FLEET_CELL, FLEET_RES, FLEET_SESSIONS = "fleet_256_b16", 256, 16
FLEET_K = 4                    # speeds linspace(0.5, 4.0, 16) at MAX_DT
FLEET_WARM, FLEET_TIMED = 50, 200
FLEET_PAD_TICKS = 50           # 15b: 5 sessions in a padded 8
FLEET_SERVE_S = 4.0            # 15c: each traffic mode's seconds
FLEET_DASH_PERIOD_S = 0.1      # 15c: the dashboard page's frame poll (setInterval 100)
FLEET_DIRECT_TICKS = 100       # 15c: the resumed fleet's ticks, no traffic
FLEET_SOAK_S = 45.0            # 15d: tools/serve_soak.py's 600 s, cut for time
# Phase 16, the batch-mesh modes.
DP_MESH = (4, 1)               # 16a: fleet_256_b16's 16 sims, 4 a slice
DP_STEPS, DP_WARM = 200, 10
DP_TICKS = 50
BS_MESHES = ((2, 2, 2), (4, 2, 1))   # 16b: the demo's cross grid, 2 sims a group
BS_STEPS = 4
# 16b, c against the unsharded batch: each field's departure over its scale
# is held under a fault bound (a halo or wall fault moves whole texels) and
# printed beside phase 12's bound, which phase 12 holds on its one trace.
BS_F32_FAULT_BOUND = 1e-2
BS_BF16_FAULT_BOUND = 0.08     # tests/test_torch_sharding.py's bf16 class
BS_SPLIT, BS_SPLIT_MESH = (256, 512), (2, 2, 1)   # 16b: every phase split (OVERLAP_HALO=True)
BS_FULL_MESH, BS_FULL_PER_GROUP, BS_FULL_STEPS = (2, 2, 2), 2, 3   # 16c at 16384^2
DRYRUN_DEVICES = 8
AUTO_STEPS = 5
# Phase 17, the batch demo (tpufluid_torch.tools.batch_demo) at its defaults.
DEMO_OUT = Path("out/batch_demo/batch_grid.gif")
DEMO_HELD_FRAMES = 10          # frames always held to the plain loop
DEMO_PLAIN_BUDGET_S = 30.0     # the whole plain run is held where it fits this
LONG_HORIZON_ARGS = ["--res", "4096", "--dtype", "bfloat16", "--steps", str(LONG_HORIZON_STEPS),
                     "--splat-steps", "300", "--chunk", "50", "--out", str(LONG_HORIZON_OUT)]


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def jacobi_launches(cfg) -> int:
    """Launches of a Jacobi solve of ``cfg``: JACOBI_SWEEPS_A_LAUNCH sweeps
    a launch (the standalone solve; the step's last is jacobi_project)."""
    return math.ceil(cfg.PRESSURE_ITERATIONS / JACOBI_SWEEPS_A_LAUNCH)


def expected_per_step(cfg) -> dict:
    """Launches of each kernel in one step of ``cfg``, those that launch:
    the Jacobi solve in launches of JACOBI_SWEEPS_A_LAUNCH sweeps, its last
    the fused jacobi_project (a solve of no sweeps is that one launch), so
    no gradient_subtract; the velocity's gather and the dye's kernel. Five
    at 20 sweeps."""
    counts = {"pre_pressure": 1, "jacobi_chunk": max(jacobi_launches(cfg) - 1, 0),
              "jacobi_project": 1, "advect": 1, "advect_dye": 1}
    return {k: n for k, n in counts.items() if n}


def step_device_ms(timing: dict) -> float:
    """A step's kernels' device ms from timing_phase's rows of its cases:
    MAIN_STEP_KERNELS, not the standalone pair that check.step_cases adds."""
    return sum(timing[k]["ms"] for k in MAIN_STEP_KERNELS if k in timing)


def print_pair(name: str, timing: dict, gpu: str) -> None:
    """The fused solve's spin-queued ms beside the pair it replaces."""
    fused, chunk, grad = (timing[k] for k in ("jacobi_project", "jacobi_chunk",
                                              "gradient_subtract"))
    print(f"time   jacobi_project at {name} on {gpu}: fused {fused['ms']:.4f} ms (bound "
          f"{fused['bound_ms']:.4f} ms, plain {fused['plain_ms']:.4f} ms) beside the pair it "
          f"replaces, jacobi {chunk['ms']:.4f} + gradient_subtract {grad['ms']:.4f} = "
          f"{chunk['ms'] + grad['ms']:.4f} ms ({fused['ms'] / (chunk['ms'] + grad['ms']):.3f}x)")


def ptxas_report(build) -> list:
    """The ptxas report of every kernel instance of PTXAS_LIBRARIES: one
    dict per compiled kernel (name demangled where c++filt is found)."""
    import shutil

    rows = []
    for name in PTXAS_LIBRARIES:
        log = build.library_path(name).with_suffix(".log").read_text()
        for f in build.ptxas_report(log):
            if shutil.which("c++filt"):
                f["function"] = subprocess.run(["c++filt", f["function"]], capture_output=True,
                                               text=True, timeout=60).stdout.strip()
            rows.append(f)
    return rows


def configs():
    from tpufluid_torch import FluidConfig

    demo = dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280,
                CANVAS_HEIGHT=720, PRESSURE_ITERATIONS=20, MAX_SPLATS=8)
    square = dict(SIM_RESOLUTION=1024, DYE_RESOLUTION=1024, CANVAS_WIDTH=1024,
                  CANVAS_HEIGHT=1024, PRESSURE_ITERATIONS=20, MAX_SPLATS=8)
    out = {}
    for grid, base in (("demo", demo), ("1024", square)):
        for dtype, rgb9e5 in (("float32", False), ("bfloat16", True),
                              ("bfloat16", False), ("float16", False)):
            name = f"{grid}_{dtype}" + ("_rgb9e5" if rgb9e5 else "")
            out[name] = FluidConfig(DTYPE=dtype, DYE_RGB9E5=rgb9e5, **base).validate()
    return out


def check_cases(torch, check, name, cases, errors: dict, exact: bool = False) -> None:
    """Each case's kernel against its plain version: prints the max abs
    error beside its tolerance (0 for EXACT_KERNELS, or for every case when
    ``exact``), fails past it, and adds it to ``errors`` per (config,
    kernel)."""
    for case in cases:
        err, tol = check.compare(case.run(), case.run(plain=True))
        torch.cuda.synchronize()
        if exact or case.kernel_name in EXACT_KERNELS:
            tol = 0.0
        print(f"kernel {name:22s} {case.label:20s} max_abs_err {err:.3e}  tol {tol:.3e}")
        assert err <= tol, f"{case.label} on {name}: {err} > {tol}"
        key = (name, case.kernel_name)
        errors[key] = max(errors.get(key, 0.0), err)


def kernel_phase(torch, check, cfgs, device) -> dict:
    """Max abs error per (config, case); asserts each within tolerance."""
    errors = {}
    for name, cfg in cfgs.items():
        state, splats = check.random_state(cfg, seed=7, device=device)
        check_cases(torch, check, name, check.step_cases(state, splats, cfg), errors)
    return errors


def project_phase(torch, device, errors: dict) -> None:
    """The fused solve (jacobi_project) against jacobi_plain then
    gradient_subtract_plain at every sweep count of PROJECT_SWEEPS, in the
    three storage types, one sim, batches and packed fleets of
    PROJECT_CELLS (both tiles: the demo's grid takes the small ones alone
    and 16 of them the large ones): each pressure and velocity bit-equal,
    the launches ceil(N / 10) - 1 chunks and one fused. Adds each max abs
    error to ``errors`` under ("project:<cell>", "jacobi_project")."""
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.ops.cuda import jacobi as kjacobi

    gen = torch.Generator(device=device).manual_seed(17)
    sms = build.sm_count(device)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for (h, w), b, packed in PROJECT_CELLS:
            lead = () if b == 1 and not packed else (b,)
            p, d = (torch.randn(lead + (h, w), generator=gen, device=device).to(dtype)
                    for _ in range(2))
            vel = torch.clamp(torch.randn(lead + (2, h, w), generator=gen, device=device) * 400,
                              -1000, 1000).to(dtype)
            kw = {}
            if packed:
                p, d, vel = (build.pack_fleet(t) for t in (p, d, vel))
                kw = {"sim_w": w}
            cell = f"{h}x{w}:{'packed:' if packed else ''}b{b}"
            err, chunks, fused = 0.0, 0, 0
            for n in PROJECT_SWEEPS:
                before = (kjacobi.JACOBI_CHUNK.launches, kjacobi.JACOBI_PROJECT.launches)
                got = kjacobi.jacobi_project(p, d, vel, n, 0.8, **kw)
                torch.cuda.synchronize()
                ran = (kjacobi.JACOBI_CHUNK.launches - before[0],
                       kjacobi.JACOBI_PROJECT.launches - before[1])
                assert ran == (max(math.ceil(n / JACOBI_SWEEPS_A_LAUNCH) - 1, 0), 1), (cell, n,
                                                                                        ran)
                chunks, fused = chunks + ran[0], fused + ran[1]
                want = kjacobi.jacobi_project_plain(p, d, vel, n, 0.8, **kw)
                for g, x in zip(got, want):
                    assert g.dtype == x.dtype and g.shape == x.shape, (cell, n)
                    err = max(err, float((g.float() - x.float()).abs().max()))
            tiles = kjacobi.tiles_for(h, w, sms, b)
            print(f"kernel project {cell:22s} {str(dtype)[6:]:8s} jacobi_project at N = "
                  f"{','.join(map(str, PROJECT_SWEEPS))} on the {('large', 'small')[tiles]} "
                  f"tiles {kjacobi.TILES[tiles]}: pressure and velocity max_abs_err {err:.3e}  "
                  f"tol 0 (launches: {chunks} jacobi_chunk, {fused} jacobi_project)")
            assert err == 0.0, (cell, dtype, err)
            key = (f"project:{cell}:{str(dtype)[6:]}", "jacobi_project")
            errors[key] = max(errors.get(key, 0.0), err)


def path_phase(torch, cfg, device) -> dict:
    """Drive make_multi_step, then make_step, over a swirl trace; return
    the launch counts, the step rate and the step-time distribution."""
    from tpufluid_torch import init_state, make_multi_step, make_step, swirl_trace
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.step import plain_step
    from tpufluid_torch.tools.render_rate import call_times

    trace = swirl_trace(cfg, PATH_STEPS, seed=42)
    multi = make_multi_step(cfg, device=device)
    warm = PATH_STEPS - TIMED_STEPS

    build.reset_launches()
    state = multi(init_state(cfg, device=device), trace.dts[:CHECK_STEPS],
                  trace.batches[:CHECK_STEPS])
    # The first steps against the plain step on the same GPU tensors (the
    # plain versions launch no kernel, so the counts stay the path's).
    want = init_state(cfg, device=device)
    for t in range(CHECK_STEPS):
        want = plain_step(want, trace.dts[t], trace.batches[t], cfg)
    step_err = {}
    for f in ("velocity", "dye", "pressure"):
        g, w = getattr(state, f).float(), getattr(want, f).float()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        step_err[f] = err
        assert err <= 1e-3 * scale, (f, err, scale)
    state = multi(state, trace.dts[CHECK_STEPS:warm], trace.batches[CHECK_STEPS:warm])
    # The timed window: one make_step call per step, as an interactive
    # caller steps, with a CUDA event between steps.
    step = make_step(cfg, device=device)
    box = [state]

    def one(k):
        box[0] = step(box[0], trace.dts[warm + k], trace.batches[warm + k])

    steps_per_s, step_median, step_p95 = call_times(one, TIMED_STEPS)
    state = box[0]
    launches = {k: v.launches for k, v in build.KERNELS.items()}

    want = {k: n * PATH_STEPS for k, n in expected_per_step(cfg).items()}
    assert {k: n for k, n in launches.items() if n} == want, (launches, want)
    v, d, p = (x.float() for x in (state.velocity, state.dye, state.pressure))
    assert all(bool(torch.isfinite(x).all()) for x in (v, d, p)), "non-finite state"
    assert float(d.min()) >= 0.0, "negative dye"
    assert float(v.abs().max()) > 0.0 and float(d.max()) > 0.0, "nothing moved"
    return {"state": state, "splats": trace.batches[-1], "launches": launches,
            "steps_per_s": steps_per_s, "step_err": step_err,
            "step_ms_median": step_median, "step_ms_p95": step_p95}


def timing_phase(torch, check, cases, verbose: bool = True) -> dict:
    """Per kernel: device ms, plain ms and bound ms summed over ``cases``
    (one step's or one frame's calls); ``verbose`` prints each case."""
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate

    rate = spin_rate()
    out = {}
    for case in cases:
        kernel = queued_ms(case.run, 20, rate)
        plain = queued_ms(lambda: case.run(plain=True), 3, rate)
        bound = 1e3 * max(case.nbytes / HBM_BYTES_PER_S, case.flops / F32_FLOPS_PER_S)
        by = "bytes" if case.nbytes / HBM_BYTES_PER_S >= case.flops / F32_FLOPS_PER_S \
            else "operations"
        err, tol = check.compare(case.run(), case.run(plain=True))
        assert err <= tol, f"{case.label} on the path's state: {err} > {tol}"
        if verbose:
            print(f"time   {case.label:20s} kernel {kernel:.4f} ms  plain {plain:.4f} ms  "
                  f"bound {bound:.4f} ms ({by}, {case.nbytes} B, {case.flops} flop)")
        row = out.setdefault(case.kernel_name, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                                "bytes": 0, "flops": 0, "by": by,
                                                "max_abs_err": 0.0})
        row["ms"] += kernel
        row["plain_ms"] += plain
        row["bound_ms"] += bound
        row["bytes"] += case.nbytes
        row["flops"] += case.flops
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if by == "operations":
            row["by"] = by
    return out


def queued_us(timing: dict, kernel: str) -> str:
    """A kernel's spin-queued µs from timing_phase's rows, where it has a
    row of its own: the sunrays' blur is timed in its pass, the "sunrays"
    row, with the march."""
    return (f"{1e3 * timing[kernel]['ms']:.4f} us" if kernel in timing
            else "in its pass's row")


def render_kernel_phase(torch, check, cfgs, device, errors: dict) -> None:
    """Every kernel call of a frame against its plain version: at each
    config's canvas, then the variants at the two path configs, then two
    small canvases, where each form's display launches are counted. Adds
    each max abs error to ``errors`` per (config, kernel); asserts each
    within tolerance."""
    from tpufluid_torch import FluidConfig
    from tpufluid_torch.ops.cuda import build

    def run(name, cfg, label, state, **kw):
        ran = []
        for case in check.render_cases(state, cfg, **kw) + check.sunrays_cases(state, cfg):
            ran.append(case.kernel_name)
            err, tol = check.compare(case.run(), case.run(plain=True))
            torch.cuda.synchronize()
            print(f"kernel {name:22s} {label:14s} {case.label:15s} max_abs_err {err:.3e}  "
                  f"tol 0")
            assert err == 0.0, f"{case.label} on {name} {label}: {err} != 0"
            key = (name, case.kernel_name)
            errors[key] = max(errors.get(key, 0.0), err)
        return ran

    for name, cfg in cfgs.items():
        state, _ = check.random_state(cfg, seed=7, device=device)
        run(name, cfg, "canvas", state)
    for name in ("demo_float32", "1024_bfloat16_rgb9e5"):
        cfg = cfgs[name]
        state, _ = check.random_state(cfg, seed=8, device=device)
        for flag in ("SHADING", "BLOOM", "SUNRAYS"):
            run(name, dataclasses.replace(cfg, **{flag: False}), f"{flag.lower()}=off", state)
        run(name, cfg, "no-dither", state, dither=False)
        run(name, cfg, "compose=off", state, compose=False)
        cw, ch = cfg.capture_size
        run(name, cfg, f"capture{ch}x{cw}", state, out_hw=(ch, cw))
        run(name, cfg, "tick360x640", state, out_hw=(360, 640))
    # Canvases much smaller than their dye, where the staged window does
    # not fit a block in f32: the direct form runs, the staged form does
    # not. In bf16 some of them fit (a 16-bit window is half the bytes):
    # the form the wrapper picks is the one that runs.
    for label in (SMALL_SERVER_CANVAS, SMALL_APP_CANVAS):
        res, cw, ch, own = check.DIRECT_GEOMETRIES[label]
        for dtype, rgb9e5 in (("float32", False), ("bfloat16", True)):
            cfg = FluidConfig(DYE_RESOLUTION=res, CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch,
                              DTYPE=dtype, DYE_RGB9E5=rgb9e5, MAX_SPLATS=8).validate()
            name = f"{label}_{dtype}"
            state, _ = check.random_state(cfg, seed=10, device=device)
            build.reset_launches()
            ran = (run(name, cfg, "canvas", state)
                   + run(name, dataclasses.replace(cfg, SHADING=False), "shading=off", state)
                   + run(name, cfg, "compose=off", state, compose=False))
            forms = {k: build.KERNELS[k].launches for k in ("display", "display_direct")}
            print(f"kernel {name:22s} display forms: launches {forms}")
            assert forms == {k: ran.count(k) for k in forms}, (name, forms, ran)
            if cfg.dtype == own:
                assert ran.count("display_direct") == 3, (name, ran)


def render_path_phase(torch, check, cfg, run, device) -> dict:
    """Render the path's final state through make_render and
    make_step_and_render; return launch counts, rates, device times, the
    render kernels' timing and the frame's profile."""
    from tpufluid_torch import capture_frame, make_render, make_step_and_render, swirl_trace
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate
    from tpufluid_torch.render import plain_render
    from tpufluid_torch.tools.render_rate import call_times

    state = run["state"]
    render = make_render(cfg, device=device)
    n_mips = len(cfg.bloom_mip_sizes())
    rays = 1 if cfg.SUNRAYS else 0
    per_frame = {"bloom_pyramid": 1 if n_mips >= 2 else 0, "sunrays": rays, "sunrays_blur": rays,
                 "display": 1}

    build.reset_launches()
    frame = render(state)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    want = {k: per_frame.get(k, 0) for k in launches}
    assert launches == want, (launches, want)
    err, tol = check.compare(frame, plain_render(state, cfg))
    assert err <= tol, f"render vs plain render: {err} > {tol}"
    assert frame.shape == (4, cfg.CANVAS_HEIGHT, cfg.CANVAS_WIDTH), frame.shape
    assert bool(torch.isfinite(frame).all()), "non-finite frame"
    back = torch.tensor([c / 255.0 for c in cfg.BACK_COLOR], device=device)[:, None, None]
    assert float((frame[:3] - back).abs().max()) > 0.05, "frame is all background"
    # opaque: alpha a + 1 * (1 - a) is 1 to within an ulp of a = max(rgb)
    assert float((frame[3] - 1.0).abs().max()) <= 1e-6 * max(1.0, float(frame[:3].max())), \
        "opaque frame with alpha != 1"
    cap = capture_frame(state, dataclasses.replace(cfg, TRANSPARENT=True))
    assert bool(torch.equal(cap[3], cap[:3].amax(dim=0))), "capture alpha != max(rgb)"

    build.reset_launches()
    fps, frame_med, frame_p95 = call_times(lambda k: render(state), TIMED_FRAMES)
    frame_launches = {k: v.launches for k, v in build.KERNELS.items()}
    for k, n in want.items():
        assert frame_launches[k] == n * TIMED_FRAMES, (k, frame_launches[k])

    trace = swirl_trace(cfg, TIMED_FRAMES, seed=43)
    tick = make_step_and_render(cfg, device=device)
    box = [state]

    def one_tick(k):
        box[0], pixels = tick(box[0], trace.dts[k], trace.batches[k])
        return pixels

    build.reset_launches()
    tps, tick_med, tick_p95 = call_times(one_tick, TIMED_FRAMES)
    tick_launches = {k: v.launches for k, v in build.KERNELS.items()}
    want_tick = {k: n * TIMED_FRAMES for k, n in {**expected_per_step(cfg), **per_frame}.items()
                 if n}
    assert {k: n for k, n in tick_launches.items() if n} == want_tick, tick_launches
    pixels = one_tick(0)
    assert pixels.dtype == torch.uint8 and pixels.shape == (cfg.CANVAS_HEIGHT,
                                                           cfg.CANVAS_WIDTH, 3)

    # One frame (about 25 launches, most of them PyTorch's: the bloom's
    # base resample, the backdrop, the blend) or one tick behind the spin
    # kernel: the device's queue of pending
    # launches holds about a thousand, and a host that blocks on a full queue
    # would be timed with the device. The tick's splats are put on the card
    # first: their copy from the host would wait for the spin.
    rate = spin_rate()
    frame_device = queued_ms(lambda: render(state), 1, rate)
    splats = torch.as_tensor(trace.batches[0], device=device)
    tick_device = queued_ms(lambda: tick(state, trace.dts[0], splats), 1, rate)
    timing = timing_phase(torch, check, check.render_cases(state, cfg)
                          + check.sunrays_cases(state, cfg))
    host = host_profile(torch, lambda: render(state), 50, RENDER_HOST_FUNCS, "frame")
    profile = floors.profile_frame_kernels(cfg, state, PROFILE_FRAMES)
    for k, row in profile["kernel_events"].items():
        assert row["events"] == per_frame[k] * PROFILE_FRAMES, (k, row)
    print(f"profile frame {cfg.DTYPE} {cfg.CANVAS_HEIGHT}x{cfg.CANVAS_WIDTH}, torch.profiler over "
          f"{PROFILE_FRAMES} frames: device {profile['frame_device_us']} us a frame; " + ", ".join(
              f"{k} {row['us']:.4f} us ({row['events']} events = launches), spin-queued "
              f"{queued_us(timing, k)}" for k, row in profile["kernel_events"].items())
          + f"; other device {profile['other_device_us']} us: " + "; ".join(
              f"{o['us']} us {o['op'][:40]}" for o in profile["top_other_ops"]))
    return {"frame_err": err, "host_ms_cprofile": host, "frames_per_s": fps,
            "frame_profile": profile,
            "frame_ms_median": frame_med, "frame_ms_p95": frame_p95,
            "frame_device_ms": frame_device,
            "ticks_per_s": tps, "tick_ms_median": tick_med, "tick_ms_p95": tick_p95,
            "tick_device_ms": tick_device,
            "launches": {k: frame_launches[k] for k in RENDER_KERNELS},
            "tick_launches": tick_launches, "kernels": timing}


def small_canvas_phase(torch, check, cfgs, gpu: str, device, errors: dict) -> dict:
    """Phase 6b, the display's direct form on the entry points. The server
    at its CLI defaults ticks at its 640x360, then takes a small browser
    window's canvas (reconfigure, as the page's POST /config) and ticks
    SMALL_TICKS times with pointer events, launch counts zeroed just before
    and read just after (the step's 6, 1 bloom_pyramid, the sunrays' 2 and 1
    display_direct a tick, no staged display); its frame against the plain render. The app
    at --canvas 256x256 with its default dye, counts zeroed before and read
    after (1 display_direct a frame). Then the direct form's device time on
    the server's state beside its bound and its plain version's, and both
    forms at the demo and 1024x1024, where the wrapper picks the staged one:
    each bit-equal to the plain version, spin-queued side by side."""
    import shutil

    from tpufluid_torch import init_state
    from tpufluid_torch.app import build_argparser as app_argparser
    from tpufluid_torch.ops.cuda import build, display
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate
    from tpufluid_torch.render import plain_render, render_frame
    from tpufluid_torch.server import MAX_DT, FluidServer, build_argparser, config_from_args

    res, cw, ch, _ = check.DIRECT_GEOMETRIES[SMALL_SERVER_CANVAS]
    cfg = config_from_args(build_argparser().parse_args([]))
    assert cfg.DYE_RESOLUTION == res, (cfg.DYE_RESOLUTION, res)
    srv = FluidServer(cfg, seed=0, device=device)
    srv.state = init_state(cfg, device=device)
    srv.handle_events([{"k": "burst"}])
    for _ in range(5):
        srv.advance(MAX_DT)
    srv.reconfigure({"CANVAS_WIDTH": cw, "CANVAS_HEIGHT": ch})
    small = srv.config
    srv.tracer.feed("down", pid=1, x=40.0, y=40.0)
    build.reset_launches()
    for k in range(SMALL_TICKS):
        srv.tracer.feed("move", pid=1, x=40.0 + 6 * k, y=40.0 + 2 * k)
        frame = srv.advance(MAX_DT)
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    per_tick = {**expected_per_step(small), "bloom_pyramid": 1, "sunrays": 1, "sunrays_blur": 1,
                "display_direct": 1}
    want = {k: n * SMALL_TICKS for k, n in per_tick.items() if n}
    assert launches == want, (launches, want)
    assert frame.shape == (ch, cw, 3) and frame.dtype == np.uint8, frame.shape
    state = srv.state
    err, tol = check.compare(render_frame(state, small), plain_render(state, small))
    assert err <= tol, f"small-canvas frame vs plain render: {err} > {tol}"
    assert bool(torch.isfinite(state.dye).all()) and float(state.dye.max()) > 0.0
    cases = check.render_cases(state, small) + check.sunrays_cases(state, small)
    check_cases(torch, check, SMALL_SERVER_CANVAS, cases, errors, exact=True)
    print(f"small canvas server {small.SIM_RESOLUTION}/{small.DYE_RESOLUTION} "
          f"{cw}x{ch} (from 640x360) on {gpu}: {SMALL_TICKS} ticks, launches {launches}; "
          f"frame vs plain render max abs err {err:.3e} tol {tol:.3e}")

    ares, acw, ach, _ = check.DIRECT_GEOMETRIES[SMALL_APP_CANVAS]
    assert app_argparser().parse_args([]).dye_res == ares
    out = Path("out/chip_smoke_small_canvas")
    shutil.rmtree(out, ignore_errors=True)
    build.reset_launches()
    line = app_run(["--canvas", f"{acw}x{ach}", "--steps", str(SMALL_APP_STEPS),
                    "--render-every", str(SMALL_APP_RENDER_EVERY), "--metrics-every", "0",
                    "--out", str(out)])
    app_launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    frames = SMALL_APP_STEPS // SMALL_APP_RENDER_EVERY
    want = {k: n * SMALL_APP_STEPS for k, n in expected_per_step(cfgs["demo_float32"]).items()
            if n}
    want.update(bloom_pyramid=frames, sunrays=frames, sunrays_blur=frames, display_direct=frames)
    assert app_launches == want, (app_launches, want)
    assert len(sorted(out.glob("frame_*.png"))) == frames
    print(f"small canvas app --canvas {acw}x{ach} on {gpu}: {line}; launches {app_launches}")

    timing = timing_phase(torch, check, cases)
    rate = spin_rate()
    forms = {}
    for name in ("demo_float32", "1024_bfloat16_rgb9e5"):
        big, _ = check.random_state(cfgs[name], seed=12, device=device)
        case = check.render_cases(big, cfgs[name])[-1]
        assert case.kernel_name == "display", (name, case.kernel_name)
        plain = case.run(plain=True)
        assert torch.equal(display.display(*case.args, force="direct"), plain), name
        assert torch.equal(case.run(), plain), name
        row = {}
        for form in ("staged", "direct", "direct", "staged"):
            ms = queued_ms(lambda: display.display(*case.args, force=form), 20, rate)
            row.setdefault(form, []).append(ms)
        forms[name] = {f: sum(v) / len(v) for f, v in row.items()}
        print(f"time   display forms at {name} on {gpu}: staged {forms[name]['staged']:.4f} ms, "
              f"direct {forms[name]['direct']:.4f} ms (the wrapper picks staged; "
              f"each the mean of two, in turns)")
    return {"launches": launches, "app_launches": app_launches, "app_line": line,
            "frame_err": err, "frame_tol": tol, "kernels": timing, "forms": forms}


HOST_FUNCS = {  # (module file, function) -> label, for the host profile
    ("step.py", "_step"): "step (all)",
    ("splat.py", "splat_factors"): "splat_factors x2",
    ("stencil.py", "pre_pressure"): "pre_pressure",
    ("jacobi.py", "jacobi_project"): "jacobi_project",
    ("advect.py", "advect"): "advect x2",
    ("build.py", "__call__"): "Kernel.__call__ (ctypes)",
}


RENDER_HOST_FUNCS = {  # the same, for the render profile
    ("render.py", "_render"): "render (all)",
    ("sunrays.py", "sunrays"): "sunrays wrapper (2 launches)",
    ("sampling.py", "sample_affine"): "sample_affine (all callers)",
    ("bloom.py", "bloom_chain"): "bloom_chain (resample + 1 launch)",
    ("display.py", "display"): "display wrapper",
    ("display.py", "blend_premultiplied"): "blend_premultiplied",
    ("build.py", "__call__"): "Kernel.__call__ (ctypes)",
}


def host_profile(torch, fn, n: int, funcs: dict, what: str) -> dict:
    """Host ms per call of fn's Python layers named in ``funcs``, over n
    calls under cProfile (which inflates every Python call; read the
    shares, not the sums)."""
    import cProfile
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    out = {}
    for (path, _, name), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        label = funcs.get((Path(path).name, name))
        if label and "tpufluid_torch" in path:
            out[label] = out.get(label, 0.0) + 1e3 * cum / n
    print(f"host ms per {what} under cProfile: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(out.items(), key=lambda kv: -kv[1])))
    return out


def host_phase(torch, cfg, run, steps: int = 50) -> dict:
    """Host time per step of the step's Python layers, under cProfile."""
    from tpufluid_torch import make_step

    step = make_step(cfg)
    box = [run["state"]]

    def one():
        box[0] = step(box[0], 1.0 / 60.0, run["splats"])

    return host_profile(torch, one, steps, HOST_FUNCS, "step")


def floors_kernel_phase(torch, check, device, errors: dict) -> None:
    """The floors kernels against their plain versions at the default and
    the ragged shapes, each bit-equal; adds each max abs error to
    ``errors``."""
    from tpufluid_torch.ops.cuda import build

    for ragged in (False, True):
        for case in check.floors_cases(device, ragged) + check.random_floors_cases(device, ragged):
            before = build.KERNELS[case.kernel_name].launches
            err, _ = check.compare(case.run(), case.run(plain=True))
            torch.cuda.synchronize()
            print(f"kernel floors {case.label:20s} max_abs_err {err:.3e}  tol {0.0:.3e}")
            assert err == 0.0, f"{case.label}: {err} != 0"
            assert build.KERNELS[case.kernel_name].launches > before, case.label
            key = ("floors", case.kernel_name)
            errors[key] = max(errors.get(key, 0.0), err)


def floors_phase(torch, check, cfg, run, step_timing: dict, gpu: str, device) -> dict:
    """The profiling path on the path's final state: bandwidth, reference
    rates, the profiled step and the floor report, with the floors kernels'
    launches counted; then their timing."""
    from tpufluid_torch.ops.cuda import build, floors

    planes, nrk, cbw, trips = check.ROLL_DEFAULT
    build.reset_launches()
    bw = floors.measure_hbm_bandwidth_gbps()
    # floor_report profiles the step and measures the gather and sweep
    # rates; the roll rate, which it does not use, is measured apart.
    report = floors.floor_report(cfg, run["state"], 1.0 / 60.0, bw, run["steps_per_s"])
    rolls = floors.measure_roll_rate(planes, nrk, cbw, trips)
    launches = {k: build.KERNELS[k].launches for k in FLOORS_KERNELS}
    for k, n in launches.items():
        assert n > 0, f"{k} did not launch on the profiling path"
    print(f"floors rates on {gpu}: memory {bw} GB/s; gather "
          f"{report['velocity_gather']['reference_rows_per_us']} rows/us; roll ({planes}, "
          f"{nrk}, {cbw}) {rolls} rolls/s; sweep "
          f"{report['jacobi']['reference_gcells_per_s']} Gcell-sweeps/s")
    other = report["other"]
    print(f"profile {FLOORS_CONFIG} on {gpu}, torch.profiler over {PROFILE_STEPS} steps, "
          "each kernel's device time a step beside the spin-queued time of phase 4:")
    for name, row in other["kernel_events"].items():
        print(f"profile {name:20s} {row['events'] // PROFILE_STEPS:3d} a step "
              f"({row['events']} events = launches)  profiler {row['us']:.4f} us  "
              f"spin-queued {1e3 * step_timing[name]['ms']:.4f} us")
    print(f"profile other device {other['other_device_us']} us a step, CUDA runtime calls "
          f"on the host {other['cuda_runtime_host_us']} us; top other: "
          + "; ".join(f"{o['us']} us {o['op'][:60]}" for o in other["top_other_ops"]))
    print("floors " + json.dumps({"gpu": gpu, **report}))
    print(f"floors launches {launches}")
    kernels = timing_phase(torch, check, check.floors_cases(device))
    scaling = floors_scaling(torch, check, gpu, device)
    mhz, max_mhz = sm_clock_mhz(torch)
    sms = build.sm_count(device)
    chunks, sweeps, h, w = check.SWEEP_DEFAULT
    barriers = floors.sweep_plan(h, w, chunks * sweeps, sms).barriers
    roll_r = floors.roll_plan(*check.ROLL_DEFAULT, sms).r
    for name, row in kernels.items():
        # SM clocks of the kernel's work: the sweep's float32 operations;
        # the gather's shared-memory words, one an add; the roll's int32
        # adds and its shared-memory words, one for every R adds.
        flops = row["flops"]
        clocks = {"floor_sweep": flops / F32_LANES_PER_SM, "floor_taa": flops / SMEM_WORDS_PER_SM,
                  "floor_roll": flops / INT32_LANES_PER_SM
                  + flops / roll_r / SMEM_WORDS_PER_SM}[name]
        sm_floor = clocks / (sms * mhz * 1e6) * 1e3 if mhz else None
        row.update(sm_floor_ms=sm_floor, sm_clock_mhz=mhz, was_ms=FLOORS_EARLIER_MS[name])
        note = "not reckoned (no SM clock read)" if sm_floor is None else (
            f"{sm_floor:.4f} ms at {mhz} MHz ({sms} SMs x "
            + {"floor_sweep": f"{F32_LANES_PER_SM} float32 lanes, no fused multiply-add) + "
                              f"{barriers} grid barriers",
               "floor_taa": f"{SMEM_WORDS_PER_SM} shared-memory words a clock)",
               "floor_roll": f"{INT32_LANES_PER_SM} int32 lanes, + a shared-memory word for "
                             f"{roll_r} adds at {SMEM_WORDS_PER_SM} a clock)"}[name])
        print(f"floors {name:11s} {row['ms']:.4f} ms on {gpu} (was {FLOORS_EARLIER_MS[name]} ms, "
              f"PERF.md §6; {FLOORS_EARLIER_MS[name] / row['ms']:.2f}x); bound "
              f"{row['bound_ms']:.4f} ms ({row['by']}); SM-level floor {note}; plain "
              f"{row['plain_ms']:.4f} ms; clocks.max.sm {max_mhz} MHz")
    return {"device_bw_gbps": bw, "rolls_per_s": rolls, "report": report,
            "launches": launches, "kernels": kernels, "scaling": scaling,
            "sm_clock_mhz": mhz, "sm_clock_max_mhz": max_mhz, "sweep_grid_barriers": barriers}


def sm_clock_mhz(torch) -> tuple:
    """(clocks.sm, clocks.max.sm) in MHz as nvidia-smi reads them while a
    spin kernel keeps the card busy (idle, the clock drops); None where it
    reads none."""
    from tpufluid_torch.ops.cuda.floors import spin_rate

    torch.cuda._sleep(int(spin_rate() * 1500))
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    torch.cuda.synchronize()
    try:
        mhz, max_mhz = (float(v) for v in out[0].split(","))
    except (IndexError, ValueError):
        return None, None
    return mhz, max_mhz


def floors_scaling(torch, check, gpu: str, device) -> dict:
    """floor_taa at twice the trips and floor_sweep at twice the chunks,
    spin-queued beside their defaults in turns (default, double, double,
    default, default, double): a kernel that skipped or folded work would
    not take about twice as long. Asserts each ratio within FLOORS_SCALING.
    floor_roll runs a few microseconds over its fixed cost, so its time is
    taken at ROLL_TRIPS (256, 512, 1024 trips, in turns up, down and up):
    growing linearly, the time added from 512 to 1024 trips is twice that
    from 256 to 512, and the ratio of the two is held within FLOORS_SCALING
    too. Each size's time is the least of its three runs: a host that falls
    behind the queue only adds time to a run, and the least run is the
    kernel's."""
    from tpufluid_torch.ops import floors as plain
    from tpufluid_torch.ops.cuda import floors
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate

    rate = spin_rate()

    def least(run, order) -> dict:
        ms = {n: [] for n in order}
        for n in order:
            ms[n].append(queued_ms(lambda: run(n), 20, rate))
        return {n: min(v) for n, v in ms.items()}, ms

    planes, n_idx, reps, trips = check.TAA_DEFAULT
    chunks, sweeps, h, w = check.SWEEP_DEFAULT
    seed, idx, op = plain.taa_inputs(planes, n_idx, reps, device)
    field, x = plain.sweep_inputs(h, w, device)
    runs = {"floor_taa": (f"trips {trips} -> {2 * trips}",
                          lambda n: floors.taa(seed, idx, op, n * trips, reps)),
            "floor_sweep": (f"chunks {chunks} -> {2 * chunks}",
                            lambda n: floors.sweep(field, x, n * chunks, sweeps))}
    out = {}
    for name, (what, run) in runs.items():
        t, ms = least(run, (1, 2, 2, 1, 1, 2))
        ratio = t[2] / t[1]
        print(f"floors scaling {name:11s} {what}: {t[1]:.4f} -> {t[2]:.4f} ms (least of "
              f"{len(ms[1])} runs each), ratio {ratio:.3f} (held to {FLOORS_SCALING[0]}-"
              f"{FLOORS_SCALING[1]}) on {gpu}")
        assert FLOORS_SCALING[0] <= ratio <= FLOORS_SCALING[1], (name, ratio, ms)
        out[name] = {"ms": t[1], "double_ms": t[2], "ratio": ratio, "runs": ms}
    rseed, rop = plain.roll_inputs(*check.ROLL_DEFAULT[:3], device)
    t, ms = least(lambda n: floors.roll(rseed, rop, n),
                  ROLL_TRIPS + ROLL_TRIPS[::-1] + ROLL_TRIPS)
    t = [t[n] for n in ROLL_TRIPS]
    ratio = (t[2] - t[1]) / (t[1] - t[0])
    print(f"floors scaling floor_roll  trips {' -> '.join(map(str, ROLL_TRIPS))}: "
          + " -> ".join(f"{v:.4f}" for v in t) + f" ms (least of 3 runs each); added time "
          f"{t[1] - t[0]:.4f} -> {t[2] - t[1]:.4f} ms, ratio {ratio:.3f} (linear: 2; held to "
          f"{FLOORS_SCALING[0]}-{FLOORS_SCALING[1]}) on {gpu}")
    assert FLOORS_SCALING[0] <= ratio <= FLOORS_SCALING[1], ("floor_roll", ratio, ms)
    out["floor_roll"] = {"trips": list(ROLL_TRIPS), "ms": t, "ratio": ratio, "runs": ms}
    return out


def long_horizon_phase(torch, check, gpu: str, device, errors: dict) -> dict:
    """The long-horizon tool at 4096x4096 bf16 through the kernels, its
    launches and its ok; then the step's kernels at that config on a random
    state: each against its plain version (adding to ``errors``), their
    timing, and the profiled step."""
    from tpufluid_torch import FluidConfig
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.tools import long_horizon

    LONG_HORIZON_OUT.mkdir(parents=True, exist_ok=True)
    build.reset_launches()
    with open(LONG_HORIZON_OUT / "stdout.txt", "w") as log, contextlib.redirect_stdout(log):
        summary = long_horizon.main(LONG_HORIZON_ARGS)
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    cfg = FluidConfig(SIM_RESOLUTION=4096, DYE_RESOLUTION=4096, CANVAS_WIDTH=4096,
                      CANVAS_HEIGHT=4096, DTYPE="bfloat16", MAX_SPLATS=8).validate()
    assert launches == {k: n * LONG_HORIZON_STEPS for k, n in expected_per_step(cfg).items()}, \
        launches
    assert summary["ok"] and summary["nonfinite_total"] == 0, summary
    print(f"long horizon ok: 4096x4096 bfloat16 (RGB9E5) on {gpu}, {LONG_HORIZON_STEPS} "
          f"steps: {summary['steps_per_s_compute_median']} steps/s (median chunk), "
          f"{summary['steps_per_s']} steps/s wall; nonfinite {summary['nonfinite_total']}, "
          f"backtrace peak {summary['backtrace_speed_peak']} <= "
          f"{summary['halo_contract_speed']}, energy decay {summary['energy_decay_ratio']}, "
          f"max uptick {summary['energy_max_uptick_frac']}; launches {launches}")

    name = "4096_bfloat16_rgb9e5"
    state, splats = check.random_state(cfg, seed=7, device=device)
    cases = check.step_cases(state, splats, cfg)
    check_cases(torch, check, name, cases, errors)
    timing = timing_phase(torch, check, cases)
    print_pair(name, timing, gpu)
    _, other = floors.profile_step_kernels(cfg, state, 1.0 / 60.0, PROFILE_STEPS)
    print(f"profile {name} on {gpu}, torch.profiler over {PROFILE_STEPS} steps from a random "
          f"state, each kernel's device time a step beside its spin-queued time:")
    for k, row in other["kernel_events"].items():
        print(f"profile {k:20s} {row['events'] // PROFILE_STEPS:3d} a step "
              f"({row['events']} events = launches)  profiler {row['us']:.4f} us  "
              f"spin-queued {1e3 * timing[k]['ms']:.4f} us")
    print(f"profile other device {other['other_device_us']} us a step, CUDA runtime calls "
          f"on the host {other['cuda_runtime_host_us']} us; top other: "
          + "; ".join(f"{o['us']} us {o['op'][:60]}" for o in other["top_other_ops"]))
    return {"summary": summary, "launches": launches, "kernels": timing, "profile": other}


def batch_config(res: int):
    from tpufluid_torch import FluidConfig

    return FluidConfig(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res,
                       CANVAS_HEIGHT=res, PRESSURE_ITERATIONS=20, MAX_SPLATS=8,
                       DTYPE="bfloat16", DYE_RGB9E5=True).validate()


def batch_rates(torch, cfg, batch: int, seq, dts, device) -> dict:
    """make_batched_multi_step: BATCH_WARM warm-up steps, then BATCH_TIMED
    timed in one call (aggregate sim-steps/s); then BATCH_TIMED
    make_batched_step calls, one a step, for the median and p95 step."""
    from tpufluid_torch import init_batch, make_batched_multi_step, make_batched_step
    from tpufluid_torch.tools.render_rate import call_times

    multi = make_batched_multi_step(cfg, device=device)
    end = BATCH_WARM + BATCH_TIMED
    per_sim = np.ndim(dts) == 2
    state = multi(init_batch(cfg, batch, device=device),
                  dts[:BATCH_WARM] if per_sim else dts, seq[:BATCH_WARM])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = multi(state, dts[BATCH_WARM:end] if per_sim else dts, seq[BATCH_WARM:end])
    torch.cuda.synchronize()
    rate = batch * BATCH_TIMED / (time.perf_counter() - t0)
    step = make_batched_step(cfg, device=device)
    box = [state]

    def one(k):
        box[0] = step(box[0], dts[BATCH_WARM + k] if per_sim else dts, seq[BATCH_WARM + k])

    steps_per_s, median, p95 = call_times(one, BATCH_TIMED)
    v = box[0].velocity.float()
    assert bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0.0, "batched run broke"
    return {"sim_steps_per_s": rate, "steps_per_s": steps_per_s,
            "sim_steps_per_s_stepped": batch * steps_per_s,
            "step_ms_median": median, "step_ms_p95": p95}


def single_rate(torch, cfg, seq, device) -> dict:
    """make_step at ``cfg`` over sim 0's trace: BATCH_WARM warm-up steps in
    make_multi_step, BATCH_TIMED timed make_step calls."""
    from tpufluid_torch import init_state, make_multi_step, make_step
    from tpufluid_torch.tools.render_rate import call_times

    state = make_multi_step(cfg, device=device)(init_state(cfg, device=device), 1.0 / 60.0,
                                                seq[:BATCH_WARM, 0])
    step = make_step(cfg, device=device)
    box = [state]

    def one(k):
        box[0] = step(box[0], 1.0 / 60.0, seq[BATCH_WARM + k, 0])

    steps_per_s, median, p95 = call_times(one, BATCH_TIMED)
    return {"steps_per_s": steps_per_s, "step_ms_median": median, "step_ms_p95": p95}


def batched_phase(torch, check, cfgs, gpu: str, device, errors: dict) -> dict:
    """The batched serving mode at BATCH_CONFIGS: kernel comparisons (and
    the demo's cross grid), launches and per-sim equality after 3 steps,
    rates lock-step and per sim, kernel timing beside single-sim x B, the
    profiled batched step, and B = 1 beside make_step."""
    from tpufluid_torch import init_batch, init_state, make_batched_multi_step, make_step
    from tpufluid_torch import swirl_trace, unstack_state
    from tpufluid_torch.batch import plain_batched_step
    from tpufluid_torch.ops.cuda import build, floors

    for name in ("demo_float32", "demo_bfloat16_rgb9e5"):
        check_cases(torch, check, name, check.batched_step_cases(
            cfgs[name], CROSS_GRID_BATCH, seed=7, device=device), errors, exact=True)
    out = {}
    for name, (res, batch) in BATCH_CONFIGS.items():
        cfg = batch_config(res)
        check_cases(torch, check, name, check.batched_step_cases(cfg, batch, seed=7,
                                                                 device=device), errors,
                    exact=True)
        steps = BATCH_WARM + BATCH_TIMED
        seq = torch.as_tensor(np.stack([swirl_trace(cfg, steps, seed=42 + i).batches
                                        for i in range(batch)], axis=1), device=device)
        dts = np.broadcast_to(check.per_sim_dts(batch), (steps, batch))

        build.reset_launches()
        state = make_batched_multi_step(cfg, device=device)(
            init_batch(cfg, batch, device=device), dts[:CHECK_STEPS], seq[:CHECK_STEPS])
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        want = {k: n * CHECK_STEPS for k, n in expected_per_step(cfg).items()}
        assert launches == want, (name, launches, want)
        plain = init_batch(cfg, batch, device=device)
        for t in range(CHECK_STEPS):
            plain = plain_batched_step(plain, dts[t], seq[t], cfg)
        step = make_step(cfg, device=device)
        for i in range(batch):
            one = init_state(cfg, device=device)
            for t in range(CHECK_STEPS):
                one = step(one, dts[t, i], seq[t, i])
            for f in ("velocity", "dye", "pressure"):
                got = getattr(unstack_state(state, i), f)
                assert torch.equal(got, getattr(one, f)), (name, i, f, "vs make_step")
                assert torch.equal(got, getattr(unstack_state(plain, i), f)), (name, i, f)
        print(f"batched {name}: {batch} sims of {res}x{res} bf16, {CHECK_STEPS} steps, per-sim "
              f"dt: every sim equal to make_step on it alone and to the plain batched step "
              f"(max abs err 0); launches {launches} ({sum(launches.values()) // CHECK_STEPS} "
              "a batched step)")

        lock = batch_rates(torch, cfg, batch, seq, 1.0 / 60.0, device)
        per = batch_rates(torch, cfg, batch, seq, dts, device)
        state0, splats0 = check.random_batch(cfg, batch, seed=7, device=device)
        cases = check.step_cases(state0, splats0, cfg, check.per_sim_dts(batch), ":batched")
        timing = timing_phase(torch, check, cases)
        # Each sim's kernels launched on it alone, summed over the B sims.
        single = {}
        for i in range(batch):
            sim = unstack_state(state0, i)
            dt = float(check.per_sim_dts(batch)[i])
            for k, row in timing_phase(torch, check, check.step_cases(sim, splats0[i], cfg, dt),
                                       False).items():
                single[k] = single.get(k, 0.0) + row["ms"]
        device_ms = step_device_ms(timing)
        print_pair(f"{name} (batched)", timing, gpu)
        kt, other = floors.profile_step_kernels(cfg, state0, check.per_sim_dts(batch),
                                                PROFILE_STEPS)
        prof_us = sum(r["us"] for r in other["kernel_events"].values())
        for k, row in other["kernel_events"].items():
            assert row["events"] == expected_per_step(cfg)[k] * PROFILE_STEPS, (k, row)
        b1 = batch_rates(torch, cfg, 1, seq[:, :1], 1.0 / 60.0, device)
        alone = single_rate(torch, cfg, seq, device)
        for form, r in (("lock-step", lock), ("per-sim", per)):
            print(f"batched {name} {form} on {gpu}: {r['sim_steps_per_s']:.1f} sim-steps/s "
                  f"(make_batched_multi_step, {BATCH_TIMED} steps in one call); stepped "
                  f"{r['sim_steps_per_s_stepped']:.1f} sim-steps/s, step median "
                  f"{r['step_ms_median']:.4f} ms, p95 {r['step_ms_p95']:.4f} ms")
        print(f"batched {name}: kernels' device {device_ms:.4f} ms a batched step (spin-queued), "
              f"{100 * (1 - device_ms / per['step_ms_median']):.1f}% idle at the per-sim median; "
              f"profiler {prof_us:.1f} us of kernels + {other['other_device_us']} us other a "
              f"batched step over {PROFILE_STEPS} steps; " + ", ".join(
                  f"{k} {row['events'] // PROFILE_STEPS} launches {row['us']:.2f} us"
                  for k, row in other["kernel_events"].items()))
        for k, row in timing.items():
            print(f"batched {name} {k:18s} spin-queued {row['ms']:.4f} ms for {batch} sims, "
                  f"single-sim launches on each sim summed {single[k]:.4f} ms "
                  f"({single[k] / batch:.4f} ms x {batch}); bound {row['bound_ms']:.4f} "
                  f"ms ({row['by']}), plain {row['plain_ms']:.4f} ms")
        print(f"batched {name} B=1 lock-step: {b1['sim_steps_per_s']:.1f} sim-steps/s "
              f"(make_batched_multi_step), step median {b1['step_ms_median']:.4f} ms, p95 "
              f"{b1['step_ms_p95']:.4f} ms; make_step {alone['steps_per_s']:.1f} steps/s, "
              f"median {alone['step_ms_median']:.4f} ms, p95 {alone['step_ms_p95']:.4f} ms")
        out[name] = {"batch": batch, "res": res, "launches": launches, "lockstep": lock,
                     "per_sim": per, "kernel_device_ms": device_ms,
                     "kernels": timing, "single_sim_kernels": single,
                     "profile": {"kernel_times_us": kt, **other}, "b1": b1, "make_step": alone}
    return out


def batched_frame_phase(torch, check, cfgs, gpu: str, device, errors: dict) -> dict:
    """The batched frame and tick (phase 11) at the demo's cross grid with
    B = 4 and at BATCH_CONFIGS: kernel comparisons, launches, per-sim
    equality, rates, kernel timing beside single-sim x B, B = 1 beside
    make_render, and the profiled batched frame."""
    from tpufluid_torch import (init_batch, make_batched_multi_step, make_batched_render,
                                make_batched_tick, make_render, make_step_and_render,
                                stack_states, swirl_trace, unstack_state)
    from tpufluid_torch.batch import plain_batched_render
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate
    from tpufluid_torch.tools.render_rate import call_times

    cells = {"demo_float32:b4": (cfgs["demo_float32"], CROSS_GRID_BATCH)}
    cells.update({name: (batch_config(res), b) for name, (res, b) in BATCH_CONFIGS.items()})
    rate = spin_rate()
    out = {}
    for name, (cfg, batch) in cells.items():
        state0, _ = check.random_batch(cfg, batch, seed=7, device=device)
        check_cases(torch, check, name, check.batched_render_cases(state0, cfg)
                    + check.sunrays_cases(state0, cfg, f":b{batch}"), errors, exact=True)
        steps = BATCH_FRAME_WARM + CHECK_STEPS + BATCH_TIMED
        seq = torch.as_tensor(np.stack([swirl_trace(cfg, steps, seed=42 + i).batches
                                        for i in range(batch)], axis=1), device=device)
        dts = check.per_sim_dts(batch)
        state = make_batched_multi_step(cfg, device=device)(
            init_batch(cfg, batch, device=device),
            np.broadcast_to(dts, (BATCH_FRAME_WARM, batch)), seq[:BATCH_FRAME_WARM])

        render = make_batched_render(cfg, device=device)
        build.reset_launches()
        frames = render(state)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        assert launches == PER_FRAME, (name, launches)
        assert frames.shape == (batch, 4, cfg.CANVAS_HEIGHT, cfg.CANVAS_WIDTH), frames.shape
        assert bool(torch.isfinite(frames).all()), "non-finite batched frame"
        assert torch.equal(frames, plain_batched_render(state, cfg)), (name, "vs plain")
        single = make_render(cfg, device=device)
        for i in range(batch):
            assert torch.equal(frames[i], single(unstack_state(state, i))), (name, i)

        tick, one = make_batched_tick(cfg, device=device), make_step_and_render(cfg, device=device)
        sims = [unstack_state(state, i) for i in range(batch)]
        box = [state]
        tick_launches = {}
        for t in range(CHECK_STEPS):
            k = BATCH_FRAME_WARM + t
            build.reset_launches()
            box[0], pixels = tick(box[0], dts, seq[k])
            for kernel, v in build.KERNELS.items():   # the batched tick's alone
                if v.launches:
                    tick_launches[kernel] = tick_launches.get(kernel, 0) + v.launches
            for i in range(batch):
                sims[i], want = one(sims[i], dts[i], seq[k, i])
                assert torch.equal(pixels[i], want), (name, t, i, "pixels")
                for f in ("velocity", "dye", "pressure"):
                    assert torch.equal(getattr(unstack_state(box[0], i), f),
                                       getattr(sims[i], f)), (name, t, i, f)
        want = {**expected_per_step(cfg), **PER_FRAME}
        assert tick_launches == {k: n * CHECK_STEPS for k, n in want.items()}, tick_launches
        print(f"batched frame {name}: {batch} sims, dye {tuple(state.dye.shape[-2:])} "
              f"{cfg.DTYPE} -> {cfg.CANVAS_HEIGHT}x{cfg.CANVAS_WIDTH}: the frame equal to the "
              f"plain batched render and each sim to make_render on it alone (max abs err 0), "
              f"launches {launches} a batched frame; {CHECK_STEPS} make_batched_tick ticks, "
              f"per-sim dt: every sim's state and uint8 frame equal to make_step_and_render's; launches "
              f"{tick_launches} ({sum(tick_launches.values()) // CHECK_STEPS} a batched tick)")

        build.reset_launches()
        fps, frame_med, frame_p95 = call_times(lambda k: render(box[0]), BATCH_TIMED)
        frame_launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        assert frame_launches == {k: n * BATCH_TIMED for k, n in PER_FRAME.items()}, \
            frame_launches
        start = BATCH_FRAME_WARM + CHECK_STEPS

        # The timed ticks, and the device time their idle share is taken
        # against, run at the server's one clock (the lock-step dt): a
        # per-sim dt table is copied from the host, which behind the spin
        # kernel would wait for the spin.
        def one_tick(k):
            box[0], _ = tick(box[0], 1.0 / 60.0, seq[start + k])

        build.reset_launches()
        tps, tick_med, tick_p95 = call_times(one_tick, BATCH_TIMED)
        tick_timed = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        assert tick_timed == {k: n * BATCH_TIMED for k, n in want.items()}, tick_timed
        assert bool(torch.isfinite(box[0].velocity.float()).all()), "batched ticks broke"
        frame_device = queued_ms(lambda: render(box[0]), 1, rate)
        tick_device = queued_ms(lambda: tick(box[0], 1.0 / 60.0, seq[start]), 1, rate)

        cases = (check.batched_render_cases(box[0], cfg)
                 + check.sunrays_cases(box[0], cfg, f":b{batch}"))
        timing = timing_phase(torch, check, cases)
        alone = {}
        for i in range(batch):
            sim = unstack_state(box[0], i)
            for k, row in timing_phase(torch, check, check.render_cases(sim, cfg)
                                       + check.sunrays_cases(sim, cfg), False).items():
                alone[k] = alone.get(k, 0.0) + row["ms"]
        b1_state = stack_states([unstack_state(box[0], 0)])
        b1 = call_times(lambda k: render(b1_state), BATCH_TIMED)
        alone1 = call_times(lambda k: single(unstack_state(box[0], 0)), BATCH_TIMED)
        profile = floors.profile_frame_kernels(cfg, box[0], PROFILE_FRAMES)
        for k, row in profile["kernel_events"].items():
            assert row["events"] == PER_FRAME[k] * PROFILE_FRAMES, (k, row)

        print(f"batched frame {name} on {gpu}: {batch * fps:.1f} sim-frames/s ({batch} x "
              f"{fps:.1f} batched frames/s over {BATCH_TIMED}), frame median {frame_med:.4f} ms, "
              f"p95 {frame_p95:.4f} ms, device {frame_device:.4f} ms a batched frame "
              f"({100 * (1 - frame_device / frame_med):.1f}% idle at the median); "
              f"{batch * tps:.1f} sim-ticks/s lock-step, tick median {tick_med:.4f} ms, p95 "
              f"{tick_p95:.4f} ms, device {tick_device:.4f} ms a batched tick "
              f"({100 * (1 - tick_device / tick_med):.1f}% idle)")
        for k, row in timing.items():
            print(f"batched frame {name} {k:14s} spin-queued {row['ms']:.4f} ms for {batch} sims, "
                  f"single-sim launches on each sim summed {alone[k]:.4f} ms "
                  f"({alone[k] / batch:.4f} ms x {batch}); bound {row['bound_ms']:.4f} ms "
                  f"({row['by']}), plain {row['plain_ms']:.4f} ms")
        print(f"batched frame {name} B=1: {b1[0]:.1f} frames/s (make_batched_render), median "
              f"{b1[1]:.4f} ms, p95 {b1[2]:.4f} ms; make_render {alone1[0]:.1f} frames/s, median "
              f"{alone1[1]:.4f} ms, p95 {alone1[2]:.4f} ms")
        print(f"profile batched frame {name}, torch.profiler over {PROFILE_FRAMES} batched frames: "
              f"device {profile['frame_device_us']} us a batched frame; " + ", ".join(
                  f"{k} {row['us']:.4f} us ({row['events']} events = launches), spin-queued "
                  f"{queued_us(timing, k)}" for k, row in profile["kernel_events"].items())
              + f"; other device {profile['other_device_us']} us: " + "; ".join(
                  f"{o['us']} us {o['op'][:40]}" for o in profile["top_other_ops"]))
        out[name] = {"batch": batch, "launches": launches, "tick_launches": tick_launches,
                     "sim_frames_per_s": batch * fps, "frame_ms_median": frame_med,
                     "frame_ms_p95": frame_p95, "frame_device_ms": frame_device,
                     "sim_ticks_per_s": batch * tps, "tick_ms_median": tick_med,
                     "tick_ms_p95": tick_p95, "tick_device_ms": tick_device,
                     "kernels": timing, "single_sim_kernels": alone,
                     "b1": {"frames_per_s": b1[0], "frame_ms_median": b1[1],
                            "frame_ms_p95": b1[2]},
                     "make_render": {"frames_per_s": alone1[0], "frame_ms_median": alone1[1],
                                     "frame_ms_p95": alone1[2]},
                     "profile": profile}
    return out


def packed_phase(torch, check, gpu: str, device, errors: dict) -> dict:
    """Phase 13: the lane-packed fleet at PACKED_CONFIGS: kernel comparisons
    (f32 and bf16), launches and equality with the batched step and the
    plain packed step after 3 steps, sim-steps/s packed and batched, each
    packed kernel's time beside its batched form's, the idle share, the
    library yardstick and the profiled packed step."""
    from tpufluid_torch import init_batch, make_batched_multi_step, swirl_trace
    from tpufluid_torch.batch_packed import (init_packed, make_packed_multi_step,
                                             plain_packed_step, unpack_state)
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.ops.cuda.floors import spin_rate

    fields = ("velocity", "dye", "pressure")
    out = {}
    for name, (res, batch) in PACKED_CONFIGS.items():
        cfg = batch_config(res)
        f32 = dataclasses.replace(cfg, DTYPE="float32", DYE_RGB9E5=False).validate()
        for label, c in ((f"{name}:packed:float32", f32), (f"{name}:packed", cfg)):
            check_cases(torch, check, label, check.packed_step_cases(c, batch, seed=7,
                                                                     device=device),
                        errors, exact=True)
        seq = torch.as_tensor(np.stack([swirl_trace(cfg, CHECK_STEPS + PACKED_TIMED,
                                                    seed=42 + i).batches
                                        for i in range(batch)], axis=1), device=device)
        multi = make_packed_multi_step(cfg, batch, device=device)
        bmulti = make_batched_multi_step(cfg, device=device)

        # The main path: 3 packed steps, the launches counted.
        build.reset_launches()
        packed = multi(init_packed(cfg, batch, device=device), 1.0 / 60.0, seq[:CHECK_STEPS])
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        want = {k: n * CHECK_STEPS for k, n in expected_per_step(cfg).items()}
        assert launches == want, (name, launches, want)
        batched = bmulti(init_batch(cfg, batch, device=device), 1.0 / 60.0, seq[:CHECK_STEPS])
        plain = init_packed(cfg, batch, device=device)
        for t in range(CHECK_STEPS):
            plain = plain_packed_step(plain, 1.0 / 60.0, seq[t], cfg, batch)
        unpacked = unpack_state(packed, batch)
        vs_batched = max(float((getattr(unpacked, f).float() - getattr(batched, f).float())
                               .abs().max()) for f in fields)
        vs_plain = max(float((getattr(packed, f).float() - getattr(plain, f).float())
                             .abs().max()) for f in fields)
        print(f"packed {name}: {batch} sims of {res}x{res} bf16 (RGB9E5), {CHECK_STEPS} "
              f"make_packed_multi_step steps, lock-step 1/60: unpacked vs "
              f"make_batched_multi_step max abs err {vs_batched:.3e} (every field, every sim); "
              f"vs plain_packed_step {vs_plain:.3e}; launches {launches} "
              f"({sum(launches.values()) // CHECK_STEPS} a packed step)")
        assert vs_batched == 0.0 and vs_plain == 0.0, (name, vs_batched, vs_plain)
        del plain

        # Rates: batched, packed, packed, batched, 200 steps in one call each.
        def timed(fn, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = fn(state, 1.0 / 60.0, seq[CHECK_STEPS:])
            torch.cuda.synchronize()
            v = state.velocity.float()
            assert bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0.0, name
            return batch * PACKED_TIMED / (time.perf_counter() - t0)

        rates = {"batched": [], "packed": []}
        timed_launches = {}
        for kind in ("batched", "packed", "packed", "batched"):
            if kind == "batched":
                rates[kind].append(timed(bmulti, batched))
                continue
            build.reset_launches()
            rates[kind].append(timed(multi, packed))
            for k, v in build.KERNELS.items():
                if v.launches:
                    timed_launches[k] = timed_launches.get(k, 0) + v.launches
        assert timed_launches == {k: 2 * n * PACKED_TIMED
                                  for k, n in expected_per_step(cfg).items()}, timed_launches
        print(f"packed {name} on {gpu}: sim-steps/s over {PACKED_TIMED} steps in one call, "
              f"batched / packed / packed / batched: {rates['batched'][0]:.1f} / "
              f"{rates['packed'][0]:.1f} / {rates['packed'][1]:.1f} / "
              f"{rates['batched'][1]:.1f}; packed launches {timed_launches} over "
              f"{2 * PACKED_TIMED} steps")

        pcases = check.packed_step_cases(cfg, batch, 7, device)
        bcases = [c for c in check.batched_step_cases(cfg, batch, 7, device)
                  if c.label.endswith(":lockstep")]

        ptiming, btiming = (timing_phase(torch, check, c) for c in (pcases, bcases))
        lib_ms = check.grid_sample_ms(next(c for c in pcases if c.label.startswith("advect:dye")),
                                      spin_rate(), sim_w=res)
        ptiming["advect_dye"]["library_ms"] = lib_ms
        device_ms = step_device_ms(ptiming)
        print_pair(f"{name} (packed)", ptiming, gpu)
        print_pair(f"{name} (batched, the same sims)", btiming, gpu)
        step_ms = 1e3 * batch / (sum(rates["packed"]) / 2)
        idle = 1 - device_ms / step_ms
        kt, other = floors.profile_step_kernels(cfg, packed, 1.0 / 60.0, PROFILE_STEPS)
        for k, row in other["kernel_events"].items():
            assert row["events"] == expected_per_step(cfg)[k] * PROFILE_STEPS, (k, row)
        print(f"packed {name}: kernels' device {device_ms:.4f} ms a packed step (spin-queued), "
              f"step {step_ms:.4f} ms (one call's mean), {100 * idle:.1f}% idle; grid_sample "
              f"(library, the fleet's dye as a batch) {lib_ms:.4f} ms")
        for k, row in ptiming.items():
            prof = other["kernel_events"].get(k, {}).get("us")
            # the standalone gradient subtract: compared and timed, no launch on the step
            prof = "no launch on the step" if prof is None else f"{prof:.2f} us a step"
            print(f"packed {name} {k:18s} spin-queued {row['ms']:.4f} ms packed, "
                  f"{btiming[k]['ms']:.4f} ms batched ({row['ms'] / btiming[k]['ms']:.3f}x); "
                  f"bound {row['bound_ms']:.4f} ms ({row['by']}), plain {row['plain_ms']:.4f} "
                  f"ms; profiler {prof}")
        out[name] = {"batch": batch, "res": res, "launches": launches,
                     "timed_launches": timed_launches, "vs_batched_max_abs_err": vs_batched,
                     "vs_plain_max_abs_err": vs_plain, "sim_steps_per_s": rates,
                     "kernel_device_ms": device_ms, "step_ms": step_ms, "idle": idle,
                     "kernels": ptiming, "batched_kernels": btiming,
                     "profile": {"kernel_times_us": kt, **other}}
        del packed, batched, unpacked
        torch.cuda.empty_cache()
    return out


def sharded_mesh(shape):
    """A mesh of ``shape`` over the cards there are, round robin."""
    import torch
    from tpufluid_torch import make_mesh

    n = torch.cuda.device_count()
    return make_mesh(devices=[f"cuda:{k % n}" for k in range(shape[0] * shape[1])], shape=shape)


def sharded_launches(cfg, shape) -> dict:
    """Launches of each step kernel in one sharded step of ``cfg`` on a
    mesh of ``shape``: a step's on every shard, three times over in each
    phase that splits (an interior band and two strips)."""
    from tpufluid_torch.parallel import sharded_step as ss

    ny, nx = shape
    h = cfg.sim_size[1] // ny
    hd = cfg.dye_size[1] // ny

    def bands(ghost, extent):
        return 3 if cfg.overlap_halo and extent >= 3 * ghost else 1

    dye = bands(ss.dye_halo_width(cfg), hd)
    shard = {"pre_pressure": bands(ss._G_STENCIL, h),
             "jacobi_chunk": jacobi_launches(cfg) * bands(ss._G_JACOBI, h),
             "gradient_subtract": bands(ss._G_STENCIL, h),
             "advect": bands(ss._G_VEL, h), "advect_dye": dye}
    return {k: v * ny * nx for k, v in shard.items()}


def field_diff(torch, got, want) -> dict:
    """Per field of two states: the largest difference, the field's scale
    and the share of texels that differ."""
    out = {}
    for f in ("velocity", "dye", "pressure"):
        g, w = getattr(got, f).float(), getattr(want, f).float()
        assert g.shape == w.shape, (f, g.shape, w.shape)
        assert bool(torch.isfinite(g).all()), f"non-finite sharded {f}"
        out[f] = {"max_abs": float((g - w).abs().max()), "scale": float(w.abs().max()),
                  "share_differing": float((g != w).float().mean())}
    return out


def sharded_phase(torch, check, cfgs, gpu: str, device, errors: dict) -> dict:
    """Phase 12: the bounded pre_pressure, the sharded step's kernel passes
    against its plain passes (and, at sharded_16384_bf16_2x2, make_step's
    against plain_step), the sharded against the unsharded step, and the
    rates at sharded_16384_bf16_2x2, split and monolithic."""
    from tpufluid_torch import (init_state, make_multi_step, make_sharded_multi_step,
                                make_sharded_step, shard_state, swirl_trace)
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.ops.cuda import stencil as kstencil
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate
    from tpufluid_torch.ops.splat import SPLAT_DX, SPLAT_DY, splat_factors
    from tpufluid_torch.parallel import halo
    from tpufluid_torch.parallel import sharded_step as ss
    from tpufluid_torch.parallel.mesh import gather_state
    from tpufluid_torch.step import plain_step

    mesh = sharded_mesh(SHARDED_MESH)
    ghosts = (ss._G_STENCIL, ss._GC)   # pre_pressure's padded block
    print(f"sharded: {torch.cuda.device_count()} card(s); the meshes put their shards on them "
          f"round robin: the 2x2 mesh's on {[str(d) for r in mesh.devices for d in r]}")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        check_cases(torch, check, f"sharded_{str(dtype)[6:]}",
                    check.bounded_cases(device, dtype, ghosts, seed=7), errors, exact=True)
    bounded_err = max(v for (c, k), v in errors.items() if c.startswith("sharded_"))
    for name in ("demo_bfloat16_rgb9e5", "demo_bfloat16"):
        check_cases(torch, check, f"{name}:f32-velocity",
                    check.f32_velocity_dye_cases(cfgs[name], seed=7, device=device), errors,
                    exact=True)

    def fields(state):
        return tuple(getattr(state, f) for f in ("velocity", "dye", "pressure"))

    def kernels_vs_plain(name, cfg, shape):
        m = sharded_mesh(shape)
        trace = swirl_trace(cfg, CHECK_STEPS, seed=42)
        step = make_sharded_step(cfg, m)
        a = shard_state(init_state(cfg, device=device), m)
        b = shard_state(init_state(cfg, device=device), m)
        build.reset_launches()
        for t in range(CHECK_STEPS):
            a = step(a, trace.dts[t], trace.batches[t])
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        want = {k: n * CHECK_STEPS for k, n in sharded_launches(cfg, shape).items()}
        assert launches == want, (name, launches, want)
        for t in range(CHECK_STEPS):
            b = ss.plain_sharded_step(b, trace.dts[t], trace.batches[t], cfg)
        err, tol = check.compare(fields(gather_state(a)), fields(gather_state(b)))
        print(f"sharded {name} {shape[0]}x{shape[1]}: {CHECK_STEPS} make_sharded_step steps "
              f"through the kernels vs the plain passes: max_abs_err {err:.3e}  tol {tol:.3e}; "
              f"launches {launches}")
        assert err <= tol, (name, err, tol)
        return {"max_abs_err": err, "tol": tol, "launches": launches}

    out = {"bounded_max_abs_err": bounded_err, "vs_plain": {
        "demo_float32": kernels_vs_plain("demo_float32", cfgs["demo_float32"], (2, 2)),
        f"{SHARDED_CHECK_RES}_bfloat16_rgb9e5": kernels_vs_plain(
            f"{SHARDED_CHECK_RES}_bfloat16_rgb9e5", batch_config(SHARDED_CHECK_RES), (4, 1)),
        f"{SHARDED_CHECK_RES}_bfloat16_rgb9e5:overlap": kernels_vs_plain(
            f"{SHARDED_CHECK_RES}_bfloat16_rgb9e5:overlap",
            dataclasses.replace(batch_config(SHARDED_CHECK_RES), OVERLAP_HALO=True), (2, 2))}}

    def vs_unsharded(name, cfg, steps, bound, plain=False):
        """The sharded step against make_step; with ``plain``, make_step
        (launches counted) against plain_step as well."""
        trace = swirl_trace(cfg, steps, seed=42)
        build.reset_launches()
        one = make_multi_step(cfg, device=device)(init_state(cfg, device=device), trace.dts,
                                                  trace.batches)
        torch.cuda.synchronize()
        if plain:
            launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
            want = {k: n * steps for k, n in expected_per_step(cfg).items()}
            assert launches == want, (name, launches, want)
            ref = init_state(cfg, device=device)
            for t in range(steps):
                ref = plain_step(ref, trace.dts[t], trace.batches[t], cfg)
            err, tol = check.compare(fields(one), fields(ref))
            del ref
            out[f"unsharded_vs_plain:{name}"] = {"max_abs_err": err, "tol": tol,
                                                 "launches": launches}
            print(f"unsharded {name}: {steps} make_multi_step steps through the kernels vs "
                  f"plain_step: max_abs_err {err:.3e}  tol {tol:.3e}; launches {launches}")
            assert err <= tol, (name, err, tol)
        shards = make_sharded_multi_step(cfg, mesh)(
            shard_state(init_state(cfg, device=device), mesh), trace.dts, trace.batches)
        diff = field_diff(torch, gather_state(shards), one)
        print(f"sharded {name} 2x2 vs make_step after {steps} steps: " + "; ".join(
            f"{f} max abs diff {d['max_abs']:.4e} of scale {d['scale']:.4e} "
            f"({d['max_abs'] / max(d['scale'], 1e-3):.3e} <= {bound:.0e}), "
            f"{100 * d['share_differing']:.4f}% of texels differ" for f, d in diff.items()))
        for f, d in diff.items():
            assert d["max_abs"] <= bound * max(d["scale"], 1e-3), (name, f, d)
        return diff, one, shards

    out["demo_vs_unsharded"], _, _ = vs_unsharded("demo_float32", cfgs["demo_float32"], 4,
                                                  SHARDED_DEMO_BOUND)
    cfg = batch_config(SHARDED_RES)
    cell = f"sharded_{SHARDED_RES}_bf16_2x2"
    # The cell's own shapes (the padded blocks, the split bands, the whole
    # grid): its kernels against the plain passes, sharded and unsharded.
    out["vs_plain"][cell] = kernels_vs_plain(cell, cfg, SHARDED_MESH)
    torch.cuda.empty_cache()
    diff, one, shards = vs_unsharded(cell, cfg, CHECK_STEPS, SHARDED_16K_BOUND, plain=True)
    out[f"{SHARDED_RES}_vs_unsharded"] = diff
    torch.cuda.empty_cache()

    # The rates: 20 steps each, one call, then each one's device time.
    trace = swirl_trace(cfg, CHECK_STEPS + SHARDED_RATE_STEPS, seed=42)
    seq = torch.as_tensor(trace.batches[CHECK_STEPS:], device=device)
    multi, smulti = make_multi_step(cfg, device=device), make_sharded_multi_step(cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = multi(one, 1.0 / 60.0, seq)
    torch.cuda.synchronize()
    single_sps = SHARDED_RATE_STEPS / (time.perf_counter() - t0)
    build.reset_launches()
    t0 = time.perf_counter()
    shards = smulti(shards, 1.0 / 60.0, seq)
    torch.cuda.synchronize()
    sharded_sps = SHARDED_RATE_STEPS / (time.perf_counter() - t0)
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    want = {k: n * SHARDED_RATE_STEPS for k, n in sharded_launches(cfg, SHARDED_MESH).items()}
    assert launches == want, (launches, want)
    # The same steps with the row-halo phases whole (OVERLAP_HALO=False),
    # from the split run's state after one warm-up step; results dropped.
    mono_cfg = dataclasses.replace(cfg, OVERLAP_HALO=False)
    mono_multi = make_sharded_multi_step(mono_cfg, mesh)
    mono_multi(shards, 1.0 / 60.0, seq[:1])
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    mono = mono_multi(shards, 1.0 / 60.0, seq)
    torch.cuda.synchronize()
    mono_sps = SHARDED_RATE_STEPS / (time.perf_counter() - t0)
    mono_launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    assert mono_launches == {k: n * SHARDED_RATE_STEPS for k, n in
                             sharded_launches(mono_cfg, SHARDED_MESH).items()}, mono_launches
    del mono
    step = make_sharded_step(cfg, mesh)
    halo.SENT.reset()
    box = [step(shards, 1.0 / 60.0, seq[0])]
    sent = halo.SENT.bytes
    report = ss.overhead_report(cfg, SHARDED_MESH)

    def one_sharded(t):
        box[0] = step(box[0], 1.0 / 60.0, seq[t])

    mono_step = make_sharded_step(mono_cfg, mesh)
    mono_box = [box[0]]

    def one_mono(t):
        mono_box[0] = mono_step(mono_box[0], 1.0 / 60.0, seq[t])

    _, sother = floors.profile_calls(one_sharded, SHARDED_PROFILE_STEPS)
    _, mother = floors.profile_calls(one_mono, SHARDED_PROFILE_STEPS)
    _, uother = floors.profile_step_kernels(cfg, one, 1.0 / 60.0, SHARDED_PROFILE_STEPS)
    rates = {}
    for name, sps, other in ((f"make_multi_step {SHARDED_RES}^2", single_sps, uother),
                             ("make_sharded_multi_step 2x2", sharded_sps, sother),
                             ("make_sharded_multi_step 2x2 OVERLAP_HALO=False", mono_sps,
                              mother)):
        kern = sum(r["us"] for r in other["kernel_events"].values()) / 1e3
        dev = kern + other["other_device_us"] / 1e3
        rates[name] = {"steps_per_s": sps, "kernels_ms": kern, "other_device_ms":
                       other["other_device_us"] / 1e3, "idle": 1 - dev * sps / 1e3,
                       "kernel_events": other["kernel_events"],
                       "top_other_ops": other["top_other_ops"]}
        print(f"sharded rate {name} on {gpu}: {sps:.2f} steps/s over {SHARDED_RATE_STEPS} steps "
              f"(one call, {1e3 / sps:.4f} ms a step); profiler over {SHARDED_PROFILE_STEPS} "
              f"steps: kernels {kern:.4f} ms + other device "
              f"{other['other_device_us'] / 1e3:.4f} ms a step, "
              f"{100 * rates[name]['idle']:.1f}% idle (1 - device / wall); top other: " + "; ".join(
                  f"{o['us']} us {o['op'][:40]}" for o in other["top_other_ops"][:4]))
    print(f"sharded rate: all 4 shards on {torch.cuda.device_count()} card(s), so the sharded "
          f"rate is the cost of sharding on one card, not a multi-card rate; launches "
          f"{launches} over {SHARDED_RATE_STEPS} sharded steps = "
          f"{sum(launches.values()) // SHARDED_RATE_STEPS} a step, as expected "
          f"{ {k: n // SHARDED_RATE_STEPS for k, n in want.items()} } (OVERLAP_HALO=False: "
          f"{sum(mono_launches.values()) // SHARDED_RATE_STEPS}); halo bytes moved in a "
          f"step {sent} (all shards) vs overhead_report "
          f"{report['total_send_bytes_per_step']} a device x 4 = "
          f"{4 * report['total_send_bytes_per_step']}")
    out.update(rates=rates, launches=launches, monolithic_launches=mono_launches,
               halo_bytes=sent, overhead_report=report)
    del one, shards, box, mono_box
    torch.cuda.empty_cache()

    # The bounded launch on a corner shard's padded block, beside the
    # unbounded one on a copy of the same window.
    h, w = SHARDED_RES // SHARDED_MESH[0], SHARDED_RES // SHARDED_MESH[1]
    hp, wp = h + 2 * ghosts[0], w + 2 * ghosts[1]
    gen = torch.Generator(device=device).manual_seed(7)
    vel = torch.clamp(torch.randn((2, hp, wp), generator=gen, device=device) * 400, -1000,
                      1000).to(torch.bfloat16)
    splats = torch.as_tensor(trace.batches[0], device=device)
    vf = splat_factors(splats, hp, wp, cfg.splat_radius_uv(), cfg.aspect_ratio,
                       slice(SPLAT_DX, SPLAT_DY + 1), row0=-ss._G_STENCIL, h_total=SHARDED_RES,
                       col0=-ss._GC, w_total=SHARDED_RES)
    bounds = check.shard_bounds(h, w, *ghosts)["corner"]
    r0, c0, wh, ww = kstencil.window(hp, wp, bounds)
    rows, cols = slice(r0, r0 + wh), slice(c0, c0 + ww)
    copy = (vel[:, rows, cols].contiguous(), cfg.CURL, 1.0 / 60.0,
            (vf[0][rows].contiguous(), vf[1][:, cols].contiguous(), vf[2]))
    # the window's bf16 velocity and float32 factors read, its velocity and
    # divergence written; the chain's operations and the bump's
    n_active, n_rows = int((splats[:, 7] != 0).sum()), splats.shape[0]
    nbytes = 2 * 2 * wh * ww + 4 * n_rows * (wh + ww + 2) + 3 * 2 * wh * ww
    flops = wh * ww * (2 * 2 * n_active + check._PRE_PRESSURE)
    args = (vel, cfg.CURL, 1.0 / 60.0, vf, bounds)
    err, _ = check.compare(*(tuple(t[..., rows, cols] for t in fn(*args))   # the window's
                             for fn in (kstencil.pre_pressure, kstencil.pre_pressure_plain)))
    assert err == 0.0, err
    rate = spin_rate()
    bounded_ms = queued_ms(lambda: kstencil.pre_pressure(*args), 20, rate)
    copy_ms = queued_ms(lambda: kstencil.pre_pressure(*copy), 20, rate)
    plain_ms = queued_ms(lambda: kstencil.pre_pressure_plain(*args), 3, rate)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    print(f"time   pre_pressure:bounded corner shard {hp}x{wp} bf16, window {wh}x{ww}: kernel "
          f"{bounded_ms:.4f} ms, unbounded on a copy of the window {copy_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}, {nbytes} B, {flops} flop); "
          f"max_abs_err {err:.3e}")
    out["bounded"] = {"ms": bounded_ms, "window_copy_ms": copy_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "by": by, "bytes": nbytes, "flops": flops,
                      "launches": launches["pre_pressure"], "max_abs_err": max(err, bounded_err)}
    return out


def app_run(argv) -> str:
    """tpufluid_torch.app.main(argv) with its standard output captured;
    returns the app's steps/s line."""
    import io

    from tpufluid_torch import app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        app.main(argv)
    return next(line for line in buf.getvalue().splitlines() if line.endswith("steps/s"))


def app_phase(torch, gpu: str, device) -> dict:
    """Phase 14, the app: tpufluid_torch.app.main at its defaults (the demo
    geometry, f32), a straight run of APP_STEPS with checkpoints, metrics,
    a few frames, a GIF and a capture; a run resumed from its first
    checkpoint, whose final checkpoint must equal the straight run's bit
    for bit; a run with no output for the app's own loop rate. Launches
    counted for each run."""
    import shutil

    from tpufluid_torch.app import build_argparser
    from tpufluid_torch.checkpoint import load_state
    from tpufluid_torch.io import load_png
    from tpufluid_torch.ops.cuda import build

    shutil.rmtree(APP_OUT, ignore_errors=True)
    straight, resumed, bare = (APP_OUT / n for n in ("straight", "resumed", "bare"))
    half = APP_STEPS // 2
    args = ["--steps", str(APP_STEPS), "--ckpt-every", str(half), "--metrics-every", "60"]
    frames = APP_STEPS // APP_RENDER_EVERY
    runs = {}
    for name, argv, steps, renders in (
            ("straight", [*args, "--out", str(straight), "--render-every", str(APP_RENDER_EVERY),
                          "--gif", "run.gif", "--capture", str(APP_OUT / "capture.png")],
             APP_STEPS, frames + 1),
            ("resumed", [*args, "--out", str(resumed),
                         "--resume", str(straight / f"ckpt_{half:06d}.npz")], half, 0),
            ("bare", ["--steps", str(APP_STEPS), "--metrics-every", "0", "--out", str(bare)],
             APP_STEPS, 0)):
        build.reset_launches()
        line = app_run(argv)
        launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
        runs[name] = {"line": line, "launches": launches}
        print(f"app {name}: {line}; launches {launches} on {gpu}")
        if name == "straight":
            _, cfg, _, _ = load_state(straight / f"ckpt_{half:06d}.npz", device=device)
        want = {k: n * steps for k, n in expected_per_step(cfg).items() if n}
        want.update({k: n * renders for k, n in PER_FRAME.items() if n * renders})
        assert launches == want, (name, launches, want)

    a, _, sa, _ = load_state(straight / f"ckpt_{APP_STEPS:06d}.npz", device=device)
    b, _, sb, _ = load_state(resumed / f"ckpt_{APP_STEPS:06d}.npz", device=device)
    assert sa == sb == APP_STEPS
    err = {f: float((getattr(a, f).float() - getattr(b, f).float()).abs().max())
           for f in ("velocity", "dye", "pressure")}
    equal = all(torch.equal(getattr(a, f), getattr(b, f)) for f in err)
    print(f"app resumed from step {half} vs the straight run at step {APP_STEPS} on {gpu}: "
          f"max abs err {err}, bit-equal {equal}")
    assert equal, err
    assert all(bool(torch.isfinite(getattr(a, f)).all()) for f in err) and \
        float(a.dye.max()) > 0, "the app's state is not finite or has no dye"
    recs = [json.loads(line) for line in (straight / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == APP_STEPS // 60 and all(r["nonfinite"] == 0 for r in recs)
    pngs = sorted(straight.glob("frame_*.png"))
    assert len(pngs) == frames and (straight / "run.gif").exists()
    cap = load_png(str(APP_OUT / "capture.png"))
    assert cap.shape[0] == 4 and float(cap[:3].max()) > 0.05, "capture is all background"
    defaults = build_argparser().parse_args([])
    return {"runs": runs, "resume_err": err, "metrics": recs[-1],
            "frames": [p.name for p in pngs], "capture_shape": list(cap.shape),
            "defaults": {k: getattr(defaults, k) for k in ("sim_res", "dye_res", "canvas",
                                                            "dtype", "jacobi_iters")}}


def server_phase(torch, check, gpu: str, device) -> dict:
    """Phase 14, the server: FluidServer at the server's defaults on the
    card with its sim thread and an HTTP server on 127.0.0.1; pointer
    events; /frame until SERVER_FRAMES frames were served (tick ms, encode
    ms, frames/s); /stats, /config, /screenshot.png, /trace.npz and, paused,
    /checkpoint.npz, which must resume a second server on the saved state
    bit for bit; a live /config switch to bfloat16 and another dye grid.
    Then the resumed server's own ticks: SERVER_TICKS counted (8 launches a
    tick) and one held against the plain render of the state it left."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.render import plain_render, render_frame
    from tpufluid_torch.server import (MAX_DT, FluidServer, build_argparser,
                                       config_from_args, make_handler)

    cfg = config_from_args(build_argparser().parse_args([]))
    server = FluidServer(cfg, seed=0, device=device)
    tick_ms, encode_ms = [], []

    def timed(fn, out):
        def call(*a):
            t = time.perf_counter()
            r = fn(*a)
            out.append(1e3 * (time.perf_counter() - t))
            return r
        return call

    server.advance = timed(server.advance, tick_ms)
    server.encode = timed(server.encode, encode_ms)
    sim = threading.Thread(target=server.run, daemon=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    web = threading.Thread(target=httpd.serve_forever, daemon=True)
    sim.start()
    web.start()
    url = f"http://127.0.0.1:{httpd.server_port}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=30) as r:
            assert r.status == 200, (path, r.status)
            return r.read()

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()

    def steps():
        return json.loads(get("/stats"))["steps"]

    def wait_steps(n, limit_s=60.0):
        t_end = time.time() + limit_s
        while steps() < n:
            assert time.time() < t_end, f"the sim loop did not reach {n} steps"
            time.sleep(0.01)

    try:
        wait_steps(1)
        assert post("/events", [{"k": "down", "x": 0.3, "y": 0.5}, {"k": "burst"}])[0] == 204
        tick_ms.clear()
        encode_ms.clear()
        s0, t0, served, k = steps(), time.perf_counter(), 0, 0
        while steps() < s0 + SERVER_FRAMES:
            assert get("/frame")[:2] == b"\xff\xd8"
            served += 1
            k += 1
            x = 0.5 + 0.3 * math.cos(k / 20)
            y = 0.5 + 0.3 * math.sin(k / 10)
            assert post("/events", [{"k": "move", "x": x, "y": y}])[0] == 204
            assert time.perf_counter() - t0 < 60, "frames stopped"
        wall = time.perf_counter() - t0
        produced = steps() - s0
        fps = produced / wall
        ticks = sorted(tick_ms)
        encodes = sorted(encode_ms)

        stats = json.loads(get("/stats"))
        config = json.loads(get("/config"))
        assert config["SIM_RESOLUTION"] == cfg.SIM_RESOLUTION and stats["paused"] is False
        png = get("/screenshot.png")
        shot = Image.open(io.BytesIO(png))
        cw, ch = cfg.capture_size
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and shot.size == (cw, ch), shot.size
        trace = np.load(io.BytesIO(get("/trace.npz")))
        assert trace["batches"].shape[1:] == (cfg.MAX_SPLATS, 8)
        assert trace["batches"][:, :, 7].sum() > 0 and (trace["dts"] <= np.float32(MAX_DT)).all()

        # Paused, the state holds still: the checkpoint is of this state.
        post("/events", [{"k": "pause", "v": True}])
        wait_steps(steps() + 2)
        ckpt = get("/checkpoint.npz")
        with server.lock:
            saved = {f: getattr(server.state, f).clone() for f in ("velocity", "dye", "pressure")}
        post("/events", [{"k": "up"}, {"k": "pause", "v": False}])
        path = APP_OUT / "server_session.npz"
        path.write_bytes(ckpt)

        status, body = post("/config", {"DYE_RESOLUTION": SERVER_DYE_SWITCH, "DTYPE": "bfloat16"})
        assert status == 200 and json.loads(body)["DTYPE"] == "bfloat16"
        wait_steps(steps() + 10)
        with server.lock:
            dye = server.state.dye
            assert dye.dtype == torch.bfloat16 and dye.shape[-2:] == (
                server.config.dye_size[1], server.config.dye_size[0]), dye.shape
            assert bool(torch.isfinite(dye.float()).all())
    finally:
        server.stop()
        httpd.shutdown()
        httpd.server_close()
        sim.join(timeout=30)
    assert not sim.is_alive(), "the sim thread did not stop"

    resumed = FluidServer(cfg, seed=0, resume=str(path), device=device)
    resumed_at = resumed.steps_done
    resume_err = {f: float((getattr(resumed._resume_state, f).float() - saved[f].float())
                           .abs().max()) for f in saved}
    equal = all(torch.equal(getattr(resumed._resume_state, f), saved[f]) for f in saved)
    assert equal and resumed.config == cfg and 0 in resumed.tracer.pointers, resume_err

    # The resumed server's loop runs, then stops; its own ticks are counted.
    run2 = threading.Thread(target=resumed.run, daemon=True)
    run2.start()
    t_end = time.time() + 30
    while resumed.steps_done < 5:
        assert time.time() < t_end, "the resumed server did not tick"
        time.sleep(0.01)
    resumed.stop()
    run2.join(timeout=30)
    assert not run2.is_alive()
    resumed.tracer.feed("down", pid=1, x=100.0, y=100.0)
    build.reset_launches()
    direct_ms = []
    for k in range(SERVER_TICKS):
        resumed.tracer.feed("move", pid=1, x=100.0 + 5 * k, y=100.0 + 2 * k)
        t = time.perf_counter()
        resumed.advance(MAX_DT)
        direct_ms.append(1e3 * (time.perf_counter() - t))
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    want = {k: n * SERVER_TICKS for k, n in {**expected_per_step(cfg), **PER_FRAME}.items() if n}
    assert launches == want, (launches, want)

    frame = resumed.advance(MAX_DT)
    state = resumed.state
    plain = plain_render(state, cfg)
    err, tol = check.compare(render_frame(state, cfg), plain)
    rgb = (plain[:3].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    plain_u8 = torch.flip(rgb.movedim(0, -1), dims=(0,)).cpu().numpy()
    u8_err = int(np.abs(frame.astype(np.int32) - plain_u8.astype(np.int32)).max())
    assert frame.shape == (cfg.CANVAS_HEIGHT, cfg.CANVAS_WIDTH, 3) and frame.dtype == np.uint8
    assert err <= tol, f"server tick frame vs plain render: {err} > {tol}"

    (tm, tp), (em, ep) = med_p95(ticks), med_p95(encodes)
    print(f"server {cfg.SIM_RESOLUTION}/{cfg.DYE_RESOLUTION} {cfg.CANVAS_WIDTH}x"
          f"{cfg.CANVAS_HEIGHT} on {gpu}: {produced} frames in {wall:.3f} s = {fps:.1f} "
          f"frames/s served ({served} /frame fetches, paced at MAX_DT); tick ms median "
          f"{tm:.4f} p95 {tp:.4f} over {len(ticks)} ticks; JPEG encode ms median {em:.4f} "
          f"p95 {ep:.4f}")
    print(f"server on {gpu}: /stats {stats}, /config ok, /screenshot.png {shot.size}, /trace.npz "
          f"{trace['batches'].shape[0]} steps, /checkpoint.npz {len(ckpt)} bytes resumed at "
          f"step {resumed_at}: max abs err {resume_err}; "
          f"/config DYE_RESOLUTION {SERVER_DYE_SWITCH} + bfloat16 live")
    dm, dp = med_p95(sorted(direct_ms))
    print(f"server ticks on {gpu}: launches {launches} ({SERVER_TICKS} ticks, "
          f"{sum(launches.values()) // SERVER_TICKS} a tick, called in turn with no HTTP "
          f"traffic: tick ms median {dm:.4f} p95 {dp:.4f}); tick frame vs "
          f"plain render max abs err {err:.3e} tol {tol:.3e} (uint8 max diff {u8_err})")
    return {"frames_per_s": fps, "frames": produced, "wall_s": wall, "fetches": served,
            "tick_ms_median": tm, "tick_ms_p95": tp, "direct_tick_ms_median": dm,
            "direct_tick_ms_p95": dp, "encode_ms_median": em,
            "encode_ms_p95": ep, "resume_err": resume_err, "launches": launches,
            "frame_err": err, "frame_tol": tol, "frame_u8_err": u8_err,
            "checkpoint_bytes": len(ckpt)}


def med_p95(values) -> tuple:
    """(median, nearest-rank 95th percentile) of ``values``."""
    v = sorted(values)
    return v[len(v) // 2], v[math.ceil(0.95 * len(v)) - 1]


def launch_counts() -> dict:
    from tpufluid_torch.ops.cuda import build

    return {k: v.launches for k, v in build.KERNELS.items() if v.launches}


def fleet_programs_phase(torch, check, gpu: str, device) -> dict:
    """Phase 15a: make_tick_program at fleet_256_b16 for 'scalar', 'vector'
    and K = FLEET_K from a running fleet: each against the same program
    through the plain passes on the card (0), each sim of the K-substep tick
    against its iterated make_step_and_render ticks (0), launches a tick;
    then FLEET_TIMED ticks of each (ticks/s, sim-ticks/s, median, p95, the
    launches counted) and the kernels' spin-queued device time a tick."""
    from tpufluid_torch import (init_batch, make_batched_multi_step, make_step_and_render,
                                swirl_trace, unstack_state)
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.serve_batch import MAX_DT, make_tick_program
    from tpufluid_torch.tools.render_rate import call_times

    cfg = batch_config(FLEET_RES)
    b = FLEET_SESSIONS
    seq = np.stack([swirl_trace(cfg, FLEET_WARM + 1 + FLEET_TIMED, seed=42 + i).batches
                    for i in range(b)], axis=1)
    state = make_batched_multi_step(cfg, device=device)(init_batch(cfg, b, device=device),
                                                        1.0 / 60.0, seq[:FLEET_WARM])
    speeds = np.linspace(0.5, 4.0, b).astype(np.float32)
    t_total = (np.float32(MAX_DT) * speeds).astype(np.float32)
    n_sub = np.maximum(np.ceil(t_total / MAX_DT - 1e-9), 1.0).astype(np.int64)
    sub = (t_total / n_sub).astype(np.float32)
    assert int(n_sub.max()) == FLEET_K
    dts = {"scalar": np.float32(1.0 / 60.0), "vector": check.per_sim_dts(b),
           FLEET_K: np.where(np.arange(FLEET_K)[:, None] < n_sub[None, :], sub[None, :],
                             0.0).astype(np.float32)}
    per_step = expected_per_step(cfg)
    splats = seq[FLEET_WARM]
    out, launches_timed = {}, {}
    for kind, dt in dts.items():
        k = kind if isinstance(kind, int) else 1
        want = {n: c * k for n, c in per_step.items()}
        want.update(PER_FRAME)
        prog = make_tick_program(cfg, b, kind)
        build.reset_launches()
        got, frames = prog(state, dt, splats)
        torch.cuda.synchronize()
        launches = launch_counts()
        assert launches == want, (kind, launches, want)
        pstate, pframes = make_tick_program(cfg, b, kind, plain=True)(state, dt, splats)
        err = max([float((getattr(got, f).float() - getattr(pstate, f).float()).abs().max())
                   for f in ("velocity", "dye", "pressure")]
                  + [float((frames.int() - pframes.int()).abs().max())])
        assert err == 0.0 and all(torch.equal(getattr(got, f), getattr(pstate, f))
                                  for f in ("velocity", "dye", "pressure")), (kind, err)
        assert torch.equal(frames, pframes), kind
        iter_err = None
        if k > 1:
            single = make_step_and_render(cfg, device=device)
            iter_err = 0.0
            for i in range(b):
                s = unstack_state(state, i)
                for j in range(int(n_sub[i])):
                    s, frame = single(s, sub[i], splats[i] if j == 0 else
                                      np.zeros_like(splats[i]))
                for f in ("velocity", "dye", "pressure"):
                    g = getattr(unstack_state(got, i), f)
                    iter_err = max(iter_err, float((g.float() - getattr(s, f).float())
                                                   .abs().max()))
                    assert torch.equal(g, getattr(s, f)), (kind, i, f)
                assert torch.equal(frames[i], frame), (kind, i, "frame")
        box = [got]

        def one(t):
            box[0], _ = prog(box[0], dt, seq[FLEET_WARM + 1 + t])

        build.reset_launches()
        tps, median, p95 = call_times(one, FLEET_TIMED)
        timed = launch_counts()
        assert timed == {n: c * FLEET_TIMED for n, c in want.items()}, (kind, timed)
        for n, c in timed.items():
            launches_timed[n] = launches_timed.get(n, 0) + c
        v = box[0].velocity.float()
        assert bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0.0, "fleet broke"
        sim_steps = int(n_sub.sum()) if k > 1 else b
        print(f"fleet {FLEET_CELL} {kind!s:6} on {gpu}: program vs its plain passes max abs err "
              f"{err:.3e}" + (f"; each sim vs its iterated make_step_and_render ticks "
                              f"{iter_err:.3e}" if k > 1 else "")
              + f"; launches {launches} ({sum(launches.values())} a tick); {FLEET_TIMED} ticks: "
              f"{tps:.1f} ticks/s, {b * tps:.1f} sim-ticks/s, {sim_steps * tps:.1f} sim-steps/s, "
              f"tick median {median:.4f} ms, p95 {p95:.4f} ms")
        out[str(kind)] = {"launches": launches, "err": err, "iter_err": iter_err,
                          "ticks_per_s": tps, "sim_ticks_per_s": b * tps,
                          "sim_steps_per_s": sim_steps * tps, "tick_ms_median": median,
                          "tick_ms_p95": p95}
    # The kernels' spin-queued device time of one tick's calls, on the timed
    # fleet's state with per-sim dts (check.py's cases, each against its
    # plain version): the step's K times, the frame's once.
    splats_dev = torch.as_tensor(seq[-1], device=device)
    cases = (check.step_cases(box[0], splats_dev, cfg, check.per_sim_dts(b), ":fleet")
             + check.batched_render_cases(box[0], cfg) + check.sunrays_cases(box[0], cfg, f":b{b}"))
    timing = timing_phase(torch, check, cases, verbose=False)
    step_ms = step_device_ms(timing)
    frame_ms = sum(r["ms"] for n, r in timing.items() if n in PER_FRAME)
    for kind, row in out.items():
        k = int(kind) if kind.isdigit() else 1
        row["kernel_device_ms"] = k * step_ms + frame_ms
        row["idle"] = 1.0 - row["kernel_device_ms"] / row["tick_ms_median"]
        print(f"fleet {FLEET_CELL} {kind:6} kernels' device {row['kernel_device_ms']:.4f} ms a "
              f"tick ({k} x step {step_ms:.4f} + frame {frame_ms:.4f}, spin-queued), "
              f"{100 * row['idle']:.1f}% idle at the median")
    print(f"fleet {FLEET_CELL} kernels: " + "; ".join(
        f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f})"
        for n, r in timing.items()))
    return {"programs": out, "kernels": timing, "launches": launches_timed}


def drain_reconciler(srv, until=None) -> None:
    """Run the server's reconciler tasks in this thread until there is none
    left, or until after the task ``until``."""
    while True:
        with srv.lock:
            task = srv._next_task()
        if task is None:
            return
        srv._run_task(task)
        if task == until:
            return


def fleet_padding_phase(torch, gpu: str, device) -> dict:
    """Phase 15b: a fleet of 5 in a padded 8 at fleet_256_b16's geometry,
    driven by hand (the reconciler's tasks, then _tick): after
    FLEET_PAD_TICKS ticks rows 5-7 are exactly 0; resize_fleet(2): after
    the zero tail rows 2-7 are exactly 0; then the swap to 2, and
    resize_fleet(5): rows 2-4 start from 0, rows 5-7 stay 0."""
    from tpufluid_torch.serve_batch import MAX_DT, BatchFluidServer

    srv = BatchFluidServer(batch_config(FLEET_RES), sessions=5, seed=3, prewarm="off",
                           device=device)
    fields = ("velocity", "dye", "pressure")

    def zero(rows):
        return all(bool((getattr(srv.state, f)[rows] == 0).all()) for f in fields)

    drain_reconciler(srv)
    assert srv._pb == 8 and srv._live_rows == 5
    for t in range(FLEET_PAD_TICKS):
        srv.tracers[t % 5].feed("burst", n=2)
        assert srv._tick(MAX_DT)
    torch.cuda.synchronize()
    moved = all(float(srv.state.dye[i].float().abs().max()) > 0 for i in range(5))
    assert zero(slice(5, 8)) and moved, "pad rows not zero, or a live row did not move"
    srv.resize_fleet(2)
    assert srv._gen == 1 and not srv._tail_clean
    drain_reconciler(srv, until=("zero_tail",))
    assert srv._tail_clean and srv._pb == 8 and zero(slice(2, 8)), "evicted rows not zero"
    drain_reconciler(srv)
    assert srv._pb == 2 and srv.state.velocity.shape[0] == 2
    for _ in range(3):
        assert srv._tick(MAX_DT)
    srv.resize_fleet(5)
    drain_reconciler(srv)
    assert srv._pb == 8 and srv._live_rows == 5 and zero(slice(2, 8))
    for _ in range(5):
        assert srv._tick(MAX_DT)
    torch.cuda.synchronize()
    assert zero(slice(5, 8)), "pad rows not zero after the regrow"
    print(f"fleet padding on {gpu}: 5 sessions in a padded 8, {FLEET_PAD_TICKS} ticks: rows 5-7 "
          "exactly 0; resize_fleet(2): after the zero tail rows 2-7 exactly 0, swapped to 2; "
          "resize_fleet(5): rows 2-7 exactly 0 at activation, rows 5-7 after 5 ticks")
    srv.stop()
    return {"ok": True, "gen": srv._gen}


@contextlib.contextmanager
def counted_programs(counts: dict):
    """Count each (pb, kind) program's calls while the block runs: the
    reconciler makes programs through serve_batch.make_tick_program."""
    from tpufluid_torch import serve_batch

    made = serve_batch.make_tick_program

    def counting(config, pb, kind, plain=False):
        prog = made(config, pb, kind, plain)

        def run(*a):
            counts[(pb, kind)] = counts.get((pb, kind), 0) + 1
            return prog(*a)
        return run

    serve_batch.make_tick_program = counting
    try:
        yield
    finally:
        serve_batch.make_tick_program = made


def fleet_server_phase(torch, gpu: str, device) -> dict:
    """Phase 15c: BatchFluidServer at its CLI defaults on the card with its
    sim thread and an HTTP server on 127.0.0.1: every endpoint, speeds 0.25
    and 2.5 (the per-sim program, then K = 3), /sessions 4 -> 6 -> 3 (padded
    4 -> 8 -> 4), paused /checkpoint.npz resuming a second server whose
    state equals the checkpointed one (0). Steps served a second under
    traffic, the tick's ms with and without HTTP traffic, the JPEG encode."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.serve_batch import (MAX_DT, BatchFluidServer, build_argparser,
                                            config_from_args, make_handler)

    args = build_argparser().parse_args([])
    cfg = config_from_args(args)
    calls = {}
    tick_ms, encode_ms = [], []
    with counted_programs(calls):
        srv = BatchFluidServer(cfg, sessions=args.sessions, seed=args.seed,
                               quality=args.quality, prewarm=args.prewarm, device=device)
        real_tick, real_encode = srv._tick, srv._encode

        def timed_tick(dt):
            t = time.perf_counter()
            ran = real_tick(dt)
            if ran:
                tick_ms.append(1e3 * (time.perf_counter() - t))
            return ran

        def timed_encode(arr):
            t = time.perf_counter()
            data = real_encode(arr)
            encode_ms.append(1e3 * (time.perf_counter() - t))
            return data

        srv._tick, srv._encode = timed_tick, timed_encode
        build.reset_launches()
        sim = threading.Thread(target=srv.run, daemon=True)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
        web = threading.Thread(target=httpd.serve_forever, daemon=True)
        sim.start()
        web.start()
        url = f"http://127.0.0.1:{httpd.server_port}"

        def get(path, status=200):
            try:
                with urllib.request.urlopen(url + path, timeout=30) as r:
                    assert r.status == status, (path, r.status)
                    return r.read()
            except urllib.error.HTTPError as e:
                assert e.code == status, (path, e.code, status)
                return b""

        def post(path, body, status=204):
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == status, (path, r.status)
            except urllib.error.HTTPError as e:
                assert e.code == status, (path, body, e.code, status)

        def stats():
            return json.loads(get("/stats"))

        def wait(pred, what, limit_s=30.0):
            t_end = time.time() + limit_s
            while True:
                st = stats()
                assert st["error"] is None, st["error"]
                if pred(st):
                    return st
                assert time.time() < t_end, f"{what}: {st}"
                time.sleep(0.02)

        try:
            wait(lambda s: s["steps"] > 0, "first tick", 120.0)
            assert b"sessions" in get("/")
            for sid in range(args.sessions):
                assert get(f"/frame?sid={sid}")[:2] == b"\xff\xd8"
            post("/events?sid=0", [{"k": "down", "x": 0.3, "y": 0.5}, {"k": "burst", "n": 9}])
            post("/events?sid=1", [{"k": "burst", "n": 12}])
            traffic = {}
            for mode, period in (("back-to-back", 0.0), ("dashboard", FLEET_DASH_PERIOD_S)):
                # back-to-back: one client fetching a frame and posting an
                # event with no pause; dashboard: the page's cadence, every
                # session's frame and one event for each every 100 ms.
                tick_ms.clear()
                encode_ms.clear()
                s0, t0, k = stats()["steps"], time.perf_counter(), 0
                while time.perf_counter() - t0 < FLEET_SERVE_S:
                    t_round = time.perf_counter()
                    for sid in range(args.sessions):
                        assert get(f"/frame?sid={sid}")[:2] == b"\xff\xd8"
                        x, y = 0.5 + 0.3 * math.cos(k / 20), 0.5 + 0.3 * math.sin(k / 10)
                        post(f"/events?sid={sid}", [{"k": "move", "x": x, "y": y}])
                        k += 2
                    left = period - (time.perf_counter() - t_round)
                    if left > 0:
                        time.sleep(left)
                wall = time.perf_counter() - t0
                traffic[mode] = {"steps_per_s": (stats()["steps"] - s0) / wall, "wall_s": wall,
                                 "requests": k, "ticks": list(tick_ms),
                                 "encodes": list(encode_ms)}

            post("/events?sid=0", [{"k": "up"}])
            post("/events?sid=2", [{"k": "speed", "v": 0.25}])
            wait(lambda s: "(4, 'vector')" in s["programs"] and s["speeds"][2] == 0.25,
                 "per-sim program")
            v0 = calls.get((4, "vector"), 0)
            wait(lambda s: calls.get((4, "vector"), 0) > v0 + 5, "per-sim ticks")
            post("/events?sid=3", [{"k": "speed", "v": 2.5}])
            st = wait(lambda s: s["substeps"] == 3, "K = 3 substeps")
            assert calls.get((4, 3), 0) > 0
            for sid in (2, 3):
                post(f"/events?sid={sid}", [{"k": "speed", "v": 1.0}])
            wait(lambda s: s["substeps"] == 1 and s["speeds"] == [1.0] * 4, "back to 1x")
            post("/events?sid=9", [{"k": "burst"}], status=400)
            for lit in ("NaN", "Infinity"):
                req = urllib.request.Request(url + "/events?sid=0", method="POST",
                                             data=f'[{{"k": "speed", "v": {lit}}}]'.encode())
                try:
                    urllib.request.urlopen(req, timeout=30)
                    raise AssertionError(f"speed {lit} accepted")
                except urllib.error.HTTPError as e:
                    assert e.code == 400, (lit, e.code)

            post("/sessions", {"n": 6})
            wait(lambda s: s["padded_batch"] == 8 and s["live_rows"] == 6, "grow to 6")
            t_end = time.time() + 30
            while True:
                try:
                    with urllib.request.urlopen(url + "/frame?sid=5", timeout=30) as r:
                        assert r.read()[:2] == b"\xff\xd8"
                        break
                except urllib.error.HTTPError as e:
                    assert e.code == 503 and time.time() < t_end, e.code
                    time.sleep(0.02)
            post("/sessions", {"n": 3})
            wait(lambda s: s["padded_batch"] == 4 and s["live_rows"] == 3, "shrink to 3")
            get("/frame?sid=4", status=404)
            post("/sessions", {"n": 0}, status=400)
            post("/sessions", {"n": 2.5}, status=400)
            gen = srv._gen

            post("/events?sid=0", [{"k": "pause", "v": True}])
            still, t_end = -1, time.time() + 10
            while stats()["steps"] != still:   # the tick in flight lands
                assert time.time() < t_end, "the paused fleet still ticks"
                still = stats()["steps"]
                time.sleep(0.2)
            ckpt = get("/checkpoint.npz")
            assert srv._fleet_and_state()
            try:
                saved = {f: getattr(srv.state, f)[:srv.sessions].clone()
                         for f in ("velocity", "dye", "pressure")}
                speeds, sessions = srv.speeds.copy(), srv.sessions
            finally:
                srv._release_both()
            assert stats()["steps"] == still, "the paused fleet ticked"
            post("/events?sid=0", [{"k": "pause", "v": False}])
            final = wait(lambda s: s["steps"] > still + 3, "unpaused")
        finally:
            srv.stop()
            httpd.shutdown()
            httpd.server_close()
            sim.join(timeout=30)
        assert not sim.is_alive(), "the sim thread did not stop"
    launches = launch_counts()
    for n in (*expected_per_step(cfg), *PER_FRAME):
        assert launches.get(n, 0) > 0, (n, launches)

    path = APP_OUT / "fleet.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(ckpt)
    resumed = BatchFluidServer(cfg, resume=str(path), device=device)
    resume_err = {f: float((getattr(resumed.state, f)[:sessions].float() - saved[f].float())
                           .abs().max()) for f in saved}
    assert resumed.sessions == sessions == 3 and resumed._pb == 4
    assert all(torch.equal(getattr(resumed.state, f)[:sessions], saved[f]) for f in saved), \
        resume_err
    assert np.array_equal(resumed.speeds, speeds)
    # The resumed fleet's own ticks, called in turn with no HTTP traffic.
    drain_reconciler(resumed)
    for _ in range(10):
        resumed._tick(MAX_DT)
    build.reset_launches()
    direct = []
    for _ in range(FLEET_DIRECT_TICKS):
        t = time.perf_counter()
        assert resumed._tick(MAX_DT)
        direct.append(1e3 * (time.perf_counter() - t))
    direct_launches = launch_counts()
    want = {n: c * FLEET_DIRECT_TICKS for n, c in {**expected_per_step(cfg), **PER_FRAME}.items()}
    assert direct_launches == want, (direct_launches, want)
    resumed.stop()

    dm, dp = med_p95(direct)
    for mode, t in traffic.items():
        t["tick_ms_median"], t["tick_ms_p95"] = med_p95(t.pop("ticks"))
        t["encode_ms_median"], t["encode_ms_p95"] = med_p95(t.pop("encodes"))
        print(f"fleet server {args.sessions} x {cfg.SIM_RESOLUTION}/{cfg.DYE_RESOLUTION} "
              f"{cfg.CANVAS_WIDTH}x{cfg.CANVAS_HEIGHT} {cfg.DTYPE} on {gpu}, {mode} HTTP "
              f"traffic: {t['steps_per_s']:.1f} steps/s served over {t['wall_s']:.2f} s "
              f"({t['requests']} /frame fetches and event posts; paced at MAX_DT); tick ms "
              f"median {t['tick_ms_median']:.4f} p95 {t['tick_ms_p95']:.4f}; JPEG encode ms "
              f"median {t['encode_ms_median']:.4f} p95 {t['encode_ms_p95']:.4f}")
    print(f"fleet server on {gpu}, no HTTP traffic (the resumed fleet, {FLEET_DIRECT_TICKS} "
          f"ticks in turn): tick ms median {dm:.4f} p95 {dp:.4f}")
    print(f"fleet server on {gpu}: /, /frame, /stats, drag and burst events, speed 0.25 (per-sim "
          f"program ticks {calls.get((4, 'vector'), 0)}) and 2.5 (substeps {st['substeps']}, "
          f"K = 3 ticks {calls.get((4, 3), 0)}), bad sid and NaN speed 400, /sessions 4 -> 6 -> 3 "
          f"(padded 4 -> 8 -> 4, generation {gen}), sid 4 404, /checkpoint.npz {len(ckpt)} bytes "
          f"resumed: max abs err {resume_err}; launches {launches} over {final['steps']} steps; "
          f"the resumed fleet's ticks {direct_launches} ({FLEET_DIRECT_TICKS} ticks, "
          f"{sum(direct_launches.values()) // FLEET_DIRECT_TICKS} a tick)")
    return {"traffic": traffic, "direct_tick_ms_median": dm, "direct_tick_ms_p95": dp,
            "resume_err": resume_err, "launches": launches, "program_calls":
            {str(key): n for key, n in calls.items()}, "checkpoint_bytes": len(ckpt)}


def fleet_soak_phase(gpu: str, device) -> dict:
    """Phase 15d: tpufluid_torch.tools.serve_soak in process for
    FLEET_SOAK_S at the server's CLI geometry (sessions 3, max-resize 5);
    its p99s beside its bars; any bar or correctness field that fails
    fails the run."""
    from tpufluid_torch.serve_batch import build_argparser, config_from_args
    from tpufluid_torch.tools.serve_soak import SLO_MS, soak, verdict

    cfg = config_from_args(build_argparser().parse_args([]))
    summary = soak(cfg, FLEET_SOAK_S, sessions=3, max_resize=5, seed=0, device=device)
    summary["slo_violations"], summary["ok"] = verdict(summary)
    lat = summary["latency_ms"]
    print(f"fleet soak {FLEET_SOAK_S:.0f} s (tools/serve_soak.py's default 600 s, cut for time) "
          f"at {cfg.SIM_RESOLUTION}/{cfg.DYE_RESOLUTION} {cfg.CANVAS_WIDTH}x{cfg.CANVAS_HEIGHT} "
          f"on {gpu}: {summary['steps_during_soak']} steps, " + "; ".join(
              f"{k} n {lat[k]['n']} p50 {lat[k]['p50']} p99 {lat[k]['p99']} max {lat[k]['max']} ms "
              f"(bar p99 <= {SLO_MS[k]:.0f})" for k in SLO_MS)
          + f"; failures {summary['n_failures']}, violations {summary['slo_violations']}, ok "
          f"{summary['ok']}")
    assert summary["ok"], summary
    return summary


def fleet_phase(torch, check, gpu: str, device) -> dict:
    """Phase 15, the multi-tenant fleet server: 15a-15d."""
    return {"programs": fleet_programs_phase(torch, check, gpu, device),
            "padding": fleet_padding_phase(torch, gpu, device),
            "server": fleet_server_phase(torch, gpu, device),
            "soak": fleet_soak_phase(gpu, device)}


def bs_mesh(shape):
    """A batch x spatial mesh of ``shape`` over the cards there are, round
    robin."""
    import torch
    from tpufluid_torch import make_batch_spatial_mesh

    n = torch.cuda.device_count()
    return make_batch_spatial_mesh(shape, [f"cuda:{k % n}" for k in range(math.prod(shape))])


def states_equal(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("velocity", "dye", "pressure"))


def device_share(other, wall_ms: float) -> tuple:
    """(kernels' ms, other device ms, idle share) of one call from
    floors.profile_calls' ``other`` beside the call's wall ms."""
    kern = sum(r["us"] for r in other["kernel_events"].values()) / 1e3
    dev = kern + other["other_device_us"] / 1e3
    return kern, other["other_device_us"] / 1e3, 1.0 - dev / wall_ms


def batch_dp_phase(torch, check, gpu: str, device) -> dict:
    """Phase 16a: batch DP at fleet_256_b16 on a DP_MESH mesh: 200 steps
    lock-step and per sim, and the K = FLEET_K substepped tick, each equal
    to the unsharded batch (frames included), launches counted, no halo
    byte; sim-steps/s and sim-ticks/s beside the unsharded path's, each
    with its idle share."""
    from tpufluid_torch import (gather_batch, init_batch, make_batch_sharded_multi_step,
                                make_batch_sharded_substepped_tick, make_batched_multi_step,
                                make_substepped_tick, shard_batch, swirl_trace)
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.parallel import halo
    from tpufluid_torch.serve_batch import MAX_DT
    from tpufluid_torch.tools.render_rate import call_times

    cfg = batch_config(FLEET_RES)
    b = FLEET_SESSIONS
    mesh = sharded_mesh(DP_MESH)
    n = mesh.size
    seq = np.stack([swirl_trace(cfg, DP_STEPS, seed=42 + i).batches for i in range(b)], axis=1)
    per_step = expected_per_step(cfg)
    unsharded, dp = make_batched_multi_step(cfg, device=device), make_batch_sharded_multi_step(
        cfg, mesh)
    # Untimed first calls: a shape's first steps in a process pay one-time costs.
    unsharded(init_batch(cfg, b, device=device), 1.0 / 60.0, seq[:DP_WARM])
    dp(shard_batch(init_batch(cfg, b, device=device), mesh), 1.0 / 60.0, seq[:DP_WARM])
    out, warm = {}, None
    for kind, dt in (("lock-step", 1.0 / 60.0),
                     ("per-sim", np.broadcast_to(check.per_sim_dts(b), (DP_STEPS, b)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = unsharded(init_batch(cfg, b, device=device), dt, seq)
        torch.cuda.synchronize()
        un_s = time.perf_counter() - t0
        start = shard_batch(init_batch(cfg, b, device=device), mesh)
        halo.SENT.reset()
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dp(start, dt, seq)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        launches = launch_counts()
        assert launches == {k: c * n * DP_STEPS for k, c in per_step.items()}, (kind, launches)
        assert halo.SENT.bytes == 0, halo.SENT.bytes
        assert all(s.velocity.device == d for s, d in zip(got, mesh.flat))
        assert states_equal(torch, gather_batch(got, device), want), kind
        one_dt = dt if np.ndim(dt) == 0 else dt[:1]
        box, ubox = [got], [want]

        def dp_one(t):
            box[0] = dp(box[0], one_dt, seq[t:t + 1])

        def un_one(t):
            ubox[0] = unsharded(ubox[0], one_dt, seq[t:t + 1])

        _, dother = floors.profile_calls(dp_one, SHARDED_PROFILE_STEPS)
        _, uother = floors.profile_calls(un_one, SHARDED_PROFILE_STEPS)
        row = {}
        for name, secs, other in (("unsharded", un_s, uother), ("dp", dp_s, dother)):
            kern, odev, idle = device_share(other, 1e3 * secs / DP_STEPS)
            row[name] = {"sim_steps_per_s": b * DP_STEPS / secs,
                         "step_ms": 1e3 * secs / DP_STEPS, "kernels_ms": kern,
                         "other_device_ms": odev, "idle": idle}
        row["launches"] = launches
        print(f"batch-dp {FLEET_CELL} {DP_MESH[0]}x{DP_MESH[1]} {kind} on {gpu}: {DP_STEPS} "
              f"make_batch_sharded_multi_step steps equal to make_batched_multi_step (max abs "
              f"err 0); halo bytes {halo.SENT.bytes}; launches {launches} "
              f"({sum(launches.values()) // DP_STEPS} a step); " + "; ".join(
                  f"{name} {r['sim_steps_per_s']:.1f} sim-steps/s ({r['step_ms']:.4f} ms a "
                  f"step; kernels {r['kernels_ms']:.4f} + other device "
                  f"{r['other_device_ms']:.4f} ms, {100 * r['idle']:.1f}% idle)"
                  for name, r in row.items() if name != "launches"))
        out[kind] = row
        warm = want
        del got, box

    # The K-substep tick from the per-sim run's state (speeds as 15a's).
    speeds = np.linspace(0.5, 4.0, b).astype(np.float32)
    t_total = (np.float32(MAX_DT) * speeds).astype(np.float32)
    n_sub = np.maximum(np.ceil(t_total / MAX_DT - 1e-9), 1.0).astype(np.int64)
    sub = (t_total / n_sub).astype(np.float32)
    kdts = np.where(np.arange(FLEET_K)[:, None] < n_sub[None, :], sub[None, :], 0.0
                    ).astype(np.float32)
    tick, dp_tick = make_substepped_tick(cfg, device=device), \
        make_batch_sharded_substepped_tick(cfg, mesh)
    want, want_frames = tick(warm, kdts, seq[-1])
    halo.SENT.reset()
    build.reset_launches()
    got, frames = dp_tick(shard_batch(warm, mesh), kdts, seq[-1])
    torch.cuda.synchronize()
    launches = launch_counts()
    per_tick = {k: c * FLEET_K * n for k, c in per_step.items()}
    per_tick.update({k: c * n for k, c in PER_FRAME.items()})
    assert launches == per_tick, launches
    assert halo.SENT.bytes == 0
    assert states_equal(torch, gather_batch(got, device), want)
    assert frames.device == mesh.flat[0] and torch.equal(frames, want_frames)
    ubox, box = [want], [got]

    def un_tick(t):
        ubox[0], _ = tick(ubox[0], kdts, seq[t])

    def dp_tick_one(t):
        box[0], _ = dp_tick(box[0], kdts, seq[t])

    ticks = {}
    for name, fn in (("unsharded", un_tick), ("dp", dp_tick_one)):
        tps, median, p95 = call_times(fn, DP_TICKS)
        _, other = floors.profile_calls(fn, SHARDED_PROFILE_STEPS)
        kern, odev, idle = device_share(other, median)
        ticks[name] = {"ticks_per_s": tps, "sim_ticks_per_s": b * tps,
                       "sim_steps_per_s": int(n_sub.sum()) * tps, "tick_ms_median": median,
                       "tick_ms_p95": p95, "kernels_ms": kern, "other_device_ms": odev,
                       "idle": idle}
    print(f"batch-dp {FLEET_CELL} {DP_MESH[0]}x{DP_MESH[1]} K={FLEET_K} tick on {gpu}: state and "
          f"frames equal to make_substepped_tick (max abs err 0); halo bytes 0; launches "
          f"{launches} ({sum(launches.values())} a tick); {DP_TICKS} ticks: " + "; ".join(
              f"{name} {r['sim_ticks_per_s']:.1f} sim-ticks/s, median {r['tick_ms_median']:.4f} "
              f"ms, p95 {r['tick_ms_p95']:.4f} ms, kernels {r['kernels_ms']:.4f} + other "
              f"device {r['other_device_ms']:.4f} ms, {100 * r['idle']:.1f}% idle at the median"
              for name, r in ticks.items()))
    out["tick"] = {"launches": launches, **ticks}
    return out


def unsharded_departure(torch, got_sims, truth, cfg, dts, seq, steps: int, device,
                        phase12_bound: float, fault_bound: float) -> dict:
    """The batch x spatial batch against the unsharded batch ``truth``
    (make_batched_multi_step), each field's largest difference over its
    scale. Since each sim equals its single-sim sharded step, this is the
    sharded step's own departure from make_step, sim by sim, once each sim
    of ``truth`` equals make_multi_step on it alone (checked here, 0).
    Held under ``fault_bound`` (a halo or wall fault moves whole texels:
    an error of the order of the scale); printed beside phase 12's bound,
    which phase 12 holds on its one trace (seed 42, dt 1/60); None where
    phase 12 has no bound for the cell. ``got_sims(i, f)``: sim i's field
    f of the batch x spatial result."""
    from tpufluid_torch import init_state, make_multi_step, unstack_state

    multi = make_multi_step(cfg, device=device)
    fields = ("velocity", "dye", "pressure")
    scale = {f: max(float(getattr(truth, f).float().abs().max()), 1e-3) for f in fields}
    rel = {f: 0.0 for f in fields}
    per_sim = []
    for i in range(truth.velocity.shape[0]):
        ref = multi(init_state(cfg, device=device), dts[:, i], seq[:steps, i])
        mine = unstack_state(truth, i)
        assert all(torch.equal(getattr(mine, f), getattr(ref, f)) for f in fields), i
        del ref
        sim = {}
        for f in fields:
            g = got_sims(i, f)
            assert bool(torch.isfinite(g.float()).all()), (i, f)
            sim[f] = float((g.float() - getattr(mine, f).float()).abs().max()) / scale[f]
            rel[f] = max(rel[f], sim[f])
        per_sim.append(sim)
    for f in fields:
        assert rel[f] <= fault_bound, (f, rel[f], fault_bound)
    within = None if phase12_bound is None else all(v <= phase12_bound for v in rel.values())
    return {"rel": rel, "per_sim": per_sim, "phase12_bound": phase12_bound,
            "within_phase12_bound": within}


def phase12_note(dep: dict) -> str:
    if dep["phase12_bound"] is None:
        return "phase 12 has no bound for this cell"
    return (f"phase 12's {dep['phase12_bound']:.0e} "
            f"{'held' if dep['within_phase12_bound'] else 'exceeded'}")


def batch_spatial_run(torch, check, name: str, cfg, shape, phase12_bound,
                      fault_bound: float, gpu: str, device) -> dict:
    """Phase 16b's comparisons on one (nb, ny, nx) mesh: BS_STEPS steps of
    2 nb sims with per-sim dts through the kernels (launches counted)
    against the plain passes (0), each sim against its single-sim sharded
    step on its group's mesh (0), the batch against the unsharded
    make_batched_multi_step (unsharded_departure)."""
    from tpufluid_torch import (gather_batch_spatial, init_batch, init_state,
                                make_batch_spatial_multi_step, make_batched_multi_step,
                                make_sharded_multi_step, shard_batch_spatial, shard_state,
                                swirl_trace, unstack_state)
    from tpufluid_torch.ops.cuda import build

    mesh = bs_mesh(shape)
    nb, b = shape[0], 2 * shape[0]
    seq = np.stack([swirl_trace(cfg, BS_STEPS, seed=42 + i).batches for i in range(b)], axis=1)
    dts = np.broadcast_to(check.per_sim_dts(b), (BS_STEPS, b))
    build.reset_launches()
    got = make_batch_spatial_multi_step(cfg, mesh)(
        shard_batch_spatial(init_batch(cfg, b, device=device), mesh), dts, seq)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {k: c * nb * BS_STEPS for k, c in sharded_launches(cfg, shape[1:]).items()}
    assert launches == want, (name, shape, launches, want)
    whole = gather_batch_spatial(got, device)
    plain = gather_batch_spatial(make_batch_spatial_multi_step(cfg, mesh, plain=True)(
        shard_batch_spatial(init_batch(cfg, b, device=device), mesh), dts, seq), device)
    fields = ("velocity", "dye", "pressure")
    err, _ = check.compare(tuple(getattr(whole, f) for f in fields),
                           tuple(getattr(plain, f) for f in fields))
    assert err == 0.0, (name, shape, err)
    del plain
    for i in range(b):
        group = mesh.groups[i // 2]
        one = make_sharded_multi_step(cfg, group)(
            shard_state(init_state(cfg, device=device), group), dts[:, i], seq[:, i])
        for r, row in enumerate(one):
            for c, s in enumerate(row):
                mine = got[i // 2][r][c]
                assert all(torch.equal(getattr(mine, f)[i % 2], getattr(s, f)) for f in fields), \
                    (name, shape, i, r, c)
    truth = make_batched_multi_step(cfg, device=device)(init_batch(cfg, b, device=device), dts,
                                                        seq)
    dep = unsharded_departure(torch, lambda i, f: getattr(unstack_state(whole, i), f), truth,
                              cfg, dts, seq, BS_STEPS, device, phase12_bound, fault_bound)
    print(f"batch-spatial {name} {'x'.join(map(str, shape))} on {gpu}: {b} sims, {BS_STEPS} "
          f"steps, per-sim dt: kernels vs plain passes max abs err {err:.3e}; each sim equal to "
          f"its single-sim sharded step (0) and each unsharded sim to make_multi_step (0); "
          f"launches {launches} ({sum(launches.values()) // BS_STEPS} a step); vs "
          f"make_batched_multi_step: " + "; ".join(f"{f} {v:.3e}" for f, v in dep["rel"].items())
          + f" of scale (<= {fault_bound:.0e}; {phase12_note(dep)}); per sim: " + "; ".join(
              "/".join(f"{v:.2e}" for v in sim.values()) for sim in dep["per_sim"]))
    return {"launches": launches, "max_abs_err": err, "vs_unsharded": dep}


def bounded_batched_timing(torch, check, cfg, seq, device) -> dict:
    """pre_pressure's true-wall form on a batch of BS_FULL_PER_GROUP sims
    with a per-sim dt table, on a corner shard's padded block of
    sharded_16384_bf16_2x2 (what 16c's groups launch): compared inside its
    walls (0), timed beside its plain version and its bound."""
    from tpufluid_torch.ops.cuda import stencil as kstencil
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate
    from tpufluid_torch.ops.splat import SPLAT_DX, SPLAT_DY, splat_factors
    from tpufluid_torch.parallel import sharded_step as ss

    b = BS_FULL_PER_GROUP
    h, w = SHARDED_RES // SHARDED_MESH[0], SHARDED_RES // SHARDED_MESH[1]
    hp, wp = h + 2 * ss._G_STENCIL, w + 2 * ss._GC
    gen = torch.Generator(device=device).manual_seed(7)
    vel = torch.clamp(torch.randn((b, 2, hp, wp), generator=gen, device=device) * 400, -1000,
                      1000).to(torch.bfloat16)
    splats = torch.as_tensor(seq[0, :b], device=device)
    vf = splat_factors(splats, hp, wp, cfg.splat_radius_uv(), cfg.aspect_ratio,
                       slice(SPLAT_DX, SPLAT_DY + 1), row0=-ss._G_STENCIL, h_total=SHARDED_RES,
                       col0=-ss._GC, w_total=SHARDED_RES)
    dt = check._step_dts(check.per_sim_dts(b), b, cfg, device)[0]
    bounds = check.shard_bounds(h, w, ss._G_STENCIL, ss._GC)["corner"]
    r0, c0, wh, ww = kstencil.window(hp, wp, bounds)
    rows, cols = slice(r0, r0 + wh), slice(c0, c0 + ww)
    args = (vel, cfg.CURL, dt, vf, bounds)
    err, _ = check.compare(*(tuple(t[..., rows, cols] for t in fn(*args))
                             for fn in (kstencil.pre_pressure, kstencil.pre_pressure_plain)))
    assert err == 0.0, err
    n_active, n_rows = int((splats[..., 7] != 0).sum()), splats.shape[1]
    nbytes = b * (2 * 2 * wh * ww + 4 * n_rows * (wh + ww + 2) + 3 * 2 * wh * ww) + dt.numel() * 4
    flops = wh * ww * (2 * 2 * n_active + b * check._PRE_PRESSURE)
    rate = spin_rate()
    ms = queued_ms(lambda: kstencil.pre_pressure(*args), 20, rate)
    plain_ms = queued_ms(lambda: kstencil.pre_pressure_plain(*args), 3, rate)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    print(f"time   pre_pressure:bounded:b{b}:per-sim corner shard {hp}x{wp} bf16, window "
          f"{wh}x{ww}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}, {nbytes} B, {flops} flop); max_abs_err {err:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "by": by, "bytes": nbytes,
            "flops": flops, "max_abs_err": err}


def batch_spatial_phase(torch, check, cfgs, gpu: str, device, errors: dict,
                        sharded: dict) -> dict:
    """Phase 16b and 16c: the two new kernel forms against their plain
    versions (check.batched_bounded_cases, batched_f32_velocity_dye_cases)
    with their times; batch x spatial at the demo's cross grid (f32 and bf16
    RGB9E5, on BS_MESHES) and with the split phases forced; then at
    sharded_16384_bf16_2x2 with BS_FULL_PER_GROUP tenants a group."""
    from tpufluid_torch import (FluidConfig, init_batch, init_state,
                                make_batch_spatial_multi_step, make_batched_multi_step,
                                make_sharded_multi_step, shard_batch_spatial, shard_state,
                                swirl_trace)
    from tpufluid_torch.ops.cuda import build, floors
    from tpufluid_torch.parallel import sharded_step as ss

    ghosts = (ss._G_STENCIL, ss._GC)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        check_cases(torch, check, f"batch_spatial_{str(dtype)[6:]}",
                    check.batched_bounded_cases(device, dtype, ghosts, seed=7), errors,
                    exact=True)
    dye_cases = {}
    for name in ("demo_bfloat16_rgb9e5", "demo_bfloat16", "demo_float16"):
        dye_cases[name] = check.batched_f32_velocity_dye_cases(cfgs[name], seed=7, device=device)
        check_cases(torch, check, f"{name}:f32-velocity:batched", dye_cases[name], errors,
                    exact=True)
    # Times: the corner walls of both shard shapes, and the dye on the dye's
    # grid (the sharded step's form: the velocity resampled there).
    timing = {
        "pre_pressure": timing_phase(torch, check, [
            c for c in check.batched_bounded_cases(device, torch.bfloat16, ghosts, seed=7)
            if c.label.startswith("pre_pressure:corner:")]),
        "advect_dye": timing_phase(torch, check, [
            c for c in dye_cases["demo_bfloat16_rgb9e5"] if ":dye-grid:" in c.label])}

    out = {"demo": {}}
    launch_totals = {"pre_pressure": 0, "advect_dye": 0}
    for name, p12, fault in (("demo_float32", SHARDED_DEMO_BOUND, BS_F32_FAULT_BOUND),
                             ("demo_bfloat16_rgb9e5", None, BS_BF16_FAULT_BOUND)):
        for shape in BS_MESHES:
            r = batch_spatial_run(torch, check, name, cfgs[name], shape, p12, fault, gpu,
                                  device)
            out["demo"][f"{name}:{'x'.join(map(str, shape))}"] = r
            launch_totals["pre_pressure"] += r["launches"]["pre_pressure"]
            if name == "demo_bfloat16_rgb9e5":   # the f32 velocity beside the bf16 dye
                launch_totals["advect_dye"] += r["launches"]["advect_dye"]
    split = FluidConfig(SIM_RESOLUTION=BS_SPLIT[0], DYE_RESOLUTION=BS_SPLIT[1],
                        CANVAS_WIDTH=BS_SPLIT[0], CANVAS_HEIGHT=BS_SPLIT[0],
                        PRESSURE_ITERATIONS=20, MAX_SPLATS=8, OVERLAP_HALO=True).validate()
    r = batch_spatial_run(torch, check, f"split_{BS_SPLIT[0]}_{BS_SPLIT[1]}_float32", split,
                          BS_SPLIT_MESH, SHARDED_DEMO_BOUND, BS_F32_FAULT_BOUND, gpu, device)
    # Every phase split: three launches a phase where the unsplit step makes one.
    mono = sharded_launches(dataclasses.replace(split, OVERLAP_HALO=False), BS_SPLIT_MESH[1:])
    assert r["launches"] == {k: 3 * c * BS_SPLIT_MESH[0] * BS_STEPS for k, c in mono.items()}, \
        r["launches"]
    out["split"] = r
    launch_totals["pre_pressure"] += r["launches"]["pre_pressure"]

    # 16c: sharded_16384_bf16_2x2, BS_FULL_PER_GROUP tenants a group.
    cfg = batch_config(SHARDED_RES)
    mesh = bs_mesh(BS_FULL_MESH)
    nb = BS_FULL_MESH[0]
    b = nb * BS_FULL_PER_GROUP
    seq = np.stack([swirl_trace(cfg, BS_FULL_STEPS, seed=42 + i).batches for i in range(b)],
                   axis=1)
    dts = np.broadcast_to(check.per_sim_dts(b), (BS_FULL_STEPS, b))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = shard_batch_spatial(init_batch(cfg, b, device=device), mesh)
    multi = make_batch_spatial_multi_step(cfg, mesh)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = multi(start, dts, seq)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    del start
    per = {k: c * nb for k, c in sharded_launches(cfg, BS_FULL_MESH[1:]).items()}
    assert launches == {k: c * BS_FULL_STEPS for k, c in per.items()}, launches
    launch_totals["pre_pressure"] += launches["pre_pressure"]
    # The same steps again from the state reached (the allocator warm; the
    # result dropped), then torch.profiler over SHARDED_PROFILE_STEPS steps.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi(got, dts, seq)
    torch.cuda.synchronize()
    warm_secs = time.perf_counter() - t0
    box = [got]

    def one_step(t):
        box[0] = multi(box[0], dts[:1], seq[t % BS_FULL_STEPS:t % BS_FULL_STEPS + 1])

    _, other = floors.profile_calls(one_step, SHARDED_PROFILE_STEPS)
    del box
    kern, odev, idle = device_share(other, 1e3 * warm_secs / BS_FULL_STEPS)
    fields = ("velocity", "dye", "pressure")
    for i in range(b):
        g, k = divmod(i, BS_FULL_PER_GROUP)
        group = mesh.groups[g]
        one = make_sharded_multi_step(cfg, group)(
            shard_state(init_state(cfg, device=device), group), dts[:, i], seq[:, i])
        for r_, row in enumerate(one):
            for c, s in enumerate(row):
                assert all(torch.equal(getattr(got[g][r_][c], f)[k], getattr(s, f))
                           for f in fields), (i, r_, c)
        del one
        torch.cuda.empty_cache()
    truth = make_batched_multi_step(cfg, device=device)(init_batch(cfg, b, device=device), dts,
                                                        seq)
    torch.cuda.synchronize()

    def sim_field(i, f):   # one sim's field from its group's blocks
        g, k = divmod(i, BS_FULL_PER_GROUP)
        return torch.cat([torch.cat([getattr(s, f)[k] for s in row], dim=-1)
                          for row in got[g]], dim=-2)

    dep = unsharded_departure(torch, sim_field, truth, cfg, dts, seq, BS_FULL_STEPS, device,
                              SHARDED_16K_BOUND, BS_BF16_FAULT_BOUND)
    peak = torch.cuda.max_memory_allocated()
    del truth
    single_sps = sharded["rates"]["make_sharded_multi_step 2x2"]["steps_per_s"]
    full = {"sim_steps_per_s": b * BS_FULL_STEPS / secs, "step_ms": 1e3 * secs / BS_FULL_STEPS,
            "warm_sim_steps_per_s": b * BS_FULL_STEPS / warm_secs,
            "warm_step_ms": 1e3 * warm_secs / BS_FULL_STEPS, "kernels_ms": kern,
            "other_device_ms": odev, "idle": idle, "top_other_ops": other["top_other_ops"],
            "launches_a_step": {k: c for k, c in per.items()}, "launches": launches,
            "vs_unsharded": dep, "peak_bytes": peak, "single_sim_sharded_steps_per_s": single_sps}
    print(f"batch-spatial sharded_{SHARDED_RES}_bf16_2x2:b{b} {'x'.join(map(str, BS_FULL_MESH))} "
          f"on {gpu}: {b} sims ({BS_FULL_PER_GROUP} a group), {BS_FULL_STEPS} steps, per-sim dt "
          f"(cut: {BS_FULL_STEPS} steps, every group's 4 shards on "
          f"{torch.cuda.device_count()} card(s)): each sim equal to its single-sim sharded step "
          f"(0) and each unsharded sim to make_multi_step (0); vs make_batched_multi_step: "
          + "; ".join(f"{f} {v:.3e}" for f, v in dep["rel"].items())
          + f" of scale (<= {BS_BF16_FAULT_BOUND:.0e}; {phase12_note(dep)}); per sim: "
          + "; ".join(
              "/".join(f"{v:.2e}" for v in sim.values()) for sim in dep["per_sim"]) + "; "
          f"{full['sim_steps_per_s']:.2f} sim-steps/s ({full['step_ms']:.2f} ms a step of the "
          f"{b} sims; again from there {full['warm_sim_steps_per_s']:.2f}, "
          f"{full['warm_step_ms']:.2f} ms, of which kernels {kern:.2f} + other device "
          f"{odev:.2f} ms, {100 * idle:.1f}% idle; top other: " + "; ".join(
              f"{o['us']} us {o['op'][:40]}" for o in other["top_other_ops"][:3])
          + f") beside phase 12's single-sim sharded {single_sps:.2f} steps/s; launches a "
          f"step {per} ({sum(per.values())} = 2 x {sum(per.values()) // 2}); peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    del got
    torch.cuda.empty_cache()
    bounded = bounded_batched_timing(torch, check, cfg, seq, device)
    out.update(full=full, timing=timing, bounded=bounded, launches=launch_totals)
    return out


def dryrun_phase(torch, cfgs, gpu: str, device) -> dict:
    """Phase 16d: dryrun_multichip(DRYRUN_DEVICES) on the cards round
    robin, and make_auto_sharded_step against make_step over AUTO_STEPS
    steps at demo_float32 on a 2x2 mesh (0: the same step)."""
    from tpufluid_torch import (init_state, make_auto_sharded_step, make_step, shard_state,
                                swirl_trace)
    from tpufluid_torch.dryrun import dryrun_multichip
    from tpufluid_torch.parallel.mesh import gather_state

    t0 = time.perf_counter()
    dry = dryrun_multichip(DRYRUN_DEVICES)
    print(f"dryrun_multichip({DRYRUN_DEVICES}) on {gpu} ({torch.cuda.device_count()} card(s), "
          f"round robin) passed in {time.perf_counter() - t0:.1f} s: {json.dumps(dry)}")
    cfg = cfgs["demo_float32"]
    mesh = sharded_mesh(SHARDED_MESH)
    trace = swirl_trace(cfg, AUTO_STEPS, seed=42)
    auto, step = make_auto_sharded_step(cfg, mesh), make_step(cfg, device=device)
    shards, one = shard_state(init_state(cfg, device=device), mesh), init_state(cfg, device=device)
    for t in range(AUTO_STEPS):
        shards = auto(shards, trace.dts[t], trace.batches[t])
        one = step(one, trace.dts[t], trace.batches[t])
        assert states_equal(torch, gather_state(shards, device), one), t
    print(f"make_auto_sharded_step demo_float32 2x2: {AUTO_STEPS} steps equal to make_step (max "
          "abs err 0)")
    return {"dryrun": dry, "auto_max_abs_err": 0.0}


def drift_phase(gpu: str, device) -> dict:
    """Phase 16e: tools/fidelity_drift.run() at its defaults on the card;
    every number of every summary finite."""
    from tpufluid_torch.tools import fidelity_drift as fd

    t0 = time.perf_counter()
    summary = fd.run(device=device)
    print(f"fidelity drift on {gpu}: {fd.STEPS} steps at {fd.SIM}^2, record every "
          f"{fd.RECORD_EVERY}, trace seed {fd.TRACE_SEED}, {time.perf_counter() - t0:.1f} s; the "
          "JAX tool's keys final, vel_rel_l2_at_100, max_abs_ke_rel_diff, "
          "max_abs_dye_mass_rel_diff:")
    for name, s in summary.items():
        values = [v for k, v in s.items() if k != "final"]
        values += [v for k, v in s["final"].items() if k not in ("variant", "step")]
        assert all(math.isfinite(v) for v in values), (name, s)
        print(f"fidelity drift {name:12s} {json.dumps(s)}")
    return summary


def batch_mesh_phase(torch, check, cfgs, gpu: str, device, errors: dict, sharded: dict) -> dict:
    """Phase 16, the batch-mesh modes: 16a-16e."""
    return {"batch_dp": batch_dp_phase(torch, check, gpu, device),
            "batch_spatial": batch_spatial_phase(torch, check, cfgs, gpu, device, errors,
                                                 sharded),
            "dryrun": dryrun_phase(torch, cfgs, gpu, device),
            "drift": drift_phase(gpu, device)}


def batch_demo_phase(torch, check, gpu: str, device, errors: dict) -> dict:
    """Phase 17: tpufluid_torch.tools.batch_demo.main at its defaults (4
    sims at speeds 0.25-1 of 1/60 s, 96^2 sim, 192^2 dye and canvas, 360
    steps, a frame every 6), launches counted over the tool's run; its GIF;
    its frames and states bit-equal to the same loop through
    plain_batched_step and the plain batched render (contiguous splat rows
    a sim, where the tool passes one expanded view); each step and frame
    kernel at the demo's last state against its plain version and timed."""
    from PIL import Image

    from tpufluid_torch import init_batch
    from tpufluid_torch.batch import plain_batched_render, plain_batched_step
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.tools import batch_demo as demo

    args = demo.build_argparser().parse_args(["--out", str(DEMO_OUT)])
    cfg = demo.demo_config(args.sim_res, args.dye_res)
    n_frames, sims = args.steps // args.every, len(demo.SPEEDS)
    build.reset_launches()
    got = demo.main(["--out", str(DEMO_OUT)])
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    display = "display" if got["display_form"] == "staged" else "display_direct"
    want = {k: n * args.steps for k, n in expected_per_step(cfg).items()}
    want.update({"bloom_pyramid": n_frames, "sunrays": n_frames, "sunrays_blur": n_frames,
                 display: n_frames})
    assert launches == want, (launches, want)
    with Image.open(DEMO_OUT) as gif:
        gif_frames, gif_size = gif.n_frames, gif.size
    assert gif_frames == n_frames and gif_size == (2 * args.dye_res,) * 2, (gif_frames, gif_size)
    assert len(got["frames"]) == n_frames

    # The same loop through the plain versions, held bit for bit: the first
    # DEMO_HELD_FRAMES frames and the state there always, the whole run
    # where the first part's pace puts it within DEMO_PLAIN_BUDGET_S.
    dts, rows = demo.demo_inputs(cfg, args.steps, device)
    held_steps = DEMO_HELD_FRAMES * args.every
    *_, (_, _, tool_at) = demo.run(cfg, held_steps, args.every, device)
    state, frame = init_batch(cfg, sims, device=device), 0
    t0 = time.perf_counter()
    for t in range(args.steps):
        state = plain_batched_step(state, dts, rows[t].expand(sims, -1, -1).contiguous(), cfg)
        if (t + 1) % args.every == 0:
            g = demo.grid(plain_batched_render(state, cfg).cpu().numpy())
            assert np.array_equal(g, got["frames"][frame]), ("frame", frame)
            frame += 1
        if t + 1 == held_steps:
            assert states_equal(torch, state, tool_at), ("state", held_steps)
            pace = (time.perf_counter() - t0) / held_steps
            if pace * args.steps > DEMO_PLAIN_BUDGET_S:
                break
    plain_s = time.perf_counter() - t0
    whole = frame == n_frames
    if whole:
        assert states_equal(torch, state, got["state"]), ("state", args.steps)
    held = (f"the whole run ({args.steps} steps, {n_frames} frames)" if whole else
            f"the first {held_steps} steps and {frame} frames")
    assert bool(torch.isfinite(got["state"].velocity).all()) and float(got["state"].dye.max()) > 0

    cases = check.step_cases(got["state"], rows[-1].expand(sims, -1, -1), cfg, dts.cpu().numpy(),
                             ":demo") + check.batched_render_cases(got["state"], cfg)
    cases += check.sunrays_cases(got["state"], cfg, f":b{sims}")
    check_cases(torch, check, "batch_demo", cases, errors, exact=True)
    timing = timing_phase(torch, check, cases)
    # The run's kernels' device time: each step's and frame's spin-queued ms.
    device_s = 1e-3 * (args.steps * step_device_ms(timing) + n_frames * sum(
        timing[k]["ms"] for k in ("bloom_pyramid", "sunrays", display)))
    idle = 1 - device_s / got["seconds"]
    print(f"batch demo {sims} sims {cfg.SIM_RESOLUTION}/{cfg.DYE_RESOLUTION} f32, canvas "
          f"{cfg.CANVAS_WIDTH}x{cfg.CANVAS_HEIGHT}, {args.steps} steps, {n_frames} frames, display "
          f"{got['display_form']} on {gpu}: {got['seconds']:.3f} s, "
          f"{got['sim_steps_per_s']:.1f} sim-steps/s, {got['frames_per_s']:.2f} frames/s, "
          f"kernels' device {device_s:.4f} s ({100 * idle:.1f}% idle); launches {launches} ({sum(launches.values())}: "
          f"{sum(expected_per_step(cfg).values())} a step, 4 a frame); GIF {gif_frames} frames "
          f"of {gif_size[0]}x{gif_size[1]}; held to the plain loop bit for bit (max abs err 0) "
          f"over {held}, plain run {plain_s:.1f} s")
    for k, row in timing.items():
        print(f"batch demo {k:18s} spin-queued {row['ms']:.4f} ms for {sims} sims; bound "
              f"{row['bound_ms']:.4f} ms ({row['by']}), plain {row['plain_ms']:.4f} ms")
    return {"seconds": got["seconds"], "sim_steps_per_s": got["sim_steps_per_s"],
            "frames_per_s": got["frames_per_s"], "display_form": got["display_form"],
            "device_seconds": device_s, "idle": idle,
            "launches": launches, "gif": [gif_frames, *gif_size], "held": held,
            "plain_seconds": plain_s, "kernels": timing}


def demo_config_row(demo: dict, name: str) -> dict:
    """The kernels line's "batch_demo" entry of kernel ``name``: its timing
    at the demo's last state and its launches over the tool's run; none
    where the demo does not launch it."""
    if not demo["launches"].get(name):
        return {}
    row = demo["kernels"][name]
    return {"batch_demo": {**{f: row.get(f) for f in ("ms", "plain_ms", "bound_ms",
                                                     "max_abs_err")},
                           "launches": demo["launches"][name]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from tpufluid_torch.ops.cuda import advect, build, check
    from tpufluid_torch.ops.cuda.floors import spin_rate

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"setup: built {len(build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    ptxas = ptxas_report(build)
    regs = [f.get("registers", 0) for f in ptxas]
    frames = [f for f in ptxas if f.get("stack") or f.get("spill_stores") or f.get("spill_loads")]
    print(f"ptxas: {len(ptxas)} instances of {', '.join(PTXAS_LIBRARIES)}, "
          f"{min(regs)}-{max(regs)} registers, {len(frames)} with a stack frame or spills "
          "(the full report in out/chip_smoke.json)")
    for f in ptxas:
        if any(k in f["function"] for k in ("pre_pressure", "bloom", "display", "sunrays")):
            print(f"ptxas {f['function'][:90]}: {f.get('registers')} registers, "
                  f"{f.get('smem')} bytes static smem, {f.get('stack')} bytes stack frame, "
                  f"{f.get('spill_stores')} / {f.get('spill_loads')} bytes spill stores / loads")
    for f in frames:
        print(f"ptxas {f['function']}: {f}")
    gpu = gpu_line()
    print(gpu)

    cfgs = configs()
    errors = kernel_phase(torch, check, cfgs, device)
    project_phase(torch, device, errors)
    render_kernel_phase(torch, check, cfgs, device, errors)
    floors_kernel_phase(torch, check, device, errors)

    report, runs = {}, {}
    for name in ("demo_float32", "1024_bfloat16_rgb9e5"):
        cfg = cfgs[name]
        run = runs[name] = path_phase(torch, cfg, device)
        print(f"path {name}: {run['steps_per_s']:.1f} steps/s over {TIMED_STEPS} steps "
              f"(step median {run['step_ms_median']:.4f} ms, p95 {run['step_ms_p95']:.4f} ms); "
              f"launches {run['launches']}; first-{CHECK_STEPS}-step max err vs plain "
              f"{run['step_err']}")
        splats = torch.as_tensor(run["splats"])
        cases = check.step_cases(run["state"], splats, cfg)
        timing = timing_phase(torch, check, cases)
        dye_case = next(c for c in cases if c.label == "advect:dye")
        share = advect.dye_window_plan(*dye_case.args)["share"]
        timing["advect_dye"]["fit_share"] = share
        for label, k in (("advect:velocity", "advect"), ("advect:dye", "advect_dye")):
            lib_ms = check.grid_sample_ms(next(c for c in cases if c.label == label),
                                          spin_rate())
            timing[k]["library_ms"] = lib_ms
            print(f"time   grid_sample (library, {label[7:]} in {cfg.dtype}) {lib_ms:.4f} ms: "
                  "bilinear, border, no splat bump, no RGB9E5, no decay")
        print(f"time   advect_dye windows on the path's final state: {100 * share:.1f}% of "
              f"its {advect.DYE_TILE[0]}x{advect.DYE_TILE[1]} tiles fit {advect.DYE_SMEM} "
              "bytes of shared memory")
        print_pair(name, timing, gpu)
        device_total = step_device_ms(timing)
        step_ms = 1e3 / run["steps_per_s"]
        print(f"path {name}: step {step_ms:.4f} ms, kernels' device time "
              f"{device_total:.4f} ms ({100 * (1 - device_total / step_ms):.1f}% idle); "
              "per step: " + ", ".join(
                  f"{k} {run['launches'][k] // PATH_STEPS} launches {timing[k]['ms']:.4f} ms"
                  for k in MAIN_STEP_KERNELS)
              + f" (jacobi_project's ms its {run['launches']['jacobi_chunk'] // PATH_STEPS} "
              "chunk launch(es) and the fused one)")
        host = host_phase(torch, cfg, run)
        rend = render_path_phase(torch, check, cfg, run, device)
        frame_ms, tick_ms = 1e3 / rend["frames_per_s"], 1e3 / rend["ticks_per_s"]
        print(f"path {name} render: {rend['frames_per_s']:.1f} frames/s over {TIMED_FRAMES} "
              f"frames (median {rend['frame_ms_median']:.4f} ms, p95 "
              f"{rend['frame_ms_p95']:.4f} ms), device {rend['frame_device_ms']:.4f} ms a "
              f"frame ({100 * (1 - rend['frame_device_ms'] / frame_ms):.1f}% idle); "
              f"{rend['ticks_per_s']:.1f} ticks/s over {TIMED_FRAMES} ticks (median "
              f"{rend['tick_ms_median']:.4f} ms, p95 {rend['tick_ms_p95']:.4f} ms), device "
              f"{rend['tick_device_ms']:.4f} ms a tick "
              f"({100 * (1 - rend['tick_device_ms'] / tick_ms):.1f}% idle); launches "
              f"{rend['launches']}; frame max err vs plain render {rend['frame_err']:.3e}; "
              "per frame: " + ", ".join(
                  f"{k} {rend['launches'][k] // TIMED_FRAMES} launches {r['ms']:.4f} ms"
                  for k, r in rend["kernels"].items()))
        report[name] = {"steps_per_s": run["steps_per_s"], "step_ms": step_ms,
                        "host_ms_cprofile": host,
                        "step_ms_median": run["step_ms_median"],
                        "step_ms_p95": run["step_ms_p95"],
                        "kernel_device_ms": device_total,
                        "launches": {**run["launches"], **rend["launches"]},
                        "step_err": run["step_err"],
                        "kernels": {**timing, **rend["kernels"]},
                        "render": {k: v for k, v in rend.items()
                                   if k not in ("kernels", "launches")}}

    small = small_canvas_phase(torch, check, cfgs, gpu, device, errors)
    floors_run = floors_phase(torch, check, cfgs[FLOORS_CONFIG], runs[FLOORS_CONFIG],
                              report[FLOORS_CONFIG]["kernels"], gpu, device)
    horizon = long_horizon_phase(torch, check, gpu, device, errors)
    batched = batched_phase(torch, check, cfgs, gpu, device, errors)
    frames = batched_frame_phase(torch, check, cfgs, gpu, device, errors)
    sharded = sharded_phase(torch, check, cfgs, gpu, device, errors)
    packed = packed_phase(torch, check, gpu, device, errors)
    app_server = {"app": app_phase(torch, gpu, device),
                  "server": server_phase(torch, check, gpu, device)}
    fleet = fleet_phase(torch, check, gpu, device)
    batch_mesh = batch_mesh_phase(torch, check, cfgs, gpu, device, errors, sharded)
    batch_demo = batch_demo_phase(torch, check, gpu, device, errors)

    kernels = []
    for k in build.KERNELS.values():
        if k.name == "display_direct":   # launched at small canvases only, below
            continue
        if k.name == "sunrays_blur":   # timed and compared with the march, the sunrays row
            continue
        if k.name in FLOORS_KERNELS:   # launched by the profiling path only
            row, launches = floors_run["kernels"][k.name], floors_run["launches"][k.name]
            err = max(errors[("floors", k.name)], row["max_abs_err"])
            per_config = {}
        else:
            row, launches = report["demo_float32"]["kernels"][k.name], \
                report["demo_float32"]["launches"][k.name]
            if k.name == "gradient_subtract":   # the sharded step's alone (phase 12)
                launches = sharded["launches"][k.name]
                assert launches > 0 and report["demo_float32"]["launches"][k.name] == 0
            err = errors[("demo_float32", k.name)]
            per_config = {c: {**{f: r["kernels"][k.name].get(f) for f in
                                 ("ms", "plain_ms", "bound_ms", "max_abs_err", "library_ms")},
                              "launches": r["launches"][k.name]}
                          for c, r in report.items()}
            if k.name in horizon["kernels"]:
                row4096 = horizon["kernels"][k.name]
                per_config["4096_bfloat16_rgb9e5"] = {
                    **{f: row4096.get(f) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
                    "launches": horizon["launches"].get(k.name, 0)}
            for c, run in [*batched.items(), *frames.items()]:   # step, render kernels
                if k.name in run["kernels"]:
                    per_config[c] = {
                        **{f: run["kernels"][k.name].get(f)
                           for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
                        "single_sim_ms": run["single_sim_kernels"][k.name],
                        "launches": run["launches"].get(k.name, 0)}
            fk = fleet["programs"]["kernels"]
            if k.name in fk:   # the fleet's timed ticks, all three programs
                per_config[FLEET_CELL] = {
                    **{f: fk[k.name].get(f) for f in ("ms", "plain_ms", "bound_ms",
                                                      "max_abs_err")},
                    "launches": fleet["programs"]["launches"].get(k.name, 0)}
                per_config["fleet_server_default"] = {
                    "launches": fleet["server"]["launches"].get(k.name, 0)}
            per_config.update(demo_config_row(batch_demo, k.name))
        kernels.append({
            "name": k.name, "route": "cuda", "source": f"tpufluid_torch/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": launches, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["by"], "library_ms": row.get("library_ms"), "configs": per_config,
        })
    # The display's direct form: launched where the staged window does not
    # fit, here the server's ticks at a small canvas (phase 6b).
    row, k = small["kernels"]["display_direct"], build.KERNELS["display_direct"]
    kernels.append({
        "name": k.name, "route": "cuda", "source": f"tpufluid_torch/csrc/{k.source}.cu",
        "replaces": k.replaces, "launches": small["launches"]["display_direct"],
        "max_abs_err": max(e for (c, n), e in errors.items() if n == k.name),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["by"], "library_ms": None,
        "configs": {SMALL_SERVER_CANVAS: {"launches": small["launches"]["display_direct"]},
                    SMALL_APP_CANVAS: {"launches": small["app_launches"]["display_direct"]},
                    **demo_config_row(batch_demo, k.name),
                    **{f"{c}:forced": {"ms": f["direct"], "staged_ms": f["staged"]}
                       for c, f in small["forms"].items()}},
    })
    # pre_pressure's true-wall form: launched by the sharded step alone.
    b = sharded["bounded"]
    kernels.append({
        "name": "pre_pressure:bounded", "route": "cuda", "source": "tpufluid_torch/csrc/stencil.cu",
        "replaces": build.KERNELS["pre_pressure"].replaces, "launches": b["launches"],
        "max_abs_err": b["max_abs_err"], "ms": b["ms"], "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"], "bound_by": b["by"], "library_ms": None,
        "configs": {f"sharded_{SHARDED_RES}_bf16_2x2": {"window_copy_ms": b["window_copy_ms"],
                                                        "launches": b["launches"]}},
    })
    # The packed forms: launched by the packed fleet alone. The standalone
    # gradient subtract's packed form is compared in phase 13, but no path
    # launches it (the packed step's solve ends in jacobi_project).
    main = packed[PACKED_MAIN]
    for k in build.KERNELS.values():
        if k.name not in main["kernels"] or not main["launches"].get(k.name):
            continue
        row = main["kernels"][k.name]
        kernels.append({
            "name": f"{k.name}:packed", "route": "cuda",
            "source": f"tpufluid_torch/csrc/{k.source}.cu", "replaces": k.replaces,
            "launches": main["launches"][k.name],
            "max_abs_err": max(e for (c, n), e in errors.items()
                               if n == k.name and ":packed" in c),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["by"], "library_ms": row.get("library_ms"),
            "configs": {c: {"ms": r["kernels"][k.name]["ms"],
                            "batched_ms": r["batched_kernels"][k.name]["ms"],
                            "bound_ms": r["kernels"][k.name]["bound_ms"],
                            "plain_ms": r["kernels"][k.name]["plain_ms"],
                            "launches": r["launches"][k.name]} for c, r in packed.items()},
        })
    # The batched forms of phase 16: pre_pressure's true walls with a
    # per-sim dt table, advect_dye's float32 velocity beside a 16-bit dye;
    # launches counted in the batch x spatial runs (16b, 16c).
    bs = batch_mesh["batch_spatial"]
    b, dye = bs["bounded"], bs["timing"]["advect_dye"]["advect_dye"]
    for name, kernel, row, err, cfg_rows in (
            ("pre_pressure:bounded:batched", "pre_pressure", b,
             max([b["max_abs_err"]] + [e for (c, n), e in errors.items()
                                       if c.startswith("batch_spatial_")]),
             {f"sharded_{SHARDED_RES}_bf16_2x2:b{BS_FULL_PER_GROUP}": {
                 "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"]},
              "check_corners_b3": {f: bs["timing"]["pre_pressure"]["pre_pressure"][f]
                                   for f in ("ms", "plain_ms", "bound_ms")}}),
            ("advect_dye:f32-velocity:batched", "advect_dye", dye,
             max(e for (c, n), e in errors.items() if c.endswith(":f32-velocity:batched")),
             {"demo_bfloat16_rgb9e5:b3": {f: dye[f] for f in ("ms", "plain_ms", "bound_ms")}})):
        launches = bs["launches"][kernel]
        assert launches > 0, (name, launches)
        k = build.KERNELS[kernel]
        kernels.append({
            "name": name, "route": "cuda", "source": f"tpufluid_torch/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": launches, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["by"],
            "library_ms": None, "configs": cfg_rows})
    out_dir = Path("out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"gpu": gpu, "paths": report, "ptxas": ptxas,
         "kernel_errors": {f"{c}/{k}": e for (c, k), e in errors.items()},
         "small_canvas": small, "floors": floors_run,
         "long_horizon": horizon, "batched": batched, "batched_frames": frames,
         "sharded": sharded, "packed": packed, "app_server": app_server, "fleet": fleet,
         "batch_mesh": batch_mesh, "batch_demo": batch_demo, "kernels": kernels}, indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
