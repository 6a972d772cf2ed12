#!/usr/bin/env python3
"""Smoke test of tpufluid_torch on one NVIDIA GPU (sm_90a): the quickest
proof that the port builds and runs its simulation step and its render on
the card.

    python3 chip_smoke.py

1. Setup: builds the CUDA kernels from tpufluid_torch/csrc (one nvcc per
   source, all at once) and prints the card's name and power limit.
2. Kernel phase: every kernel call of a step (check.step_cases) against its
   plain PyTorch version on the same inputs, at the main path's shapes —
   demo default (sim 128x228, dye 1024x1820) and 1024x1024 — in float32,
   bfloat16 with and without RGB9E5, and float16. Prints each max error
   beside its tolerance and fails past it.
3. Path phase: the port's make_multi_step over a swirl_trace, 300 steps
   each: the demo default in float32 and 1024x1024 in bfloat16 (RGB9E5 on).
   Launch counts are zeroed just before each run and read just after; each
   kernel must have launched its expected count per step. The first 3 steps
   must match the plain step run on the same GPU tensors, and the state must
   stay finite with dye >= 0.
4. Timing: steps/s of the last 200 steps of each run, stepped one
   make_step call at a time with a CUDA event between steps (median and
   95th percentile of the 200 step times beside the rate), then
   each kernel's device time per step on the run's final state (launches
   queued behind a spin kernel, so host launch cost is hidden) beside its
   plain version's time and its bound: max(bytes / 3.35 TB/s,
   float32 operations / 67 TFLOP/s), the H100 SXM's published peaks; last
   the host time of the step's Python layers under cProfile.
5. Render kernel phase: every kernel call of a frame (check.render_cases:
   the bloom chain's 14 stages and the display) against its plain version,
   at both grids' canvas in every dtype of phase 2; then, in float32 and
   bf16 (RGB9E5), the flag variants (SHADING, BLOOM, SUNRAYS each off), the
   display without dither and with compose=False, the capture size and the
   server's 360x640 tick. Prints each max error beside its tolerance and
   fails past it.
6. Render path phase, on each path's final state: one make_render frame
   with the launch counts zeroed just before and read just after (2 x mips
   bloom_blur4 stages, 1 display, no step kernel), held against the plain
   render on the same GPU tensors; the frame must be finite, opaque and not
   all background, and a transparent capture must have alpha = max(rgb).
   Then frames/s of make_render over 200 frames and ticks/s of
   make_step_and_render over 200 ticks (counts zeroed before each run and
   checked after), each with its median and p95 and its device time per
   frame (queued behind a spin kernel, so the idle share is 1 - device /
   frame time), each render kernel's device time per frame beside its
   plain version's and its bound, and the host time of the render's Python
   layers under cProfile.
7. Floors kernel phase: the three microbenchmark kernels (floor_taa,
   floor_roll, floor_sweep; check.floors_cases) against their plain
   versions at the TPU microbenchmarks' default shapes (measure_roll_rate
   at (2, 96, 384)) and at ragged ones, on the microbenchmarks' inputs and
   on random ones (check.random_floors_cases: row-varying gather indices,
   a sweep field that is not uniform): uint32 words bit-equal, the float32
   sweep within tolerance, each launch counted.
8. Floors phase, on the 1024x1024 bfloat16 (RGB9E5) path's final state
   (bench.py config 3), launch counts zeroed just before and read just
   after: the card's memory bandwidth, the three reference rates,
   profile_step_kernels (torch.profiler over 30 steps: each kernel's own
   device time a step, printed beside phase 4's spin-queued time, its event
   count equal to its launch count) and one `floors {...}` JSON line of
   floor_report; then the three kernels' device time beside their plain
   version's and their bound.
9. Long-horizon phase: tpufluid_torch.tools.long_horizon at 4096x4096
   bfloat16 (RGB9E5), 1500 steps (300 with splats) in chunks of 50, launch
   counts zeroed before and checked after; it must report ok with no
   non-finite value (its output goes to out/long_horizon_4096/).

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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores

PATH_STEPS = 300               # per config; steps/s over the last TIMED_STEPS
TIMED_STEPS = 200
CHECK_STEPS = 3                # compared against the plain step
EXPECTED_PER_STEP = {"splat_curl": 1, "confine_divergence": 1, "jacobi_sweep": 20,
                     "gradient_subtract": 1, "advect": 2}
RENDER_KERNELS = ("bloom_blur4", "display")
TIMED_FRAMES = 200             # make_render frames and make_step_and_render ticks
FLOORS_KERNELS = ("floor_taa", "floor_roll", "floor_sweep")
FLOORS_CONFIG = "1024_bfloat16_rgb9e5"    # bench.py config 3, where bench.py reports floors
PROFILE_STEPS = 30                        # profile_step_kernels' default
LONG_HORIZON_STEPS = 1500
LONG_HORIZON_OUT = Path("out/long_horizon_4096")
LONG_HORIZON_ARGS = ["--res", "4096", "--dtype", "bfloat16", "--steps", str(LONG_HORIZON_STEPS),
                     "--splat-steps", "300", "--chunk", "50", "--out", str(LONG_HORIZON_OUT)]


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def kernel_phase(torch, check, cfgs, device) -> dict:
    """Max abs error per (config, case); asserts each within tolerance."""
    errors = {}
    for name, cfg in cfgs.items():
        state, splats = check.random_state(cfg, seed=7, device=device)
        for case in check.step_cases(state, splats, cfg):
            err, tol = check.compare(case.run(), case.run(plain=True))
            torch.cuda.synchronize()
            print(f"kernel {name:22s} {case.label:20s} max_abs_err {err:.3e}  tol {tol:.3e}")
            assert err <= tol, f"{case.label} on {name}: {err} > {tol}"
            key = (name, case.kernel_name)
            errors[key] = max(errors.get(key, 0.0), err)
    return errors


def frame_times(torch, fn, n: int):
    """fn(k) for k < n with a CUDA event after each call -> (calls per s,
    median ms, nearest-rank 95th percentile ms: n/20 calls lie beyond it)."""
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for k in range(n):
        fn(k)
        events[k + 1].record()
    events[-1].synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return (n / (events[0].elapsed_time(events[-1]) / 1e3), ms[len(ms) // 2],
            ms[math.ceil(0.95 * len(ms)) - 1])


def path_phase(torch, cfg, device) -> dict:
    """Drive make_multi_step, then make_step, over a swirl trace; return
    the launch counts, the step rate and the step-time distribution."""
    from tpufluid_torch import init_state, make_multi_step, make_step, swirl_trace
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.step import plain_step

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

    steps_per_s, step_median, step_p95 = frame_times(torch, one, TIMED_STEPS)
    state = box[0]
    launches = {k: v.launches for k, v in build.KERNELS.items()}

    for k, per_step in EXPECTED_PER_STEP.items():
        assert launches[k] == per_step * PATH_STEPS, (k, launches[k], per_step * PATH_STEPS)
    v, d, p = (x.float() for x in (state.velocity, state.dye, state.pressure))
    assert all(bool(torch.isfinite(x).all()) for x in (v, d, p)), "non-finite state"
    assert float(d.min()) >= 0.0, "negative dye"
    assert float(v.abs().max()) > 0.0 and float(d.max()) > 0.0, "nothing moved"
    return {"state": state, "splats": trace.batches[-1], "launches": launches,
            "steps_per_s": steps_per_s, "step_err": step_err,
            "step_ms_median": step_median, "step_ms_p95": step_p95}


def device_ms(torch, fn, reps: int, cycles_per_ms: float) -> float:
    """Device time of one fn() call: ``reps`` calls queued behind a spin
    kernel long enough to cover their enqueue, between CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(cycles_per_ms * (2 * enqueue_ms + 5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def spin_rate(torch) -> float:
    """GPU spin-kernel cycles per millisecond."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def timing_phase(torch, check, cases) -> dict:
    """Per kernel: device ms, plain ms and bound ms summed over ``cases``
    (one step's or one frame's calls)."""
    rate = spin_rate(torch)
    out = {}
    for case in cases:
        kernel = device_ms(torch, case.run, 20, rate)
        plain = device_ms(torch, lambda: case.run(plain=True), 3, rate)
        bound = 1e3 * max(case.nbytes / HBM_BYTES_PER_S, case.flops / F32_FLOPS_PER_S)
        by = "bytes" if case.nbytes / HBM_BYTES_PER_S >= case.flops / F32_FLOPS_PER_S \
            else "operations"
        err, tol = check.compare(case.run(), case.run(plain=True))
        assert err <= tol, f"{case.label} on the path's state: {err} > {tol}"
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


def render_kernel_phase(torch, check, cfgs, device, errors: dict) -> None:
    """Every kernel call of a frame against its plain version: at each
    config's canvas, then the variants at the two path configs. Adds each
    max abs error to ``errors`` per (config, kernel); asserts each within
    tolerance."""
    def run(name, cfg, label, state, **kw):
        for case in check.render_cases(state, cfg, **kw):
            err, tol = check.compare(case.run(), case.run(plain=True))
            torch.cuda.synchronize()
            print(f"kernel {name:22s} {label:14s} {case.label:15s} max_abs_err {err:.3e}  "
                  f"tol {tol:.3e}")
            assert err <= tol, f"{case.label} on {name} {label}: {err} > {tol}"
            key = (name, case.kernel_name)
            errors[key] = max(errors.get(key, 0.0), err)

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


def render_path_phase(torch, check, cfg, run, device) -> dict:
    """Render the path's final state through make_render and
    make_step_and_render; return launch counts, rates, device times and
    the render kernels' timing."""
    from tpufluid_torch import capture_frame, make_render, make_step_and_render, swirl_trace
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.render import plain_render

    state = run["state"]
    render = make_render(cfg, device=device)
    n_mips = len(cfg.bloom_mip_sizes())
    per_frame = {"bloom_blur4": 2 * n_mips if n_mips >= 2 else 0, "display": 1}

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
    fps, frame_med, frame_p95 = frame_times(torch, lambda k: render(state), TIMED_FRAMES)
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
    tps, tick_med, tick_p95 = frame_times(torch, one_tick, TIMED_FRAMES)
    tick_launches = {k: v.launches for k, v in build.KERNELS.items()}
    for k, n in {**EXPECTED_PER_STEP, **per_frame}.items():
        assert tick_launches[k] == n * TIMED_FRAMES, (k, tick_launches[k])
    pixels = one_tick(0)
    assert pixels.dtype == torch.uint8 and pixels.shape == (cfg.CANVAS_HEIGHT,
                                                           cfg.CANVAS_WIDTH, 3)

    # One frame (about 400 launches, most of them the sunrays' PyTorch ops)
    # or one tick behind the spin kernel: the device's queue of pending
    # launches holds about a thousand, and a host that blocks on a full queue
    # would be timed with the device. The tick's splats are put on the card
    # first: their copy from the host would wait for the spin.
    rate = spin_rate(torch)
    frame_device = device_ms(torch, lambda: render(state), 1, rate)
    splats = torch.as_tensor(trace.batches[0], device=device)
    tick_device = device_ms(torch, lambda: tick(state, trace.dts[0], splats), 1, rate)
    timing = timing_phase(torch, check, check.render_cases(state, cfg))
    host = host_profile(torch, lambda: render(state), 50, RENDER_HOST_FUNCS, "frame")
    return {"frame_err": err, "host_ms_cprofile": host, "frames_per_s": fps,
            "frame_ms_median": frame_med, "frame_ms_p95": frame_p95,
            "frame_device_ms": frame_device,
            "ticks_per_s": tps, "tick_ms_median": tick_med, "tick_ms_p95": tick_p95,
            "tick_device_ms": tick_device,
            "launches": {k: frame_launches[k] for k in RENDER_KERNELS},
            "tick_launches": tick_launches, "kernels": timing}


HOST_FUNCS = {  # (module file, function) -> label, for the host profile
    ("step.py", "_step"): "step (all)",
    ("splat.py", "splat_factors"): "splat_factors x2",
    ("stencil.py", "pre_pressure"): "pre_pressure",
    ("jacobi.py", "jacobi_pressure"): "jacobi_pressure",
    ("stencil.py", "gradient_subtract"): "gradient_subtract",
    ("advect.py", "advect"): "advect x2",
    ("build.py", "__call__"): "Kernel.__call__ (ctypes)",
}


RENDER_HOST_FUNCS = {  # the same, for the render profile
    ("render.py", "_render"): "render (all)",
    ("sunrays.py", "apply_sunrays"): "apply_sunrays",
    ("sampling.py", "sample_affine"): "sample_affine (all callers)",
    ("bloom.py", "bloom_chain"): "bloom_chain (resample + 14 launches)",
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
    the ragged shapes; adds each max abs error to ``errors``."""
    from tpufluid_torch.ops.cuda import build

    for ragged in (False, True):
        for case in check.floors_cases(device, ragged) + check.random_floors_cases(device, ragged):
            before = build.KERNELS[case.kernel_name].launches
            err, tol = check.compare(case.run(), case.run(plain=True))
            torch.cuda.synchronize()
            print(f"kernel floors {case.label:20s} max_abs_err {err:.3e}  tol {tol:.3e}")
            assert err <= tol, f"{case.label}: {err} > {tol}"
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
    return {"device_bw_gbps": bw, "rolls_per_s": rolls, "report": report,
            "launches": launches,
            "kernels": timing_phase(torch, check, check.floors_cases(device))}


def long_horizon_phase(gpu: str) -> dict:
    """The long-horizon tool at 4096x4096 bf16 through the kernels; its
    launches and its ok."""
    from tpufluid_torch.ops.cuda import build
    from tpufluid_torch.tools import long_horizon

    LONG_HORIZON_OUT.mkdir(parents=True, exist_ok=True)
    build.reset_launches()
    with open(LONG_HORIZON_OUT / "stdout.txt", "w") as log, contextlib.redirect_stdout(log):
        summary = long_horizon.main(LONG_HORIZON_ARGS)
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    for k, per_step in EXPECTED_PER_STEP.items():
        assert launches.get(k) == per_step * LONG_HORIZON_STEPS, (k, launches.get(k))
    assert summary["ok"] and summary["nonfinite_total"] == 0, summary
    print(f"long horizon ok: 4096x4096 bfloat16 (RGB9E5) on {gpu}, {LONG_HORIZON_STEPS} "
          f"steps: {summary['steps_per_s_compute_median']} steps/s (median chunk), "
          f"{summary['steps_per_s']} steps/s wall; nonfinite {summary['nonfinite_total']}, "
          f"backtrace peak {summary['backtrace_speed_peak']} <= "
          f"{summary['halo_contract_speed']}, energy decay {summary['energy_decay_ratio']}, "
          f"max uptick {summary['energy_max_uptick_frac']}; launches {launches}")
    return {"summary": summary, "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from tpufluid_torch.ops.cuda import build, check

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"setup: built {len(build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    gpu = gpu_line()
    print(gpu)

    cfgs = configs()
    errors = kernel_phase(torch, check, cfgs, device)
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
        timing = timing_phase(torch, check, check.step_cases(
            run["state"], torch.as_tensor(run["splats"]), cfg))
        device_total = sum(r["ms"] for r in timing.values())
        step_ms = 1e3 / run["steps_per_s"]
        print(f"path {name}: step {step_ms:.4f} ms, kernels' device time "
              f"{device_total:.4f} ms ({100 * (1 - device_total / step_ms):.1f}% idle); "
              "per step: " + ", ".join(
                  f"{k} {run['launches'][k] // PATH_STEPS} launches {r['ms']:.4f} ms"
                  for k, r in timing.items()))
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
                        "step_err": run["step_err"], "kernels": {**timing, **rend["kernels"]},
                        "render": {k: v for k, v in rend.items()
                                   if k not in ("kernels", "launches")}}

    floors_run = floors_phase(torch, check, cfgs[FLOORS_CONFIG], runs[FLOORS_CONFIG],
                              report[FLOORS_CONFIG]["kernels"], gpu, device)
    horizon = long_horizon_phase(gpu)

    kernels = []
    for k in build.KERNELS.values():
        if k.name in FLOORS_KERNELS:   # launched by the profiling path only
            row, launches = floors_run["kernels"][k.name], floors_run["launches"][k.name]
            err = max(errors[("floors", k.name)], row["max_abs_err"])
            per_config = {}
        else:
            row, launches = report["demo_float32"]["kernels"][k.name], \
                report["demo_float32"]["launches"][k.name]
            err = errors[("demo_float32", k.name)]
            per_config = {c: {**{f: r["kernels"][k.name][f] for f in
                                 ("ms", "plain_ms", "bound_ms", "max_abs_err")},
                              "launches": r["launches"][k.name]}
                          for c, r in report.items()}
        kernels.append({
            "name": k.name, "route": "cuda", "source": f"tpufluid_torch/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": launches, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["by"], "library_ms": None, "configs": per_config,
        })
    out_dir = Path("out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"gpu": gpu, "paths": report,
         "kernel_errors": {f"{c}/{k}": e for (c, k), e in errors.items()},
         "floors": floors_run,
         "long_horizon": horizon, "kernels": kernels}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
