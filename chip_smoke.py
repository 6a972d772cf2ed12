#!/usr/bin/env python3
"""Smoke test of tpufluid_torch on one NVIDIA GPU (sm_90a): the quickest
proof that the port builds and runs its simulation step on the card.

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

Prints a JSON line {"kernels": [...]}, the card's name and power limit, and
last {"ok": true, "device": {...}}; writes details to
out/chip_smoke.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

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
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    events[0].record()
    for k in range(warm, PATH_STEPS):
        state = step(state, trace.dts[k], trace.batches[k])
        events[k - warm + 1].record()
    events[-1].synchronize()
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    steps_per_s = TIMED_STEPS / (events[0].elapsed_time(events[-1]) / 1e3)

    for k, per_step in EXPECTED_PER_STEP.items():
        assert launches[k] == per_step * PATH_STEPS, (k, launches[k], per_step * PATH_STEPS)
    v, d, p = (x.float() for x in (state.velocity, state.dye, state.pressure))
    assert all(bool(torch.isfinite(x).all()) for x in (v, d, p)), "non-finite state"
    assert float(d.min()) >= 0.0, "negative dye"
    assert float(v.abs().max()) > 0.0 and float(d.max()) > 0.0, "nothing moved"
    return {"state": state, "splats": trace.batches[-1], "launches": launches,
            "steps_per_s": steps_per_s, "step_err": step_err,
            "step_ms_median": step_ms[len(step_ms) // 2],
            # nearest-rank 95th percentile: 10 of the 200 steps lie beyond it
            "step_ms_p95": step_ms[math.ceil(0.95 * len(step_ms)) - 1]}


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


def timing_phase(torch, check, cfg, run) -> dict:
    """Per kernel: device ms per step, plain ms per step, bound ms per step."""
    cases = check.step_cases(run["state"], torch.as_tensor(run["splats"]), cfg)
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


HOST_FUNCS = {  # (module file, function) -> label, for the host profile
    ("step.py", "_step"): "step (all)",
    ("splat.py", "splat_factors"): "splat_factors x2",
    ("stencil.py", "pre_pressure"): "pre_pressure",
    ("jacobi.py", "jacobi_pressure"): "jacobi_pressure",
    ("stencil.py", "gradient_subtract"): "gradient_subtract",
    ("advect.py", "advect"): "advect x2",
    ("build.py", "__call__"): "Kernel.__call__ (ctypes)",
}


def host_phase(torch, cfg, run, steps: int = 50) -> dict:
    """Host time per step of the step's Python layers, under cProfile
    (which inflates every Python call; read the shares, not the sums)."""
    import cProfile
    import pstats

    from tpufluid_torch import make_step

    step = make_step(cfg)
    state, splats = run["state"], run["splats"]
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        state = step(state, 1.0 / 60.0, splats)
    torch.cuda.synchronize()
    prof.disable()
    out = {}
    for (path, _, fn), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        label = HOST_FUNCS.get((Path(path).name, fn))
        if label and "tpufluid_torch" in path:
            out[label] = out.get(label, 0.0) + 1e3 * cum / steps
    print("host ms per step under cProfile: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(out.items(), key=lambda kv: -kv[1])))
    return out


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

    report = {}
    for name in ("demo_float32", "1024_bfloat16_rgb9e5"):
        cfg = cfgs[name]
        run = path_phase(torch, cfg, device)
        print(f"path {name}: {run['steps_per_s']:.1f} steps/s over {TIMED_STEPS} steps "
              f"(step median {run['step_ms_median']:.4f} ms, p95 {run['step_ms_p95']:.4f} ms); "
              f"launches {run['launches']}; first-{CHECK_STEPS}-step max err vs plain "
              f"{run['step_err']}")
        timing = timing_phase(torch, check, cfg, run)
        device_total = sum(r["ms"] for r in timing.values())
        step_ms = 1e3 / run["steps_per_s"]
        print(f"path {name}: step {step_ms:.4f} ms, kernels' device time "
              f"{device_total:.4f} ms ({100 * (1 - device_total / step_ms):.1f}% idle); "
              "per step: " + ", ".join(
                  f"{k} {run['launches'][k] // PATH_STEPS} launches {r['ms']:.4f} ms"
                  for k, r in timing.items()))
        host = host_phase(torch, cfg, run)
        report[name] = {"steps_per_s": run["steps_per_s"], "step_ms": step_ms,
                        "host_ms_cprofile": host,
                        "step_ms_median": run["step_ms_median"],
                        "step_ms_p95": run["step_ms_p95"],
                        "kernel_device_ms": device_total, "launches": run["launches"],
                        "step_err": run["step_err"], "kernels": timing}

    kernels = []
    for k in build.KERNELS.values():
        demo = report["demo_float32"]["kernels"][k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": f"tpufluid_torch/csrc/{k.source}.cu",
            "replaces": k.replaces,
            "launches": report["demo_float32"]["launches"][k.name],
            "max_abs_err": errors[("demo_float32", k.name)],
            "ms": demo["ms"], "plain_ms": demo["plain_ms"], "bound_ms": demo["bound_ms"],
            "bound_by": demo["by"], "library_ms": None,
            "configs": {c: {**{f: r["kernels"][k.name][f] for f in
                               ("ms", "plain_ms", "bound_ms", "max_abs_err")},
                            "launches": r["launches"][k.name]}
                        for c, r in report.items()},
        })
    out_dir = Path("out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"gpu": gpu, "paths": report,
         "kernel_errors": {f"{c}/{k}": e for (c, k), e in errors.items()},
         "kernels": kernels}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
