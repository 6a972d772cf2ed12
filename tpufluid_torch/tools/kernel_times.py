"""Device ms of each step and frame kernel call on the card, to compare two
checkouts on one card.

    python3 tpufluid_torch/tools/kernel_times.py TAG [--reps 5] [--configs demo,1024]

At the demo's defaults (float32) and at 1024x1024 and 4096x4096 (bfloat16
with the RGB9E5 dye), on check.random_state (seed 7), times every kernel call
of one step (check.step_cases; a checkout with check.part_cases, the dye's
prepare alone too) and the frame's bloom pyramid, sunrays (where the
checkout has the kernel) and display at the canvas (render_cases); at the
serving cells serving_256_b16 (16 sims of 256^2), serving_1024_b8 (8 of
1024^2) and packed_288_b64 (64 of 288^2), bf16 RGB9E5, every kernel call
of a lock-step batched step (check.batched_step_cases, labels
":b<B>:lockstep") and of a packed fleet step on the same sims
(check.packed_step_cases, ":packed:b<B>:lockstep").
Where the step's solve ends in the fused jacobi_project, its case
("jacobi_project") is timed beside the standalone pair it replaces
("jacobi" and "gradient_subtract", the cases after the step's), which are
a parent checkout's step calls. Then, at every config, the dye's advection on a
flow state, labelled ":flow": the state after FLOW_STEPS steps of
swirl_trace (seed 42, a fleet's sim i seed 42 + i) through the kernel step
(make_multi_step, make_batched_multi_step; the packed rows on the same sims
packed), with the trace's last splat batch. Each time is 20 calls queued
behind a spin kernel, so host launch cost is hidden, the median of
``--reps`` such runs. Run as a file, it measures the tpufluid_torch that
PYTHONPATH names, so one copy of the script times two checkouts, in the
order parent, change, change, parent:

    cd path/to/other/checkout && PYTHONPATH=. python3 path/to/kernel_times.py parent

Prints one line per call: ``KT TAG config case ms``, and ``BOUND TAG config
case bound_ms plain_ms`` beside it: the call's bound, max(bytes / 3.35 TB/s,
operations / 67 TFLOP/s) from the case's work model, and for the frame's
calls the plain version's ms (one call queued); where the checkout has
them, ``KT TAG config grid_sample:case ms`` (one torch grid_sample call on
each advection case's source, check.grid_sample_ms: the library yardstick)
and ``FIT TAG config case share`` (the share of the dye kernel's tiles
whose window fits its shared memory, advect.dye_window_plan); and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

CONFIGS = (("demo", dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280,
                         CANVAS_HEIGHT=720, DTYPE="float32")),
           ("1024", dict(SIM_RESOLUTION=1024, DYE_RESOLUTION=1024, CANVAS_WIDTH=1024,
                         CANVAS_HEIGHT=1024, DTYPE="bfloat16")),
           ("4096", dict(SIM_RESOLUTION=4096, DYE_RESOLUTION=4096, CANVAS_WIDTH=4096,
                         CANVAS_HEIGHT=4096, DTYPE="bfloat16")))
# The fleets: (resolution, sims), bf16 with the RGB9E5 dye, 20 sweeps.
FLEETS = {"serving_256_b16": (256, 16), "serving_1024_b8": (1024, 8),
          "packed_288_b64": (288, 64)}
FLOW_STEPS = 100
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def config(name, FluidConfig):
    if name in FLEETS:
        res = FLEETS[name][0]
        return FluidConfig(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res,
                           CANVAS_HEIGHT=res, PRESSURE_ITERATIONS=20, MAX_SPLATS=8,
                           DTYPE="bfloat16", DYE_RGB9E5=True).validate()
    return FluidConfig(MAX_SPLATS=8, **dict(CONFIGS)[name]).validate()


def cases(name, check, FluidConfig) -> list:
    """The kernel calls timed at config ``name`` on random states."""
    cfg = config(name, FluidConfig)
    if name in FLEETS:
        batch = FLEETS[name][1]
        out = check.batched_step_cases(cfg, batch, 7, "cuda")
        if hasattr(check, "packed_step_cases"):
            out += check.packed_step_cases(cfg, batch, 7, "cuda")
        return [c for c in out if c.label.endswith(":lockstep")]
    state, splats = check.random_state(cfg, 7, "cuda")
    out = check.step_cases(state, splats, cfg)
    if hasattr(check, "part_cases"):
        out += check.part_cases(state, splats, cfg)
    out += check.render_cases(state, cfg)
    if hasattr(check, "sunrays_cases"):
        out += check.sunrays_cases(state, cfg)
    return out


def flow_cases(name, check, FluidConfig) -> list:
    """The dye's advection at config ``name`` on its flow state (batched,
    then packed, for a fleet), labelled ":flow"."""
    import tpufluid_torch as T

    cfg = config(name, FluidConfig)
    if name not in FLEETS:
        trace = T.swirl_trace(cfg, FLOW_STEPS, seed=42)
        state = T.make_multi_step(cfg)(T.init_state(cfg), trace.dts, trace.batches)
        return [c for c in check.step_cases(state, torch.as_tensor(trace.batches[-1]), cfg,
                                            tag=":flow") if c.label.startswith("advect:dye")]
    from tpufluid_torch.batch_packed import pack_state

    res, batch = FLEETS[name]
    seq = torch.as_tensor(np.stack([T.swirl_trace(cfg, FLOW_STEPS, seed=42 + i).batches
                                    for i in range(batch)], axis=1), device="cuda")
    state = T.make_batched_multi_step(cfg)(T.init_batch(cfg, batch), 1.0 / 60.0, seq)
    out = check.step_cases(state, seq[-1], cfg, 1.0 / 60.0, f":b{batch}:lockstep:flow")
    out += check.step_cases(pack_state(state), seq[-1], cfg, 1.0 / 60.0,
                            f":packed:b{batch}:lockstep:flow", sim_w=res)
    return [c for c in out if c.label.startswith("advect:dye")]


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--configs", default=",".join([n for n, _ in CONFIGS] + list(FLEETS)),
                    help="comma-separated: " + ", ".join([n for n, _ in CONFIGS] + list(FLEETS)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times measures a CUDA GPU and none is available")
    from tpufluid_torch import FluidConfig
    from tpufluid_torch.ops.cuda import advect, build, check
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate

    build.build([n for n in ("stencil", "jacobi", "advect", "bloom", "display", "sunrays")
                 if n in build.SOURCES])
    rate = spin_rate()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for name in args.configs.split(","):
        for case in cases(name, check, FluidConfig) + flow_cases(name, check, FluidConfig):
            ms = sorted(queued_ms(case.run, 20, rate) for _ in range(args.reps))[args.reps // 2]
            print(f"KT {args.tag} {name} {case.label} {ms:.5f}", flush=True)
            bound = max(case.nbytes / HBM_BYTES_PER_S, case.flops / F32_FLOPS_PER_S) * 1e3
            frame = case.kernel_name in ("bloom_pyramid", "sunrays", "display", "display_direct")
            plain = queued_ms(lambda: case.run(plain=True), 1, rate) if frame else float("nan")
            print(f"BOUND {args.tag} {name} {case.label} {bound:.5f} {plain:.5f}", flush=True)
            if not case.label.startswith("advect:"):
                continue
            sim_w = FLEETS[name][0] if ":packed" in case.label else None
            if hasattr(check, "grid_sample_ms"):
                lib = sorted(check.grid_sample_ms(case, rate, sim_w)
                             for _ in range(args.reps))[args.reps // 2]
                print(f"KT {args.tag} {name} grid_sample:{case.label} {lib:.5f}", flush=True)
            if case.label.startswith("advect:dye") and hasattr(advect, "dye_window_plan"):
                plan = advect.dye_window_plan(*case.args, sim_w=sim_w)
                print(f"FIT {args.tag} {name} {case.label} {plan['share']:.4f}", flush=True)
        torch.cuda.empty_cache()
    print(f"kernel times {args.tag} on {gpu}")


if __name__ == "__main__":
    main(sys.argv[1:])
