"""Headless app, counterpart of ``tpufluid.app``: the reference's update()
loop without vsync. Replay a trace (or synthesize one), step, optionally
render frames to PNG, log metrics, checkpoint, resume.

CLI (on the GPU; TPUFLUID_DEVICE=cpu runs the kernels' plain versions on
the CPU instead):
  python -m tpufluid_torch.app --steps 600 --sim-res 128 --dye-res 512 \\
      --render-every 10 --out out/run1 [--trace trace.npz] [--resume ck.npz]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

from tpufluid_torch import spans
from tpufluid_torch.checkpoint import load_state, save_state
from tpufluid_torch.config import MAX_DT, FluidConfig
from tpufluid_torch.io import save_gif, save_png
from tpufluid_torch.metrics import MetricsLogger, contract_warning
from tpufluid_torch.render import capture_frame, load_dither_tensor, make_render
from tpufluid_torch.state import device_from_env, init_state
from tpufluid_torch.step import make_step
from tpufluid_torch.trace import Trace, swirl_trace


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpufluid_torch.app", description=__doc__)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--sim-res", type=int, default=128)
    p.add_argument("--dye-res", type=int, default=1024)
    p.add_argument("--canvas", type=str, default="1280x720")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "float16"])
    p.add_argument("--jacobi-iters", type=int, default=20)
    # every control-panel knob of the reference
    p.add_argument("--density-dissipation", type=float, default=1.0)
    p.add_argument("--velocity-dissipation", type=float, default=0.2)
    p.add_argument("--pressure", type=float, default=0.8)
    p.add_argument("--vorticity", type=float, default=30.0, help="CURL strength")
    p.add_argument("--splat-radius", type=float, default=0.25)
    p.add_argument("--splat-force", type=float, default=6000.0)
    p.add_argument("--bloom-intensity", type=float, default=0.8)
    p.add_argument("--bloom-threshold", type=float, default=0.6)
    p.add_argument("--sunrays-weight", type=float, default=1.0)
    p.add_argument("--back-color", type=str, default="0,0,0", help="R,G,B 0-255")
    p.add_argument("--transparent", action="store_true")
    p.add_argument("--no-colorful", action="store_true")
    p.add_argument("--capture", type=str, default=None,
                   help="write a CAPTURE_RESOLUTION screenshot at the end (reference captureScreenshot)")
    p.add_argument("--trace", type=str, default=None, help="replay a recorded .npz trace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render-every", type=int, default=0, help="0 = no frames")
    p.add_argument("--out", type=str, default="out/run")
    p.add_argument("--metrics-every", type=int, default=60)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--no-bloom", action="store_true")
    p.add_argument("--no-sunrays", action="store_true")
    p.add_argument("--no-shading", action="store_true")
    p.add_argument("--paused", action="store_true",
                   help="skip stepping (render-only), reference config.PAUSED")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of the run (trace.json) into this dir")
    p.add_argument("--gif", type=str, default=None,
                   help="also write rendered frames as an animated GIF")
    p.add_argument("--dither", type=str, default=None,
                   help="external dither texture PNG (R channel, tiled at the "
                        "reference's ditherScale like its LDR_LLL1_0.png); "
                        "default: the generated blue-noise tile")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail at the first step whose fields are not all "
                        "finite (checked once a step, after it, not per pass "
                        "as tpufluid's jax_debug_nans does)")
    return p


def _check_finite(state, step: int) -> None:
    for name in ("velocity", "dye", "pressure"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise FloatingPointError(f"non-finite {name} after step {step}")


def main(argv: Optional[list] = None) -> None:
    args = build_argparser().parse_args(argv)
    device = device_from_env()
    cw, ch = (int(x) for x in args.canvas.split("x"))
    back = tuple(int(x) for x in args.back_color.split(","))
    config = FluidConfig(
        SIM_RESOLUTION=args.sim_res, DYE_RESOLUTION=args.dye_res,
        CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch, DTYPE=args.dtype,
        PRESSURE_ITERATIONS=args.jacobi_iters,
        DENSITY_DISSIPATION=args.density_dissipation,
        VELOCITY_DISSIPATION=args.velocity_dissipation,
        PRESSURE=args.pressure, CURL=args.vorticity,
        SPLAT_RADIUS=args.splat_radius, SPLAT_FORCE=args.splat_force,
        BLOOM_INTENSITY=args.bloom_intensity, BLOOM_THRESHOLD=args.bloom_threshold,
        SUNRAYS_WEIGHT=args.sunrays_weight, BACK_COLOR=back,
        TRANSPARENT=args.transparent, COLORFUL=not args.no_colorful,
        BLOOM=not args.no_bloom, SUNRAYS=not args.no_sunrays,
        SHADING=not args.no_shading, PAUSED=args.paused,
    ).validate()

    os.makedirs(args.out, exist_ok=True)
    start_step = 0
    if args.resume:
        state, config, start_step, _ = load_state(args.resume, device=device)
        print(f"resumed from {args.resume} at step {start_step}")
    else:
        state = init_state(config, device=device)

    trace = Trace.load(args.trace) if args.trace else swirl_trace(config, args.steps,
                                                                  seed=args.seed)
    # The trace's splat batches go to the device once, as make_multi_step's
    # do; past the recording, free-run at the dt clamp with no splats.
    batches = torch.as_tensor(trace.batches, dtype=torch.float32, device=device)
    none_batch = torch.zeros((config.MAX_SPLATS, 8), dtype=torch.float32, device=device)
    step = make_step(config, device=device)
    render = make_render(config, device=device)
    dither = load_dither_tensor(args.dither, device)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    gif_frames = []

    prof = None
    if args.profile:
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        # The port's spans (step, frame and their passes) as the profiler's
        # ranges, so the trace carries them on its own clock.
        spans.enable(profiler=True)
    t0 = time.time()
    for t in range(start_step, args.steps):
        batch, dt = (batches[t], trace.dts[t]) if t < trace.num_steps else (none_batch, MAX_DT)
        if not config.PAUSED:
            state = step(state, dt, batch)
            if args.debug_nans:
                _check_finite(state, t + 1)
        if args.render_every and (t + 1) % args.render_every == 0:
            frame = render(state, dither).cpu().numpy()
            save_png(frame, os.path.join(args.out, f"frame_{t + 1:06d}.png"))
            if args.gif:
                gif_frames.append(frame)
        if args.metrics_every and (t + 1) % args.metrics_every == 0:
            rec = logger.log(t + 1, state, config)
            print(f"step {t + 1}: max|v|={rec['max_speed']:.1f} "
                  f"E={rec['kinetic_energy']:.3g} dye={rec['dye_mass']:.3g}")
            warn = contract_warning(rec)
            if warn is not None:
                print(f"  WARNING: {warn}")
        if args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            save_state(os.path.join(args.out, f"ckpt_{t + 1:06d}.npz"),
                       state, config, step=t + 1)

    if device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    if prof is not None:
        spans.disable()
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}")
    n = args.steps - start_step
    print(f"{n} steps in {elapsed:.2f}s = {n / max(elapsed, 1e-9):.0f} steps/s")
    if args.capture:
        save_png(capture_frame(state, config, dither=dither), args.capture)
        print(f"capture written to {args.capture}")
    if args.gif and gif_frames:
        fps = args.render_every and (60.0 / args.render_every) or 60.0
        save_gif(gif_frames, os.path.join(args.out, "run.gif"), fps=max(fps, 5.0))
        print(f"gif written to {os.path.join(args.out, 'run.gif')}")
    logger.close()


if __name__ == "__main__":
    main()
