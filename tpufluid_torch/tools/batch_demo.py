"""Batched-serving demo, counterpart of tools/batch_demo.py: one batched step
advances four sims seeded alike at four clock rates (a dt a sim), one
batched frame renders the four, and the frames tile a 2x2 grid GIF. The
panels start bit-identical and drift apart only by their clocks.

Each chunk of ``--every`` steps is one make_batched_multi_step call: the
shared splat rows go to the device once for the run and reach every sim as
one expanded (T, B, MAX_SPLATS, 8) view, the per-sim dts (one float32 tensor
on the device) as one (T, B) table a chunk. Each frame's (B, 4, H, W) batch
comes to the host in one copy. On the GPU that is five launches a step
(pre_pressure, jacobi_chunk, jacobi_project, advect, advect_dye) and four a
frame (bloom_pyramid, sunrays, sunrays_blur, display); TPUFLUID_DEVICE=cpu
runs their plain versions on the CPU instead.

  python -m tpufluid_torch.tools.batch_demo                  # the GPU
  TPUFLUID_DEVICE=cpu python -m tpufluid_torch.tools.batch_demo --steps 60
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from tpufluid_torch.batch import init_batch, make_batched_multi_step, make_batched_render
from tpufluid_torch.config import FluidConfig
from tpufluid_torch.io import frame_to_uint8, save_gif
from tpufluid_torch.state import FluidState, device_from_env
from tpufluid_torch.trace import swirl_trace

SPEEDS = (0.25, 0.5, 0.75, 1.0)   # each sim's clock over the 1/60 s ceiling
SEED = 11                         # the one swirl_trace every sim replays
GIF_FPS = 15
# The libraries of the step's and the frame's kernels.
LIBRARIES = ("stencil", "jacobi", "advect", "bloom", "display", "sunrays")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpufluid_torch.tools.batch_demo", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="out/batch_grid.gif")
    p.add_argument("--steps", type=int, default=360)
    p.add_argument("--every", type=int, default=6)
    p.add_argument("--sim-res", type=int, default=96)
    p.add_argument("--dye-res", type=int, default=192)
    return p


def demo_config(sim_res: int = 96, dye_res: int = 192) -> FluidConfig:
    """The demo's config: a dye_res x dye_res canvas, MAX_SPLATS 8, f32."""
    return FluidConfig(SIM_RESOLUTION=sim_res, DYE_RESOLUTION=dye_res, CANVAS_WIDTH=dye_res,
                       CANVAS_HEIGHT=dye_res, MAX_SPLATS=8).validate()


def demo_inputs(config: FluidConfig, steps: int, device,
                speeds: Sequence[float] = SPEEDS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dts (B,) float32, splat rows (steps, MAX_SPLATS, 8) float32), both
    on ``device``, each copied there once: the per-sim dts speeds / 60 and
    swirl_trace(seed SEED), the trace every sim replays."""
    dts = torch.as_tensor(np.asarray(speeds, np.float32) / np.float32(60.0), device=device)
    rows = torch.as_tensor(swirl_trace(config, steps, seed=SEED).batches, device=device)
    return dts, rows


def grid(frames: np.ndarray) -> np.ndarray:
    """(4, 4, H, W) float RGBA frames on the host -> the (2H, 2W, 3) uint8
    grid: sims 0 | 1 over 2 | 3, each flipped upright by frame_to_uint8."""
    u = [frame_to_uint8(f)[..., :3] for f in frames]
    return np.concatenate([np.concatenate(u[:2], axis=1), np.concatenate(u[2:], axis=1)],
                          axis=0)


def run(config: FluidConfig, steps: int, every: int, device,
        speeds: Sequence[float] = SPEEDS) -> Iterator[Tuple[int, Optional[np.ndarray], FluidState]]:
    """The demo's loop: yields (step, uint8 grid, batched state) after every
    ``every`` steps, then (steps, None, state) once more where ``steps`` is
    not a multiple of ``every``. Every sim replays the same splat rows in the
    same order, inactive rows too."""
    if every < 1:
        raise ValueError(f"--every must be at least 1, got {every}")
    if len(speeds) != 4:
        raise ValueError(f"the 2x2 grid takes 4 speeds, got {len(speeds)}")
    b = len(speeds)
    dts, rows = demo_inputs(config, steps, device, speeds)
    multi = make_batched_multi_step(config, device=device)
    render = make_batched_render(config, device=device)
    state = init_batch(config, b, device=device)
    for t0 in range(0, steps, every):
        t1 = min(t0 + every, steps)
        state = multi(state, dts.expand(t1 - t0, b), rows[t0:t1, None].expand(-1, b, -1, -1))
        if t1 % every == 0:
            yield t1, grid(render(state).cpu().numpy()), state
        else:
            yield t1, None, state


def display_form(config: FluidConfig, device) -> str:
    """The display form the frame takes on ``device``: "staged" or "direct"
    (display.form at the canvas), "plain" on the CPU."""
    if device.type != "cuda":
        return "plain"
    from tpufluid_torch.ops.cuda import display
    from tpufluid_torch.ops.cuda.build import smem_optin

    dw, dh = config.dye_size
    return display.form(3, dh, dw, config.CANVAS_HEIGHT, config.CANVAS_WIDTH, config.SHADING,
                        config.dtype.itemsize, smem_optin(device))


def main(argv: Optional[list] = None) -> dict:
    """Run the demo, print ``step t/T`` a frame and the wall time, write the
    GIF; returns the frames, the last state and the run's figures."""
    args = build_argparser().parse_args(argv)
    device = device_from_env()
    config = demo_config(args.sim_res, args.dye_res)
    if device.type == "cuda":
        from tpufluid_torch.ops.cuda import build

        build.build(LIBRARIES)
    form = display_form(config, device)
    frames, state = [], None
    t0 = time.perf_counter()
    for t, g, state in run(config, args.steps, args.every, device):
        if g is not None:
            frames.append(g)
            print(f"step {t}/{args.steps}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    sims = len(SPEEDS)
    sim, dye = ("x".join(map(str, size)) for size in (config.sim_size, config.dye_size))
    print(f"batch demo on {name}: {sims} sims x {args.steps} steps, {len(frames)} frames "
          f"(sim {sim}, dye {dye}, display {form}) in {wall:.3f} s: "
          f"{sims * args.steps / wall:.1f} sim-steps/s, {len(frames) / wall:.2f} frames/s",
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_gif(frames, args.out, fps=GIF_FPS)
    print(f"wrote {args.out} ({len(frames)} frames, speeds {list(SPEEDS)})")
    return {"frames": frames, "state": state, "seconds": wall,
            "sim_steps_per_s": sims * args.steps / wall, "frames_per_s": len(frames) / wall,
            "display_form": form}


if __name__ == "__main__":
    main()
