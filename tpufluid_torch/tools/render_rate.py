"""Frames/s and ticks/s of the render path on the card, to compare two
checkouts on one card.

    python3 tpufluid_torch/tools/render_rate.py [--frames 200] [--json PATH]

At both main-path configs (the demo's defaults in float32 and 1024x1024 in
bfloat16 with the RGB9E5 dye), steps 100 steps of a swirl_trace (seed 42),
then times make_render over ``--frames`` frames of that state and
make_step_and_render over ``--frames`` ticks of a swirl_trace (seed 43),
with a CUDA event after each call, as chip_smoke.py's render path does.
Run as a file, it measures the tpufluid_torch that PYTHONPATH names, so one
copy of the script times two checkouts:

    PYTHONPATH=path/to/other/checkout python3 tpufluid_torch/tools/render_rate.py

Prints one line per config with the rates, the median and nearest-rank 95th
percentile ms, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

DEMO = dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720)
SQUARE = dict(SIM_RESOLUTION=1024, DYE_RESOLUTION=1024, CANVAS_WIDTH=1024, CANVAS_HEIGHT=1024)
CONFIGS = (("demo_float32", dict(DTYPE="float32", **DEMO)),
           ("1024_bfloat16_rgb9e5", dict(DTYPE="bfloat16", DYE_RGB9E5=True, **SQUARE)))
WARM_STEPS = 100


def call_times(fn, n: int):
    """fn(k) for k < n with a CUDA event after each call -> (calls per s,
    median ms, nearest-rank 95th percentile ms: n/20 calls lie beyond it).
    chip_smoke.py times its steps, frames and ticks with it too."""
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for k in range(n):
        fn(k)
        events[k + 1].record()
    events[-1].synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return n / (events[0].elapsed_time(events[-1]) / 1e3), ms[len(ms) // 2], \
        ms[math.ceil(0.95 * len(ms)) - 1]


def measure(name: str, overrides: dict, frames: int) -> dict:
    from tpufluid_torch import (FluidConfig, init_state, make_multi_step, make_render,
                                make_step_and_render, swirl_trace)

    cfg = FluidConfig(PRESSURE_ITERATIONS=20, MAX_SPLATS=8, **overrides).validate()
    trace = swirl_trace(cfg, WARM_STEPS, seed=42)
    state = make_multi_step(cfg)(init_state(cfg), trace.dts, trace.batches)
    render = make_render(cfg)
    render(state)
    fps, frame_med, frame_p95 = call_times(lambda k: render(state), frames)
    ticks = swirl_trace(cfg, frames, seed=43)
    tick = make_step_and_render(cfg)
    box = [state]

    def one_tick(k):
        box[0], pixels = tick(box[0], ticks.dts[k], ticks.batches[k])
        return pixels

    one_tick(0)
    tps, tick_med, tick_p95 = call_times(one_tick, frames)
    return {"config": name, "frames_per_s": fps, "frame_ms_median": frame_med,
            "frame_ms_p95": frame_p95, "ticks_per_s": tps, "tick_ms_median": tick_med,
            "tick_ms_p95": tick_p95}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_rate measures a CUDA GPU and none is available")
    import tpufluid_torch

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rows = []
    for name, overrides in CONFIGS:
        row = measure(name, overrides, args.frames)
        rows.append(row)
        print(f"render rate {name} ({tpufluid_torch.__file__}): {row['frames_per_s']:.1f} "
              f"frames/s (median {row['frame_ms_median']:.4f} ms, p95 "
              f"{row['frame_ms_p95']:.4f} ms), {row['ticks_per_s']:.1f} ticks/s (median "
              f"{row['tick_ms_median']:.4f} ms, p95 {row['tick_ms_p95']:.4f} ms) on {gpu}",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "package": tpufluid_torch.__file__, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
