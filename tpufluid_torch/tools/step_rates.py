"""Steps/s and ticks/s of the port's entry points on the card, to compare
two checkouts on one card.

    python3 tpufluid_torch/tools/step_rates.py TAG [--calls 200] [--cells demo,1024,...]

Each cell is warmed by WARM calls, then timed over ``--calls`` calls, one
call a step or tick with a CUDA event after each (render_rate.call_times:
calls/s, median and 95th-percentile ms), on swirl_trace inputs (seed 42,
a fleet's sim i seed 42 + i) at dt 1/60:

  * demo: make_step at the app's defaults (sim 128, dye 1024, float32);
  * 1024: make_step at 1024^2, bfloat16 with the RGB9E5 dye;
  * serving_256_b16:batched / :packed: make_batched_step and
    make_packed_step, 16 sims of 256^2 (bf16 RGB9E5), lock-step;
  * fleet_256_b16:scalar: the fleet server's tick program
    (serve_batch.make_tick_program(cfg, 16, "scalar")), one step and one
    frame of every sim a tick.

These rates are set by the host, not the card, and spread between
processes, so compare two checkouts only within one call, in turns. Run
as a file, it measures the tpufluid_torch that PYTHONPATH names:

    cd path/to/other/checkout && PYTHONPATH=. python3 path/to/step_rates.py parent

Prints ``SR TAG cell calls_per_s median_ms p95_ms`` a cell, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

WARM = 50
CELLS = ("demo", "1024", "serving_256_b16:batched", "serving_256_b16:packed",
         "fleet_256_b16:scalar")
FLEET = (256, 16)


def _config(cell: str):
    from tpufluid_torch import FluidConfig

    if cell == "demo":
        return FluidConfig(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280,
                           CANVAS_HEIGHT=720, PRESSURE_ITERATIONS=20, MAX_SPLATS=8).validate()
    res = 1024 if cell == "1024" else FLEET[0]
    return FluidConfig(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res,
                       CANVAS_HEIGHT=res, PRESSURE_ITERATIONS=20, MAX_SPLATS=8,
                       DTYPE="bfloat16", DYE_RGB9E5=True).validate()


def _caller(cell: str, calls: int, device="cuda"):
    """(fn(k) making call k, the state box it advances) after WARM calls."""
    from tpufluid_torch import (init_batch, init_state, make_batched_step, make_step,
                                swirl_trace)

    cfg = _config(cell)
    n = WARM + calls
    dt = 1.0 / 60.0
    if cell in ("demo", "1024"):
        seq = torch.as_tensor(np.asarray(swirl_trace(cfg, n, seed=42).batches, np.float32),
                              device=device)
        fn, box = make_step(cfg, device), [init_state(cfg, device)]
    else:
        seq = torch.as_tensor(np.stack([swirl_trace(cfg, n, seed=42 + i).batches
                                        for i in range(FLEET[1])], axis=1), device=device)
        if cell.endswith(":batched"):
            fn, box = make_batched_step(cfg, device), [init_batch(cfg, FLEET[1], device)]
        elif cell.endswith(":packed"):
            from tpufluid_torch.batch_packed import init_packed, make_packed_step

            fn, box = (make_packed_step(cfg, FLEET[1], device),
                       [init_packed(cfg, FLEET[1], device)])
        else:
            from tpufluid_torch.serve_batch import make_tick_program

            prog = make_tick_program(cfg, FLEET[1], "scalar")

            def fn(state, dt, splats):
                return prog(state, np.float32(dt), splats)[0]

            box = [init_batch(cfg, FLEET[1], device)]

    def one(k):
        box[0] = fn(box[0], dt, seq[k])

    for k in range(WARM):
        one(k)
    return (lambda k: one(WARM + k)), box


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_rates measures a CUDA GPU and none is available")
    from tpufluid_torch.tools.render_rate import call_times

    for cell in args.cells.split(","):
        one, box = _caller(cell, args.calls)
        rate, median, p95 = call_times(one, args.calls)
        v = box[0].velocity.float()
        assert bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0.0, cell
        print(f"SR {args.tag} {cell} {rate:.2f} {median:.5f} {p95:.5f}", flush=True)
        del one, box
        torch.cuda.empty_cache()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"step rates on {gpu}")


if __name__ == "__main__":
    main(sys.argv[1:])
