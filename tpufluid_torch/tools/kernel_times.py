"""Device ms of each step and frame kernel call on the card, to compare two
checkouts on one card.

    python3 tpufluid_torch/tools/kernel_times.py TAG [--reps 5] [--configs demo,1024]

At the demo's defaults (float32) and at 1024x1024 and 4096x4096 (bfloat16
with the RGB9E5 dye), on check.random_state (seed 7), times every kernel call
of one step, the dye's advect_prepare and the frame's bloom pyramid and
display at the canvas (check.step_cases, part_cases, render_cases); at the
serving cells serving_256_b16 (16 sims of 256^2) and packed_288_b64 (64 of
288^2), bf16 RGB9E5, every kernel call of a lock-step batched step
(check.batched_step_cases, labels ":b<B>:lockstep") and of a packed fleet
step on the same sims (check.packed_step_cases, ":packed:b<B>:lockstep",
where the checkout has them). Each time is 20 calls queued behind a spin
kernel, so host launch cost is hidden, the median of ``--reps`` such runs.
Run as a file, it measures the
tpufluid_torch that PYTHONPATH names, so one copy of the script times two
checkouts, in the order parent, change, change, parent:

    cd path/to/other/checkout && PYTHONPATH=. python3 path/to/kernel_times.py parent

Prints one line per call: ``KT TAG config case ms``, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

CONFIGS = (("demo", dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280,
                         CANVAS_HEIGHT=720, DTYPE="float32")),
           ("1024", dict(SIM_RESOLUTION=1024, DYE_RESOLUTION=1024, CANVAS_WIDTH=1024,
                         CANVAS_HEIGHT=1024, DTYPE="bfloat16")),
           ("4096", dict(SIM_RESOLUTION=4096, DYE_RESOLUTION=4096, CANVAS_WIDTH=4096,
                         CANVAS_HEIGHT=4096, DTYPE="bfloat16")))
# The fleets: (resolution, sims), bf16 with the RGB9E5 dye, 20 sweeps.
FLEETS = {"serving_256_b16": (256, 16), "packed_288_b64": (288, 64)}


def cases(name, check, FluidConfig) -> list:
    """The kernel calls timed at config ``name``."""
    if name in FLEETS:
        res, batch = FLEETS[name]
        cfg = FluidConfig(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res,
                          CANVAS_HEIGHT=res, PRESSURE_ITERATIONS=20, MAX_SPLATS=8,
                          DTYPE="bfloat16", DYE_RGB9E5=True).validate()
        out = check.batched_step_cases(cfg, batch, 7, "cuda")
        if hasattr(check, "packed_step_cases"):
            out += check.packed_step_cases(cfg, batch, 7, "cuda")
        return [c for c in out if c.label.endswith(":lockstep")]
    cfg = FluidConfig(MAX_SPLATS=8, **dict(CONFIGS)[name]).validate()
    state, splats = check.random_state(cfg, 7, "cuda")
    return (check.step_cases(state, splats, cfg) + check.part_cases(state, splats, cfg)
            + check.render_cases(state, cfg))


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
    from tpufluid_torch.ops.cuda import build, check
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate

    build.build(["stencil", "jacobi", "advect", "bloom", "display"])
    rate = spin_rate()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for name in args.configs.split(","):
        for case in cases(name, check, FluidConfig):
            ms = sorted(queued_ms(case.run, 20, rate) for _ in range(args.reps))[args.reps // 2]
            print(f"KT {args.tag} {name} {case.label} {ms:.5f}", flush=True)
        torch.cuda.empty_cache()
    print(f"kernel times {args.tag} on {gpu}")


if __name__ == "__main__":
    main(sys.argv[1:])
