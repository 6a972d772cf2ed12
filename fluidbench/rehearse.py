"""A CPU rehearsal of a cell: the whole run at a tiny size, the program's
plain versions in place of its kernels, the traced window read from the
CPU profiler. It shows that the plumbing, the readers and the comparison
work; it prints no device metric, only which metrics were read.

  python -m fluidbench.rehearse --workload <name> [--seed 5] [--seconds 0.5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict

import torch

from fluidbench import harness

TINY = {"SIM_RESOLUTION": 24, "DYE_RESOLUTION": 48, "BLOOM_RESOLUTION": 32,
        "SUNRAYS_RESOLUTION": 24}
TINY_HEIGHT = 90
TINY_SIMS = 4


def shrink(cfg: Dict) -> Dict:
    """The configuration at a rehearsal's size: grids of at most TINY
    texels, the canvas TINY_HEIGHT rows at its aspect."""
    out = dict(cfg)
    for k, v in TINY.items():
        out[k] = min(cfg[k], v)
    out["CANVAS_WIDTH"] = round(TINY_HEIGHT * cfg["CANVAS_WIDTH"] / cfg["CANVAS_HEIGHT"])
    out["CANVAS_HEIGHT"] = TINY_HEIGHT
    return out


def shrink_mix(mix: Dict) -> Dict:
    """The traffic at a rehearsal's size: at most TINY_SIMS sims (their
    speeds spread as the mix's), chunks of 2 steps, one warm-up call, one
    traced call."""
    out = dict(mix, warm_calls=1, trace_calls=1)
    if "chunk" in mix:
        out["chunk"] = 2
    n = min(mix["sims"], TINY_SIMS)
    out["sims"] = n
    if "speeds" in mix:
        out["speeds"] = [mix["speeds"][i * mix["sims"] // n] for i in range(n)]
    return out


def rehearse(name: str, seed: int = 5, seconds: float = 0.5, make_program=None,
             log=sys.stderr) -> Dict:
    """harness.run of the cell, shrunk, on the CPU, traced."""
    cell = harness.load_cell(name)
    cell = dataclasses.replace(cell, cfg=shrink(cell.cfg), mix=shrink_mix(cell.mix))
    return harness.run(cell, seed, seconds, True, torch.device("cpu"), time.perf_counter(),
                       make_program=make_program, log=log)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fluidbench.rehearse")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)
    r = rehearse(args.workload, args.seed, args.seconds)
    print(json.dumps({"rehearsal": args.workload, "correct": r["correct"],
                      "attempted": r["attempted"], "failed": r["failed"],
                      "read": sorted(r["metrics"]), "checks": r["checks"]}))
    return 0 if r["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
