"""The control of the comparison: the reference itself, computed in the
storage type one step below the configuration's (bfloat16 for float32,
float8 e4m3 for bfloat16 and float16), put in the program's place and
driven through the whole run. Its readings must fail the cell's limits.

  python3 -m fluidbench.control --workload <name> --seeds 11,12,13 --seconds 3

runs one short run a seed in one process and prints each run's readings
beside the limits (a line ``control <seed> <number> <reading> limit
<limit>``), then ``control correct <all seeds' correct>``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import torch

from fluidbench import check, harness, program
from fluidbench.reference import bluenoise, fluid, frame

LOWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}


class Control:
    """Program's interface, computed by the reference in lower precision."""

    def __init__(self, cfg: Dict, mix: Dict, traffic, device):
        self.cfg, self.mix, self.traffic, self.device = cfg, mix, traffic, device
        self.config = program.fluid_config(cfg)
        self.steps = mix.get("chunk", 1)
        self.host_s = 0.0
        self.store = fluid.storage(LOWER[cfg["DTYPE"]])
        self.rgb9e5 = check.precision(cfg)[1]
        self.tile = (torch.from_numpy(bluenoise.tile()).to(device) if mix["entry"] == "tick"
                     else None)

    def init(self):
        from fluidbench.reference import geometry

        g, b = geometry.sizes(self.cfg), self.mix["sims"]
        (sh, sw), (dh, dw) = g["sim"], g["dye"]
        z = lambda *s: torch.zeros((b,) + s, dtype=torch.float32, device=self.device)  # noqa: E731
        return {"velocity": z(2, sh, sw), "dye": z(3, dh, dw), "pressure": z(sh, sw)}

    def call(self, f, t: int):
        a = time.perf_counter()
        with torch.no_grad():
            f, dye = check.reference_call(f, self.cfg, self.mix, self.traffic, t, self.store,
                                          self.rgb9e5)
            frames = None if dye is None else frame.frame(dye, self.cfg, self.tile)
        self.host_s = time.perf_counter() - a
        return f, frames


def run_seeds(cell, seeds, seconds: float, device, log=sys.stderr) -> Dict[int, Dict]:
    out = {}
    for seed in seeds:
        r = harness.run(cell, seed, seconds, False, device, time.perf_counter(),
                        make_program=Control, log=log)
        out[seed] = r
        for k, v in r["checks"].items():
            print(f"control {seed} {k} {v['value']!r} limit {v['limit']!r}", file=log)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fluidbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fluidbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    res = run_seeds(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                    torch.device("cuda", 0), log=sys.stdout)
    print(f"control correct {[r['correct'] for r in res.values()]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
