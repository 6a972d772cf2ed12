"""The control of a sharded cell, in bands: the reference computed in the
storage type one step below the configuration's (``control.LOWER``: float8
e4m3 for bfloat16), put in the program's place and driven through the
whole run, as ``control.py`` does for a grid one card holds. Its readings
must fail the cell's limits.

Its state is the cell's blocks, the configuration's ``MESH`` [ny, nx] over
the run's devices row-major as the program lays them, so that no device
holds the whole grid. A call steps the grid band by band
(``reference/banded.py``'s plan for the call's chunk): each band's rows and
their margins are read from the blocks into float32 on the device that
holds the band's first kept row, stepped by the reference there, and its
kept rows are written into the new blocks. The blocks are held in the
configuration's storage type, which holds every value of the lower type
exactly (each field goes through the lower type when it is written), so
the blocks lose nothing.

  python3 -m fluidbench.control_banded --workload <name> --seeds 11,12,13 --seconds 3

runs one short run a seed on the cell's ``chips`` cards in one process and
prints each run's readings beside the limits (``control <seed> <number>
<reading> limit <limit>``), then ``control correct <all seeds' correct>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict

import torch

from fluidbench import check, control, harness, program
from fluidbench.reference import banded, fluid, geometry


@dataclasses.dataclass
class Block:
    """One block of the grid's fields, (2, h, w), (3, hd, wd) and (h, w)."""

    velocity: torch.Tensor
    dye: torch.Tensor
    pressure: torch.Tensor


class BandedControl:
    """Program's interface for a sharded cell, computed by the reference in
    lower precision band by band over blocks on the run's devices."""

    def __init__(self, cfg: Dict, mix: Dict, traffic, devices):
        self.cfg, self.mix, self.traffic = cfg, mix, traffic
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.config = program.fluid_config(cfg)
        self.steps = mix.get("chunk", 1)
        self.host_s = 0.0
        self.store = fluid.storage(control.LOWER[cfg["DTYPE"]])
        self.rgb9e5 = check.precision(cfg)[1]
        self.ny, self.nx = cfg["MESH"]
        if len(self.devices) != self.ny * self.nx:
            raise ValueError(f"a {self.ny}x{self.nx} mesh on {len(self.devices)} devices")
        g = geometry.sizes(cfg)
        (self.sh, self.sw), (self.dh, self.dw) = g["sim"], g["dye"]
        self.bands = banded.plan(cfg, self.steps)

    def on(self, i: int, j: int) -> torch.device:
        return self.devices[i * self.nx + j]

    def init(self):
        """The zero state, one block a device."""
        h, w, hd, wd = self.sh // self.ny, self.sw // self.nx, self.dh // self.ny, self.dw // self.nx

        def zeros(i, j, *shape):
            return torch.zeros(shape, dtype=self.config.dtype, device=self.on(i, j))

        return tuple(tuple(Block(zeros(i, j, 2, h, w), zeros(i, j, 3, hd, wd), zeros(i, j, h, w))
                           for j in range(self.nx)) for i in range(self.ny))

    def call(self, state, t: int):
        a = time.perf_counter()
        new = harness.like(state)
        h = self.sh // self.ny
        with torch.no_grad():
            for b in self.bands:
                where = self.on(b.keep[0] // h, 0)
                f = check.reference_call(program.fields(state, b.rows("run"), where), self.cfg,
                                         self.mix, self.traffic, t, self.store, self.rgb9e5,
                                         b.run[0])[0]
                self._write(new, f, b)
                del f
        self.host_s = time.perf_counter() - a
        return new, None

    def _write(self, new, f: Dict[str, torch.Tensor], b: banded.Band) -> None:
        """Band ``b``'s kept rows of the stepped fields ``f`` into the blocks
        that hold them."""
        run, keep = b.rows("run"), b.rows("keep")
        for name, x in f.items():
            lo, hi = keep[name]
            n_rows = (self.sh if name != "dye" else self.dh) // self.ny
            n_cols = x.shape[-1] // self.nx
            for i in range(self.ny):
                a, c = max(lo, i * n_rows), min(hi, (i + 1) * n_rows)
                if c <= a:
                    continue
                rows = x[0, ..., a - run[name][0]:c - run[name][0], :]
                for j in range(self.nx):
                    dst = getattr(new[i][j], name)
                    dst[..., a - i * n_rows:c - i * n_rows, :].copy_(
                        rows[..., j * n_cols:(j + 1) * n_cols], non_blocking=True)


def run_seeds(cell, seeds, seconds: float, devices, log=sys.stderr) -> Dict[int, Dict]:
    out = {}
    for seed in seeds:
        r = harness.run(cell, seed, seconds, False, devices, time.perf_counter(),
                        make_program=BandedControl, log=log)
        out[seed] = r
        for k, v in r["checks"].items():
            print(f"control {seed} {k} {v['value']!r} limit {v['limit']!r}", file=log)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fluidbench.control_banded")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fluidbench.control_banded: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    res = run_seeds(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                    [torch.device("cuda", i) for i in range(chips)], log=sys.stdout)
    print(f"control correct {[r['correct'] for r in res.values()]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
