"""A cell of BENCHMARK.json run as a sharded cell that the file does not
hold: its configuration with ``MESH`` [ny, nx] and its traffic on the
``sharded_multi_step`` entry, over the devices named (row-major; a device
may repeat, so one card can hold a whole mesh). It prints the result line
``fluidbench.run`` would. For trying a sharded deployment's path, limits
and readers before its cell is added.

  python3 -m fluidbench.meshrun --workload grid4096_bf16.steps --mesh 2x2 \\
      --devices 0,0,0,0 --seed <n> --seconds <s> --trace <0|1> [--chunk <steps>]

``--chunk`` sets the steps a call (the traffic's by default): a kept call's
comparison follows the program for that many steps, over which the sharded
step's departure from the reference grows (PERF.md).
"""

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

from fluidbench import run


def meshed(cell, mesh: Sequence[int], chunk: Optional[int] = None):
    """``cell`` with its configuration cut over a (ny, nx) mesh and its
    chunks (of ``chunk`` steps, default the traffic's) on the sharded
    entry; its limits and metrics are the cell's."""
    ny, nx = mesh
    mix = dict(cell.mix, entry="sharded_multi_step")
    if chunk is not None:
        mix["chunk"] = chunk
    return dataclasses.replace(cell, name=f"{cell.name}.mesh{ny}x{nx}",
                               cfg=dict(cell.cfg, MESH=[ny, nx]), mix=mix)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fluidbench.meshrun")
    p.add_argument("--workload", required=True)
    p.add_argument("--mesh", required=True, help="NYxNX")
    p.add_argument("--devices", required=True, help="CUDA indices, row-major, e.g. 0,0,0,0")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--chunk", type=int, default=None)
    args = p.parse_args(argv)
    run.caches()
    import torch

    from fluidbench import harness

    mesh = [int(x) for x in args.mesh.split("x")]
    index = [int(x) for x in args.devices.split(",")]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max(index) >= found:
        print(f"fluidbench.meshrun: devices {index} need {max(index) + 1} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    cell = meshed(harness.load_cell(args.workload), mesh, args.chunk)
    return run.execute(cell, args.seed, args.seconds, bool(args.trace),
                       [torch.device("cuda", i) for i in index])


if __name__ == "__main__":
    sys.exit(main())
