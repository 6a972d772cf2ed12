"""The port's spans in a benchmark cell: each pass's host time, launches,
device time and idle, on the card.

  python3 -m tpufluid_torch.tools.span_window --workload <cell> --seeds 11,12 \\
      [--seconds 20] [--out out/span_window.jsonl]
  python -m tpufluid_torch.tools.span_window --workload <cell> --cpu     (a rehearsal)

For each seed, one run of the cell (fluidbench's set-up and measured window,
the recorder off), then its traced window with the port's recorder on, then
a span window: turns of as many calls with the recorder on and off, and no
profiler (fluidbench/programspans.py). Prints one JSON line a run: the
cell's own per-layer metrics and the span metrics of
fluidbench/spans_per_layer.json; whether the attribution closes (launches,
device time and idle by span against the trace's, and the port's launches
the timeline places in each span against build.Kernel's count there); the
alignment error in µs; the span window's host ms a unit beside its turns
with the recorder off and the measured window's; every span's numbers; and
the breakdown with the idle gaps named by span. ``--cpu`` runs the cell at
fluidbench.rehearse's size on the CPU: plumbing only, no device number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m tpufluid_torch.tools.span_window")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="2147483659")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU at a tiny size")
    p.add_argument("--out", default=None, help="also append each run's line to this file")
    args = p.parse_args(argv)
    cache = ROOT / "tpufluid_torch" / "_build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch

    from fluidbench import harness, program, programspans, rehearse
    from tpufluid_torch import spans

    cell = harness.load_cell(args.workload)
    if args.cpu:
        cell = dataclasses.replace(cell, cfg=rehearse.shrink(cell.cfg),
                                   mix=rehearse.shrink_mix(cell.mix))
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
        program.build(cell.mix)
    else:
        print("span_window: no CUDA device (--cpu for a rehearsal)", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(programspans.run(cell, seed, args.seconds, device, spans))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
