"""Whether the window's calls produced what the reference does.

The reference follows the program call by call from the program's own
state: chaotic flow makes two correct runs of thousands of steps part ways,
so no reference can replay a whole window. Each kept call (the cell's first
call, from the zero state the benchmark made; calls at three times drawn
from the seed; the window's last call) is run again by the reference from
the state that call started from, with the same splat rows and dts: the
chunk's steps, or the tick's step or substeps and its frame. Compared:

  state_err           the largest |program - reference| of each field over
                      the largest |reference| of that field, the worst
                      field of the worst call
  frame_mismatch_pct  ticks: the share of a session's frame's uint8 values
                      that differ from the reference's, in percent, the
                      worst session of the worst call

Each sample's readings go to the log as they are made.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

from fluidbench.program import fields
from fluidbench.reference import bluenoise, fluid, frame


def precision(cfg: Dict) -> Tuple[str, bool]:
    """(storage type, whether the dye goes through RGB9E5) as configured."""
    return cfg["DTYPE"], bool(cfg["DYE_RGB9E5"]) and cfg["DTYPE"] == "bfloat16"


def reference_call(f: Dict[str, torch.Tensor], cfg: Dict, mix: Dict, traffic, t: int, store,
                   rgb9e5: bool):
    """The reference's fields and, for a tick, the dye its frame shows, of
    the call at traffic row ``t`` from fields ``f``."""
    if mix["entry"] != "tick":
        for k in range(mix.get("chunk", 1)):
            f = fluid.step(f, traffic.dts[t + k], torch.from_numpy(traffic.splats[t + k]), cfg,
                           store, rgb9e5)
        return f, None
    splats = torch.from_numpy(traffic.splats[t])
    k = int(traffic.substeps.max())
    if k > 1:
        table = np.where(np.arange(k)[:, None] < traffic.substeps[None, :],
                         traffic.dts[t][None, :], 0.0).astype(np.float32)
        f = fluid.substep_tick(f, table, splats, cfg, store, rgb9e5)
    else:
        f = fluid.step(f, traffic.dts[t], splats, cfg, store, rgb9e5)
    return f, f["dye"]


def state_err(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    worst = 0.0
    for k, r in ref.items():
        scale = float(r.abs().max())
        err = float((program[k] - r).abs().max())
        worst = max(worst, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def frame_mismatch_pct(program: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst session's share: a fault confined to one session's frame
    counts whole, not diluted by the sessions it spares."""
    if tuple(program.shape) != tuple(ref.shape):
        return 100.0
    differ = (program.to(ref.device) != ref).reshape(ref.shape[0], -1)
    return 100.0 * float(differ.sum(1).max()) / differ.shape[1]


def compare(cell, traffic, samples, device, log=sys.stderr) -> Tuple[Dict[str, float], int]:
    """The worst readings over ``samples`` and how many samples fail the
    cell's limits. A reading that is not finite fails."""
    store_name, rgb9e5 = precision(cell.cfg)
    store = fluid.storage(store_name)
    tile = (torch.from_numpy(bluenoise.tile()).to(device)
            if cell.mix["entry"] == "tick" else None)
    worst: Dict[str, float] = {}
    failed = 0
    for s in samples:
        with torch.no_grad():
            ref, dye = reference_call(fields(s.before), cell.cfg, cell.mix, traffic, s.t,
                                      store, rgb9e5)
            got = {"state_err": state_err(fields(s.after), ref)}
            if dye is not None:
                got["frame_mismatch_pct"] = frame_mismatch_pct(s.frames, frame.frame(dye, cell.cfg,
                                                                                   tile))
        del ref, dye
        print(f"sample {s.label} row {s.t} " + " ".join(f"{k} {v!r}" for k, v in got.items()),
              file=log)
        bad = any(not np.isfinite(v) or v > cell.limits[k] for k, v in got.items())
        failed += bad
        for k, v in got.items():
            worst[k] = v if not np.isfinite(v) else max(worst.get(k, 0.0), v)
    return worst, failed
