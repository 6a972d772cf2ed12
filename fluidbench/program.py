"""The system under test: the entries of ``tpufluid_torch`` that a cell
drives, built from the cell's configuration and traffic mix. This is the
only module of the benchmark that imports the program.

An entry is called once a *call*: a chunk of steps (``multi_step``) or one
tick of the fleet's program (``tick``: the batched step or its substeps and
the batched frame, uint8 on the card, as BatchFluidServer._tick dispatches
it). A tick ends when its frames are complete on the card. The server's
copy of the frames to pageable host memory is its own code, outside the
program, and is left out: it took 19.5-23.3 ms of a ~31 ms tick and spread
the tick by 11-21% between runs of one seed (PERF.md), which no bound of
25% can hold.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from fluidbench.traffic.generator import Traffic

# The kernel libraries each entry's calls launch (csrc/<name>.cu).
STEP_LIBRARIES = ("stencil", "jacobi", "advect")
FRAME_LIBRARIES = ("bloom", "display")


def fluid_config(cfg: Dict):
    """The program's FluidConfig from a configuration file's fields."""
    from tpufluid_torch.config import FluidConfig

    names = {f.name for f in dataclasses.fields(FluidConfig)}
    return FluidConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in names}).validate()


def libraries(mix: Dict):
    return STEP_LIBRARIES + (FRAME_LIBRARIES if mix["entry"] == "tick" else ())


def build(mix: Dict) -> None:
    """Compile the libraries the cell launches, all nvcc processes at once,
    into the package's build directory inside the checkout."""
    from tpufluid_torch.ops.cuda import build as _build

    _build.build(libraries(mix))


def tick_kind(traffic: Traffic):
    """The fleet's program kind: K substeps where a sim runs faster than 1,
    else "scalar" (one shared dt)."""
    k = int(traffic.substeps.max())
    return k if k > 1 else "scalar"


def tick_dt(traffic: Traffic, t: int, kind):
    """The dt argument of the tick at traffic row ``t``."""
    row = traffic.dts[t]
    if kind == "scalar":
        return np.float32(row[0])
    k = np.arange(kind)[:, None]
    return np.where(k < traffic.substeps[None, :], row[None, :], 0.0).astype(np.float32)


class Program:
    """The cell's entry on ``device``: ``init()`` makes the zero state and
    ``call(state, t)`` runs the call at traffic row ``t``, returning the new
    state and, for a tick, its frames on the card (uint8, (B, H, W, 3))."""

    def __init__(self, cfg: Dict, mix: Dict, traffic: Traffic, device: torch.device):
        from tpufluid_torch.serve_batch import make_tick_program
        from tpufluid_torch.step import make_multi_step

        self.config = fluid_config(cfg)
        self.mix, self.traffic, self.device = mix, traffic, device
        self.entry = mix["entry"]
        self.host_s = 0.0
        self.sims = mix["sims"]
        self.steps = mix.get("chunk", 1)
        if self.entry == "multi_step":
            if self.sims != 1:
                raise ValueError("multi_step drives one sim")
            self.fn = make_multi_step(self.config, device=device)
        elif self.entry == "tick":
            self.kind = tick_kind(traffic)
            self.fn = make_tick_program(self.config, self.sims, self.kind)
        else:
            raise ValueError(f"unknown entry {self.entry!r}")

    def init(self):
        from tpufluid_torch.state import FluidState

        c = self.config
        (sw, sh), (dw, dh) = c.sim_size, c.dye_size
        lead = () if self.entry == "multi_step" else (self.sims,)

        def zeros(*shape):
            return torch.zeros(lead + shape, dtype=c.dtype, device=self.device)

        return FluidState(velocity=zeros(2, sh, sw), dye=zeros(3, dh, dw), pressure=zeros(sh, sw))

    def call(self, state, t: int):
        """(new state, frames or None); ``host_s`` is then the host time
        inside the entry. A tick returns once its frames are complete."""
        tr, a = self.traffic, time.perf_counter()
        if self.entry == "multi_step":
            out = self.fn(state, tr.dts[t:t + self.steps, 0], tr.splats[t:t + self.steps, 0])
            self.host_s = time.perf_counter() - a
            return out, None
        state, frames = self.fn(state, tick_dt(tr, t, self.kind), tr.splats[t])
        self.host_s = time.perf_counter() - a
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state, frames


def fields(state) -> Dict[str, torch.Tensor]:
    """A state's fields as float32 tensors with a leading sim axis."""
    out = {}
    for f in ("velocity", "dye", "pressure"):
        x = getattr(state, f) if not isinstance(state, dict) else state[f]
        x = x.to(torch.float32)
        out[f] = x if x.ndim == (4 if f != "pressure" else 3) else x.unsqueeze(0)
    return out


def release() -> None:
    """Hand the caching allocator's free blocks back before the reference."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_name(device: torch.device) -> Optional[str]:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else None
