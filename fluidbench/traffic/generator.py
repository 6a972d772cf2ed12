"""The general traffic generator: a mix file of parameters -> each sim's
splat rows and dts, made from the seed on the host.

A sim's input is the WebGL reference's pointer machinery, replayed
headless: one pointer held down and dragged along a figure of eight
(x = cx + ax cos(a), y = cy + ay sin(2 a), a advancing 2 pi / period a
step from a phase), its splat each step it moves (texcoords, the delta
times SPLAT_FORCE, aspect-corrected, in the pointer's colour); the colours
re-rolled every 1 / COLOR_UPDATE_SPEED of sim time (updateColors); and,
every ``every`` steps, a burst of random splats (multipleSplats: a random
position, 10 times a random colour, +/-500 velocity) of a drawn size. A
step holds MAX_SPLATS rows; a burst that does not fit spills into the next
steps. The arithmetic is that of the reference's pointer handlers, so a mix
with one sim, period 120, amplitude 0.3 and one burst of 8 at step 0 gives
tpufluid_torch.trace.swirl_trace's rows.

A mix (``traffic/<name>.json``):
  entry      the program's entry the cell drives: "multi_step",
             "sharded_multi_step" (the sharded step over the mesh that the
             configuration's MESH [ny, nx] names, on the cell's chips) or
             "tick"
  sims       sims driven together
  chunk      steps a call (the multi-step entries)
  length     steps (ticks) of input made; a run cycles through them
  dt         the frame's dt in seconds
  speeds     a tick's substeps of each sim (fast-forward); the tick takes
             max(speeds) substeps
  pointer    {"period": [lo, hi], "amp": [ax, ay]}: periods spaced evenly
             over the sims, which take them in an order drawn from the
             seed; phases drawn ("phase": "zero" fixes them)
  burst      {"every": steps, "first": step or "drawn", "size": [lo, hi]}:
             a sim's bursts take sizes spaced evenly over lo .. hi, capped
             at MAX_SPLATS - 1, in an order drawn from the seed
So every seed makes the same set of pointer speeds and burst sizes,
arriving in another order.
Seeds: sim i's pointer colours and bursts come from seed + i (the
reference's own random streams), its path and burst times from the seed
and i.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
COLS = 8


def load(name: str) -> Dict:
    return json.loads((HERE / f"{name}.json").read_text())


def hsv_to_rgb(h: float, s: float, v: float):
    i = int(np.floor(h * 6))
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i % 6]


def color(rng: np.random.Generator):
    """generateColor: a random hue at full saturation and value, times 0.15."""
    r, g, b = hsv_to_rgb(float(rng.random()), 1.0, 1.0)
    return (r * 0.15, g * 0.15, b * 0.15)


def random_splats(rng: np.random.Generator, n: int) -> List[Tuple]:
    out = []
    for _ in range(n):
        r, g, b = color(rng)
        x, y = float(rng.random()), float(rng.random())
        dx = 1000.0 * (float(rng.random()) - 0.5)
        dy = 1000.0 * (float(rng.random()) - 0.5)
        out.append((x, y, dx, dy, (r * 10.0, g * 10.0, b * 10.0)))
    return out


@dataclasses.dataclass
class Pointer:
    x: float = 0.0
    y: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    moved: bool = False
    color: Tuple = (30.0, 0.0, 300.0)


class Sim:
    """One sim's input stream: its pointer, colour cycle and bursts."""

    def __init__(self, cfg: Dict, seed: int):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.cycle_rng = np.random.default_rng(seed + 1)
        self.timer = 0.0
        self.pointer = None
        self.bursts: List[int] = []
        self.spill: List[Tuple] = []

    def down(self, px: float, py: float) -> None:
        cw, ch = self.cfg["CANVAS_WIDTH"], self.cfg["CANVAS_HEIGHT"]
        x, y = px / cw, 1.0 - py / ch
        self.pointer = Pointer(x=x, y=y, color=color(self.rng))

    def move(self, px: float, py: float) -> None:
        p, cw, ch = self.pointer, self.cfg["CANVAS_WIDTH"], self.cfg["CANVAS_HEIGHT"]
        aspect = cw / ch
        x, y = px / cw, 1.0 - py / ch
        dx, dy = x - p.x, y - p.y
        if aspect < 1:
            dx *= aspect
        if aspect > 1:
            dy /= aspect
        p.x, p.y, p.dx, p.dy = x, y, dx, dy
        p.moved = abs(dx) > 0 or abs(dy) > 0

    def drain(self, dt: float) -> List[Tuple]:
        """applyInputs of one step of ``dt`` sim seconds."""
        cfg = self.cfg
        if cfg["COLORFUL"]:
            self.timer += dt * cfg["COLOR_UPDATE_SPEED"]
            if self.timer >= 1.0:
                self.timer = (self.timer - 0.0) % 1.0 + 0.0
                if self.pointer is not None:
                    self.pointer.color = color(self.cycle_rng)
        events = self.spill
        self.spill = []
        if self.bursts:
            events = events + random_splats(self.rng, self.bursts.pop())
        mine = []
        p = self.pointer
        if p is not None and p.moved:
            p.moved = False
            mine.append((p.x, p.y, p.dx * cfg["SPLAT_FORCE"], p.dy * cfg["SPLAT_FORCE"], p.color))
        budget = cfg["MAX_SPLATS"] - len(mine)
        if len(events) > budget:
            self.spill, events = events[budget:], events[:budget]
        return events + mine


def rows(events: List[Tuple], max_splats: int) -> np.ndarray:
    out = np.zeros((max_splats, COLS), np.float32)
    for j, (x, y, dx, dy, c) in enumerate(events):
        out[j] = [x, y, dx, dy, c[0], c[1], c[2], 1.0]
    return out


def _spread(lo_hi, n: int, order: np.ndarray) -> np.ndarray:
    lo, hi = lo_hi
    return np.linspace(lo, hi, n)[order]


@dataclasses.dataclass
class Traffic:
    splats: np.ndarray     # (length, sims, MAX_SPLATS, 8) float32
    dts: np.ndarray        # (length, sims) float32: each sim's dt a step
    substeps: np.ndarray   # (sims,) int: a tick's substeps of each sim


def generate(mix: Dict, cfg: Dict, seed: int) -> Traffic:
    """Every sim's inputs for ``mix["length"]`` steps (ticks) from ``seed``."""
    n, length = mix["sims"], mix["length"]
    draw = np.random.default_rng([seed, 7])
    order = draw.permutation(n)
    host_dt = np.full(n, mix["dt"])
    sim_dt = host_dt.astype(np.float32)
    speeds = np.asarray(mix.get("speeds", [1] * n), np.int64)
    periods = _spread(mix["pointer"]["period"], n, order)
    ax, ay = mix["pointer"]["amp"]
    cw, ch = cfg["CANVAS_WIDTH"], cfg["CANVAS_HEIGHT"]
    burst = mix["burst"]
    cap = cfg["MAX_SPLATS"] - 1
    out = np.zeros((length, n, cfg["MAX_SPLATS"], COLS), np.float32)
    for i in range(n):
        own = np.random.default_rng([seed, 11, i])
        phase = 0.0 if mix["pointer"].get("phase") == "zero" else float(own.random()) * 2 * math.pi
        first = (int(own.integers(0, burst["every"])) if burst["first"] == "drawn"
                 else int(burst["first"]))
        count = len(range(first, length, burst["every"]))
        sizes = [min(int(round(x)), cap) for x in np.linspace(*burst["size"], count)]
        sizes = [sizes[k] for k in own.permutation(count)]
        sim = Sim(cfg, seed + i)
        applied = float(host_dt[i]) * int(speeds[i])
        for t in range(length):
            if t >= first and (t - first) % burst["every"] == 0:
                sim.bursts.append(sizes.pop())
            if t == 0:
                sim.down(cw * 0.5, ch * 0.5)
            a = 2.0 * np.pi * (t / periods[i]) + phase
            sim.move(cw * (0.5 + ax * np.cos(a)), ch * (0.5 + ay * np.sin(2 * a)))
            out[t, i] = rows(sim.drain(applied), cfg["MAX_SPLATS"])
    return Traffic(out, np.tile(sim_dt, (length, 1)), speeds)
