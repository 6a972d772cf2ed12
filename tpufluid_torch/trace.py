"""Pointer traces: the deterministic record/replay seam.

The reference turns mouse/touch events into per-frame splat calls through a
pointer state machine and a queued random-splat stack. Here that machinery is
headless and deterministic, and pure numpy:

  * ``Pointer`` reproduces the texcoord / aspect-corrected-delta math.
  * ``PointerTracer`` consumes pixel-space events and emits per-step splat
    batches — what the reference's applyInputs + splatPointer inject.
  * ``random_splats`` reproduces multipleSplats from a seeded RNG.
  * ``Trace`` (v2: per-step dt) serializes to .npz for replay.

Given the same seed, every batch and dt equals ``tpufluid.trace``'s bit for
bit (tests/test_torch_trace.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpufluid_torch.config import MAX_DT, FluidConfig
from tpufluid_torch.ops.splat import SPLAT_COLS
from tpufluid_torch.utils.color import generate_color_np, wrap


@dataclasses.dataclass
class Pointer:
    """Reference pointerPrototype."""

    id: int = -1
    texcoord_x: float = 0.0
    texcoord_y: float = 0.0
    prev_texcoord_x: float = 0.0
    prev_texcoord_y: float = 0.0
    delta_x: float = 0.0
    delta_y: float = 0.0
    down: bool = False
    moved: bool = False
    color: Tuple[float, float, float] = (30.0, 0.0, 300.0)

    def on_down(self, pid: int, pos_x: float, pos_y: float, config: FluidConfig,
                color: Tuple[float, float, float]) -> None:
        """updatePointerDownData. pos in canvas pixels."""
        self.id = pid
        self.down = True
        self.moved = False
        self.texcoord_x = pos_x / config.CANVAS_WIDTH
        self.texcoord_y = 1.0 - pos_y / config.CANVAS_HEIGHT
        self.prev_texcoord_x = self.texcoord_x
        self.prev_texcoord_y = self.texcoord_y
        self.delta_x = 0.0
        self.delta_y = 0.0
        self.color = color

    def on_move(self, pos_x: float, pos_y: float, config: FluidConfig) -> None:
        """updatePointerMoveData + correctDeltaX/Y."""
        if not self.down:
            return
        aspect = config.aspect_ratio
        self.prev_texcoord_x = self.texcoord_x
        self.prev_texcoord_y = self.texcoord_y
        self.texcoord_x = pos_x / config.CANVAS_WIDTH
        self.texcoord_y = 1.0 - pos_y / config.CANVAS_HEIGHT
        dx = self.texcoord_x - self.prev_texcoord_x
        dy = self.texcoord_y - self.prev_texcoord_y
        if aspect < 1:
            dx *= aspect
        if aspect > 1:
            dy /= aspect
        self.delta_x = dx
        self.delta_y = dy
        self.moved = abs(dx) > 0 or abs(dy) > 0

    def on_up(self) -> None:
        self.down = False

    def drain(self, config: FluidConfig) -> Optional[Tuple]:
        """splatPointer: one splat if moved, clears the flag."""
        if not self.moved:
            return None
        self.moved = False
        return (
            self.texcoord_x,
            self.texcoord_y,
            self.delta_x * config.SPLAT_FORCE,
            self.delta_y * config.SPLAT_FORCE,
            self.color,
        )


def random_splats(rng: np.random.Generator, n: int) -> List[Tuple]:
    """multipleSplats(n): random position, 10x color, +/-500 velocity."""
    events = []
    for _ in range(n):
        r, g, b = generate_color_np(rng)
        color = (r * 10.0, g * 10.0, b * 10.0)
        x = float(rng.random())
        y = float(rng.random())
        dx = 1000.0 * (float(rng.random()) - 0.5)
        dy = 1000.0 * (float(rng.random()) - 0.5)
        events.append((x, y, dx, dy, color))
    return events


class ColorCycler:
    """Seeded color cycling (updateColors): every 1/COLOR_UPDATE_SPEED
    accumulated sim-seconds, re-roll pointer colors."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.timer = 0.0

    def tick(self, dt: float, config: FluidConfig, pointers: Sequence[Pointer]) -> None:
        if not config.COLORFUL:
            return
        self.timer += dt * config.COLOR_UPDATE_SPEED
        if self.timer >= 1.0:
            self.timer = wrap(self.timer, 0.0, 1.0)
            for p in pointers:
                p.color = generate_color_np(self.rng)


class PointerTracer:
    """Replays pixel-space pointer events into per-step splat batches.

    Events: (kind, pointer_id, x, y) with kind in {"down","move","up"}, plus
    ("burst", n) for the random-splat stack. Deterministic given the seed.
    """

    def __init__(self, config: FluidConfig, seed: int = 0):
        self.config = config
        self.rng = np.random.default_rng(seed)
        self.pointers: Dict[int, Pointer] = {}
        self.cycler = ColorCycler(seed + 1)
        self.splat_stack: List[int] = []
        self._spill: List[Tuple] = []  # burst overflow carried to later steps

    def _pointer(self, pid: int) -> Pointer:
        if pid not in self.pointers:
            self.pointers[pid] = Pointer()
        return self.pointers[pid]

    def feed(self, kind: str, pid: int = -1, x: float = 0.0, y: float = 0.0,
             n: int = 0) -> None:
        if kind == "down":
            self._pointer(pid).on_down(pid, x, y, self.config, generate_color_np(self.rng))
        elif kind == "move":
            self._pointer(pid).on_move(x, y, self.config)
        elif kind == "up":
            self._pointer(pid).on_up()
        elif kind == "burst":
            self.splat_stack.append(n)
        else:
            raise ValueError(f"unknown event kind {kind!r}")

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of the whole input-side session state:
        both RNG cursors (bursts, color cycling), the color-cycle timer,
        every pointer's state machine, the pending bursts and the spill —
        everything ``drain_step`` reads. The dict is tpufluid.trace's, so a
        session saved by either package resumes in the other."""
        return {
            "rng": self.rng.bit_generator.state,
            "cycler_rng": self.cycler.rng.bit_generator.state,
            "cycler_timer": self.cycler.timer,
            "pointers": {str(pid): dataclasses.asdict(p)
                         for pid, p in self.pointers.items()},
            "splat_stack": list(self.splat_stack),
            "spill": [[x, y, dx, dy, list(c)] for (x, y, dx, dy, c) in self._spill],
        }

    def load_state_dict(self, d: dict) -> None:
        self.rng.bit_generator.state = d["rng"]
        self.cycler.rng.bit_generator.state = d["cycler_rng"]
        self.cycler.timer = float(d["cycler_timer"])
        self.pointers = {int(pid): Pointer(**{**pd, "color": tuple(pd["color"])})
                         for pid, pd in d["pointers"].items()}
        self.splat_stack = [int(n) for n in d["splat_stack"]]
        self._spill = [(e[0], e[1], e[2], e[3], tuple(e[4])) for e in d["spill"]]

    def drain_step(self, dt: float) -> List[Tuple]:
        """applyInputs: pop one burst and drain moved pointers. A burst larger
        than the MAX_SPLATS rows of one batch spills into later steps
        (pointer splats keep their own slots each step)."""
        self.cycler.tick(dt, self.config, list(self.pointers.values()))
        events: List[Tuple] = list(self._spill)
        self._spill = []
        if self.splat_stack:
            events.extend(random_splats(self.rng, self.splat_stack.pop()))
        pointer_events: List[Tuple] = []
        for p in self.pointers.values():
            e = p.drain(self.config)
            if e is not None:
                pointer_events.append(e)
        budget = self.config.MAX_SPLATS - len(pointer_events)
        if len(events) > budget:
            self._spill = events[budget:]
            events = events[:budget]
        return events + pointer_events


class Trace:
    """A recorded splat stream: (T, MAX_SPLATS, 8) float32, .npz-serializable.

    v2 records a per-step dt array ``dts`` (T,): the reference recomputes dt
    from wall time every frame. v1 files (one scalar dt) load as a constant
    dts array.
    """

    def __init__(self, batches: np.ndarray, dt):
        if batches.ndim != 3 or batches.shape[-1] != SPLAT_COLS:
            raise ValueError(f"batches must be (T, S, {SPLAT_COLS}), got {batches.shape}")
        self.batches = batches.astype(np.float32)
        dts = np.asarray(dt, np.float32).reshape(-1)
        if dts.size == 1:
            dts = np.full((self.batches.shape[0],), dts[0], np.float32)
        if dts.shape[0] != self.batches.shape[0]:
            raise ValueError(f"dts length {dts.shape[0]} != steps {self.batches.shape[0]}")
        # Clamped at record time too, at the literal MAX_DT.
        self.dts = np.minimum(dts, np.float32(MAX_DT))

    @property
    def num_steps(self) -> int:
        return self.batches.shape[0]

    @property
    def dt(self) -> float:
        """First-step dt (v1 compatibility: constant-rate traces)."""
        return float(self.dts[0]) if self.dts.size else 1.0 / 60.0

    def save(self, path: str) -> None:
        np.savez_compressed(path, batches=self.batches, dts=self.dts,
                            version=np.int32(2))

    @classmethod
    def load(cls, path: str) -> "Trace":
        data = np.load(path)
        if "dts" in data:
            return cls(data["batches"], data["dts"])
        return cls(data["batches"], float(data["dt"]))  # v1

    @classmethod
    def from_events(cls, per_step_events: Sequence[List[Tuple]], dt,
                    max_splats: int) -> "Trace":
        """``dt``: scalar (constant rate) or per-step sequence of seconds."""
        t = len(per_step_events)
        out = np.zeros((t, max_splats, SPLAT_COLS), dtype=np.float32)
        for i, events in enumerate(per_step_events):
            if len(events) > max_splats:
                raise ValueError(f"step {i}: {len(events)} events > MAX_SPLATS")
            for j, (x, y, dx, dy, color) in enumerate(events):
                out[i, j] = [x, y, dx, dy, color[0], color[1], color[2], 1.0]
        return cls(out, dt)


def generate_color(rng: np.random.Generator) -> Tuple[float, float, float]:
    """The reference's generateColor: a random hue at full saturation and
    value, times 0.15 (utils/color.generate_color_np)."""
    return generate_color_np(rng)


def swirl_trace(config: FluidConfig, num_steps: int, dt: float = 1.0 / 60.0,
                seed: int = 0) -> Trace:
    """A canonical deterministic trace: one pointer swirling an ellipse plus a
    burst at step 0 — the replay workload of the benchmarks and tests."""
    tracer = PointerTracer(config, seed=seed)
    w, h = config.CANVAS_WIDTH, config.CANVAS_HEIGHT
    tracer.feed("burst", n=min(8, config.MAX_SPLATS - 1))
    tracer.feed("down", pid=0, x=w * 0.5, y=h * 0.5)
    per_step = []
    for t in range(num_steps):
        ang = 2.0 * np.pi * (t / 120.0)
        x = w * (0.5 + 0.3 * np.cos(ang))
        y = h * (0.5 + 0.3 * np.sin(2 * ang))
        tracer.feed("move", pid=0, x=x, y=y)
        per_step.append(tracer.drain_step(dt))
    return Trace.from_events(per_step, dt, config.MAX_SPLATS)
