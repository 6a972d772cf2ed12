"""The reference over row bands of the whole grid, for a grid whose float32
fields and the step's temporaries no one device holds at once.

A band keeps whole rows [lo, hi) of the sim grid (and the dye's rows at the
same place) and is computed on MARGIN more rows on either side, inside the
grid, that are worked on and not compared. After a chunk of steps a texel
depends only on the texels within the chunk's reach of it, so where the
margin covers that reach the kept rows come out of ``fluid.step`` with the
band's first row by the same float32 operations as over the whole grid, bit
for bit. One step reaches, in sim rows:

  PRESSURE_ITERATIONS   the Jacobi sweeps, a row each
  PRE_PRESSURE_LAYERS   the pre-pressure chain: curl, confinement, divergence
  GRADIENT              the gradient subtract
  2 * BACKTRACE         the velocity's and the dye's backtraces,
                        ceil(MAX_SPEED * MAX_DT) rows and the bilinear
                        corner's one more

and a chunk its steps times that. MAX_SPEED is the confinement's clamp; the
program's sharded step sizes its ghosts by the same bound.

Band height: BUDGET_BYTES over the float32 working set of a band's row,
BYTES_PER_TEXEL a texel of the larger grid on it. The budget leaves room
on an 80 GB card beside what a sharded run keeps there for the comparison:
ten states of the card's block (the kept calls' inputs and outputs), 32 GB
in bfloat16 at a 16384 x 16384 block.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fluidbench.reference import geometry

MAX_SPEED = 1000.0
PRE_PRESSURE_LAYERS = 3
GRADIENT = 1
BACKTRACE = int(np.ceil(MAX_SPEED * geometry.MAX_DT)) + 1
# Live float32 bytes of fluid.step beyond its inputs, a texel of the larger
# grid, which sets the peak: 196 with the sim and dye grids alike, 182 a dye
# texel where the dye has 16 times the sim's texels, 152 a sim texel the
# other way round (tracked on the CPU at 128-512 texels a side). With the
# inputs, the chunk's previous fields and the compared rows: 256.
BYTES_PER_TEXEL = 256
BUDGET_BYTES = 24 << 30

Rows = Dict[str, Tuple[int, int]]


def reach(cfg: Dict) -> int:
    """The sim rows one step reaches."""
    return cfg["PRESSURE_ITERATIONS"] + PRE_PRESSURE_LAYERS + GRADIENT + 2 * BACKTRACE


class Band(NamedTuple):
    """Kept sim rows and the rows computed for them, on a grid of ``sim_h``
    sim rows and ``dye_h`` dye rows."""

    keep: Tuple[int, int]
    run: Tuple[int, int]
    sim_h: int
    dye_h: int

    def rows(self, which: str) -> Rows:
        """Each field's rows of ``keep`` or ``run``."""
        lo, hi = getattr(self, which)
        dye = (lo * self.dye_h // self.sim_h, hi * self.dye_h // self.sim_h)
        return {"velocity": (lo, hi), "pressure": (lo, hi), "dye": dye}


def plan(cfg: Dict, steps: int, budget: Optional[int] = None) -> List[Band]:
    """The bands of a chunk of ``steps`` steps: its reach as the margin, as
    many kept rows a band as ``budget`` (default BUDGET_BYTES) leaves beside
    the margins, at least one step of ``unit`` rows."""
    (sh, sw), (dh, dw) = _grids(cfg)
    unit = _unit(cfg)
    m = -(-steps * reach(cfg) // unit) * unit
    row_bytes = BYTES_PER_TEXEL * max(sw, dw * dh / sh)
    budget = BUDGET_BYTES if budget is None else budget
    return bands(cfg, max(unit, (int(budget // row_bytes) - 2 * m) // unit * unit), m)


def bands(cfg: Dict, keep: int, margin: int) -> List[Band]:
    """Bands of ``keep`` kept sim rows with ``margin`` rows on either side,
    inside the grid; both whole steps of ``_unit`` rows, where sim and dye
    rows meet."""
    (sh, _), (dh, _) = _grids(cfg)
    unit = _unit(cfg)
    if keep % unit or margin % unit:
        raise ValueError(f"bands of {keep} rows and margins of {margin} split dye rows "
                         f"(a step of {unit} sim rows)")
    return [Band((lo, min(lo + keep, sh)), (max(0, lo - margin), min(sh, lo + keep + margin)),
                 sh, dh) for lo in range(0, sh, keep)]


def _grids(cfg: Dict):
    g = geometry.sizes(cfg)
    return g["sim"], g["dye"]


def _unit(cfg: Dict) -> int:
    """The fewest sim rows that span a whole number of dye rows."""
    (sh, _), (dh, _) = _grids(cfg)
    return sh // int(np.gcd(sh, dh))


def run(read: Callable[[Rows], Dict[str, torch.Tensor]],
        steps: Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]],
        bands: List[Band]) -> Iterator[Tuple[Band, Dict[str, torch.Tensor]]]:
    """Each band and its kept rows after ``steps``: ``read`` gives the
    fields' rows the band computes on, ``steps(fields, row0)`` steps them
    as a band from sim row ``row0``."""
    for b in bands:
        out = steps(read(b.rows("run")), b.run[0])
        run_rows, keep = b.rows("run"), b.rows("keep")
        yield b, {k: x[..., keep[k][0] - run_rows[k][0]:keep[k][1] - run_rows[k][0], :]
                  for k, x in out.items()}
