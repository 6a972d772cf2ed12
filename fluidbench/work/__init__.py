"""Work models of the passes: the bytes a pass must move (each input read
once, each output written once) and the float32 operations it needs,
weighted by their cost in the card's float32 pipe, at a cell's shapes.

One module a pass (``work/<pass>.py``, a function ``work(shape)`` giving a
unit's bytes and operations), and one file a kernel
(``work/kernels/<kernel>.json``, ``{"pass": ...}``) mapping the kernel's
name in the device trace to the pass it does, so a later kernel that does a
pass's work is added as a file. Frozen from the program's own models
(tpufluid_torch/ops/cuda/check.py: Case.nbytes and flops, _pyramid_flops,
_display_flops) so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
from pathlib import Path
from typing import Dict, Tuple

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Shape:
    """What a unit of a cell (a step of its sims, or a fleet tick) runs on."""

    cfg: Dict             # the configuration file's fields
    sims: int             # sims a launch takes
    item: int             # bytes of a stored field value
    steps: int            # steps of the sims in the unit (a tick's substeps)
    active: float         # active splat rows a unit, over every sim
    frames: int           # frames of the sims in the unit (0 or 1)


@functools.lru_cache(maxsize=None)
def kernel_pass(kernel: str):
    """The pass a kernel of the device trace does, or None."""
    f = HERE / "kernels" / f"{kernel}.json"
    return json.loads(f.read_text())["pass"] if f.is_file() else None


def pass_work(name: str, shape: Shape) -> Tuple[int, int]:
    """(bytes, operations) of pass ``name`` in one unit."""
    return importlib.import_module(f"fluidbench.work.{name}").work(shape)


def passes():
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem not in ("__init__", "costs"))
