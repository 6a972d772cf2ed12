"""Operation costs and shared counts of the work models, frozen from
tpufluid_torch/ops/cuda/check.py.

Float32 operations are counted at their cost in the card's float32 pipe
(128 lanes a clock an SM; its special function unit does 16, so one of its
instructions counts as 8): an add, multiply, compare or conversion 1; an
IEEE division 18; an IEEE sqrtf 16; a powf 56. One axis coordinate is a
division and 7 more operations; one lerp 4; the soft knee 13 per source
texel with its division.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from fluidbench.reference import geometry

DIV, SQRT, POW = 18, 16, 56
AXIS, LERP = DIV + 7, 4
KNEE = 12 + DIV
# The pre-pressure chain a texel: the bump's add to the velocity (2), the
# curl (4), the confinement (4 + 4 + 3 + sqrtf + 1 + division + 5 + 8) and
# the divergence (4); beside it the bump's 2 operations a channel and
# active splat.
PRE_PRESSURE = 2 + 4 + (4 + 4 + 3 + SQRT + 1 + DIV + 5 + 8) + 4


def grids(cfg: Dict) -> Dict[str, Tuple[int, int]]:
    return geometry.sizes(cfg)


def quant(cfg: Dict) -> bool:
    return bool(cfg["DYE_RGB9E5"]) and cfg["DTYPE"] == "bfloat16"


def blur4_flops(out_hw, prefilter_texels: int) -> int:
    """One bloom stage: 6 axis coordinates a texel; a channel 4 taps of 3
    lerps, their sum, x 0.25 and the add or the intensity scale."""
    oh, ow = out_hw
    return oh * ow * (6 * AXIS + 3 * (4 * 3 * LERP + 5)) + KNEE * prefilter_texels


def pyramid_flops(base_hw, mips) -> int:
    """Every stage of the bloom pyramid, down, up and final; ``mips`` as
    (height, width)."""
    n = blur4_flops(mips[0], base_hw[0] * base_hw[1])
    n += sum(blur4_flops(x, 0) for x in mips[1:])
    n += sum(blur4_flops(x, 0) for x in mips[:-1])
    return n + blur4_flops(base_hw, 0)


def display_flops(dye_hw, out_hw, c: int, shading: bool, extras: Dict) -> int:
    """One composed display pass: each axis coordinate once a row or column,
    each separable stage's lerps over the grid it makes, then a texel the
    channel norms, sqrtf, the diffuse term, the gamma's powf, the dither's
    division and the alpha. ``extras``: "bloom", "sunrays", "dither" to
    their (h, w)."""
    (h, w), (oh, ow) = dye_hw, out_hw
    texels = oh * ow
    if shading:
        n = 3 * (oh + ow) * AXIS
        n += c * LERP * (oh * w + 3 * texels + h * ow + 2 * texels)
        n += texels * (4 * (2 * c - 1) + 4 * SQRT + 2 + 5 + DIV + SQRT + 4 + c)
    else:
        n = (oh + ow) * AXIS + c * LERP * (h * ow + texels)
    n += texels * (c - 1)
    for name, (th, tw) in extras.items():
        ch = 3 if name == "bloom" else 1
        n += (oh + ow) * AXIS + ch * LERP * (th * ow + texels)
    if "sunrays" in extras:
        n += texels * (c + (3 if "bloom" in extras else 0))
    if "bloom" in extras:
        n += texels * 3 * (POW + 5)
    if "dither" in extras:
        n += texels * (2 + DIV + 3)
    return n


def _taps(n_in: int, n_out: int, off: float) -> set:
    """Indices the two corners of a clamped separable stage touch."""
    p = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) / np.float32(n_out)
         + np.float32(off)).astype(np.float32)
    x0 = np.floor(p * np.float32(n_in) - np.float32(0.5)).astype(np.int64)
    return set(np.clip(x0, 0, n_in - 1).tolist()) | set(np.clip(x0 + 1, 0, n_in - 1).tolist())


def dye_texels_read(dye_hw, out_hw, shading: bool) -> int:
    """Texels of one dye channel a display pass must read: the rows and
    columns its taps touch; with shading, the center's rows by every column
    of the center, left and right taps, and the above and below taps' other
    rows by the center's columns."""
    (h, w), (oh, ow) = dye_hw, out_hw
    tx, ty = float(np.float32(1.0 / ow)), float(np.float32(1.0 / oh))
    rows, cols = _taps(h, oh, 0.0), _taps(w, ow, 0.0)
    if not shading:
        return len(rows) * len(cols)
    sides = _taps(w, ow, tx) | _taps(w, ow, -tx)
    above_below = _taps(h, oh, ty) | _taps(h, oh, -ty)
    return len(rows) * len(cols | sides) + len(above_below - rows) * len(cols)
