"""Grid sizes of a configuration, as the WebGL reference derives them from
the canvas (getResolution, script.js): the shorter canvas side gets the
resolution, the longer side the resolution times the aspect, rounded."""

from __future__ import annotations

from typing import Dict, List, Tuple

MAX_DT = 0.016666   # the literal dt ceiling of calcDeltaTime (script.js)


def resolution(res: int, canvas_w: int, canvas_h: int) -> Tuple[int, int]:
    """(width, height) of a grid of resolution ``res`` on the canvas."""
    aspect = canvas_w / canvas_h
    if aspect < 1:
        aspect = 1.0 / aspect
    lo, hi = round(res), round(res * aspect)
    return (hi, lo) if canvas_w > canvas_h else (lo, hi)


def sizes(cfg: Dict) -> Dict[str, Tuple[int, int]]:
    """(height, width) of the sim, dye, bloom, sunrays grids and the canvas."""
    cw, ch = cfg["CANVAS_WIDTH"], cfg["CANVAS_HEIGHT"]
    out = {"canvas": (ch, cw)}
    for key, name in (("SIM_RESOLUTION", "sim"), ("DYE_RESOLUTION", "dye"),
                      ("BLOOM_RESOLUTION", "bloom"), ("SUNRAYS_RESOLUTION", "sunrays")):
        w, h = resolution(cfg[key], cw, ch)
        out[name] = (h, w)
    return out


def bloom_mips(cfg: Dict) -> List[Tuple[int, int]]:
    """(height, width) of each bloom mip below the base: base >> (i + 1),
    stopping where a side drops below 2."""
    bh, bw = sizes(cfg)["bloom"]
    out = []
    for i in range(cfg["BLOOM_ITERATIONS"]):
        mh, mw = bh >> (i + 1), bw >> (i + 1)
        if mw < 2 or mh < 2:
            break
        out.append((mh, mw))
    return out


def aspect(cfg: Dict) -> float:
    return cfg["CANVAS_WIDTH"] / cfg["CANVAS_HEIGHT"]


def splat_radius(cfg: Dict) -> float:
    """correctRadius: SPLAT_RADIUS / 100, times the aspect on a wide canvas."""
    r = cfg["SPLAT_RADIUS"] / 100.0
    a = aspect(cfg)
    return r * a if a > 1 else r
