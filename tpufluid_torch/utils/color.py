"""Color helpers (reference HSVtoRGB / generateColor / wrap)."""

from __future__ import annotations

import numpy as np


def hsv_to_rgb(h: float, s: float, v: float):
    """HSV -> RGB, the exact 6-sector formulation of the reference."""
    i = int(np.floor(h * 6))
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r, g, b = [
        (v, t, p), (q, v, p), (p, v, t),
        (p, q, v), (t, p, v), (v, p, q),
    ][i % 6]
    return r, g, b


def generate_color_np(rng: np.random.Generator):
    """Random saturated hue scaled by 0.15 (reference generateColor)."""
    r, g, b = hsv_to_rgb(float(rng.random()), 1.0, 1.0)
    return (r * 0.15, g * 0.15, b * 0.15)


def wrap(value: float, lo: float, hi: float) -> float:
    """(value - lo) % (hi - lo) + lo."""
    rng = hi - lo
    if rng == 0:
        return lo
    return (value - lo) % rng + lo
