"""Sunrays: volumetric light-scattering march + separable blur. Mirrors
``tpufluid.ops.sunrays``, which is jnp ops there (no TPU kernel).

These ops are the plain version of the CUDA pass (csrc/sunrays.cu, wrapped
by ops/cuda/sunrays.py: a march launch that masks the dye once in shared
memory, the mask and the column stages never in device memory, and a blur
launch), which the render runs on a CUDA dye; the render runs these ops on
a CPU dye, and plain_render on any device.

Reference applySunrays/blur (script.js:1396-1419) and the
sunraysMask/sunrays/blur shaders (script.js:676-724, 479-494):

  1. mask: alpha = 1 - min(max(20 * max(r,g,b), 0), 0.8) over the dye.
  2. march: 16 radial steps toward screen center (0.5, 0.5) with Density 0.3,
     Decay 0.95, Exposure 0.7, accumulating mask alpha, at SUNRAYS_RESOLUTION.
  3. blur: one iteration of a separable 3-tap Gaussian with linear-tap offset
     1.33333 texels (weights 0.29411764 center, 0.35294117 each side).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpufluid_torch.ops.sampling import sample_affine

SUNRAYS_ITERATIONS = 16
_DENSITY = 0.3
_DECAY = 0.95
_EXPOSURE = 0.7


def sunrays_mask(dye_rgb: torch.Tensor) -> torch.Tensor:
    """Mask alpha at dye resolution (sunraysMaskShader, script.js:676-689):
    (..., 3, H, W) -> (..., H, W), the max over the channel axis -3."""
    br = dye_rgb.amax(dim=-3)
    return 1.0 - (br * 20.0).clamp_min(0.0).clamp_max(0.8)


def sunrays_march(mask_alpha: torch.Tensor, out_hw: Tuple[int, int],
                  weight: float) -> torch.Tensor:
    """16-step radial march (sunraysShader, script.js:691-724) -> (h, w).

    Step k samples at coord = uv*(1 - k*Density/16) + 0.5*k*Density/16, an
    affine scale toward the center; scale, offset and decay*weight are
    Python doubles that round to float32 where they are used."""
    color = sample_affine(mask_alpha, out_hw)
    decay = 1.0
    for k in range(1, SUNRAYS_ITERATIONS + 1):
        scale = 1.0 - k * (_DENSITY / SUNRAYS_ITERATIONS)
        off = 0.5 * k * (_DENSITY / SUNRAYS_ITERATIONS)
        col = sample_affine(mask_alpha, out_hw, su=scale, ou=off, sv=scale, ov=off)
        color = color + col * (decay * weight)
        decay *= _DECAY
    return color * _EXPOSURE


def blur_separable(tex: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Separable 3-tap blur with 1.33333-texel linear taps (blurShader, 479-494)."""
    h, w = tex.shape[-2], tex.shape[-1]
    off = 1.33333333
    tx, ty = off / w, off / h
    out = tex
    hw = (h, w)
    for _ in range(iterations):
        out = (sample_affine(out, hw) * 0.29411764
               + sample_affine(out, hw, ou=-tx) * 0.35294117
               + sample_affine(out, hw, ou=tx) * 0.35294117)
        out = (sample_affine(out, hw) * 0.29411764
               + sample_affine(out, hw, ov=-ty) * 0.35294117
               + sample_affine(out, hw, ov=ty) * 0.35294117)
    return out


def apply_sunrays(dye_rgb: torch.Tensor, out_hw: Tuple[int, int], weight: float) -> torch.Tensor:
    """mask -> march -> 1x separable blur (render(), script.js:1299-1302)."""
    mask = sunrays_mask(dye_rgb)
    rays = sunrays_march(mask, out_hw, weight)
    return blur_separable(rays, iterations=1)
