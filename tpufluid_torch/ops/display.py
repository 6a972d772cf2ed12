"""Display composite — the display shader of the reference
(displayShaderSource, script.js:549-612) plus the blend-mode composition of
render() (script.js:1296-1348). Mirrors ``tpufluid.ops.display``; these are
also the plain versions of the display kernel (ops/cuda/display.py), so
every step is written in the order the kernel computes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpufluid_torch.ops.sampling import sample_affine, sample_affine_axis, true_div, uv_grid

GAMMA_EXPONENT = 0.416666667


def linear_to_gamma(color: torch.Tensor) -> torch.Tensor:
    """max(1.055 * c^(1/2.4) - 0.055, 0) (script.js:563-566)."""
    color = color.clamp_min(0.0)
    return (1.055 * torch.pow(color, GAMMA_EXPONENT) - 0.055).clamp_min(0.0)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum over the channels (axis -3) of x*x, summed from
    channel 0 in order."""
    s = x[..., 0, :, :] * x[..., 0, :, :]
    for ch in range(1, x.shape[-3]):
        s = s + x[..., ch, :, :] * x[..., ch, :, :]
    return torch.sqrt(s)


def shading_constants(out_hw: Tuple[int, int]) -> Tuple[float, float, float]:
    """(tx, ty, nz) of the shading taps: one display texel, and
    nz = sqrt(float32(tx*tx + ty*ty)) with the sum taken in Python doubles,
    as the JAX package does; all three hold float32 values."""
    out_h, out_w = out_hw
    tx, ty = 1.0 / out_w, 1.0 / out_h
    nz = np.sqrt(np.float32(tx * tx + ty * ty))
    return float(np.float32(tx)), float(np.float32(ty)), float(nz)


def shaded_base(dye_rgb: torch.Tensor, out_hw: Tuple[int, int],
                shading: bool) -> torch.Tensor:
    """The display's dye sampling: center tap, with SHADING multiplied by the
    diffuse term from the four 1-display-texel neighbor norms
    (script.js:571-584). Stage order per tap, as in the JAX package: the
    center, left and right taps take rows, then columns; the top and bottom
    taps columns, then rows."""
    out_h, out_w = out_hw
    if not shading:
        return sample_affine(dye_rgb, out_hw)
    tx, ty, nz = shading_constants(out_hw)
    rows = sample_affine_axis(dye_rgb, out_h, axis=-2)
    c = sample_affine_axis(rows, out_w, axis=-1)
    lc = sample_affine_axis(rows, out_w, axis=-1, off=-tx)
    rc = sample_affine_axis(rows, out_w, axis=-1, off=tx)
    cols = sample_affine_axis(dye_rgb, out_w, axis=-1)
    tc = sample_affine_axis(cols, out_h, axis=-2, off=ty)
    bc = sample_affine_axis(cols, out_h, axis=-2, off=-ty)
    dx = channel_norm(rc) - channel_norm(lc)
    dy = channel_norm(tc) - channel_norm(bc)
    nz2 = float(np.float32(nz) * np.float32(nz))
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + nz2)
    diffuse = (nz * inv_len + 0.7).clamp(0.7, 1.0)
    return c * diffuse.unsqueeze(-3)


def display_composite(
    dye_rgb: torch.Tensor,
    out_hw: Tuple[int, int],
    shading: bool,
    bloom_tex: Optional[torch.Tensor],
    sunrays_tex: Optional[torch.Tensor],
    dither_tex: Optional[torch.Tensor],
    base: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> (..., 4, h, w) premultiplied RGBA (alpha = max(r,g,b),
    script.js:608-609), with the channel axis -3 and any leading axes those
    of the dye, bloom and sunrays (the dither is one tile for all).

    Every source is sampled bilinearly at the display target's texel
    centers (columns, then rows); the dither (64x64, REPEAT) at
    uv * target/texture size. ``base`` optionally supplies the shaded
    center taps."""
    out_h, out_w = out_hw
    c = shaded_base(dye_rgb, out_hw, shading) if base is None else base

    bloom = None
    if bloom_tex is not None:
        bloom = sample_affine(bloom_tex, out_hw)

    if sunrays_tex is not None:
        rays = sample_affine(sunrays_tex, out_hw)
        c = c * rays.unsqueeze(-3)
        if bloom is not None:
            bloom = bloom * rays.unsqueeze(-3)

    if bloom is not None:
        if dither_tex is not None:
            scale_x = out_w / dither_tex.shape[-1]
            scale_y = out_h / dither_tex.shape[-2]
            noise = sample_affine(dither_tex, out_hw, su=scale_x, sv=scale_y, wrap=True)
            bloom = bloom + true_div(noise * 2.0 - 1.0, 255.0)[None]
        bloom = linear_to_gamma(bloom)
        c = c + bloom

    a = c.amax(dim=-3)
    return torch.cat([c, a.unsqueeze(-3)], dim=-3)


def checkerboard(out_hw: Tuple[int, int], aspect: float, device=None) -> torch.Tensor:
    """Transparent-mode backdrop (checkerboardShader, script.js:531-547) -> (4,h,w)."""
    out_h, out_w = out_hw
    u, v = uv_grid(out_h, out_w, device=device)
    fu = torch.floor(u * 25.0 * aspect)
    fv = torch.floor(v * 25.0)
    val = torch.remainder(fu + fv, 2.0) * 0.1 + 0.8
    rgb = val[None].expand(3, out_h, out_w)
    return torch.cat([rgb, torch.ones((1, out_h, out_w), dtype=rgb.dtype, device=rgb.device)])


def blend_premultiplied(src_rgba: torch.Tensor, dst_rgba: torch.Tensor) -> torch.Tensor:
    """GL blendFunc(ONE, ONE_MINUS_SRC_ALPHA): out = src + dst * (1 - src.a),
    alpha the fourth channel of axis -3; dst broadcasts (one backdrop for a
    batch)."""
    a = src_rgba[..., 3:4, :, :]
    return src_rgba + dst_rgba * (1.0 - a)
