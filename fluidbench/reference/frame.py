"""The WebGL reference's frame (script.js render(), applyBloom,
applySunrays, the display shader, the blend) in plain PyTorch, for B sims at
once, to the servers' uint8 wire format.

Bloom: the dye resampled to the bloom base; the soft-knee prefilter; a
4-tap cross blur into each halved mip, then up again, each added into the
mip above; a last blur into the base, times the intensity. Sunrays: the
mask 1 - min(max(20 * max(r, g, b), 0), 0.8); 16 radial samples toward the
center (density 0.3, decay 0.95, exposure 0.7); one separable 3-tap blur.
Display: the dye at the canvas's texel centers, shaded by the diffuse term
of its neighbours' norms; bloom and dye darkened by the rays; the bloom
dithered by +/-1/255 of the blue-noise tile, gamma-encoded and added; alpha
max(r, g, b); blended over BACK_COLOR premultiplied. Quantized by
truncating clamp01 * 255, top row first.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fluidbench.reference import geometry
from fluidbench.reference.sampling import div, resample, sample_affine, sample_axis

GAMMA_EXPONENT = 0.416666667


def knee(c: torch.Tensor, threshold: float, soft_knee: float) -> torch.Tensor:
    k = threshold * soft_knee + 1e-4
    curve0, curve1, curve2 = threshold - k, k * 2.0, 0.25 / k
    br = c.amax(dim=-3)
    rq = (br - curve0).clamp(0.0, curve1)
    rq = curve2 * rq * rq
    scale = torch.maximum(rq, br - threshold) / br.clamp_min(1e-4)
    return c * scale.unsqueeze(-3)


def blur4(src: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    sh, sw = src.shape[-2:]
    tx, ty = 1.0 / sw, 1.0 / sh
    s = sample_affine(src, out_hw, ou=-tx)
    s = s + sample_affine(src, out_hw, ou=tx)
    s = s + sample_affine(src, out_hw, ov=-ty)
    s = s + sample_affine(src, out_hw, ov=ty)
    return s * 0.25


def bloom(dye: torch.Tensor, cfg: Dict) -> torch.Tensor:
    base_hw = geometry.sizes(cfg)["bloom"]
    mips_hw = geometry.bloom_mips(cfg)
    if len(mips_hw) < 2:
        return torch.zeros(dye.shape[:-3] + (3,) + base_hw, dtype=torch.float32,
                           device=dye.device)
    base = resample(dye, base_hw)
    last = base
    mips = []
    for k, hw in enumerate(mips_hw):
        src = knee(last, cfg["BLOOM_THRESHOLD"], cfg["BLOOM_SOFT_KNEE"]) if k == 0 else last
        last = blur4(src, hw)
        mips.append(last)
    for i in range(len(mips) - 2, -1, -1):
        mips[i] = mips[i] + blur4(last, tuple(mips[i].shape[-2:]))
        last = mips[i]
    return blur4(last, base_hw) * cfg["BLOOM_INTENSITY"]


def sunrays(dye: torch.Tensor, cfg: Dict) -> torch.Tensor:
    out_hw = geometry.sizes(cfg)["sunrays"]
    mask = 1.0 - (dye.amax(dim=-3) * 20.0).clamp_min(0.0).clamp_max(0.8)
    color = resample(mask, out_hw)
    decay = 1.0
    for k in range(1, 17):
        scale = 1.0 - k * (0.3 / 16)
        off = 0.5 * k * (0.3 / 16)
        col = sample_affine(mask, out_hw, su=scale, ou=off, sv=scale, ov=off)
        color = color + col * (decay * cfg["SUNRAYS_WEIGHT"])
        decay *= 0.95
    rays = color * 0.7
    h, w = out_hw
    tx, ty = 1.33333333 / w, 1.33333333 / h
    rays = (sample_affine(rays, out_hw) * 0.29411764
            + sample_affine(rays, out_hw, ou=-tx) * 0.35294117
            + sample_affine(rays, out_hw, ou=tx) * 0.35294117)
    return (sample_affine(rays, out_hw) * 0.29411764
            + sample_affine(rays, out_hw, ov=-ty) * 0.35294117
            + sample_affine(rays, out_hw, ov=ty) * 0.35294117)


def _norm(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0, :, :] * x[..., 0, :, :]
    for ch in range(1, x.shape[-3]):
        s = s + x[..., ch, :, :] * x[..., ch, :, :]
    return torch.sqrt(s)


def shaded(dye: torch.Tensor, out_hw: Tuple[int, int], shading: bool) -> torch.Tensor:
    """The display's dye tap; with shading, times clamp(nz / |n| + 0.7, 0.7, 1)
    of the normal (dx, dy, nz) from the norms one display texel away."""
    if not shading:
        return sample_affine(dye, out_hw)
    oh, ow = out_hw
    tx, ty = float(np.float32(1.0 / ow)), float(np.float32(1.0 / oh))
    nz = float(np.sqrt(np.float32((1.0 / ow) * (1.0 / ow) + (1.0 / oh) * (1.0 / oh))))
    rows = sample_axis(dye, oh, -2)
    c = sample_axis(rows, ow, -1)
    lc = sample_axis(rows, ow, -1, off=-tx)
    rc = sample_axis(rows, ow, -1, off=tx)
    cols = sample_axis(dye, ow, -1)
    tc = sample_axis(cols, oh, -2, off=ty)
    bc = sample_axis(cols, oh, -2, off=-ty)
    dx = _norm(rc) - _norm(lc)
    dy = _norm(tc) - _norm(bc)
    nz2 = float(np.float32(nz) * np.float32(nz))
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + nz2)
    diffuse = (nz * inv_len + 0.7).clamp(0.7, 1.0)
    return c * diffuse.unsqueeze(-3)


def frame(dye: torch.Tensor, cfg: Dict, dither: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, 3, Hd, Wd) float32 dye -> (B, H, W, 3) uint8 frames, top row
    first. ``dither`` is the (64, 64) blue-noise tile."""
    out_hw = geometry.sizes(cfg)["canvas"]
    oh, ow = out_hw
    c = shaded(dye, out_hw, cfg["SHADING"])
    bl = sample_affine(bloom(dye, cfg), out_hw) if cfg["BLOOM"] else None
    if cfg["SUNRAYS"]:
        rays = sample_affine(sunrays(dye, cfg), out_hw).unsqueeze(-3)
        c = c * rays
        if bl is not None:
            bl = bl * rays
    if bl is not None:
        noise = sample_affine(dither, out_hw, su=ow / dither.shape[-1], sv=oh / dither.shape[-2],
                              wrap=True)
        bl = bl + div(noise * 2.0 - 1.0, 255.0)[None]
        bl = (1.055 * torch.pow(bl.clamp_min(0.0), GAMMA_EXPONENT) - 0.055).clamp_min(0.0)
        c = c + bl
    a = c.amax(dim=-3, keepdim=True)
    back = torch.tensor([v / 255.0 for v in cfg["BACK_COLOR"]], dtype=torch.float32,
                        device=dye.device)[:, None, None]
    rgb = c + back * (1.0 - a)
    q = (rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.flip(q.movedim(-3, -1), dims=(-3,))
