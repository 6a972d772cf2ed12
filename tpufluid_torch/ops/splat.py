"""Gaussian splat impulse (the reference's splatShader and splat()).

``out = base + exp(-||p||^2 / radius) * amount`` with p = (uv - point) and
p.x scaled by the canvas aspect ratio. One splat event writes the same
gaussian into the velocity grid (amount = (dx, dy)) and the dye grid
(amount = rgb).

Splats enter the step as a fixed-size (MAX_SPLATS, 8) array
[x, y, dx, dy, r, g, b, active]; rows with active = 0 contribute nothing.
The gaussian is separable, so a batch of S splats is a rank-S update
gy (H, S) . diag(amt[:, c]) . gx (S, W) per channel — the kernels take the
three factors and sum the S terms themselves.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops.sampling import true_div, uv_grid

# Columns of a splat event row.
SPLAT_X, SPLAT_Y, SPLAT_DX, SPLAT_DY = 0, 1, 2, 3
SPLAT_R, SPLAT_G, SPLAT_B, SPLAT_ACTIVE = 4, 5, 6, 7
SPLAT_COLS = 8


def gaussian_splat(h: int, w: int, x, y, radius: float, aspect: float,
                   device=None) -> torch.Tensor:
    """exp(-||p||^2 / radius) over an (h, w) grid in float32; p.x
    aspect-corrected."""
    u, v = uv_grid(h, w, device=device)
    px = (u - x) * aspect
    py = v - y
    return torch.exp(true_div(-(px * px + py * py), radius))


def splat_field(field: torch.Tensor, x, y, amount, radius: float,
                aspect: float) -> torch.Tensor:
    """Add one gaussian impulse to ``field`` (C, H, W); ``amount`` has shape
    (C,). The gaussian and the amount are cast to the field's dtype and the
    sum is taken there, as tpufluid's splat_field takes it."""
    h, w = field.shape[-2], field.shape[-1]
    g = gaussian_splat(h, w, x, y, radius, aspect, device=field.device).to(field.dtype)
    amount = torch.as_tensor(amount, device=field.device).to(field.dtype)
    return field + amount[:, None, None] * g[None]


def _texel_centers(n: int, start: int, total: int, device) -> torch.Tensor:
    """(i + 0.5) / total of the ``n`` global texels start, start + 1, ...
    of an axis of ``total`` texels, each index clamped to [0, total - 1]
    in float32 (the whole axis, start 0, takes no clamp)."""
    idx = torch.arange(n, dtype=torch.float32, device=device)
    if (start, total) != (0, n):
        idx = torch.clamp(idx + start, 0, total - 1)
    return true_div(idx + 0.5, float(total))


def _gaussians(splats: torch.Tensor, h: int, w: int, radius: float, aspect: float,
               row0: int = 0, h_total=None, col0: int = 0, w_total=None):
    """(gy (..., S, H), gx (..., S, W)): the two 1-D gaussians of every
    splat row of an (..., S, 8) batch, at the global rows and columns of
    splat_factors."""
    dev = splats.device
    u = _texel_centers(w, col0, w if w_total is None else w_total, dev)
    v = _texel_centers(h, row0, h if h_total is None else h_total, dev)
    px = (u - splats[..., SPLAT_X, None]) * aspect
    py = v - splats[..., SPLAT_Y, None]
    gx = torch.exp(true_div(-(px * px), radius))
    gy = torch.exp(true_div(-(py * py), radius))
    return gy, gx


def splat_factors(splats: torch.Tensor, h: int, w: int, radius: float,
                  aspect: float, amount_cols: slice, row0: int = 0, h_total=None,
                  col0: int = 0, w_total=None):
    """Separable factors of the splat batch for fusion into the kernels:
    (gy (H, S), gx (S, W), amt (S, C)) float32, inactive rows zeroed. A
    (B, S, 8) batch of sims gives (B, H, S), (B, S, W), (B, S, C) in one
    set of ops; elementwise, so each sim's factors are its own bit for bit.

    row0/h_total (and col0/w_total): the factors of the global rows
    [row0, row0 + h) (columns [col0, col0 + w)) of an (h_total, w_total)
    grid, a shard's halo-padded block; a row or column outside the grid
    takes the edge's, as the ghosts a halo exchange replicates there. Rows
    inside the grid get the bits of the whole grid's factors."""
    splats = splats.to(torch.float32)
    gy, gx = _gaussians(splats, h, w, radius, aspect, row0, h_total, col0, w_total)
    amt = splats[..., amount_cols] * splats[..., SPLAT_ACTIVE:SPLAT_ACTIVE + 1]
    return gy.transpose(-1, -2).contiguous(), gx.contiguous(), amt.contiguous()


def splat_bump(gy: torch.Tensor, gx: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """(C, H, W) float32 bump sum_s (gy[h, s] * amt[s, c]) * gx[s, w], summed
    over s in order from 0 — the kernels' order and rounding, so a kernel
    and this plain version agree bit for bit."""
    s_rows = gy.shape[1]
    acc = torch.zeros((amt.shape[1], gy.shape[0], gx.shape[1]),
                      dtype=torch.float32, device=gy.device)
    for s in range(s_rows):
        acc = acc + (gy[None, :, s, None] * amt[s][:, None, None]) * gx[s][None, None, :]
    return acc


def _splat_sum(field: torch.Tensor, splats: torch.Tensor, amounts: torch.Tensor,
               radius: float, aspect: float) -> torch.Tensor:
    """field (C, H, W) + sum over S splats of gauss_s * amount_s, as one
    rank-S einsum; added in float32, rounded to the field's dtype."""
    h, w = field.shape[-2], field.shape[-1]
    gy, gx = _gaussians(splats, h, w, radius, aspect)
    bump = torch.einsum("sc,sh,sw->chw", amounts.to(torch.float32), gy, gx)
    return (field.to(torch.float32) + bump).to(field.dtype)


def apply_splat_batch(velocity: torch.Tensor, dye: torch.Tensor,
                      splats: torch.Tensor, radius: float, aspect: float):
    """Apply an (S, 8) batch of splat events to velocity (2, H, W) and dye
    (3, Hd, Wd); inactive rows contribute amount * 0."""
    splats = splats.to(torch.float32)
    active = splats[:, SPLAT_ACTIVE:SPLAT_ACTIVE + 1]
    vamt = splats[:, SPLAT_DX:SPLAT_DY + 1] * active
    camt = splats[:, SPLAT_R:SPLAT_B + 1] * active
    velocity = _splat_sum(velocity, splats, vamt, radius, aspect)
    dye = _splat_sum(dye, splats, camt, radius, aspect)
    return velocity, dye


def make_splat_array(events, max_splats: int) -> torch.Tensor:
    """Pack a list of (x, y, dx, dy, (r, g, b)) into the (max_splats, 8)
    float32 batch a step takes, on the CPU; more events than rows raise."""
    import numpy as np

    if len(events) > max_splats:
        raise ValueError(f"{len(events)} splat events > MAX_SPLATS={max_splats}")
    out = np.zeros((max_splats, SPLAT_COLS), dtype=np.float32)
    for i, (x, y, dx, dy, color) in enumerate(events):
        out[i] = [x, y, dx, dy, color[0], color[1], color[2], 1.0]
    return torch.from_numpy(out)
