"""Texture sampling of the WebGL shaders in plain PyTorch: texel centers at
(i + 0.5) / N, LINEAR filtering, CLAMP_TO_EDGE (REPEAT for the dither).

Every function takes any leading axes. Arithmetic is float32, one PyTorch
operation at a time, so nothing is fused into a multiply-add.
"""

from __future__ import annotations

from typing import Tuple

import torch


def div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE a / b for a scalar b. On the GPU, PyTorch divides by a Python
    number through its reciprocal; a 0-d tensor on the device gives the
    correctly rounded quotient."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def centers(n: int, device) -> torch.Tensor:
    """(i + 0.5) / n for i in 0 .. n - 1, float32."""
    return div(torch.arange(n, dtype=torch.float32, device=device) + 0.5, float(n))


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """texture2D of ``tex`` (B, C, H, W) at per-texel coordinates ``u``,
    ``v`` (B, h, w) -> (B, C, h, w): corners at floor(uv * size - 0.5) and
    one more, clamped to the edge, mixed by the fractions, rows last."""
    b, c, h, w = tex.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    ix0 = x0.long().clamp(0, w - 1)
    ix1 = (x0.long() + 1).clamp(0, w - 1)
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = (y0.long() + 1).clamp(0, h - 1)
    flat = tex.reshape(b, c, h * w)
    out_shape = (b, c) + tuple(u.shape[-2:])

    def tap(iy, ix):
        idx = (iy * w + ix).reshape(b, 1, -1).expand(b, c, -1)
        return torch.gather(flat, 2, idx).reshape(out_shape)

    a, bb, cc, d = tap(iy0, ix0), tap(iy0, ix1), tap(iy1, ix0), tap(iy1, ix1)
    top = a + (bb - a) * fx
    bot = cc + (d - cc) * fx
    return top + (bot - top) * fy


def axis_plan(n_in: int, n_out: int, scale: float, off: float, wrap: bool, device):
    """One separable stage at p = ((k + 0.5) / n_out) * scale + off: the
    two corner indices along the axis and the lerp weight."""
    p = centers(n_out, device) * scale + off
    x = p * n_in - 0.5
    x0 = torch.floor(x)
    f = x - x0
    i0 = x0.long()
    if wrap:
        return torch.remainder(i0, n_in), torch.remainder(i0 + 1, n_in), f
    return i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1), f


def sample_axis(tex: torch.Tensor, n_out: int, axis: int, scale: float = 1.0,
                off: float = 0.0, wrap: bool = False) -> torch.Tensor:
    """One separable stage along ``axis`` (-1 columns, -2 rows):
    a * (1 - f) + b * f."""
    i0, i1, f = axis_plan(tex.shape[axis], n_out, scale, off, wrap, tex.device)
    if axis == -2:
        f = f[:, None]
    return tex.index_select(axis, i0) * (1 - f) + tex.index_select(axis, i1) * f


def sample_affine(tex: torch.Tensor, out_hw: Tuple[int, int], su: float = 1.0,
                  ou: float = 0.0, sv: float = 1.0, ov: float = 0.0,
                  wrap: bool = False) -> torch.Tensor:
    """``tex`` sampled at u = su * u_out + ou, v = sv * v_out + ov over an
    (out_h, out_w) raster: the column stage, then the row stage."""
    t = sample_axis(tex, out_hw[1], -1, su, ou, wrap)
    return sample_axis(t, out_hw[0], -2, sv, ov, wrap)


def resample(tex: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``tex`` sampled at the texel centers of an (out_h, out_w) raster."""
    return sample_affine(tex, out_hw)
