"""Bilinear texture sampling — the counterpart of GLSL ``texture2D``.

Texel centers at (i + 0.5)/N, out-of-range taps clamped to the edge texel
(CLAMP_TO_EDGE) or wrapped (REPEAT, the dither texture only). Mirrors
``tpufluid.ops.sampling`` operation for operation.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


def true_div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE ``a / b`` for a scalar ``b``. PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal instead, which can move a result by
    an ulp — and a sampling coordinate that moved by an ulp can land on
    another bilinear corner than the kernels' IEEE division. The divisor is
    a 0-d tensor filled on the device: ``torch.tensor(b, device=...)``
    would copy it from the host and synchronize the stream on every call."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def bilinear_taps(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    """The taps of a LINEAR + CLAMP_TO_EDGE sample of an (h, w) texture at
    uv: st = uv * size - 0.5, corner rows (iy0, iy1) and columns (ix0, ix1)
    at floor(st) and +1, each clamped to [0, N-1] (int64), and the lerp
    weights (fy, fx) = fract(st) in uv's dtype."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ix0 = x0.long().clamp(0, w - 1)
    ix1 = (x0.long() + 1).clamp(0, w - 1)
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = (y0.long() + 1).clamp(0, h - 1)
    return iy0, iy1, ix0, ix1, y - y0, x - x0


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample ``tex`` (..., H, W) at uv coords with LINEAR + CLAMP_TO_EDGE:
    st = uv * size - 0.5; corners at floor(st) and +1, each clamped to
    [0, N-1]; bilinear mix by fract(st). Returns shape (..., *u.shape)."""
    iy0, iy1, ix0, ix1, fy, fx = bilinear_taps(tex.shape[-2], tex.shape[-1], u, v)
    fx, fy = fx.to(tex.dtype), fy.to(tex.dtype)

    a = tex[..., iy0, ix0]
    b = tex[..., iy0, ix1]
    c = tex[..., iy1, ix0]
    d = tex[..., iy1, ix1]

    top = a + (b - a) * fx
    bot = c + (d - c) * fx
    return top + (bot - top) * fy


def sample_bilinear_repeat(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sample_bilinear with REPEAT wrap: corner indices taken modulo the
    size by floor modulo (``torch.remainder``), so -1 wraps to N-1."""
    h, w = tex.shape[-2], tex.shape[-1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(tex.dtype)
    fy = (y - y0).to(tex.dtype)

    ix0 = torch.remainder(x0.long(), w)
    ix1 = torch.remainder(x0.long() + 1, w)
    iy0 = torch.remainder(y0.long(), h)
    iy1 = torch.remainder(y0.long() + 1, h)

    a = tex[..., iy0, ix0]
    b = tex[..., iy0, ix1]
    c = tex[..., iy1, ix0]
    d = tex[..., iy1, ix1]

    top = a + (b - a) * fx
    bot = c + (d - c) * fx
    return top + (bot - top) * fy


@functools.lru_cache(maxsize=512)
def _axis_plan(n_in: int, n_out: int, scale: float, off: float, wrap: bool,
               device: torch.device):
    p = true_div(torch.arange(n_out, dtype=torch.float32, device=device) + 0.5,
                 float(n_out)) * scale + off
    x = p * n_in - 0.5
    x0 = torch.floor(x)
    f = x - x0
    i0 = x0.long()
    if wrap:
        i0, i1 = torch.remainder(i0, n_in), torch.remainder(i0 + 1, n_in)
    else:
        i0, i1 = i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1)
    return i0, i1, f


def affine_axis_plan(n_in: int, n_out: int, scale: float = 1.0, off: float = 0.0,
                     wrap: bool = False, device=None):
    """(i0, i1, f) for one separable affine bilinear stage at
    p = ((k+0.5)/n_out)*scale + off: corner indices (int64) and the float32
    lerp weight. ``scale`` and ``off`` enter as float32, as in the JAX
    package. The plans depend on the geometry alone, so they are cached per
    (sizes, scale, offset, wrap, device); callers must not write to them."""
    return _axis_plan(int(n_in), int(n_out), float(scale), float(off), bool(wrap),
                      torch.device("cpu") if device is None else torch.device(device))


def sample_affine_axis(tex: torch.Tensor, n_out: int, axis: int, scale: float = 1.0,
                       off: float = 0.0, wrap: bool = False) -> torch.Tensor:
    """One separable stage of an affine bilinear sample: take + lerp along
    ``axis`` (-1 = u/columns, -2 = v/rows) at p = ((k+0.5)/n_out)*scale + off.
    The lerp is a*(1-f) + b*f."""
    assert axis in (-1, -2)
    i0, i1, f = affine_axis_plan(tex.shape[axis], n_out, scale, off, wrap, tex.device)
    f = f.to(tex.dtype)
    if axis == -2:
        f = f[:, None]
    return tex.index_select(axis, i0) * (1 - f) + tex.index_select(axis, i1) * f


def sample_affine(tex: torch.Tensor, out_hw: Tuple[int, int], su: float = 1.0,
                  ou: float = 0.0, sv: float = 1.0, ov: float = 0.0,
                  wrap: bool = False) -> torch.Tensor:
    """Bilinear-sample ``tex`` (..., H, W) at the affine uv map
    u = su * u_out + ou, v = sv * v_out + ov over an (out_h, out_w) raster:
    the column (u) stage first, then the row (v) stage. CLAMP_TO_EDGE by
    default; wrap=True gives REPEAT."""
    out_h, out_w = out_hw
    t = sample_affine_axis(tex, out_w, axis=-1, scale=su, off=ou, wrap=wrap)
    return sample_affine_axis(t, out_h, axis=-2, scale=sv, off=ov, wrap=wrap)


def uv_grid(h: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (u, v) arrays of shape (h, w) at texel centers:
    ((j+0.5)/w, (i+0.5)/h)."""
    u = true_div(torch.arange(w, dtype=torch.float32, device=device) + 0.5, float(w))
    v = true_div(torch.arange(h, dtype=torch.float32, device=device) + 0.5, float(h))
    return u[None, :].expand(h, w), v[:, None].expand(h, w)


def resample_bilinear(tex: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resample (..., H, W) to (out_h, out_w) by sampling at the target's
    texel centers: the identity affine map, one column gather and one row
    gather through the cached plans (tpufluid's resample_bilinear computes
    the same coordinates and lerps)."""
    return sample_affine(tex, out_hw)
