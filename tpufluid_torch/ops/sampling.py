"""Bilinear texture sampling — the counterpart of GLSL ``texture2D``.

Texel centers at (i + 0.5)/N, out-of-range taps clamped to the edge texel
(CLAMP_TO_EDGE). Mirrors ``tpufluid.ops.sampling`` operation for operation.
"""

from __future__ import annotations

from typing import Tuple

import torch


def true_div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE ``a / b`` for a scalar ``b``. PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal instead, which can move a result by
    an ulp — and a sampling coordinate that moved by an ulp can land on
    another bilinear corner than the kernels' IEEE division."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample ``tex`` (..., H, W) at uv coords with LINEAR + CLAMP_TO_EDGE:
    st = uv * size - 0.5; corners at floor(st) and +1, each clamped to
    [0, N-1]; bilinear mix by fract(st). Returns shape (..., *u.shape)."""
    h, w = tex.shape[-2], tex.shape[-1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(tex.dtype)
    fy = (y - y0).to(tex.dtype)

    ix0 = x0.long().clamp(0, w - 1)
    ix1 = (x0.long() + 1).clamp(0, w - 1)
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = (y0.long() + 1).clamp(0, h - 1)

    a = tex[..., iy0, ix0]
    b = tex[..., iy0, ix1]
    c = tex[..., iy1, ix0]
    d = tex[..., iy1, ix1]

    top = a + (b - a) * fx
    bot = c + (d - c) * fx
    return top + (bot - top) * fy


def uv_grid(h: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (u, v) arrays of shape (h, w) at texel centers:
    ((j+0.5)/w, (i+0.5)/h)."""
    u = true_div(torch.arange(w, dtype=torch.float32, device=device) + 0.5, float(w))
    v = true_div(torch.arange(h, dtype=torch.float32, device=device) + 0.5, float(h))
    return u[None, :].expand(h, w), v[:, None].expand(h, w)


def resample_bilinear(tex: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resample (..., H, W) to (out_h, out_w) by sampling at the target's
    texel centers; separable, one row gather and one column gather."""
    out_h, out_w = out_hw
    h, w = tex.shape[-2], tex.shape[-1]
    dev = tex.device

    x = true_div(torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5, float(out_w)) * w - 0.5
    x0 = torch.floor(x)
    fx = (x - x0).to(tex.dtype)
    ix0 = x0.long().clamp(0, w - 1)
    ix1 = (x0.long() + 1).clamp(0, w - 1)
    t = tex[..., ix0] * (1 - fx) + tex[..., ix1] * fx

    y = true_div(torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5, float(out_h)) * h - 0.5
    y0 = torch.floor(y)
    fy = (y - y0).to(tex.dtype)[:, None]
    iy0 = y0.long().clamp(0, h - 1)
    iy1 = (y0.long() + 1).clamp(0, h - 1)
    return t[..., iy0, :] * (1 - fy) + t[..., iy1, :] * fy
