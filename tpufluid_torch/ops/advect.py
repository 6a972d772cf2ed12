"""Semi-Lagrangian advection (the reference's advectionShader), plain version.

For every target texel: backtrace ``coord = uv - dt * velocity(uv) / sim_size``
(velocity is in sim-grid texels per second, also for dye on a finer grid),
sample the source bilinearly there with clamp-to-edge, and divide by
``1 + dissipation * dt``.

Mirrors ``tpufluid.ops.advect.advect``, except that every sample is taken in
float32 whatever the storage dtype (the JAX function lerps in the storage
dtype); the result is rounded to the source dtype once. The advect kernel
(csrc/advect.cu) does the same operations in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufluid_torch.ops.quant import rgb9e5_roundtrip
from tpufluid_torch.ops.sampling import sample_bilinear, true_div, uv_grid


def decay_factor(dissipation: float, dt) -> np.float32:
    """1 + dissipation * dt in float32, as the JAX package computes it."""
    return np.float32(1.0) + np.float32(dissipation) * np.float32(dt)


def advect(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
           quant=None) -> torch.Tensor:
    """Advect ``source`` (..., H, W) through ``velocity`` (2, Hs, Ws).

    The target grid is the source grid. When the grids differ (dye) the
    velocity is sampled bilinearly at the target's texel centers; when they
    match (velocity self-advection) the sample is the texel itself.
    quant="rgb9e5" sends the (3, H, W) source through RGB9E5 storage before
    it is sampled.
    """
    out_dtype = source.dtype
    src = source.to(torch.float32)
    if quant == "rgb9e5":
        src = rgb9e5_roundtrip(src)
    coord_u, coord_v = backtrace(velocity, src.shape[-2], src.shape[-1], dt)
    result = sample_bilinear(src, coord_u, coord_v)
    dt = float(np.float32(dt))
    return true_div(result, float(decay_factor(dissipation, dt))).to(out_dtype)


def backtrace(velocity: torch.Tensor, h: int, w: int, dt):
    """(coord_u, coord_v), float32 (h, w): where each texel center of an
    (h, w) target grid backtraces to through ``velocity`` (2, Hs, Ws), in
    uv. The velocity is taken in float32, sampled bilinearly at the
    target's texel centers where the grids differ."""
    vel = velocity.to(torch.float32)
    sh, sw = vel.shape[-2], vel.shape[-1]
    u, v = uv_grid(h, w, device=vel.device)

    if (sh, sw) == (h, w):
        vel_u, vel_v = vel[0], vel[1]
    else:
        vel_u = sample_bilinear(vel[0], u, v)
        vel_v = sample_bilinear(vel[1], u, v)

    dt = float(np.float32(dt))
    return u - true_div(dt * vel_u, float(sw)), v - true_div(dt * vel_v, float(sh))
