"""Pre-pressure stencils and the gradient subtract: CUDA kernels
(csrc/stencil.cu) and their plain PyTorch versions.

pre_pressure: separable splat bump -> curl -> vorticity confinement (clamp
to +/-1000) -> divergence with -C wall reflection, the counterpart of
tpufluid/ops/pallas/stencil.py:98. Rounding points, the TPU kernel's: the
bumped velocity rounds to storage before the curl reads it; the velocity and
the divergence round once, at the output, the divergence computed from the
unrounded float32 velocity. gradient_subtract (tpufluid/ops/pallas/
stencil.py:218) rounds its output only.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops import stencil as S
from tpufluid_torch.ops.cuda.build import (F, I, P, Kernel, check_factors,
                                           check_storage, ptr, stream)
from tpufluid_torch.ops.splat import splat_bump

SPLAT_CURL = Kernel("splat_curl", "stencil", "fluid_splat_curl",
                    [P, P, P, P, I, P, P, I, I, I, P],
                    replaces="tpufluid/ops/pallas/stencil.py:98")
CONFINE_DIVERGENCE = Kernel("confine_divergence", "stencil", "fluid_confine_divergence",
                            [P, P, F, F, P, P, I, I, I, P],
                            replaces="tpufluid/ops/pallas/stencil.py:98")
GRADIENT_SUBTRACT = Kernel("gradient_subtract", "stencil", "fluid_gradient_subtract",
                           [P, P, P, I, I, I, P],
                           replaces="tpufluid/ops/pallas/stencil.py:218")


def _check_velocity(velocity: torch.Tensor):
    if velocity.ndim != 3 or velocity.shape[0] != 2:
        raise ValueError(f"velocity must be (2, H, W), got {tuple(velocity.shape)}")
    return velocity.shape[1], velocity.shape[2]


def splat_curl(velocity: torch.Tensor, splat_factors=None):
    """(bumped velocity in storage, float32 curl) on the card."""
    h, w = _check_velocity(velocity)
    code = check_storage(velocity)
    gy, gx, amt, s = check_factors(splat_factors, velocity.device, h, w, 2)
    vel_b = torch.empty_like(velocity)
    curl = torch.empty((h, w), dtype=torch.float32, device=velocity.device)
    SPLAT_CURL(ptr(velocity), ptr(gy), ptr(gx), ptr(amt), s, ptr(vel_b), ptr(curl),
               h, w, code, stream())
    return vel_b, curl


def splat_curl_plain(velocity: torch.Tensor, splat_factors=None):
    """Plain version of splat_curl."""
    _check_velocity(velocity)
    vel = velocity
    if splat_factors is not None:
        vel = (velocity.to(torch.float32) + splat_bump(*splat_factors)).to(velocity.dtype)
    return vel, S.curl(vel.to(torch.float32))


def confine_divergence(velocity: torch.Tensor, curl: torch.Tensor,
                       curl_strength: float, dt: float):
    """(confined velocity, divergence), both in storage, on the card."""
    h, w = _check_velocity(velocity)
    code = check_storage(velocity)
    if tuple(curl.shape) != (h, w) or curl.dtype != torch.float32:
        raise ValueError(f"curl must be float32 {(h, w)}, got {curl.dtype} {tuple(curl.shape)}")
    check_storage(curl)
    out = torch.empty_like(velocity)
    div = torch.empty((h, w), dtype=velocity.dtype, device=velocity.device)
    CONFINE_DIVERGENCE(ptr(velocity), ptr(curl), float(curl_strength), float(dt),
                       ptr(out), ptr(div), h, w, code, stream())
    return out, div


def confine_divergence_plain(velocity: torch.Tensor, curl: torch.Tensor,
                             curl_strength: float, dt: float):
    """Plain version of confine_divergence: the divergence comes from the
    unrounded float32 velocity; both outputs round once."""
    conf = S.vorticity_confinement(velocity.to(torch.float32), curl, curl_strength, dt)
    return conf.to(velocity.dtype), S.divergence(conf).to(velocity.dtype)


def pre_pressure(velocity: torch.Tensor, curl_strength: float, dt: float,
                 splat_factors=None):
    """(vel', divergence) on the card: splat_curl, then confine_divergence."""
    vel_b, curl = splat_curl(velocity, splat_factors)
    return confine_divergence(vel_b, curl, curl_strength, dt)


def pre_pressure_plain(velocity: torch.Tensor, curl_strength: float, dt: float,
                       splat_factors=None):
    """Plain version of pre_pressure, same operations and rounding points."""
    vel_b, curl = splat_curl_plain(velocity, splat_factors)
    return confine_divergence_plain(vel_b, curl, curl_strength, dt)


def gradient_subtract(velocity: torch.Tensor, pressure: torch.Tensor) -> torch.Tensor:
    """vel - (R - L, T - B) of pressure, on the card."""
    h, w = _check_velocity(velocity)
    if tuple(pressure.shape) != (h, w):
        raise ValueError(f"pressure {tuple(pressure.shape)} != grid {(h, w)}")
    code = check_storage(velocity, pressure)
    out = torch.empty_like(velocity)
    GRADIENT_SUBTRACT(ptr(velocity), ptr(pressure), ptr(out), h, w, code, stream())
    return out


def gradient_subtract_plain(velocity: torch.Tensor, pressure: torch.Tensor) -> torch.Tensor:
    """Plain version of gradient_subtract: float32 math, rounded once."""
    return S.gradient_subtract(velocity.to(torch.float32),
                               pressure.to(torch.float32)).to(velocity.dtype)
