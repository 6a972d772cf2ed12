"""5-point stencils: curl, vorticity confinement, divergence, Jacobi,
gradient subtract.

Plain PyTorch versions of the reference's stencil shaders, operation for
operation the order of ``tpufluid.ops.stencil``; the CUDA kernels
(csrc/stencil.cu, csrc/jacobi.cu) keep the same order, so in float32 a
kernel and its plain version agree bit for bit.

Grid convention: arrays are (H, W) with row i = the v axis (up), column j =
u. Neighbor reads clamp to the edge (at a wall "neighbor" == "self"), except
in the divergence, whose out-of-range velocity tap is -center (no-slip
reflection).

Each function computes in the dtype of its input; the step's callers
(ops/cuda/*.py) pass float32 and round to storage where the kernels do.
"""

from __future__ import annotations

from typing import Tuple

import torch


def neighbors_clamped(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
    """(L, R, T, B) of a (..., H, W) field with clamp-to-edge semantics.
    T is +v (row + 1), B is row - 1."""
    L = torch.cat([f[..., :, :1], f[..., :, :-1]], dim=-1)
    R = torch.cat([f[..., :, 1:], f[..., :, -1:]], dim=-1)
    B = torch.cat([f[..., :1, :], f[..., :-1, :]], dim=-2)
    T = torch.cat([f[..., 1:, :], f[..., -1:, :]], dim=-2)
    return L, R, T, B


def curl(velocity: torch.Tensor) -> torch.Tensor:
    """Vorticity = 0.5 * (R.y - L.y - T.x + B.x)."""
    u, v = velocity[0], velocity[1]
    Lv, Rv, _, _ = neighbors_clamped(v)
    _, _, Tu, Bu = neighbors_clamped(u)
    return 0.5 * (Rv - Lv - Tu + Bu)


def vorticity_confinement(velocity: torch.Tensor, curl_field: torch.Tensor,
                          curl_strength: float, dt: float) -> torch.Tensor:
    """force = 0.5 * (|T|-|B|, |R|-|L|) of the curl, normalized (+1e-4),
    scaled by curl_strength * curl, force.y negated; velocity += force * dt,
    clamped to +/-1000. Computed in float32, stored in the field's dtype."""
    cf = curl_field.to(torch.float32)
    L, R, T, B = neighbors_clamped(cf)
    fx = 0.5 * (torch.abs(T) - torch.abs(B))
    fy = 0.5 * (torch.abs(R) - torch.abs(L))
    inv_len = torch.reciprocal(torch.sqrt(fx * fx + fy * fy) + 1e-4)
    scale = curl_strength * cf * inv_len
    fx = fx * scale
    fy = -(fy * scale)
    vel = velocity.to(torch.float32)
    out = torch.stack([vel[0] + fx * dt, vel[1] + fy * dt])
    return torch.clamp(out, -1000.0, 1000.0).to(velocity.dtype)


def divergence(velocity: torch.Tensor) -> torch.Tensor:
    """div = 0.5 * (R.x - L.x + T.y - B.y); an out-of-range tap reads the
    negated center component (velocity reflects at the walls)."""
    u, v = velocity[0], velocity[1]
    Ru = torch.cat([u[:, 1:], -u[:, -1:]], dim=-1)
    Lu = torch.cat([-u[:, :1], u[:, :-1]], dim=-1)
    Tv = torch.cat([v[1:, :], -v[-1:, :]], dim=-2)
    Bv = torch.cat([-v[:1, :], v[:-1, :]], dim=-2)
    return 0.5 * (Ru - Lu + Tv - Bv)


def jacobi_pressure(pressure: torch.Tensor, div: torch.Tensor,
                    iterations: int) -> torch.Tensor:
    """``iterations`` Jacobi sweeps: p' = (L + R + T + B - div) * 0.25, summed
    left to right; clamp-to-edge neighbors give the Neumann boundary."""
    p = pressure
    for _ in range(iterations):
        L, R, T, B = neighbors_clamped(p)
        p = (L + R + T + B - div) * 0.25
    return p


def gradient_subtract(velocity: torch.Tensor, pressure: torch.Tensor) -> torch.Tensor:
    """v -= (R - L, T - B) of pressure. The reference omits the 0.5 of the
    central difference; reproduced as-is for behavioral parity."""
    L, R, T, B = neighbors_clamped(pressure)
    return torch.stack([velocity[0] - (R - L), velocity[1] - (T - B)])
