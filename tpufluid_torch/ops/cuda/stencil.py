"""The pre-pressure chain and the gradient subtract: CUDA kernels
(csrc/stencil.cu) and their plain PyTorch versions.

pre_pressure: separable splat bump -> curl -> vorticity confinement (clamp
to +/-1000) -> divergence with -C wall reflection, the counterpart of
tpufluid/ops/pallas/stencil.py:98, in one launch on tiles of TILES that
``plan`` picks. Rounding points, the TPU kernel's: the bumped velocity
rounds to storage before the curl reads it; the velocity and the divergence
round once, at the output, the divergence computed from the unrounded
float32 velocity. gradient_subtract (tpufluid/ops/pallas/stencil.py:218)
rounds its output only.
"""

from __future__ import annotations

import dataclasses

import torch

from tpufluid_torch.ops import stencil as S
from tpufluid_torch.ops.cuda.build import (F, I, P, Kernel, check_factors, check_storage,
                                           ptr, sm_count, stream)
from tpufluid_torch.ops.splat import splat_bump

PRE_PRESSURE = Kernel("pre_pressure", "stencil", "fluid_pre_pressure",
                      [P, P, P, P, I, F, F, P, P, I, I, I, I, P],
                      replaces="tpufluid/ops/pallas/stencil.py:98")
GRADIENT_SUBTRACT = Kernel("gradient_subtract", "stencil", "fluid_gradient_subtract",
                           [P, P, P, I, I, I, P],
                           replaces="tpufluid/ops/pallas/stencil.py:218")

HALO = 3          # stencil layers between the bumped velocity and the divergence


@dataclasses.dataclass(frozen=True)
class Tile:
    """One compiled output tile of pre_pressure_kernel: ``th`` x ``tw``
    texels a block of 256 threads, over a window of the tile and a HALO
    on every side."""

    th: int
    tw: int

    def blocks(self, h: int, w: int) -> int:
        return -(-h // self.th) * -(-w // self.tw)

    def overcompute(self) -> float:
        """The bump's texels over the tile's."""
        return (self.th + 2 * HALO) * (self.tw + 2 * HALO) / (self.th * self.tw)


# In the order of csrc/stencil.cu launch_pre_tiles. Picked by measurement on
# the H100 (PERF.md): 32x64 tiles where they give every SM a block (four
# to five blocks an SM fit), else 8x32 (the demo's 128x228 keeps 128 SMs
# busy); tools/kernel_candidates.py times both.
TILES = (Tile(32, 64), Tile(8, 32))
LARGE, SMALL = 0, 1


def plan(h: int, w: int, sms: int) -> int:
    """The tile of an (h, w) grid on a GPU of ``sms`` SMs: LARGE where it
    gives every SM a block, else SMALL."""
    return LARGE if TILES[LARGE].blocks(h, w) >= sms else SMALL


def _check_velocity(velocity: torch.Tensor):
    if velocity.ndim != 3 or velocity.shape[0] != 2:
        raise ValueError(f"velocity must be (2, H, W), got {tuple(velocity.shape)}")
    return velocity.shape[1], velocity.shape[2]


def run_tiles(velocity: torch.Tensor, curl_strength: float, dt: float, splat_factors,
              tiles: int):
    """(vel', divergence), both in storage, from one launch of pre_pressure
    on TILES[tiles]."""
    h, w = _check_velocity(velocity)
    code = check_storage(velocity)
    if not 0 <= tiles < len(TILES):
        raise ValueError(f"no tile {tiles}: TILES has {len(TILES)}")
    gy, gx, amt, s = check_factors(splat_factors, velocity.device, h, w, 2)
    out = torch.empty_like(velocity)
    div = torch.empty((h, w), dtype=velocity.dtype, device=velocity.device)
    PRE_PRESSURE(ptr(velocity), ptr(gy), ptr(gx), ptr(amt), s, float(curl_strength), float(dt),
                 ptr(out), ptr(div), h, w, tiles, code, stream())
    return out, div


def pre_pressure(velocity: torch.Tensor, curl_strength: float, dt: float,
                 splat_factors=None):
    """(vel', divergence) on the card: one launch on the tile ``plan`` picks."""
    h, w = _check_velocity(velocity)
    check_storage(velocity)
    return run_tiles(velocity, curl_strength, dt, splat_factors,
                     plan(h, w, sm_count(velocity.device)))


def splat_curl_plain(velocity: torch.Tensor, splat_factors=None):
    """(bumped velocity in storage, float32 curl): the first half of
    pre_pressure_plain."""
    _check_velocity(velocity)
    vel = velocity
    if splat_factors is not None:
        vel = (velocity.to(torch.float32) + splat_bump(*splat_factors)).to(velocity.dtype)
    return vel, S.curl(vel.to(torch.float32))


def confine_divergence_plain(velocity: torch.Tensor, curl: torch.Tensor,
                             curl_strength: float, dt: float):
    """(confined velocity, divergence) from the bumped velocity and its
    curl, the second half of pre_pressure_plain: the divergence comes from
    the unrounded float32 velocity; both outputs round once."""
    conf = S.vorticity_confinement(velocity.to(torch.float32), curl, curl_strength, dt)
    return conf.to(velocity.dtype), S.divergence(conf).to(velocity.dtype)


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
