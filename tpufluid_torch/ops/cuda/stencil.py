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

Both take one sim or a batch of B sims in one launch (the grid's z axis):
a batch's fields and factors lead with B, and dt is a number for every sim
or a (B, 2) table of (clamped dt, decay) a sim (build.check_dt). The plain
versions run a batch sim by sim, each with its own dt and factors.

Both also take the lane-packed fleet (tpufluid/batch_packed.py), ``sim_w=``
the width of a sim: B sims side by side along the rows, velocity
(2, H, B*sim_w), pressure and divergence (H, B*sim_w), the splat factors
per sim as a batch's, (B, H, S), (B, S, sim_w), (B, S, 2). One launch takes
the fleet, each sim with its own walls (the TPU kernels' sim_w walls,
tpufluid/ops/pallas/stencil.py:121-126, :238-241); the plain versions
unpack the fleet, run it as a batch and pack the result, so a packed sim
equals its batched sim bit for bit.

pre_pressure's true-wall form, ``true_bounds=(row_lo, row_hi, col_lo,
col_hi)`` (tpufluid/ops/pallas/stencil.py:335-370): the grid's walls as
array coordinates, a bound outside the array (+/-NO_WALL) where a shard
owns no wall. The clamp and the -C reflection act at the walls, and inside
them the result is the unbounded chain on the WINDOW the bounds cut out,
clipped to the array: rows max(row_lo, 0) .. min(row_hi, H - 1), columns
likewise, with the splat factors of those rows and columns. Outside the
window the outputs are unspecified, as the TPU kernel's are (its caller
crops them away): the kernel writes nothing there, the plain version NaN,
so that a caller that reads there shows it. The kernel runs on the window
in place (its base offset and row pitch); the plain version on a view of
it.
"""

from __future__ import annotations

import dataclasses

import torch

from tpufluid_torch.ops import stencil as S
from tpufluid_torch.ops.cuda.build import (BATCHED, PACKED, F, I, P, Kernel, as_batch,
                                           batch_factors, check_dt, check_factors,
                                           check_storage, pack_fleet, packed_batch, per_sim,
                                           ptr, sm_count, stream, unpack_fleet)
from tpufluid_torch.ops.splat import splat_bump

PRE_PRESSURE = Kernel("pre_pressure", "stencil", "fluid_pre_pressure",
                      [P, P, P, P, I, F, F, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
                      replaces="tpufluid/ops/pallas/stencil.py:98")
GRADIENT_SUBTRACT = Kernel("gradient_subtract", "stencil", "fluid_gradient_subtract",
                           [P, P, P, I, I, I, I, I, P],
                           replaces="tpufluid/ops/pallas/stencil.py:218")

HALO = 3          # stencil layers between the bumped velocity and the divergence
NO_WALL = 1 << 30  # a true-wall bound where a shard owns no wall


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


def plan(h: int, w: int, sms: int, batch: int = 1) -> int:
    """The tile of a batch of ``batch`` (h, w) grids on a GPU of ``sms``
    SMs: LARGE where its blocks, batch x blocks a grid, give every SM one,
    else SMALL. Both tiles are exact, so a sim's result does not depend on
    the tile its batch gets."""
    return LARGE if batch * TILES[LARGE].blocks(h, w) >= sms else SMALL


def _check_velocity(velocity: torch.Tensor):
    """(batch view (B, 2, H, W), single) of one sim's or a batch's velocity."""
    vel, single = as_batch(velocity, 3)
    if vel.shape[1] != 2:
        raise ValueError(f"velocity must be (2, H, W) or (B, 2, H, W), got "
                         f"{tuple(velocity.shape)}")
    return vel, single


def _packed_velocity(velocity: torch.Tensor, sim_w: int):
    """(B, H) of a packed fleet's velocity (2, H, B*sim_w)."""
    b = packed_batch(velocity, 3, sim_w)
    if velocity.shape[0] != 2:
        raise ValueError(f"a packed velocity is (2, H, B*W), got {tuple(velocity.shape)}")
    return b, velocity.shape[1]


def window(h: int, w: int, true_bounds=None):
    """(r0, c0, wh, ww): the window of an (h, w) array inside the walls
    ``true_bounds`` (row_lo, row_hi, col_lo, col_hi), clipped to the array;
    the whole array without bounds. Raises where the window is empty."""
    if true_bounds is None:
        return 0, 0, h, w
    row_lo, row_hi, col_lo, col_hi = (int(x) for x in true_bounds)
    r0, r1 = max(row_lo, 0), min(row_hi, h - 1)
    c0, c1 = max(col_lo, 0), min(col_hi, w - 1)
    if r0 > r1 or c0 > c1:
        raise ValueError(f"true bounds {tuple(true_bounds)} leave no texel of an "
                         f"({h}, {w}) array")
    return r0, c0, r1 - r0 + 1, c1 - c0 + 1


def run_tiles(velocity: torch.Tensor, curl_strength: float, dt, splat_factors, tiles: int,
              true_bounds=None, sim_w=None):
    """(vel', divergence), both in storage, from one launch of pre_pressure
    on TILES[tiles] over the window of ``true_bounds``, for one sim or a
    batch; outside the window the outputs are left unwritten. ``sim_w``: a
    packed fleet, velocity (2, H, B*sim_w) and divergence (H, B*sim_w), the
    factors (B, H, S), (B, S, sim_w), (B, S, 2)."""
    code = check_storage(velocity)
    if not 0 <= tiles < len(TILES):
        raise ValueError(f"no tile {tiles}: TILES has {len(TILES)}")
    if sim_w is not None:
        if true_bounds is not None:
            raise ValueError("a packed fleet's walls are its sims': no true bounds")
        b, h = _packed_velocity(velocity, sim_w)
        vel, single, w, layout = velocity, False, b * sim_w, PACKED
        r0, c0, wh, ww = 0, 0, h, sim_w      # each sim the window at column b * sim_w
        factor_w = sim_w
    else:
        vel, single = _check_velocity(velocity)
        b, _, h, w = vel.shape
        layout, factor_w = BATCHED, w
        r0, c0, wh, ww = window(h, w, true_bounds)
    gy, gx, amt, s = check_factors(batch_factors(splat_factors, single), vel.device, b, h,
                                   factor_w, 2)
    dt, dts = check_dt(dt, b, vel.device)
    out = torch.empty_like(vel)
    div = torch.empty(vel.shape[:-3] + vel.shape[-2:], dtype=vel.dtype, device=vel.device)
    PRE_PRESSURE(ptr(vel), ptr(gy), ptr(gx), ptr(amt), s, float(curl_strength), dt, dts,
                 ptr(out), ptr(div), b, h, w, r0, c0, wh, ww, tiles, layout, code, stream(vel))
    return (out[0], div[0]) if single else (out, div)


def pre_pressure(velocity: torch.Tensor, curl_strength: float, dt, splat_factors=None,
                 true_bounds=None, sim_w=None):
    """(vel', divergence) on the card, of one sim, a batch or a packed fleet
    of sims ``sim_w`` wide: one launch on the tile ``plan`` picks for the
    window of ``true_bounds`` (module docstring; None: the whole array)."""
    check_storage(velocity)
    if sim_w is not None:
        b, h = _packed_velocity(velocity, sim_w)
        wh, ww = h, sim_w
    else:
        vel, _ = _check_velocity(velocity)
        b, _, h, w = vel.shape
        _, _, wh, ww = window(h, w, true_bounds)
    return run_tiles(velocity, curl_strength, dt, splat_factors,
                     plan(wh, ww, sm_count(velocity.device), b), true_bounds, sim_w)


def splat_curl_plain(velocity: torch.Tensor, splat_factors=None):
    """(bumped velocity in storage, float32 curl): the first half of
    pre_pressure_plain (one sim)."""
    if velocity.ndim != 3 or velocity.shape[0] != 2:
        raise ValueError(f"velocity must be (2, H, W), got {tuple(velocity.shape)}")
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


def _pre_pressure_sim(velocity, curl_strength, dt, splat_factors):
    vel_b, curl = splat_curl_plain(velocity, splat_factors)
    return confine_divergence_plain(vel_b, curl, curl_strength, dt)


def pre_pressure_plain(velocity: torch.Tensor, curl_strength: float, dt, splat_factors=None,
                       true_bounds=None, sim_w=None):
    """Plain version of pre_pressure, same operations and rounding points;
    a batch sim by sim. With ``true_bounds``: the unbounded chain on a view
    of the window and its factors, placed in NaN. With ``sim_w``: the
    packed fleet unpacked, run as a batch, packed again."""
    if sim_w is not None:
        if true_bounds is not None:
            raise ValueError("a packed fleet's walls are its sims': no true bounds")
        b, _ = _packed_velocity(velocity, sim_w)
        vel, div = pre_pressure_plain(unpack_fleet(velocity, b), curl_strength, dt,
                                      splat_factors)
        return pack_fleet(vel), pack_fleet(div)
    if true_bounds is None:
        return per_sim(_pre_pressure_sim, velocity.ndim == 4,
                       (velocity, curl_strength, dt, splat_factors), fields=(0,), dt_at=2,
                       factors_at=3)
    h, w = velocity.shape[-2:]
    r0, c0, wh, ww = window(h, w, true_bounds)
    rows, cols = slice(r0, r0 + wh), slice(c0, c0 + ww)
    factors = None
    if splat_factors is not None:
        gy, gx, amt = splat_factors
        factors = (gy[..., rows, :], gx[..., cols], amt)
    vel_w, div_w = pre_pressure_plain(velocity[..., rows, cols], curl_strength, dt, factors)
    vel = torch.full_like(velocity, float("nan"))
    div = torch.full(velocity.shape[:-3] + (h, w), float("nan"), dtype=velocity.dtype,
                     device=velocity.device)
    vel[..., rows, cols] = vel_w
    div[..., rows, cols] = div_w
    return vel, div


def gradient_subtract(velocity: torch.Tensor, pressure: torch.Tensor,
                      sim_w=None) -> torch.Tensor:
    """vel - (R - L, T - B) of pressure, on the card, of one sim, a batch or
    a packed fleet of sims ``sim_w`` wide (velocity (2, H, B*sim_w),
    pressure (H, B*sim_w))."""
    code = check_storage(velocity, pressure)
    if sim_w is not None:
        (b, h), w = _packed_velocity(velocity, sim_w), sim_w
        vel, single, layout = velocity, False, PACKED
    else:
        vel, single = _check_velocity(velocity)
        (b, _, h, w), layout = vel.shape, BATCHED
    grid = tuple(velocity.shape[:-3] + velocity.shape[-2:])
    if tuple(pressure.shape) != grid:
        raise ValueError(f"pressure {tuple(pressure.shape)} != grid {grid}")
    out = torch.empty_like(vel)
    GRADIENT_SUBTRACT(ptr(vel), ptr(pressure), ptr(out), b, h, w, layout, code, stream(vel))
    return out[0] if single else out


def _gradient_subtract_sim(velocity, pressure):
    return S.gradient_subtract(velocity.to(torch.float32),
                               pressure.to(torch.float32)).to(velocity.dtype)


def gradient_subtract_plain(velocity: torch.Tensor, pressure: torch.Tensor,
                            sim_w=None) -> torch.Tensor:
    """Plain version of gradient_subtract: float32 math, rounded once; a
    batch sim by sim; a packed fleet unpacked, run as a batch, packed."""
    if sim_w is not None:
        b, _ = _packed_velocity(velocity, sim_w)
        return pack_fleet(gradient_subtract_plain(unpack_fleet(velocity, b),
                                                  unpack_fleet(pressure, b)))
    return per_sim(_gradient_subtract_sim, velocity.ndim == 4, (velocity, pressure),
                   fields=(0, 1))
