"""Jacobi pressure solve: the CUDA chunk kernel (csrc/jacobi.cu) and its
plain PyTorch version.

Counterpart of tpufluid/ops/pallas/jacobi.py:139. One launch runs several
sweeps on the tiles (each with a halo as deep as its sweeps) that its blocks
hold on chip; ``plan`` picks the geometry from the grid and the GPU's SM
count and cuts a solve of N sweeps into launches. The warm start
(p *= PRESSURE) is applied at the first launch's load and not rounded on its
own; between launches the field goes through float32 scratch and only the
last launch rounds to storage, so the result equals ``jacobi_plain`` bit for
bit however the sweeps are cut. A launch takes one (H, W) field or a batch
(B, H, W) of B independent sims, or the lane-packed fleet's (H, B*W) with
``sim_w=W`` (tpufluid/batch_packed.py): each block's region lies in one
sim, whose walls clamp it (the TPU kernel's sim_w walls,
tpufluid/ops/pallas/jacobi.py:181-209). The plain versions run a batch sim
by sim, and a packed fleet unpacked as a batch.

``jacobi_project`` is the step's solve: its last launch is jacobi_project
(csrc/jacobi.cu), the last chunk with the gradient subtract of
tpufluid/ops/pallas/stencil.py:218 fused in, on a halo one cell deeper
(``Tiles.blocks(..., project=True)``); it returns the pressure and the
projected velocity, bit for bit those of jacobi_plain then
stencil.gradient_subtract_plain (``jacobi_project_plain``). A solve of no
sweeps is one jacobi_project launch of K = 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from tpufluid_torch.ops import stencil as S
from tpufluid_torch.ops.cuda.build import (BATCHED, PACKED, F, I, P, Kernel, as_batch,
                                           check_storage, pack_fleet, packed_batch, per_sim,
                                           ptr, sm_count, stream, unpack_fleet)
from tpufluid_torch.ops.cuda.stencil import (_check_velocity, _packed_velocity,
                                             gradient_subtract_plain)

JACOBI_CHUNK = Kernel("jacobi_chunk", "jacobi", "fluid_jacobi_chunk",
                      [P, I, P, P, I, F, I, I, I, I, I, I, I, P],
                      replaces="tpufluid/ops/pallas/jacobi.py:139")
JACOBI_PROJECT = Kernel("jacobi_project", "jacobi", "fluid_jacobi_project",
                        [P, I, P, P, P, P, F, I, I, I, I, I, I, I, P],
                        replaces="tpufluid/ops/pallas/jacobi.py:139, "
                                 "tpufluid/ops/pallas/stencil.py:218")


@dataclasses.dataclass(frozen=True)
class Tiles:
    """One compiled geometry of jacobi_chunk_kernel: blocks of ``rw`` x
    ``ny`` threads, each thread one column and ``r`` rows of a region of
    ``rh`` = ny * r rows: a tile and a halo as deep as the launch's sweeps,
    one deeper for the fused last launch (``project``). ``min_blocks``:
    blocks an SM must hold at once (the compiler caps registers to fit)."""

    rw: int
    ny: int
    r: int
    min_blocks: int = 1

    @property
    def rh(self) -> int:
        return self.ny * self.r

    def max_sweeps(self, project: bool = False) -> int:
        """Most sweeps one launch can run: the tile keeps at least one cell."""
        return (min(self.rh, self.rw) - 1) // 2 - project

    def tile(self, sweeps: int, project: bool = False) -> Tuple[int, int]:
        """(rows, columns) of a block's tile: the region less its halo."""
        halo = sweeps + project
        return self.rh - 2 * halo, self.rw - 2 * halo

    def blocks(self, h: int, w: int, sweeps: int, project: bool = False) -> int:
        th, tw = self.tile(sweeps, project)
        return -(-w // tw) * -(-h // th)


# In the order of csrc/jacobi.cu launch_tiles. Picked by measurement on the
# H100 (PERF.md): 64x128 regions, two blocks an SM, where they give every SM
# a block, else 32x64 regions; 10 sweeps a launch (tools/kernel_candidates.py
# times the others).
TILES = (Tiles(128, 4, 16, 2), Tiles(64, 4, 8))
LARGE, SMALL, SWEEPS = 0, 1, 10


def chunks(iterations: int, sweeps: int, project: bool = False) -> List[int]:
    """``iterations`` sweeps cut into launches of ``sweeps``, the last
    shorter; with ``project`` (the last launch the fused one) a solve of no
    sweeps is one launch of none."""
    full, rest = divmod(iterations, sweeps)
    cut = [sweeps] * full + ([rest] if rest else [])
    return (cut or [0]) if project else cut


def tiles_for(h: int, w: int, sms: int, batch: int = 1) -> int:
    """The geometry of a batch of ``batch`` (h, w) grids on a GPU of ``sms``
    SMs: the LARGE tiles where their blocks, batch x blocks a grid, give at
    least one block per SM, else the SMALL ones (both exact)."""
    return LARGE if batch * TILES[LARGE].blocks(h, w, SWEEPS) >= sms else SMALL


def plan(h: int, w: int, iterations: int, sms: int, batch: int = 1,
         project: bool = False) -> Tuple[int, List[int]]:
    """(tiles, sweeps of each launch) of a solve on a batch of (h, w) grids
    on a GPU of ``sms`` SMs: SWEEPS sweeps a launch, the last shorter. With
    ``project`` (jacobi_project) the last launch is the fused one, and a
    solve of no sweeps is one launch of none."""
    return tiles_for(h, w, sms, batch), chunks(iterations, SWEEPS, project)


def design_cell_sweeps(h: int, w: int, iterations: int, sms: int,
                       project: bool = False) -> int:
    """Cells x sweeps the planned launches compute, halos and the padding of
    the last tiles included (the function's own work is h * w * iterations);
    with ``project`` the fused last launch's deeper halo too."""
    tiles, cut = plan(h, w, iterations, sms, project=project)
    t = TILES[tiles]
    return sum(t.blocks(h, w, k, project and n == len(cut) - 1) * t.rh * t.rw * k
               for n, k in enumerate(cut))


def design_bytes(h: int, w: int, iterations: int, sms: int, itemsize: int) -> int:
    """Bytes of device memory the step's solve (``plan(..., project=True)``)
    moves: each block loads its whole region of the pressure (float32
    scratch after the first launch) and of the divergence, halo and clamped
    padding included; each launch writes the field once (float32 scratch
    but for the last); the fused last launch also reads and writes the
    velocity's two planes, once. Beside the function's own bytes
    (function_bytes), the difference is the halos' and the scratch's."""
    tiles, cut = plan(h, w, iterations, sms, project=True)
    t = TILES[tiles]
    total = 4 * h * w * itemsize
    for n, k in enumerate(cut):
        last = n == len(cut) - 1
        region = t.blocks(h, w, k, last) * t.rh * t.rw
        total += region * ((itemsize if n == 0 else 4) + itemsize)
        total += h * w * (itemsize if last else 4)
    return total


def function_bytes(h: int, w: int, itemsize: int) -> int:
    """Bytes the solve and projection must move as a function: the pressure
    and the divergence read once, the pressure written once, the velocity's
    two planes read and written once."""
    return 7 * h * w * itemsize


def check_cut(tiles: int, cut: Sequence[int], project: bool = False) -> None:
    """Raise unless every launch of ``cut`` runs 1 to max_sweeps sweeps;
    with ``project`` the last launch is the fused one, which runs 0 to
    max_sweeps(project=True)."""
    t = TILES[tiles]
    body, last = (cut[:-1], cut[-1:]) if project else (cut, [])
    if (not cut or any(not 1 <= k <= t.max_sweeps() for k in body)
            or any(not 0 <= k <= t.max_sweeps(project=True) for k in last)):
        raise ValueError(f"tiles {t} cannot run sweeps {list(cut)}"
                         + (" (the last fused)" if project else ""))


def _warm_start_only(pressure: torch.Tensor, prescale: float) -> torch.Tensor:
    return (pressure.to(torch.float32) * prescale).to(pressure.dtype)


def _check_fields(pressure: torch.Tensor, div: torch.Tensor, sim_w=None):
    """(batch view (B, H, W) of the pressure, of the divergence, single);
    with ``sim_w``, (the packed fields, B, single = False)."""
    if pressure.shape != div.shape:
        raise ValueError(f"pressure {tuple(pressure.shape)} / div {tuple(div.shape)}")
    if sim_w is not None:
        return pressure, div, packed_batch(pressure, 2, sim_w)
    p, single = as_batch(pressure, 2)
    return p, as_batch(div, 2)[0], single


def _geometry(pressure: torch.Tensor, div: torch.Tensor, sim_w=None):
    """(p, d, single, (B, H, W, layout)) of a launch: the batch views of one
    sim or a batch, or a packed fleet's fields as they are."""
    if sim_w is None:
        p, d, single = _check_fields(pressure, div)
        return p, d, single, (*p.shape, BATCHED)
    p, d, b = _check_fields(pressure, div, sim_w)
    return p, d, False, (b, p.shape[0], sim_w, PACKED)


def _launch_chunks(p, d, cut, prescale, geo, tiles, code, out=None):
    """Launch jacobi_chunk once per entry of ``cut``, ping-ponging float32
    scratch from the stored input; the last launch writes ``out`` in
    storage, or float32 scratch where ``out`` is None. -> (the last
    launch's buffer, 1 where it is float32 scratch, the next launch's
    prescale); with no launch, the input itself."""
    bufs = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
            for _ in range(min(len(cut) - (out is not None), 2))]
    src, src_f32, scale = p, 0, float(prescale)
    for n, k in enumerate(cut):
        stored = out is not None and n == len(cut) - 1
        dst = out if stored else bufs[n % 2]
        JACOBI_CHUNK(ptr(src), src_f32, ptr(d), ptr(dst), 0 if stored else 1, scale, *geo[:3],
                     k, tiles, geo[3], code, stream(p))
        src, src_f32, scale = dst, int(not stored), 1.0
    return src, src_f32, scale


def run_chunks(pressure: torch.Tensor, div: torch.Tensor, prescale: float,
               cut: Sequence[int], sim_w=None) -> torch.Tensor:
    """Launch jacobi_chunk once per entry of ``cut`` (sweeps of that launch)
    on the tiles ``tiles_for`` picks, ping-ponging float32 scratch between the
    stored input and the stored result; one sim, a batch or a packed fleet
    of sims ``sim_w`` wide ((H, B*sim_w), its scratch packed too) each
    launch."""
    code = check_storage(pressure, div)
    p, d, single, geo = _geometry(pressure, div, sim_w)
    tiles = tiles_for(geo[1], geo[2], sm_count(p.device), geo[0])
    check_cut(tiles, cut)
    out = torch.empty_like(p)
    _launch_chunks(p, d, cut, prescale, geo, tiles, code, out)
    return out[0] if single else out


def run_project(pressure: torch.Tensor, div: torch.Tensor, velocity: torch.Tensor,
                prescale: float, cut: Sequence[int], sim_w=None):
    """(pressure, projected velocity) in storage: jacobi_chunk for every
    entry of ``cut`` but the last, then one jacobi_project launch of the
    last's sweeps (0 for a solve of none) on the same tiles; one sim, a
    batch or a packed fleet of sims ``sim_w`` wide (velocity (2, H,
    B*sim_w))."""
    code = check_storage(pressure, div, velocity)
    p, d, single, geo = _geometry(pressure, div, sim_w)
    if sim_w is None:
        vel, _ = _check_velocity(velocity)
        grid = (vel.shape[0],) + tuple(vel.shape[2:])
    else:
        vel = velocity
        grid = (_packed_velocity(velocity, sim_w)[1], velocity.shape[-1])
    if grid != tuple(p.shape):
        raise ValueError(f"velocity {tuple(velocity.shape)} is not on the pressure's grid "
                         f"{tuple(pressure.shape)}")
    tiles = tiles_for(geo[1], geo[2], sm_count(p.device), geo[0])
    check_cut(tiles, cut, project=True)
    src, src_f32, scale = _launch_chunks(p, d, cut[:-1], prescale, geo, tiles, code)
    out, vel_out = torch.empty_like(p), torch.empty_like(vel)
    JACOBI_PROJECT(ptr(src), src_f32, ptr(d), ptr(vel), ptr(out), ptr(vel_out), scale,
                   *geo[:3], cut[-1], tiles, geo[3], code, stream(p))
    return (out[0], vel_out[0]) if single else (out, vel_out)


def jacobi_pressure(pressure: torch.Tensor, div: torch.Tensor, iterations: int,
                    prescale: float = 1.0, sim_w=None) -> torch.Tensor:
    """``iterations`` sweeps on the card, SWEEPS a launch (``plan``), of one
    sim, a batch or a packed fleet of sims ``sim_w`` wide."""
    _check_fields(pressure, div, sim_w)
    check_storage(pressure, div)
    if iterations == 0:
        return _warm_start_only(pressure, prescale)
    return run_chunks(pressure, div, prescale, chunks(iterations, SWEEPS), sim_w)


def jacobi_project(pressure: torch.Tensor, div: torch.Tensor, velocity: torch.Tensor,
                   iterations: int, prescale: float = 1.0, sim_w=None):
    """(pressure, velocity - grad pressure) on the card, of one sim, a batch
    or a packed fleet of sims ``sim_w`` wide: ``iterations`` sweeps, SWEEPS a
    launch, the last launch jacobi_project (``plan(..., project=True)``)."""
    return run_project(pressure, div, velocity, prescale, chunks(iterations, SWEEPS, True), sim_w)


def _jacobi_sim(pressure, div, iterations, prescale):
    if iterations == 0:
        return _warm_start_only(pressure, prescale)
    p = pressure.to(torch.float32) * prescale
    return S.jacobi_pressure(p, div.to(torch.float32), iterations).to(pressure.dtype)


def jacobi_plain(pressure: torch.Tensor, div: torch.Tensor, iterations: int,
                 prescale: float = 1.0, sim_w=None) -> torch.Tensor:
    """Plain version of jacobi_pressure, same operations and rounding; a
    batch sim by sim; a packed fleet unpacked, run as a batch, packed."""
    if sim_w is not None:
        _, _, b = _check_fields(pressure, div, sim_w)
        return pack_fleet(jacobi_plain(unpack_fleet(pressure, b), unpack_fleet(div, b),
                                       iterations, prescale))
    return per_sim(_jacobi_sim, pressure.ndim == 3, (pressure, div, iterations, prescale),
                   fields=(0, 1))


def jacobi_project_plain(pressure: torch.Tensor, div: torch.Tensor, velocity: torch.Tensor,
                         iterations: int, prescale: float = 1.0, sim_w=None):
    """Plain version of jacobi_project: jacobi_plain, then the gradient
    subtract's plain version on the pressure as stored."""
    p = jacobi_plain(pressure, div, iterations, prescale, sim_w)
    return p, gradient_subtract_plain(velocity, p, sim_w)


def _jacobi_chunks_sim(pressure, div, cut, prescale):
    p = pressure.to(torch.float32) * prescale
    d = div.to(torch.float32)
    for k in cut:
        p = S.jacobi_pressure(p, d, k)
    return p.to(pressure.dtype)


def jacobi_chunks_plain(pressure: torch.Tensor, div: torch.Tensor, cut: Sequence[int],
                        prescale: float = 1.0, sim_w=None) -> torch.Tensor:
    """Plain version of run_chunks: the sweeps of each launch on float32
    scratch, the warm start at the first load, one rounding at the end; a
    batch sim by sim; a packed fleet unpacked, run as a batch, packed."""
    if sim_w is not None:
        _, _, b = _check_fields(pressure, div, sim_w)
        return pack_fleet(jacobi_chunks_plain(unpack_fleet(pressure, b), unpack_fleet(div, b),
                                              cut, prescale))
    return per_sim(_jacobi_chunks_sim, pressure.ndim == 3, (pressure, div, cut, prescale),
                   fields=(0, 1))
