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
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from tpufluid_torch.ops import stencil as S
from tpufluid_torch.ops.cuda.build import (BATCHED, PACKED, F, I, P, Kernel, as_batch,
                                           check_storage, pack_fleet, packed_batch, per_sim,
                                           ptr, sm_count, stream, unpack_fleet)

JACOBI_CHUNK = Kernel("jacobi_chunk", "jacobi", "fluid_jacobi_chunk",
                      [P, I, P, P, I, F, I, I, I, I, I, I, I, P],
                      replaces="tpufluid/ops/pallas/jacobi.py:139")


@dataclasses.dataclass(frozen=True)
class Tiles:
    """One compiled geometry of jacobi_chunk_kernel: blocks of ``rw`` x
    ``ny`` threads, each thread one column and ``r`` rows of a region of
    ``rh`` = ny * r rows: a tile and a halo as deep as the launch's sweeps.
    ``min_blocks``: blocks an SM must hold at once (the compiler caps
    registers to fit)."""

    rw: int
    ny: int
    r: int
    min_blocks: int = 1

    @property
    def rh(self) -> int:
        return self.ny * self.r

    def max_sweeps(self) -> int:
        """Most sweeps one launch can run: the tile keeps at least one cell."""
        return (min(self.rh, self.rw) - 1) // 2

    def blocks(self, h: int, w: int, sweeps: int) -> int:
        return -(-w // (self.rw - 2 * sweeps)) * -(-h // (self.rh - 2 * sweeps))


# In the order of csrc/jacobi.cu launch_tiles. Picked by measurement on the
# H100 (PERF.md): 64x128 regions, two blocks an SM, where they give every SM
# a block, else 32x64 regions; 10 sweeps a launch (tools/kernel_candidates.py
# times the others).
TILES = (Tiles(128, 4, 16, 2), Tiles(64, 4, 8))
LARGE, SMALL, SWEEPS = 0, 1, 10


def chunks(iterations: int, sweeps: int) -> List[int]:
    """``iterations`` sweeps cut into launches of ``sweeps``, the last shorter."""
    full, rest = divmod(iterations, sweeps)
    return [sweeps] * full + ([rest] if rest else [])


def tiles_for(h: int, w: int, sms: int, batch: int = 1) -> int:
    """The geometry of a batch of ``batch`` (h, w) grids on a GPU of ``sms``
    SMs: the LARGE tiles where their blocks, batch x blocks a grid, give at
    least one block per SM, else the SMALL ones (both exact)."""
    return LARGE if batch * TILES[LARGE].blocks(h, w, SWEEPS) >= sms else SMALL


def plan(h: int, w: int, iterations: int, sms: int, batch: int = 1) -> Tuple[int, List[int]]:
    """(tiles, sweeps of each launch) of a solve on a batch of (h, w) grids
    on a GPU of ``sms`` SMs: SWEEPS sweeps a launch, the last shorter."""
    return tiles_for(h, w, sms, batch), chunks(iterations, SWEEPS)


def design_cell_sweeps(h: int, w: int, iterations: int, sms: int) -> int:
    """Cells x sweeps the planned launches compute, halos and the padding of
    the last tiles included (the function's own work is h * w * iterations)."""
    tiles, cut = plan(h, w, iterations, sms)
    t = TILES[tiles]
    return sum(t.blocks(h, w, k) * t.rh * t.rw * k for k in cut)


def check_cut(tiles: int, cut: Sequence[int]) -> None:
    """Raise unless every launch of ``cut`` runs 1 to max_sweeps sweeps."""
    if not cut or min(cut) < 1 or max(cut) > TILES[tiles].max_sweeps():
        raise ValueError(f"tiles {TILES[tiles]} cannot run sweeps {list(cut)}")


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


def run_chunks(pressure: torch.Tensor, div: torch.Tensor, prescale: float,
               cut: Sequence[int], sim_w=None) -> torch.Tensor:
    """Launch jacobi_chunk once per entry of ``cut`` (sweeps of that launch)
    on the tiles ``tiles_for`` picks, ping-ponging float32 scratch between the
    stored input and the stored result; one sim, a batch or a packed fleet
    of sims ``sim_w`` wide ((H, B*sim_w), its scratch packed too) each
    launch."""
    code = check_storage(pressure, div)
    if sim_w is None:
        p, d, single = _check_fields(pressure, div)
        b, h, w = p.shape
        layout = BATCHED
    else:
        p, d, b = _check_fields(pressure, div, sim_w)
        single, (h, w), layout = False, (p.shape[0], sim_w), PACKED
    tiles = tiles_for(h, w, sm_count(p.device), b)
    check_cut(tiles, cut)
    out = torch.empty_like(p)
    bufs = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
            for _ in range(min(len(cut) - 1, 2))]
    src, src_f32, scale = p, 0, float(prescale)
    for n, k in enumerate(cut):
        last = n == len(cut) - 1
        dst = out if last else bufs[n % 2]
        JACOBI_CHUNK(ptr(src), src_f32, ptr(d), ptr(dst), 0 if last else 1, scale, b, h, w,
                     k, tiles, layout, code, stream())
        src, src_f32, scale = dst, 1, 1.0
    return out[0] if single else out


def jacobi_pressure(pressure: torch.Tensor, div: torch.Tensor, iterations: int,
                    prescale: float = 1.0, sim_w=None) -> torch.Tensor:
    """``iterations`` sweeps on the card, SWEEPS a launch (``plan``), of one
    sim, a batch or a packed fleet of sims ``sim_w`` wide."""
    _check_fields(pressure, div, sim_w)
    check_storage(pressure, div)
    if iterations == 0:
        return _warm_start_only(pressure, prescale)
    return run_chunks(pressure, div, prescale, chunks(iterations, SWEEPS), sim_w)


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
