"""The sharded step: halo exchanges around the step's own passes, over a
(rows, columns) mesh of devices, driven by one process.

Counterpart of tpufluid/parallel/sharded_step.py. Fields are sharded H over
the mesh's rows and W over its columns (a 1-D row decomposition is the
nx = 1 case and exchanges no column). Each phase exchanges ghost rows and
columns as deep as its stencil's or backtrace's reach, runs the pass of
``ops/cuda/dispatch.py`` on every shard's PADDED block (the CUDA kernels on
a CUDA shard, their plain versions on a CPU one: one implementation, as in
the single-device step) and keeps the block's centre. JAX's ``shard_map``
body runs on every device at once; here every phase runs over every shard
before the next phase's exchange, the same order of data.

Exactness on padded blocks (the JAX package's argument, unchanged):
  * inside the grid the ghosts hold the neighbours' data (rows, then
    columns, so the corners hold the diagonal neighbours'), so a stencil or
    backtrace within the halo reads the global values;
  * at a global wall a ghost replicates the edge row or column: exactly
    clamp-to-edge for a single stencil layer and for a bilinear gather;
  * the pre-pressure chain stacks three stencil layers, whose walls no
    ghost can emulate: it takes the grid's TRUE walls inside the block
    (``pre_pressure(..., true_bounds=...)``, sentinels where a shard owns
    no wall) and clamps and reflects exactly there;
  * the Jacobi sweeps are iterated: their ghosts outside the grid MIRROR
    the texels inside (global -k := k - 1), a fixed point of the symmetric
    sweep, so 20 sweeps on a 32-deep halo give the clamped solve at every
    texel kept;
  * the projection is split (gradient subtract, exchange, self-advection),
    as in the single-device step.

Every pass runs on the column-padded block and returns an output as wide,
of which the step keeps the centre, a view. The next column pad of that
view writes the ghost columns into the output it was cropped from
(``_colpad``, halo.exchange_halo_into) instead of concatenating the block
anew: the same padded block, value for value, without copying the block.
Only an output the step allocated and cropped at exactly that width is
written so (``_crop`` registers it, ``_owned`` finds it); any other tensor,
a caller's among them, is concatenated anew (halo.exchange_halo).

Not bit-equal to the single-device step: the advection's backtrace is
computed in coordinates relative to the array it gathers from
(csrc/advect.cu), and a padded block rounds them otherwise than the whole
grid. The sharded step through the kernels equals the sharded step through
the plain passes (``plain_sharded_step``) as the single-device step equals
``plain_step``.

The same body steps a batch of B sims on every shard (the counterpart of
the JAX package's vmap of ``sharded_fluid_step``, tpufluid/batch.py:258):
each shard's fields lead with B, the passes take the B sims in one launch
each, and dt is a number or each device's copy of the (2, B, 2) table of
step.dt_table. Every index runs over the trailing (rows, columns) axes, so
each sim of a batched sharded step equals its single-sim sharded step, bit
for bit. The splats and the dt tables are those of one group of shards:
two groups on one device never share them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.ops.cuda.stencil import NO_WALL
from tpufluid_torch.ops.sampling import true_div
from tpufluid_torch.ops.splat import SPLAT_B, SPLAT_DX, SPLAT_DY, SPLAT_R, splat_factors
from tpufluid_torch.parallel.halo import PADS, exchange_halo, exchange_halo_into, ghost_strips
from tpufluid_torch.parallel.mesh import Mesh, ShardedState, make_mesh
from tpufluid_torch.spans import span
from tpufluid_torch.state import FluidState
from tpufluid_torch.step import clamp_dt

# Ghost widths, the JAX package's (tpufluid/parallel/sharded_step.py:63-84):
# the displacement bound takes dt = 1/60, just above the clamp's 0.016666.
_BOUND_DT = 1.0 / 60.0
MAX_SPEED = 1000.0   # the reference's velocity clamp
_G_STENCIL = 16      # >= the pre-pressure chain's 3 layers
_JACOBI_SWEEPS_PER_EXCHANGE = 20
_G_JACOBI = 32       # > the sweeps between two exchanges (mirror-ghost margin)
_G_VEL = 32          # >= ceil(1000 / 60) + the bilinear corner
_GC = 64             # column ghosts: >= every phase's reach

assert _G_JACOBI > _JACOBI_SWEEPS_PER_EXCHANGE

Grid = List[List]    # (ny, nx) of one value a shard


def _round_mult(x: float, m: int) -> int:
    return max(m, -(-int(math.ceil(x)) // m) * m)


def dye_halo_width(config: FluidConfig) -> int:
    """Ghost rows of the dye advection: the sim grid's displacement bound
    scaled by the dye/sim ratio, plus the bilinear corner."""
    sh, dh = config.sim_size[1], config.dye_size[1]
    return _round_mult(MAX_SPEED * _BOUND_DT * dh / sh + 2, 16)


def dye_halo_width_cols(config: FluidConfig) -> int:
    sw, dw = config.sim_size[0], config.dye_size[0]
    return _round_mult(MAX_SPEED * _BOUND_DT * dw / sw + 2, 64)


def vel_resample_pad(config: FluidConfig) -> int:
    """Ghost rows and columns of the velocity for a shard's resample onto
    its dye block: only the dye block's centre survives the crop, and it
    needs the velocity at most 0.5 sim/dye - 0.5 sim texels past the shard,
    plus the bilinear +1 tap."""
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    need_r = math.ceil(0.5 * sh / dh - 0.5) + 1
    need_c = math.ceil(0.5 * sw / dw - 0.5) + 1
    return max(2, need_r, need_c)


def _sample_2d(tex: torch.Tensor, row_coords: torch.Tensor,
               col_coords: torch.Tensor) -> torch.Tensor:
    """Separable bilinear sample of (..., h, w) at row and column coords in
    texels of ``tex`` (clamp-to-edge): columns first, then rows. The
    shard's resample, with coords from GLOBAL texel centres shifted into
    the padded block."""
    h, w = tex.shape[-2:]
    x0 = torch.floor(col_coords)
    fx = (col_coords - x0).to(tex.dtype)
    ix = x0.to(torch.int64)
    a = tex.index_select(-1, ix.clamp(0, w - 1))
    b = tex.index_select(-1, (ix + 1).clamp(0, w - 1))
    tex = a + (b - a) * fx
    y0 = torch.floor(row_coords)
    fy = (row_coords - y0).to(tex.dtype).reshape(-1, 1)
    iy = y0.to(torch.int64)
    a = tex.index_select(-2, iy.clamp(0, h - 1))
    b = tex.index_select(-2, (iy + 1).clamp(0, h - 1))
    return a + (b - a) * fy


def overhead_report(config: FluidConfig, mesh_shape) -> dict:
    """The sharded step's overhead a device, from geometry alone: per phase
    its ghost rows and columns, its overcompute (padded block area over
    true block area, less 1) and the bytes a device SENDS a step for its
    exchange (rows and columns; a multi-hop exchange forwards whole strips,
    counted once a hop). The JAX package's dict, key for key."""
    ny, nx = mesh_shape
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    nb = torch.empty((), dtype=config.dtype).element_size()
    h, w = sh // ny, sw // nx
    hd, wd = dh // ny, dw // nx
    gc = 0 if nx == 1 else _GC
    gd = dye_halo_width(config)
    gdc = 0 if nx == 1 else dye_halo_width_cols(config)
    same_grid = (sw, sh) == (dw, dh)
    n_jacobi_ex = -(-config.PRESSURE_ITERATIONS // _JACOBI_SWEEPS_PER_EXCHANGE)

    def phase(name, gr, gcc, bh, bw, ch, repeats=1):
        hops_r = -(-gr // bh) if ny > 1 else 0
        hops_c = -(-gcc // bw) if nx > 1 else 0
        send = 2 * ch * nb * (min(gr, bh) * (bw + 2 * gcc) * hops_r
                              + min(gcc, bw) * bh * hops_c)
        over = ((bh + 2 * gr) * (bw + 2 * gcc)) / (bh * bw) - 1.0
        out = {"phase": name, "ghost_rows": gr, "ghost_cols": gcc,
               "overcompute_frac": round(over, 4),
               "send_bytes_per_step": send * repeats}
        if config.overlap_halo and bh >= 3 * gr:
            # Split phase: the interior band (bh rows, no row ghost) and two
            # 3 gr-row strips, 4 gr rows more than the monolithic block.
            over_s = ((bh + 6 * gr) * (bw + 2 * gcc)) / (bh * bw) - 1.0
            out["overlap_overcompute_frac"] = round(over_s, 4)
        return out

    phases = [
        phase("splat+curl+vort+div", _G_STENCIL, gc, h, w, 2),
        phase("jacobi", _G_JACOBI, gc, h, w, 2, repeats=max(n_jacobi_ex, 1)),
        phase("gradient_subtract", _G_STENCIL, gc, h, w, 3),
        phase("vel_self_advect", _G_VEL, gc, h, w, 2),
        phase("dye_advect", gd, gdc, hd, wd, 3 + (2 if same_grid else 0)),
    ]
    if not same_grid:
        pad = vel_resample_pad(config)
        phases.append(phase("vel_resample", pad, pad if nx > 1 else 0, h, w, 2))
    total = sum(p["send_bytes_per_step"] for p in phases)
    return {"mesh": [ny, nx], "phases": phases,
            "total_send_bytes_per_step": total,
            "mean_overcompute_frac": round(
                sum(p["overcompute_frac"] for p in phases) / len(phases), 4)}


# ---------------------------------------------------------------- the grid


def _map(fn: Callable, *grids: Grid) -> Grid:
    """fn(i, j, *values) for every shard (i, j), as a grid."""
    return [[fn(i, j, *(g[i][j] for g in grids)) for j in range(len(grids[0][0]))]
            for i in range(len(grids[0]))]


def _along_rows(fn: Callable, grid: Grid) -> Grid:
    """fn over each column of shards (their blocks in mesh order, a list in
    and out): what a row exchange takes."""
    ny, nx = len(grid), len(grid[0])
    out = [[None] * nx for _ in range(ny)]
    for j in range(nx):
        for i, v in enumerate(fn([grid[i][j] for i in range(ny)])):
            out[i][j] = v
    return out


def _along_cols(fn: Callable, grid: Grid) -> Grid:
    """fn over each row of shards: what a column exchange takes."""
    return [list(fn(row)) for row in grid]


def _exch2d(grid: Grid, wr: int, wc: int) -> Grid:
    """Rows, then columns (so the corners hold the diagonal neighbours')."""
    with span("halo.rows"):
        grid = _along_rows(lambda line: exchange_halo(line, wr, -2), grid)
    return _colpad(grid, wc)


# The pass outputs the step cropped, by the crop it keeps of each: view ->
# (the output, the ghost columns cropped off each side).
_PADDED = WeakIdKeyDictionary()


def _crop(x: torch.Tensor, gr: int, gc: int, h: int, w: int) -> torch.Tensor:
    """The shard's block of a pass's output ``x``: rows gr .. gr + h,
    columns gc .. gc + w. An output that is the block with ``gc`` ghost
    columns a side and no ghost row is registered with its crop, so that
    the next column pad of the crop writes into ``x``."""
    view = x[..., gr:gr + h, gc:gc + w]
    if gc and tuple(x.shape[-2:]) == (h, w + 2 * gc):
        _PADDED[view] = (x, gc)
    return view


def _owned(x: torch.Tensor, width: int):
    """The output the step cropped ``x`` from at ``width`` ghost columns a
    side, or None."""
    entry = _PADDED.get(x)
    return entry[0] if entry is not None and entry[1] == width else None


def _colpad(grid: Grid, wc: int, mirror: bool = False) -> Grid:
    """The column exchange alone (none on a mesh of one column); with
    ``mirror`` the walls' ghosts mirror the texels inside (_mirrored_pad).
    A row of shards whose blocks are each cropped from an output of their
    own (_owned), no deeper than a block, has its ghosts written in place;
    any other row is concatenated anew."""
    if not wc:
        return grid
    with span("halo.mirror" if mirror else "halo.cols"):
        taken, out = set(), []
        for line in grid:
            pads = [_owned(x, wc) for x in line]
            ids = {id(q) for q in pads}
            if (wc <= line[0].shape[-1] and all(q is not None for q in pads)
                    and len(ids) == len(pads) and taken.isdisjoint(ids)):
                taken |= ids
                out.append(exchange_halo_into(pads, line, wc, -1, mirror))
                PADS.in_place += len(line)
            else:
                out.append(_mirrored_pad(line, wc, -1) if mirror else exchange_halo(line, wc, -1))
                PADS.fresh += len(line)
        return out


def _row_strips(grid: Grid, width: int) -> Grid:
    """Each shard's (ghost_below, ghost_above) row strips."""
    with span("halo.rows"):
        return _along_rows(lambda line: ghost_strips(line, width, -2), grid)


def _overlap_rows(g: int, operands, op: Callable):
    """The split-phase row application of a halo-padded phase on one shard:
    ``op`` on an INTERIOR band that needs no ghost and on two boundary
    strips assembled from the ghosts, the strips' kept rows written over
    the interior's wrong edges in place.

    operands: ``(block, ghost_below, ghost_above)`` of each input, all of
    the local row extent h_loc >= 3 g. op(envs, r0) -> the result on the
    envs' rows, r0 the env's first row in g-padded coordinates [0, h_loc +
    2 g) (to slice row-indexed splat factors and shift the walls). Returns
    the result on the h_loc local rows. Equal to the monolithic padded call
    because every pass clamps at its array's edges, so a wrong edge reaches
    at most its dependency reach d <= g rows inward (the ghost widths are
    sized so): the interior keeps rows [g, h_loc - g), each strip of 3 g
    rows keeps its middle g."""
    h_loc = operands[0][0].shape[-2]
    lo = 2 * g
    interior = op([x.contiguous() for x, _, _ in operands], g)
    top = op([torch.cat([gb, x[..., :lo, :]], dim=-2) for x, gb, _ in operands], 0)
    bot = op([torch.cat([x[..., -lo:, :], ga], dim=-2) for x, _, ga in operands],
             g + h_loc - lo)

    def assemble(inner, t, b):
        inner[..., :g, :] = t[..., g:lo, :]
        inner[..., h_loc - g:, :] = b[..., lo - g:lo, :]
        return inner

    if isinstance(interior, tuple):
        return tuple(assemble(*x) for x in zip(interior, top, bot))
    return assemble(interior, top, bot)


def _mirror_strips(line: Sequence[torch.Tensor], strips, width: int, axis: int):
    """Ghost strips of a row or column of shards with the ghosts outside
    the grid rewritten as the MIRROR of the shard's own slices (global -k
    := k - 1, the far wall alike): what iterated symmetric sweeps need to
    equal clamped reads. Single hop only."""
    if width > line[0].shape[axis]:
        raise ValueError("the strip mirror is single-hop: a ghost deeper than a shard "
                         "needs _mirror_wall_ghosts")
    out = []
    n = len(line)
    for k, (x, (gb, ga)) in enumerate(zip(line, strips)):
        if k == 0:
            gb = torch.flip(x[..., :width, :] if axis == -2 else x[..., :width], dims=(axis,))
        if k == n - 1:
            ga = torch.flip(x[..., -width:, :] if axis == -2 else x[..., -width:],
                            dims=(axis,))
        out.append((gb, ga))
    return out


def _mirror_wall_ghosts(pad: torch.Tensor, width: int, idx: int, loc: int, total: int,
                        axis: int) -> torch.Tensor:
    """The slices of a padded block that fall outside the grid rewritten as
    the mirror of those inside (global -k := k - 1), by a gather over the
    padded block: what a ghost deeper than the shard needs."""
    hp = pad.shape[axis]
    base = idx * loc - width
    gr = base + np.arange(hp)
    m = np.where(gr < 0, -gr - 1, np.where(gr > total - 1, 2 * total - 1 - gr, gr))
    src = torch.as_tensor(np.clip(m - base, 0, hp - 1), device=pad.device)
    return pad.index_select(axis, src)


def _mirrored_pad(line: Sequence[torch.Tensor], width: int, axis: int) -> List[torch.Tensor]:
    """A row or column of shards halo-padded along ``axis`` with mirrored
    ghosts at the walls: from strips (one concatenation) where the ghost is
    no deeper than a shard, else by the exchanged block's gather."""
    loc = line[0].shape[axis]
    if width <= loc:
        strips = _mirror_strips(line, ghost_strips(line, width, axis), width, axis)
        return [torch.cat([gb, x, ga], dim=axis) for x, (gb, ga) in zip(line, strips)]
    return [_mirror_wall_ghosts(p, width, k, loc, loc * len(line), axis)
            for k, p in enumerate(exchange_halo(line, width, axis))]


# ---------------------------------------------------------------- the step


def _step(shards: ShardedState, dt, splats: Dict[torch.device, torch.Tensor],
          config: FluidConfig, passes: dispatch.Passes) -> ShardedState:
    """One sharded step of one sim or of a batch of B sims on every shard,
    in the span ``step``: each phase in the span of its pass (the
    single-device step's names), its exchanges in the spans ``halo.rows``,
    ``halo.cols`` and ``halo.mirror``.
    ``splats``: the (S, 8) splat batch, or the (B, S, 8) one, on each
    shard's device. ``dt``: every sim's clamped dt (a number), or each
    shard device's copy of the (2, B, 2) table of step.dt_table (the
    velocity's and the dye's dissipation)."""
    with span("step"):
        ny, nx = len(shards), len(shards[0])
        sw, sh_g = config.sim_size
        dw, dh_g = config.dye_size
        vel = _map(lambda i, j, s: s.velocity, shards)
        dye = _map(lambda i, j, s: s.dye, shards)
        p = _map(lambda i, j, s: s.pressure, shards)
        h_loc, w_loc = vel[0][0].shape[-2:]
        hd_loc, wd_loc = dye[0][0].shape[-2:]
        radius, aspect = config.splat_radius_uv(), config.aspect_ratio
        max_disp = MAX_SPEED * _BOUND_DT
        overlap = config.overlap_halo
        gc = 0 if nx == 1 else _GC

        def dts(x):
            """(velocity's dt, dye's dt) of the passes on ``x``'s device."""
            if isinstance(dt, dict):
                table = dt[x.device]
                return table[0], table[1]
            return dt, dt

        def factors(i, j, x, h, w, cols, row0, col0, h_total, w_total):
            return splat_factors(splats[x.device], h, w, radius, aspect, cols, row0=row0,
                                 h_total=h_total, col0=col0, w_total=w_total)

        def walls(i, j, top):
            """The grid's walls in the coordinates of a block whose row 0 of
            the shard lies at row ``top`` and column 0 at column gc."""
            return (top if i == 0 else -NO_WALL, top + h_loc - 1 if i == ny - 1 else NO_WALL,
                    gc if j == 0 else -NO_WALL, gc + w_loc - 1 if j == nx - 1 else NO_WALL)

        def rows(gy, r0, eh):
            """Rows r0 .. r0 + eh of a row factor, (H, S) or a batch's (B, H, S),
            as the kernels take it (contiguous; one sim's slice already is)."""
            return gy[..., r0:r0 + eh, :].contiguous()

        g = _G_STENCIL
        gd = dye_halo_width(config)
        gdc = 0 if nx == 1 else dye_halo_width_cols(config)
        with span("splat_factors"):
            fv = _map(lambda i, j, x: factors(i, j, x, h_loc + 2 * g, w_loc + 2 * gc,
                                              slice(SPLAT_DX, SPLAT_DY + 1), i * h_loc - g,
                                              j * w_loc - gc, sh_g, sw), vel)
            fd = _map(lambda i, j, x: factors(i, j, x, hd_loc + 2 * gd, wd_loc + 2 * gdc,
                                              slice(SPLAT_R, SPLAT_B + 1), i * hd_loc - gd,
                                              j * wd_loc - gdc, dh_g, dw), dye)

        with span("pre_pressure"):
            # ---- splat bump + curl + confinement + divergence, at the true walls ----
            if overlap and h_loc >= 3 * g:
                vc = _colpad(vel, gc)

                def pre(i, j, x, strips, f):
                    gy, gx, amt = f

                    def op(envs, r0):
                        eh = envs[0].shape[-2]
                        return passes.pre_pressure(envs[0], config.CURL, dts(x)[0],
                                                   splat_factors=(rows(gy, r0, eh), gx, amt),
                                                   true_bounds=walls(i, j, g - r0))
                    v, d = _overlap_rows(g, [(x, *strips)], op)
                    return _crop(v, 0, gc, h_loc, w_loc), _crop(d, 0, gc, h_loc, w_loc)

                out = _map(pre, vc, _row_strips(vc, g), fv)
            else:
                out = _map(lambda i, j, x, f: passes.pre_pressure(x, config.CURL, dts(x)[0],
                                                                  splat_factors=f,
                                                                  true_bounds=walls(i, j, g)),
                           _exch2d(vel, g, gc), fv)
                out = _map(lambda i, j, o: tuple(_crop(t, g, gc, h_loc, w_loc) for t in o), out)
            vel = _map(lambda i, j, o: o[0], out)
            div = _map(lambda i, j, o: o[1], out)

        with span("projection"):
            # ---- pressure: warm start + Jacobi, 20 sweeps a mirror-ghosted halo ----
            iters = config.PRESSURE_ITERATIONS
            gj = _G_JACOBI

            if iters == 0:
                p = _map(lambda i, j, x: (x.to(torch.float32) * config.PRESSURE).to(x.dtype), p)
            elif overlap and h_loc >= 3 * gj:
                def mirror_rows(grid):
                    with span("halo.mirror"):
                        return _along_rows(lambda line: _mirror_strips(
                            line, ghost_strips(line, gj, -2), gj, -2), grid)

                divc = _colpad(div, gc, mirror=True)
                dstrips = mirror_rows(divc)
                done = 0
                while done < iters:
                    k = min(_JACOBI_SWEEPS_PER_EXCHANGE, iters - done)
                    prescale = config.PRESSURE if done == 0 else 1.0
                    pc = _colpad(p, gc, mirror=True)

                    def jac(i, j, x, ps, d, ds, k=k, prescale=prescale):
                        res = _overlap_rows(gj, [(x, *ps), (d, *ds)], lambda envs, r0: (
                            passes.jacobi_pressure(envs[0], envs[1], k, prescale=prescale)))
                        return _crop(res, 0, gc, h_loc, w_loc)

                    p = _map(jac, pc, mirror_rows(pc), divc, dstrips)
                    done += k
            else:
                def jacobi_pad(grid):
                    with span("halo.mirror"):
                        grid = _along_rows(lambda line: _mirrored_pad(line, gj, -2), grid)
                    return _colpad(grid, gc, mirror=True)

                div_pad = jacobi_pad(div)
                done = 0
                while done < iters:
                    k = min(_JACOBI_SWEEPS_PER_EXCHANGE, iters - done)
                    prescale = config.PRESSURE if done == 0 else 1.0
                    p = _map(lambda i, j, x, d: _crop(
                        passes.jacobi_pressure(x, d, k, prescale=prescale), gj, gc, h_loc, w_loc),
                        jacobi_pad(p), div_pad)
                    done += k

            # ---- projection, then the velocity's self-advection ----
            gs = _G_STENCIL
            if overlap and h_loc >= 3 * gs:
                vc, pcs = _colpad(vel, gc), _colpad(p, gc)
                vel = _map(lambda i, j, x, xs, q, qs: _crop(_overlap_rows(
                    gs, [(x, *xs), (q, *qs)], lambda envs, r0: passes.gradient_subtract(*envs)),
                    0, gc, h_loc, w_loc), vc, _row_strips(vc, gs), pcs, _row_strips(pcs, gs))
            else:
                vel = _map(lambda i, j, x, q: _crop(passes.gradient_subtract(x, q), gs, gc, h_loc,
                                                    w_loc),
                           _exch2d(vel, gs, gc), _exch2d(p, gs, gc))

        with span("velocity_advection"):
            gv = _G_VEL

            def self_advect(x):
                return passes.advect_same_grid(x, x, dts(x)[0], config.VELOCITY_DISSIPATION,
                                               max_disp, max_disp)

            if overlap and h_loc >= 3 * gv:
                vc = _colpad(vel, gc)
                vel = _map(lambda i, j, x, xs: _crop(_overlap_rows(
                    gv, [(x, *xs)], lambda envs, r0: self_advect(envs[0])), 0, gc, h_loc, w_loc),
                    vc, _row_strips(vc, gv))
            else:
                vel = _map(lambda i, j, x: _crop(self_advect(x), gv, gc, h_loc, w_loc),
                           _exch2d(vel, gv, gc))

        with span("dye_advection"):
            # ---- dye advection at the dye's resolution, splat fused ----
            same_grid = (sw, sh_g) == (dw, dh_g)
            # RGB9E5 is pointwise, so the quantized padded block is the quantized
            # grid restricted to the block.
            quant = "rgb9e5" if config.DYE_RGB9E5 and config.dtype == torch.bfloat16 else None
            disp_y, disp_x = max_disp * dh_g / sh_g, max_disp * dw / sw

            def advect_dye(vd, src, f):
                return passes.advect_same_grid(vd, src, dts(src)[1], config.DENSITY_DISSIPATION,
                                               disp_y, disp_x, splat_factors=f, quant=quant)

            if not same_grid:
                # The velocity resampled on each shard at its padded dye block's
                # global texel centres (clamped: the reference's clamp-to-edge
                # sample), in dye texels a second, kept in float32 as JAX keeps it
                # (tpufluid/parallel/sharded_step.py:594-596): the dye kernel reads
                # a float32 velocity beside a 16-bit dye.
                gvr = vel_resample_pad(config)
                gvrc = gvr if nx > 1 else 0
                vel_small = _exch2d(vel, gvr, gvrc)

                def coords(i, j, x):
                    dev = x.device
                    f32 = torch.float32
                    rows = torch.clamp(torch.arange(hd_loc + 2 * gd, dtype=f32, device=dev)
                                       + (i * hd_loc - gd), 0, dh_g - 1)
                    cols = torch.clamp(torch.arange(wd_loc + 2 * gdc, dtype=f32, device=dev)
                                       + (j * wd_loc - gdc), 0, dw - 1)
                    return (true_div(rows + 0.5, float(dh_g)) * float(sh_g) - 0.5
                            - float(i * h_loc - gvr),
                            true_div(cols + 0.5, float(dw)) * float(sw) - 0.5
                            - float(j * w_loc - gvrc))

                rc = _map(coords, vel)

                def vel_on_dye(v_small, rows, cols):
                    vd = _sample_2d(v_small.to(torch.float32), rows, cols)
                    return torch.stack([vd[..., 0, :, :] * (dw / sw),
                                        vd[..., 1, :, :] * (dh_g / sh_g)], dim=-3)

            if overlap and hd_loc >= 3 * gd:
                dc = _colpad(dye, gdc)
                dstrips = _row_strips(dc, gd)
                if same_grid:
                    vc = _colpad(vel, gdc)
                    vstrips = _row_strips(vc, gd)

                def dye_shard(i, j, x, xs, f):
                    gy, gx, amt = f

                    def op(envs, r0):
                        eh = envs[-1].shape[-2]
                        vd = envs[0] if same_grid else vel_on_dye(
                            vel_small[i][j], rc[i][j][0][r0:r0 + eh], rc[i][j][1])
                        return advect_dye(vd, envs[-1], (rows(gy, r0, eh), gx, amt))

                    operands = [(x, *xs)]
                    if same_grid:
                        operands.insert(0, (vc[i][j], *vstrips[i][j]))
                    return _crop(_overlap_rows(gd, operands, op), 0, gdc, hd_loc, wd_loc)

                dye = _map(dye_shard, dc, dstrips, fd)
            else:
                if same_grid:
                    vel_d = _exch2d(vel, gd, gdc)
                else:
                    vel_d = _map(lambda i, j, v, c: vel_on_dye(v, *c), vel_small, rc)
                dye = _map(lambda i, j, v, x, f: _crop(advect_dye(v, x, f), gd, gdc, hd_loc,
                                                       wd_loc),
                           vel_d, _exch2d(dye, gd, gdc), fd)

        return tuple(tuple(FluidState(vel[i][j], dye[i][j], p[i][j]) for j in range(nx))
                     for i in range(ny))


def _splats_on(shards: ShardedState, splats) -> Dict[torch.device, torch.Tensor]:
    """The splats (any leading shape, float32) on every shard's device,
    copied once a device: what one group of shards reads."""
    devices = {s.velocity.device for row in shards for s in row}
    return {d: torch.as_tensor(splats, dtype=torch.float32, device=d) for d in devices}


def sharded_fluid_step(shards: ShardedState, dt, splats, config: FluidConfig) -> ShardedState:
    """One step of a sharded state (mesh.shard_state): the CUDA kernels on
    CUDA shards, their plain versions on CPU ones. ``dt`` in seconds,
    clamped as the single-device step clamps it; ``splats`` (MAX_SPLATS, 8)."""
    return _step(shards, clamp_dt(dt), _splats_on(shards, splats), config, dispatch.ROUTED)


def plain_sharded_step(shards: ShardedState, dt, splats, config: FluidConfig) -> ShardedState:
    """sharded_fluid_step through the kernels' plain versions on any device:
    the reference the kernel passes are held to on the card."""
    return _step(shards, clamp_dt(dt), _splats_on(shards, splats), config, dispatch.PLAIN)


def _check_mesh(config: FluidConfig, mesh: Mesh) -> None:
    ny, nx = mesh.shape
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    if sh % ny or dh % ny or sw % nx or dw % nx:
        raise ValueError(f"grid extents {(sh, sw)}/{(dh, dw)} must divide mesh {(ny, nx)}")


def _check_shards(shards: ShardedState, mesh: Mesh) -> None:
    if (len(shards), len(shards[0])) != mesh.shape or any(len(r) != mesh.shape[1]
                                                          for r in shards):
        raise ValueError(f"a sharded state of {len(shards)} x {len(shards[0])} shards on a "
                         f"{mesh.shape} mesh")
    for i, row in enumerate(shards):
        for j, s in enumerate(row):
            if s.velocity.device != mesh.devices[i][j]:
                raise ValueError(f"shard {(i, j)} on {s.velocity.device}, the mesh puts it "
                                 f"on {mesh.devices[i][j]}")


def make_sharded_step(config: FluidConfig, mesh: Mesh = None):
    """step(shards, dt, splats) -> shards over a (rows, cols) mesh (default
    make_mesh(): every visible GPU as rows). Grid extents must divide the
    mesh axes."""
    mesh = make_mesh() if mesh is None else mesh
    _check_mesh(config, mesh)

    def step(shards: ShardedState, dt, splats) -> ShardedState:
        _check_shards(shards, mesh)
        return sharded_fluid_step(shards, dt, splats, config)

    return step


def make_sharded_multi_step(config: FluidConfig, mesh: Mesh = None):
    """multi(shards, dt, batches) -> shards after T steps: ``batches`` (T,
    MAX_SPLATS, 8) copied to each device once, ``dt`` a scalar or (T,)."""
    mesh = make_mesh() if mesh is None else mesh
    _check_mesh(config, mesh)

    def multi(shards: ShardedState, dt, batches) -> ShardedState:
        _check_shards(shards, mesh)
        with span("multi_step"):
            with span("upload"):
                seqs = _splats_on(shards, batches)
            t = next(iter(seqs.values())).shape[0]
            dts = np.broadcast_to(np.asarray(dt, np.float32).reshape(-1), (t,))
            for k in range(t):
                shards = _step(shards, clamp_dt(dts[k]), {d: s[k] for d, s in seqs.items()},
                               config, dispatch.ROUTED)
            return shards

    return multi
