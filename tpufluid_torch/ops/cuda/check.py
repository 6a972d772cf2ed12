"""Hold each CUDA kernel against its plain version on the same inputs.

``step_cases`` takes a state and a splat batch and lays out every kernel
call one step makes, in order, each with the inputs the step would give it
(computed by the plain versions, so the kernel and its plain version see the
very same tensors), for one sim or for a batch of B sims in one launch each
(``batched_step_cases`` on ``random_batch``, in both forms of dt), or for
a lane-packed fleet of them (``packed_step_cases``), and after them the
standalone solve and gradient subtract that the step's fused
``jacobi_project`` replaces and the sharded step still runs;
``bounded_cases`` holds pre_pressure's true-wall form on the walls a
shard of the sharded step sees in its padded block, and
``f32_velocity_dye_cases`` the dye kernel with the float32 velocity the
sharded step gives a 16-bit dye (``batched_bounded_cases`` and
``batched_f32_velocity_dye_cases`` both on a batch with per-sim dts, as the
batch x spatial step gives them);
``render_cases`` does the same for one frame (``batched_render_cases`` for
a frame of B sims, one launch a kernel), and
``floors_cases`` for the three microbenchmark kernels on their own inputs
(``random_floors_cases`` on random ones). The kernel tests and
chip_smoke.py compare and time these cases on the card.

Tolerance of a kernel against its plain version, as a fraction of the plain
output's largest magnitude: both run the same float32 operations in the same
order without fused multiply-adds (csrc/common.cuh), so float32 results
agree to the last bit barring a library function that rounds differently;
1e-5 leaves room for that. In 16-bit storage an ulp of float32 difference
before the final rounding can flip it by one storage ulp: 2^-7 of the scale
for bfloat16 (8 significant bits), 2^-10 for float16.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpufluid_torch.batch import step_dt
from tpufluid_torch.batch_packed import pack_state, unpack_fleet
from tpufluid_torch.config import _DTYPES, FluidConfig
from tpufluid_torch.ops import floors as _floors
from tpufluid_torch.ops.cuda import advect as _advect
from tpufluid_torch.ops.cuda import bloom as _bloom
from tpufluid_torch.ops.cuda import display as _display
from tpufluid_torch.ops.cuda import floors as _floors_k
from tpufluid_torch.ops.cuda import jacobi as _jacobi
from tpufluid_torch.ops.cuda import stencil as _stencil
from tpufluid_torch.ops.cuda import sunrays as _sunrays
from tpufluid_torch.ops.display import shading_constants
from tpufluid_torch.ops.sampling import affine_axis_plan, resample_bilinear
from tpufluid_torch.ops.splat import SPLAT_B, SPLAT_DX, SPLAT_DY, SPLAT_R, splat_factors
from tpufluid_torch.ops.sunrays import apply_sunrays
from tpufluid_torch.render import blue_noise
from tpufluid_torch.state import FluidState
from tpufluid_torch.step import clamp_dt

TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class Case:
    """One kernel call of a step: ``kernel(*args)`` against ``plain(*args)``."""

    label: str            # e.g. "advect:dye"
    kernel_name: str      # the Kernel it launches (build.KERNELS)
    kernel: Callable
    plain: Callable
    args: Tuple
    nbytes: int           # bytes the call must move: inputs once, outputs once
    flops: int            # float32 operations the function needs

    def run(self, plain: bool = False):
        return (self.plain if plain else self.kernel)(*self.args)


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# Float32 operations of the kernels' arithmetic, each counted at its
# cost in the card's float32 pipe (128 lanes a clock an SM; its special
# function unit does 16, so one of its instructions counts as 8): an add,
# multiply, compare or conversion 1; an IEEE division 18 (a reciprocal on
# the special function unit and ~10 instructions of refinement and
# rounding); an IEEE sqrtf 16 (a reciprocal square root and ~8 more); a
# powf 56 (a log and an exp on the special function unit and ~40
# instructions of extended precision). One axis coordinate (axis_tap) is a
# division and 7 more operations; one lerp 4 (a*(1-f) + b*f); the soft knee
# 13 per source texel with its division.
_DIV, _SQRT, _POW = 18, 16, 56
_AXIS, _LERP = _DIV + 7, 4
_KNEE = 12 + _DIV
# The sunrays' mask at one corner: two maxima over the channels, x 20, the
# two clamps and 1 - t.
_MASK = 6


# The pre-pressure chain a texel, beside the bump's 2 operations a channel
# and active splat: the bump's add to the velocity (2), the curl (4), the
# confinement (4 + 4 for the force's two differences, 3 for its squared
# length, a sqrtf, 1 for the +1e-4, a division, 5 for the scale and its
# sign, 8 for the two updates and clamps) and the divergence (4).
_PRE_PRESSURE = 2 + 4 + (4 + 4 + 3 + _SQRT + 1 + _DIV + 5 + 8) + 4


def _step_dts(dt, batch: Optional[int], config: FluidConfig, device):
    """(velocity's dt, dye's dt) of a step's kernel calls, as the step
    makes them: the clamped number for one sim or a lock-step batch; for a
    batch and a (B,) ``dt``, the two (B, 2) tables of batch.step_dt."""
    if batch is None or np.ndim(dt) == 0:
        return clamp_dt(dt), clamp_dt(dt)
    table = step_dt(dt, batch, config, device)
    return table[0], table[1]


def _layout(fn: Callable, sim_w: Optional[int]) -> Callable:
    """``fn`` as it is, or bound to a packed fleet of sims ``sim_w`` wide."""
    return fn if sim_w is None else functools.partial(fn, sim_w=sim_w)


def step_cases(state: FluidState, splats: torch.Tensor, config: FluidConfig,
               dt=1.0 / 60.0, tag: str = "", sim_w: Optional[int] = None) -> List[Case]:
    """Every kernel call of one step from ``state``, in the step's order:
    one sim, or a batch of B sims (fields with a leading B, ``splats``
    (B, S, 8), ``dt`` a number or (B,) per sim), or with ``sim_w`` a packed
    fleet of B sims that wide (fields (C, H, B*sim_w)), one launch each but
    the solve's (``jacobi_project``: its earlier chunks, then the fused
    last launch, which returns the pressure and the projected velocity).
    Then the standalone solve and gradient subtract on the same inputs
    ("jacobi", "gradient_subtract"): the pair the fused launch replaces,
    which the sharded step still runs. ``tag`` is added to each label."""
    if sim_w is not None:
        batch = state.velocity.shape[-1] // sim_w
    else:
        batch = state.velocity.shape[0] if state.velocity.ndim == 4 else None
    n_sims = batch or 1
    vel_dt, dye_dt = _step_dts(dt, batch, config, state.velocity.device)
    dtype = state.velocity.dtype
    quant = "rgb9e5" if config.DYE_RGB9E5 and dtype == torch.bfloat16 else None
    radius, aspect = config.splat_radius_uv(), config.aspect_ratio
    (vh, vw), (dh, dw) = state.velocity.shape[-2:], state.dye.shape[-2:]
    if sim_w is not None:
        vw = dw = sim_w
    splats = splats.to(device=state.velocity.device, dtype=torch.float32)
    vf = splat_factors(splats, vh, vw, radius, aspect, slice(SPLAT_DX, SPLAT_DY + 1))
    df = splat_factors(splats, dh, dw, radius, aspect, slice(SPLAT_R, SPLAT_B + 1))
    n_active = int((splats[..., 7] != 0).sum())   # over every sim
    sim, dye = vh * vw, dh * dw
    iters = config.PRESSURE_ITERATIONS
    pre, pre_plain = (_layout(f, sim_w) for f in (_stencil.pre_pressure,
                                                  _stencil.pre_pressure_plain))
    jac, jac_plain = (_layout(f, sim_w) for f in (_jacobi.jacobi_pressure, _jacobi.jacobi_plain))
    proj, proj_plain = (_layout(f, sim_w) for f in (_jacobi.jacobi_project,
                                                    _jacobi.jacobi_project_plain))
    gs, gs_plain = (_layout(f, sim_w) for f in (_stencil.gradient_subtract,
                                                _stencil.gradient_subtract_plain))
    adv, adv_plain = (_layout(f, sim_w) for f in (_advect.advect, _advect.advect_plain))

    vel1, div = pre_plain(state.velocity, config.CURL, vel_dt, vf)
    pressure, vel2 = proj_plain(state.pressure, div, vel1, iters, config.PRESSURE)
    vel3 = adv_plain(vel2, vel2, vel_dt, config.VELOCITY_DISSIPATION)
    dye_out = adv_plain(vel3, state.dye, dye_dt, config.DENSITY_DISSIPATION, df, quant)
    # A sweep 6 operations a cell, the gradient subtract 4.
    return [
        Case("pre_pressure" + tag, "pre_pressure", pre, pre_plain,
             (state.velocity, config.CURL, vel_dt, vf),
             _bytes(state.velocity, *vf, vel1, div),
             sim * (2 * 2 * n_active + n_sims * _PRE_PRESSURE)),
        Case("jacobi_project" + tag, "jacobi_project", proj, proj_plain,
             (state.pressure, div, vel1, iters, config.PRESSURE),
             _bytes(state.pressure, div, vel1, pressure, vel2), n_sims * sim * (6 * iters + 4)),
        Case("advect:velocity" + tag, "advect", adv, adv_plain,
             (vel2, vel2, vel_dt, config.VELOCITY_DISSIPATION), _bytes(vel2, vel3),
             n_sims * sim * (20 + 2 * 8)),
        # The function's bytes: the velocity, the dye and the factors read
        # once, the dye written once.
        Case("advect:dye" + tag, "advect_dye", adv, adv_plain,
             (vel3, state.dye, dye_dt, config.DENSITY_DISSIPATION, df, quant),
             _bytes(vel3, state.dye, *df, dye_out),
             dye * (n_sims * (34 + 3 * 8 + (40 if quant else 0)) + 3 * 2 * n_active)),
        Case("jacobi" + tag, "jacobi_chunk", jac, jac_plain,
             (state.pressure, div, iters, config.PRESSURE),
             _bytes(state.pressure, div, pressure), n_sims * sim * 6 * iters),
        Case("gradient_subtract" + tag, "gradient_subtract", gs, gs_plain, (vel1, pressure),
             _bytes(vel1, pressure, vel2), n_sims * sim * 4),
    ]


def shard_bounds(h: int, w: int, ghost_rows: int, ghost_cols: int) -> dict:
    """The true walls (row_lo, row_hi, col_lo, col_hi) that pre_pressure
    gets in the sharded step's padded block of an (h, w) shard (ghosts of
    ``ghost_rows`` rows and ``ghost_cols`` columns), by the shard's place in
    the mesh, and walls inside the first tile and on the edges of each tile
    of stencil.TILES (there the window's origin is a tile's extent)."""
    g, gc, big = ghost_rows, ghost_cols, _stencil.NO_WALL
    out = {"top": (g, big, -big, big), "bottom": (-big, g + h - 1, -big, big),
           "corner": (g, big, gc, big), "corner-bottom-right": (-big, g + h - 1, -big, gc + w - 1),
           "middle": (-big, big, -big, big), "one-shard": (g, g + h - 1, gc, gc + w - 1),
           "first-tile": (3, g + h - 5, 5, gc + w - 3)}
    for t in _stencil.TILES:
        out[f"tile-edge-{t.th}x{t.tw}"] = (t.th, g + h - 1, t.tw, gc + w - 1)
    return out


# (h, w) of the shards bounded_cases pads: the small tiles' window and the
# large ones' (stencil.plan on 132 SMs).
BOUNDED_SHARDS = ((96, 160), (512, 1024))


def _in_window(fn: Callable) -> Callable:
    """fn(velocity, curl, dt, factors, bounds) cropped to the window of the
    bounds: its outputs outside are unspecified."""
    def run(velocity, curl_strength, dt, factors, bounds):
        r0, c0, wh, ww = _stencil.window(*velocity.shape[-2:], bounds)
        return tuple(t[..., r0:r0 + wh, c0:c0 + ww]
                     for t in fn(velocity, curl_strength, dt, factors, bounds))
    return run


def bounded_cases(device, dtype: torch.dtype, ghosts: Tuple[int, int], seed: int = 0,
                  shards=BOUNDED_SHARDS) -> List[Case]:
    """pre_pressure's true-wall form against its plain version on each
    shard's padded block (ghosts (rows, columns); random velocity, 8 splat
    rows, the last inactive), at every wall of shard_bounds; both run the
    whole block and return the window of the bounds. The bytes and
    operations are the window's."""
    cases = []
    for h, w in shards:
        hp, wp = h + 2 * ghosts[0], w + 2 * ghosts[1]
        cfg = FluidConfig(SIM_RESOLUTION=hp, DYE_RESOLUTION=hp, CANVAS_WIDTH=wp,
                          CANVAS_HEIGHT=hp, MAX_SPLATS=8, DTYPE=_DTYPE_NAMES[dtype]).validate()
        state, splats = random_state(cfg, seed, device)
        vf = splat_factors(splats, hp, wp, cfg.splat_radius_uv(), cfg.aspect_ratio,
                           slice(SPLAT_DX, SPLAT_DY + 1))
        n_active = int((splats[:, 7] != 0).sum())
        for name, bounds in shard_bounds(h, w, *ghosts).items():
            r0, c0, wh, ww = _stencil.window(hp, wp, bounds)
            # the window's velocity and factors read, its velocity and
            # divergence written
            nbytes = _bytes(state.velocity[:, :wh, :ww], vf[0][:wh], vf[1][:, :ww], vf[2]) \
                + 3 * wh * ww * state.velocity.element_size()
            cases.append(Case(f"pre_pressure:{name}:{hp}x{wp}", "pre_pressure",
                              _in_window(_stencil.pre_pressure),
                              _in_window(_stencil.pre_pressure_plain),
                              (state.velocity, cfg.CURL, 1.0 / 60.0, vf, bounds), nbytes,
                              wh * ww * (2 * 2 * n_active + _PRE_PRESSURE)))
    return cases


def batched_bounded_cases(device, dtype: torch.dtype, ghosts: Tuple[int, int], seed: int = 0,
                          shards=BOUNDED_SHARDS, batch: int = 3) -> List[Case]:
    """bounded_cases on a batch: pre_pressure's true-wall form on
    random_batch(batch) of each shard's padded block (sims that differ, with
    different numbers of active splat rows), with the per-sim dt table of
    per_sim_dts, at every wall of shard_bounds, one launch for the batch:
    what the batch x spatial step gives a group's shards. Each sim's window
    is the same; both versions return the batch's windows."""
    cases = []
    for h, w in shards:
        hp, wp = h + 2 * ghosts[0], w + 2 * ghosts[1]
        cfg = FluidConfig(SIM_RESOLUTION=hp, DYE_RESOLUTION=hp, CANVAS_WIDTH=wp,
                          CANVAS_HEIGHT=hp, MAX_SPLATS=8, DTYPE=_DTYPE_NAMES[dtype]).validate()
        state, splats = random_batch(cfg, batch, seed, device)
        vf = splat_factors(splats, hp, wp, cfg.splat_radius_uv(), cfg.aspect_ratio,
                           slice(SPLAT_DX, SPLAT_DY + 1))
        dt = _step_dts(per_sim_dts(batch), batch, cfg, device)[0]
        n_active = int((splats[..., 7] != 0).sum())   # over every sim
        for name, bounds in shard_bounds(h, w, *ghosts).items():
            r0, c0, wh, ww = _stencil.window(hp, wp, bounds)
            nbytes = _bytes(state.velocity[..., :wh, :ww], vf[0][:, :wh], vf[1][..., :ww],
                            vf[2], dt) + 3 * batch * wh * ww * state.velocity.element_size()
            cases.append(Case(f"pre_pressure:{name}:{hp}x{wp}:b{batch}:per-sim", "pre_pressure",
                              _in_window(_stencil.pre_pressure),
                              _in_window(_stencil.pre_pressure_plain),
                              (state.velocity, cfg.CURL, dt, vf, bounds), nbytes,
                              wh * ww * (2 * 2 * n_active + batch * _PRE_PRESSURE)))
    return cases


def random_batch(config: FluidConfig, batch: int, seed: int,
                 device) -> Tuple[FluidState, torch.Tensor]:
    """A batched state (B leading) and (B, S, 8) splats: sim b is
    random_state(seed + b), with its own number of active splat rows: none
    in sim 0, all MAX_SPLATS in sim 1 (where B > 1), 3 b mod (S + 1) in the
    others, so that the kernels' per-sim lists of active rows differ."""
    states, rows = [], []
    n_rows = config.MAX_SPLATS
    for b in range(batch):
        state, splats = random_state(config, seed + b, device)
        n_on = 0 if b == 0 else n_rows if b == 1 else (3 * b) % (n_rows + 1)
        splats[:, 7] = (torch.arange(n_rows, device=splats.device) < n_on).float()
        states.append(state)
        rows.append(splats)
    fields = (torch.stack([getattr(s, f) for s in states])
              for f in ("velocity", "dye", "pressure"))
    return FluidState(*fields), torch.stack(rows)


def per_sim_dts(batch: int) -> np.ndarray:
    """Per-sim dts of a batch, from 1/90 to 1/60 (bench.py's batched config 7)."""
    return np.linspace(1.0 / 90.0, 1.0 / 60.0, batch).astype(np.float32)


def batched_step_cases(config: FluidConfig, batch: int, seed: int, device) -> List[Case]:
    """Every kernel call of one batched step on random_batch(config, batch,
    seed), in both forms of dt: lock-step 1/60 (labels ":lockstep") and per
    sim (per_sim_dts, ":per-sim"), each call one launch for the B sims."""
    state, splats = random_batch(config, batch, seed, device)
    cases: List[Case] = []
    for form, dt in ((":lockstep", 1.0 / 60.0), (":per-sim", per_sim_dts(batch))):
        cases += step_cases(state, splats, config, dt, f":b{batch}{form}")
    return cases


def packed_step_cases(config: FluidConfig, batch: int, seed: int, device) -> List[Case]:
    """Every kernel call of one packed fleet step on random_batch(config,
    batch, seed) packed (sims that differ, with different numbers of active
    splat rows), at the packed step's lock-step dt of 1/60, each call one
    launch for the fleet: the same sims and the same work as
    batched_step_cases' lock-step calls, labelled ":packed:b<B>:lockstep"."""
    state, splats = random_batch(config, batch, seed, device)
    packed, sim_w, tag = pack_state(state), config.sim_size[0], f":packed:b{batch}:lockstep"
    return step_cases(packed, splats, config, 1.0 / 60.0, tag, sim_w)


def f32_velocity_dye_cases(config: FluidConfig, seed: int, device) -> List[Case]:
    """The dye kernel with a float32 velocity beside ``config``'s 16-bit
    dye, on random_state(config, seed): on the sim grid (the velocity of
    the step's dye call, taken in float32) and on the dye's grid (that
    velocity resampled there, in dye texels a second: what the sharded
    step gives each shard's dye, never rounded to storage), labelled
    "advect:dye:f32-velocity:<grid>"."""
    state, splats = random_state(config, seed, device)
    quant = "rgb9e5" if config.DYE_RGB9E5 and config.dtype == torch.bfloat16 else None
    (vh, vw), (dh, dw) = state.velocity.shape[-2:], state.dye.shape[-2:]
    df = splat_factors(splats.to(device=device), dh, dw, config.splat_radius_uv(),
                       config.aspect_ratio, slice(SPLAT_R, SPLAT_B + 1))
    coarse = state.velocity.to(torch.float32)
    fine = resample_bilinear(coarse, (dh, dw))
    fine = torch.stack([fine[0] * (dw / vw), fine[1] * (dh / vh)]).contiguous()
    n_active = int((splats[..., 7] != 0).sum())
    dt = clamp_dt(1.0 / 60.0)
    cases = []
    for grid, vel in (("sim-grid", coarse), ("dye-grid", fine)):
        args = (vel, state.dye, dt, config.DENSITY_DISSIPATION, df, quant)
        cases.append(Case(f"advect:dye:f32-velocity:{grid}", "advect_dye", _advect.advect,
                          _advect.advect_plain, args,
                          _bytes(vel, state.dye, *df, state.dye),
                          dh * dw * (34 + 3 * 8 + (40 if quant else 0) + 3 * 2 * n_active)))
    return cases


def batched_f32_velocity_dye_cases(config: FluidConfig, seed: int, device,
                                   batch: int = 3) -> List[Case]:
    """f32_velocity_dye_cases on a batch: the dye kernel with a float32
    velocity beside ``config``'s 16-bit dye on random_batch(batch) (sims
    that differ, with different numbers of active splat rows), with the dye's
    per-sim dt table of per_sim_dts, one launch for the batch, on the sim grid
    and on the dye's grid: what the batch x spatial step gives a group's
    shards at a cross grid. Labelled
    "advect:dye:f32-velocity:<grid>:b<B>:per-sim"."""
    state, splats = random_batch(config, batch, seed, device)
    quant = "rgb9e5" if config.DYE_RGB9E5 and config.dtype == torch.bfloat16 else None
    (vh, vw), (dh, dw) = state.velocity.shape[-2:], state.dye.shape[-2:]
    df = splat_factors(splats, dh, dw, config.splat_radius_uv(), config.aspect_ratio,
                       slice(SPLAT_R, SPLAT_B + 1))
    coarse = state.velocity.to(torch.float32)
    fine = resample_bilinear(coarse, (dh, dw))
    fine = torch.stack([fine[:, 0] * (dw / vw), fine[:, 1] * (dh / vh)], dim=1).contiguous()
    dt = _step_dts(per_sim_dts(batch), batch, config, device)[1]
    n_active = int((splats[..., 7] != 0).sum())   # over every sim
    cases = []
    for grid, vel in (("sim-grid", coarse), ("dye-grid", fine)):
        args = (vel, state.dye, dt, config.DENSITY_DISSIPATION, df, quant)
        cases.append(Case(f"advect:dye:f32-velocity:{grid}:b{batch}:per-sim", "advect_dye",
                          _advect.advect, _advect.advect_plain, args,
                          _bytes(vel, state.dye, *df, dt, state.dye),
                          dh * dw * (batch * (34 + 3 * 8 + (40 if quant else 0))
                                     + 3 * 2 * n_active)))
    return cases


def grid_sample_ms(case: Case, rate: float, sim_w: Optional[int] = None) -> float:
    """Device ms of one torch.nn.functional.grid_sample call that gathers
    an advect case's source: bilinear, padding_mode="border",
    align_corners=False, the source's shape and storage type, at the
    coordinates the plain version's backtrace gives. It leaves out the
    splat bump, the RGB9E5 quantization and the decay. A batch, or a packed
    fleet of sims ``sim_w`` wide (unpacked first), is one call with the
    sims on its batch axis. Its inputs are built before the timed window;
    the port never calls it: it is the advection's library yardstick."""
    from tpufluid_torch.ops.advect import backtrace
    from tpufluid_torch.ops.cuda.floors import queued_ms

    vel, src, dt = case.args[0], case.args[1], case.args[2]
    if sim_w is not None:
        vel, src = (unpack_fleet(t, t.shape[-1] // sim_w) for t in (vel, src))
    elif vel.ndim == 3:
        vel, src = vel[None], src[None]
    h, w = src.shape[-2:]
    dts = dt[:, 0].tolist() if isinstance(dt, torch.Tensor) else [dt] * src.shape[0]
    grid = torch.stack([torch.stack(backtrace(v, h, w, d), dim=-1) for v, d in zip(vel, dts)])
    grid = (2.0 * grid - 1.0).to(src.dtype)
    inp = src.contiguous()
    return queued_ms(lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="border", align_corners=False), 20, rate)


def _blur4_flops(out_hw, prefilter_texels: int) -> int:
    """One bloom stage: 6 axis coordinates per texel; per channel 4 taps
    of 3 lerps, their sum, x 0.25 and the dst add or intensity scale."""
    oh, ow = out_hw
    return oh * ow * (6 * _AXIS + 3 * (4 * 3 * _LERP + 5)) + _KNEE * prefilter_texels


def _pyramid_flops(base_hw, mip_sizes) -> int:
    """Every stage of the pyramid (ops/bloom.pyramid), down, up and final."""
    hw = [(h, w) for w, h in mip_sizes]
    n = _blur4_flops(hw[0], base_hw[0] * base_hw[1])
    n += sum(_blur4_flops(x, 0) for x in hw[1:])
    n += sum(_blur4_flops(x, 0) for x in hw[:-1])
    return n + _blur4_flops(base_hw, 0)


def _sunrays_flops(out_hw) -> int:
    """One sunrays pass of one sim, per rays texel as the kernels compute
    it from their tables: the march's 17 taps of 4 corner masks and 3
    lerps, 16 weighted adds and the exposure; the blur's two passes, each 3
    taps of 2 lerps and their weighted sum (3 multiplies, 2 adds)."""
    h, w = out_hw
    taps = _sunrays.TAPS
    march = taps * (4 * _MASK + 3 * _LERP) + 2 * (taps - 1) + 1
    blur = 2 * (3 * 2 * _LERP + 5)
    return h * w * (march + blur)


def _display_flops(dye_hw, out_hw, c: int, shading: bool, extras, compose: bool) -> int:
    """One display pass, counted as the plain version computes it: every
    axis coordinate once per output row or column, each separable stage's
    lerps over the grid it produces (the dye's row stage over the dye's
    columns, its column stage over the dye's rows), then per texel the
    channel norms, sqrtf, the diffuse term, the gamma's powf, the dither's
    division and the alpha. ``extras`` maps "bloom", "sunrays", "dither" to
    their (h, w) where present."""
    (h, w), (oh, ow) = dye_hw, out_hw
    texels = oh * ow
    if shading:
        n = 3 * (oh + ow) * _AXIS
        n += c * _LERP * (oh * w + 3 * texels + h * ow + 2 * texels)   # rows, c/l/r, cols, t/b
        n += texels * (4 * (2 * c - 1) + 4 * _SQRT + 2 + 5 + _DIV + _SQRT + 4 + c)
    else:
        n = (oh + ow) * _AXIS + c * _LERP * (h * ow + texels)
    if compose:
        n += texels * (c - 1)                                           # alpha
        for name, (th, tw) in extras.items():
            ch = 3 if name == "bloom" else 1
            n += (oh + ow) * _AXIS + ch * _LERP * (th * ow + texels)
        if "sunrays" in extras:
            n += texels * (c + (3 if "bloom" in extras else 0))
        if "bloom" in extras:
            n += texels * 3 * (_POW + 5)                                # gamma, add
        if "dither" in extras:
            n += texels * (2 + _DIV + 3)
    return n


def _dye_texels_read(dye_hw, out_hw, shading: bool) -> int:
    """Texels of one dye channel a display pass must read: the rows and
    columns its taps touch (ops/cuda/display.window's axis plans), the
    center's rows by every column of the center, left and right taps, and
    the above and below taps' other rows by the center's columns. A canvas
    much smaller than its dye reads a share of it; an upsampled one all."""
    (h, w), (oh, ow) = dye_hw, out_hw
    tx, ty, _ = shading_constants(out_hw)

    def taps(n_in, n_out, off):
        lo, hi = affine_axis_plan(n_in, n_out, off=off)[:2]
        return set(lo.tolist()) | set(hi.tolist())

    rows, cols = taps(h, oh, 0.0), taps(w, ow, 0.0)
    if not shading:
        return len(rows) * len(cols)
    sides = taps(w, ow, tx) | taps(w, ow, -tx)
    above_below = taps(h, oh, ty) | taps(h, oh, -ty)
    return len(rows) * len(cols | sides) + len(above_below - rows) * len(cols)


def render_cases(state: FluidState, config: FluidConfig, out_hw=None, dither: bool = True,
                 compose: bool = True, tag: str = "") -> List[Case]:
    """Every kernel call of one frame from ``state`` at ``out_hw`` (default
    the canvas), in the render's order: the bloom pyramid (one call, after
    the base resample, where the config has 2 mips or more), then the
    display (on the card, the kernel of the form it takes there:
    display.kernel_of); of one sim, or of a batch (fields with a leading
    B) in one launch each, with the work of the B sims. The sunrays' call
    between them is sunrays_cases'. ``dither=False`` leaves the dither out
    of the display and ``compose=False`` makes it the shaded center alone:
    neither is what render_frame calls, both are what the display kernel
    takes. The pyramid's bytes are its base read and its output written:
    the mips between are the function's own. The display's dye bytes are
    the texels its taps touch (_dye_texels_read). ``tag`` is added to each
    label."""
    out_hw = tuple(out_hw or (config.CANVAS_HEIGHT, config.CANVAS_WIDTH))
    dye = state.dye.to(torch.float32)
    lead = tuple(state.dye.shape[:-3])
    n_sims = state.dye.shape[0] if lead else 1
    cases: List[Case] = []
    bloom = rays = noise = None
    if config.BLOOM:
        bw, bh = config.bloom_size
        mips = config.bloom_mip_sizes()
        if len(mips) < 2:
            bloom = torch.zeros(lead + (3, bh, bw), dtype=torch.float32, device=dye.device)
        else:
            base = resample_bilinear(dye, (bh, bw))
            args = (base, mips, config.BLOOM_THRESHOLD, config.BLOOM_SOFT_KNEE,
                    config.BLOOM_INTENSITY)
            cases.append(Case("bloom_pyramid" + tag, "bloom_pyramid", _bloom.bloom_pyramid,
                              _bloom.bloom_pyramid_plain, args, 2 * _bytes(base),
                              n_sims * _pyramid_flops((bh, bw), mips)))
            bloom = _bloom.bloom_pyramid_plain(*args)
        if dither:
            noise = blue_noise(dye.device)
    if config.SUNRAYS:
        sw, sh = config.sunrays_size
        rays = apply_sunrays(dye, (sh, sw), config.SUNRAYS_WEIGHT)
    if not compose:
        bloom = rays = noise = None
    c = state.dye.shape[-3]
    n_out = n_sims * (c + 1 if compose else c) * out_hw[0] * out_hw[1]
    extras = {k: tuple(t.shape[-2:]) for k, t in
              (("bloom", bloom), ("sunrays", rays), ("dither", noise)) if t is not None}
    if "bloom" not in extras:
        extras.pop("dither", None)
    cases.append(Case(
        ("display" if compose else "display:base") + tag,
        _display.kernel_of(state.dye, out_hw, config.SHADING), _display.display,
        _display.display_plain,
        (state.dye, out_hw, config.SHADING, bloom, rays, noise, compose),
        n_sims * c * state.dye.element_size() * _dye_texels_read(
            tuple(state.dye.shape[-2:]), out_hw, config.SHADING)
        + _bytes(bloom, rays, noise if bloom is not None else None) + 4 * n_out,
        n_sims * _display_flops(tuple(state.dye.shape[-2:]), out_hw, c, config.SHADING,
                                extras, compose)))
    return cases


def sunrays_cases(state: FluidState, config: FluidConfig, tag: str = "") -> List[Case]:
    """The frame's sunrays call from ``state`` (render_frame's, on the dye
    cast to float32), of one sim or of a batch in one call: the march and
    blur launches, labelled by the march's Kernel, "sunrays", with the
    work of the sims: the float32 dye read and the rays written, and
    _sunrays_flops; none where the config has no sunrays. Apart from
    render_cases, whose calls fluidbench/work models pass by pass: the
    sunrays have no pass there yet. ``tag`` is added to the label."""
    if not config.SUNRAYS:
        return []
    dye = state.dye.to(torch.float32)
    n_sims = state.dye.shape[0] if state.dye.ndim == 4 else 1
    sw, sh = config.sunrays_size
    return [Case("sunrays" + tag, "sunrays", _sunrays.sunrays, apply_sunrays,
                 (dye, (sh, sw), config.SUNRAYS_WEIGHT), _bytes(dye) + 4 * n_sims * sh * sw,
                 n_sims * _sunrays_flops((sh, sw)))]


def batched_render_cases(state: FluidState, config: FluidConfig, out_hw=None,
                         dither: bool = True, compose: bool = True) -> List[Case]:
    """render_cases of a batched state (every field with a leading B, as
    random_batch makes it): the pyramid after its batched base resample and
    the display, each one launch for the B sims, labelled ":b<B>", with the
    bytes and operations of the B sims (the dither read once)."""
    if state.dye.ndim != 4:
        raise ValueError(f"a batched state leads with B, got dye {tuple(state.dye.shape)}")
    return render_cases(state, config, out_hw, dither, compose, f":b{state.dye.shape[0]}")


# Frames whose staged display window does not fit a block of the H100
# (232,448 bytes of shared memory, with shading): (DYE_RESOLUTION,
# CANVAS_WIDTH, CANVAS_HEIGHT, the dye's dtype). The server's CLI dye at a
# small browser window; the page's "high" quality (dye 1024) at 500x281;
# the app at --canvas 256x256 with its default dye; a bf16 4096 dye at
# 1280x720; a 1024 and a bf16 4096 dye at the page's 64-pixel minimum
# canvas height (server.py's resize script).
DIRECT_GEOMETRIES = {
    "server_cli_200x112": (512, 200, 112, torch.float32),
    "server_high_500x281": (1024, 500, 281, torch.float32),
    "app_canvas_256x256": (1024, 256, 256, torch.float32),
    "dye4096_1280x720": (4096, 1280, 720, torch.bfloat16),
    "dye1024_114x64": (1024, 114, 64, torch.float32),
    "dye4096_114x64": (4096, 114, 64, torch.bfloat16),
}


def direct_geometry(label: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((dye h, w), (out h, w)) of DIRECT_GEOMETRIES[label]: the dye's grid
    as FluidConfig sizes it for the canvas."""
    res, cw, ch, _ = DIRECT_GEOMETRIES[label]
    dw, dh = FluidConfig(DYE_RESOLUTION=res, CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch).validate().dye_size
    return (dh, dw), (ch, cw)


# The floors microbenchmarks' default arguments (tpufluid/ops/pallas/
# floors.py): measure_taa_row_rate's (planes, n_idx, reps, trips);
# measure_roll_rate has no default shape and is taken at that of
# tests/test_floors.py:30 with its default trips; measure_sweep_rate's
# (chunks, sweeps) on its (256, 1024) field.
TAA_DEFAULT = (2, 8, 32, 8)
ROLL_DEFAULT = (2, 96, 384, 256)
SWEEP_DEFAULT = (16, 20, 256, 1024)
# Shapes that fill no block evenly, for the kernels' ragged edges. The
# gather's tile is (64, 128) in the microbenchmark, 32 blocks of 256 threads
# exactly; random_floors_cases also takes it at TAA_RAGGED_TILE, 3700 words.
TAA_RAGGED = (3, 5, 7, 3)
TAA_RAGGED_TILE = (37, 100)
ROLL_RAGGED = (3, 37, 100, 41)
SWEEP_RAGGED = (2, 3, 37, 131)


def floors_work(taa=TAA_DEFAULT, roll=ROLL_DEFAULT, sweep=SWEEP_DEFAULT,
                tile=(_floors.ROWS, _floors.LANE)) -> dict:
    """Bytes and operations of the three floors microbenchmarks, reckoned
    from their code: each input read once, each output written once, one
    operation per add, multiply or subtract (the gathers and rolls move
    data and are not counted). ``tile`` is the gather's (rows, lanes)."""
    u32 = f32 = 4
    r, lane = tile
    planes, n_idx, reps, trips = taa
    taa_bytes = u32 * (r * lane + n_idx * r * lane + planes * (r + reps) * lane + r * lane)
    taa_ops = trips * reps * n_idx * planes * r * lane           # one add per gathered word
    rp, nrk, cbw, rtrips = roll
    roll_bytes = u32 * 3 * rp * nrk * cbw                        # seed, operand, output
    roll_ops = rtrips * rp * nrk * cbw
    chunks, sweeps, h, w = sweep
    sweep_bytes = f32 * 3 * h * w                                # seed, x, output
    sweep_ops = chunks * sweeps * h * w * 5                      # 3 adds, 1 subtract, 1 multiply
    return {"floors.py:92 _taa_kernel": (taa_bytes, taa_ops),
            "floors.py:133 _roll_kernel": (roll_bytes, roll_ops),
            "floors.py:163 _sweep_kernel": (sweep_bytes, sweep_ops)}


def floors_cases(device, ragged: bool = False) -> List[Case]:
    """The three floors kernels at the microbenchmarks' default shapes (or
    at ragged ones), on the inputs measure_* builds, with their work from
    floors_work()."""
    taa, roll, sweep = ((TAA_RAGGED, ROLL_RAGGED, SWEEP_RAGGED) if ragged
                        else (TAA_DEFAULT, ROLL_DEFAULT, SWEEP_DEFAULT))
    work = list(floors_work(taa, roll, sweep).values())
    tag = ":ragged" if ragged else ""
    planes, n_idx, reps, trips = taa
    rp, nrk, cbw, rtrips = roll
    chunks, sweeps, h, w = sweep
    return [
        Case("floor_taa" + tag, "floor_taa", _floors_k.taa, _floors.taa_plain,
             (*_floors.taa_inputs(planes, n_idx, reps, device), trips, reps), *work[0]),
        Case("floor_roll" + tag, "floor_roll", _floors_k.roll, _floors.roll_plain,
             (*_floors.roll_inputs(rp, nrk, cbw, device), rtrips), *work[1]),
        Case("floor_sweep" + tag, "floor_sweep", _floors_k.sweep, _floors.sweep_plain,
             (*_floors.sweep_inputs(h, w, device), chunks, sweeps), *work[2]),
    ]


def random_floors_cases(device, ragged: bool = False, seed: int = 0) -> List[Case]:
    """The three floors kernels on inputs made by numpy from ``seed``, which
    the microbenchmarks' own do not give: random uint32 words whose sums
    wrap; gather indices that vary by row as well as by lane, on the
    (64, 128) tile or, when ``ragged``, on TAA_RAGGED_TILE, which fills no
    256-thread block evenly; and a sweep field and right-hand side that are
    not uniform, so that a wrong neighbour, edge or order of the sum shows
    (measure_sweep_rate's field stays uniform and sums exactly)."""
    rng = np.random.default_rng(seed)
    taa, roll, sweep = ((TAA_RAGGED, ROLL_RAGGED, SWEEP_RAGGED) if ragged
                        else (TAA_DEFAULT, ROLL_DEFAULT, SWEEP_DEFAULT))
    tile = TAA_RAGGED_TILE if ragged else (_floors.ROWS, _floors.LANE)
    work = list(floors_work(taa, roll, sweep, tile).values())
    tag = (":ragged" if ragged else "") + ":random"
    planes, n_idx, reps, trips = taa
    rp, nrk, cbw, rtrips = roll
    chunks, sweeps, h, w = sweep
    rows, lanes = tile

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def words(*shape):
        return t(rng.integers(0, 2 ** 32, shape, dtype=np.uint32).view(np.int32))

    idx = t(rng.integers(0, lanes, (n_idx, rows, lanes), dtype=np.int32))
    field = t(rng.random((h, w), dtype=np.float32))
    rhs = t(rng.standard_normal((h, w), dtype=np.float32))
    return [
        Case("floor_taa" + tag, "floor_taa", _floors_k.taa, _floors.taa_plain,
             (words(rows, lanes), idx, words(planes, rows + reps, lanes), trips, reps),
             *work[0]),
        Case("floor_roll" + tag, "floor_roll", _floors_k.roll, _floors.roll_plain,
             (words(rp, nrk, cbw), words(rp, nrk, cbw), rtrips), *work[1]),
        Case("floor_sweep" + tag, "floor_sweep", _floors_k.sweep, _floors.sweep_plain,
             (field, rhs, chunks, sweeps), *work[2]),
    ]


def compare(out, want) -> Tuple[float, float]:
    """(max abs error, tolerance) of a kernel's output(s) against the plain
    version's, over every output of the call; int32 outputs hold uint32
    words and must be equal."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    err = tol = 0.0
    for o, w in zip(outs, wants):
        if o.dtype != w.dtype or o.shape != w.shape:
            raise AssertionError(f"kernel output {o.dtype} {tuple(o.shape)} != "
                                 f"plain {w.dtype} {tuple(w.shape)}")
        if w.dtype == torch.int32:  # uint32 words: bit-equal, tolerance 0
            err = max(err, float((_floors._u64(o) - _floors._u64(w)).abs().max()))
            continue
        w32 = w.to(torch.float32)
        err = max(err, float((o.to(torch.float32) - w32).abs().max()))
        tol = max(tol, TOLERANCE[w.dtype] * max(float(w32.abs().max()), 1.0))
    return err, tol


def random_state(config: FluidConfig, seed: int, device) -> Tuple[FluidState, torch.Tensor]:
    """A state and a splat batch at ``config``'s sizes, made by numpy from
    ``seed``: velocity N(0, 400) clipped to +/-1000, dye U(0, 1.5), pressure
    N(0, 1); MAX_SPLATS splat rows, the last inactive."""
    rng = np.random.default_rng(seed)
    (sw, sh), (dw, dh) = config.sim_size, config.dye_size
    vel = np.clip(rng.standard_normal((2, sh, sw)) * 400, -1000, 1000)
    dye = rng.random((3, dh, dw)) * 1.5
    p = rng.standard_normal((sh, sw))
    s = np.zeros((config.MAX_SPLATS, 8))
    s[:, 0:2] = rng.random((config.MAX_SPLATS, 2))
    s[:, 2:4] = (rng.random((config.MAX_SPLATS, 2)) - 0.5) * 1000
    s[:, 4:7] = rng.random((config.MAX_SPLATS, 3)) * 1.5
    s[:-1, 7] = 1.0

    def t(a):
        return torch.tensor(a, dtype=torch.float32).to(device=device, dtype=config.dtype)

    state = FluidState(velocity=t(vel), dye=t(dye), pressure=t(p))
    return state, torch.tensor(s, dtype=torch.float32, device=device)
