"""Hold each CUDA kernel against its plain version on the same inputs.

``step_cases`` takes a state and a splat batch and lays out every kernel
call one step makes, in order, each with the inputs the step would give it
(computed by the plain versions, so the kernel and its plain version see the
very same tensors); ``render_cases`` does the same for one frame, and
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
from typing import Callable, List, Tuple

import numpy as np
import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops import bloom as _bloom_ops
from tpufluid_torch.ops import floors as _floors
from tpufluid_torch.ops.cuda import advect as _advect
from tpufluid_torch.ops.cuda import bloom as _bloom
from tpufluid_torch.ops.cuda import display as _display
from tpufluid_torch.ops.cuda import floors as _floors_k
from tpufluid_torch.ops.cuda import jacobi as _jacobi
from tpufluid_torch.ops.cuda import stencil as _stencil
from tpufluid_torch.ops.sampling import resample_bilinear
from tpufluid_torch.ops.splat import SPLAT_B, SPLAT_DX, SPLAT_DY, SPLAT_R, splat_factors
from tpufluid_torch.ops.sunrays import apply_sunrays
from tpufluid_torch.render import blue_noise
from tpufluid_torch.state import FluidState
from tpufluid_torch.step import clamp_dt

TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


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


def step_cases(state: FluidState, splats: torch.Tensor, config: FluidConfig,
               dt: float = 1.0 / 60.0) -> List[Case]:
    """Every kernel call of one step from ``state``, in the step's order."""
    dt = clamp_dt(dt)
    dtype = state.velocity.dtype
    quant = "rgb9e5" if config.DYE_RGB9E5 and dtype == torch.bfloat16 else None
    radius, aspect = config.splat_radius_uv(), config.aspect_ratio
    (vh, vw), (dh, dw) = state.velocity.shape[-2:], state.dye.shape[-2:]
    splats = splats.to(device=state.velocity.device, dtype=torch.float32)
    vf = splat_factors(splats, vh, vw, radius, aspect, slice(SPLAT_DX, SPLAT_DY + 1))
    df = splat_factors(splats, dh, dw, radius, aspect, slice(SPLAT_R, SPLAT_B + 1))
    n_active = int((splats[:, 7] != 0).sum())
    sim, dye = vh * vw, dh * dw
    iters = config.PRESSURE_ITERATIONS

    vel_b, curl = _stencil.splat_curl_plain(state.velocity, vf)
    vel1, div = _stencil.confine_divergence_plain(vel_b, curl, config.CURL, dt)
    pressure = _jacobi.jacobi_plain(state.pressure, div, iters, config.PRESSURE)
    vel2 = _stencil.gradient_subtract_plain(vel1, pressure)
    vel3 = _advect.advect_plain(vel2, vel2, dt, config.VELOCITY_DISSIPATION)
    dye_out = _advect.advect_plain(vel3, state.dye, dt, config.DENSITY_DISSIPATION, df, quant)
    return [
        Case("splat_curl", "splat_curl", _stencil.splat_curl, _stencil.splat_curl_plain,
             (state.velocity, vf), _bytes(state.velocity, *vf, vel_b, curl),
             sim * (2 * 2 * n_active + 6)),
        Case("confine_divergence", "confine_divergence", _stencil.confine_divergence,
             _stencil.confine_divergence_plain, (vel_b, curl, config.CURL, dt),
             _bytes(vel_b, curl, vel1, div), sim * 30),
        Case("jacobi", "jacobi_sweep", _jacobi.jacobi_pressure, _jacobi.jacobi_plain,
             (state.pressure, div, iters, config.PRESSURE),
             _bytes(state.pressure, div, pressure), sim * 6 * iters),
        Case("gradient_subtract", "gradient_subtract", _stencil.gradient_subtract,
             _stencil.gradient_subtract_plain, (vel1, pressure),
             _bytes(vel1, pressure, vel2), sim * 4),
        Case("advect:velocity", "advect", _advect.advect, _advect.advect_plain,
             (vel2, vel2, dt, config.VELOCITY_DISSIPATION), _bytes(vel2, vel3),
             sim * (20 + 2 * 8)),
        Case("advect:dye", "advect", _advect.advect, _advect.advect_plain,
             (vel3, state.dye, dt, config.DENSITY_DISSIPATION, df, quant),
             _bytes(vel3, state.dye, *df, dye_out),
             dye * (34 + 3 * (8 + 2 * n_active) + (40 if quant else 0))),
    ]


# Float32 operations of the render kernels' arithmetic, counted from
# csrc/common.cuh: one axis coordinate (axis_tap) 8, one bilinear tap of one
# channel 12 (three lerps of 4), the soft knee 13 per source texel.
_AXIS, _TAP, _KNEE = 8, 12, 13


def _blur4_flops(out_hw, prefilter_texels: int) -> int:
    """One bloom stage: 6 axis coordinates per texel; per channel 4 taps,
    their sum, x 0.25 and the dst add or intensity scale."""
    oh, ow = out_hw
    return oh * ow * (6 * _AXIS + 3 * (4 * _TAP + 5)) + _KNEE * prefilter_texels


def _display_flops(out_hw, c: int, shading: bool, bloom: bool, rays: bool, noise: bool,
                   compose: bool) -> int:
    """One display pass: the dye taps (5 with shading, with the channel
    norms and the diffuse term), then bloom, sunrays, dither, gamma and
    alpha where present."""
    oh, ow = out_hw
    n = 2 * _AXIS + c * _TAP
    if shading:
        n += 4 * _AXIS + 4 * c * _TAP + 4 * (2 * c) + 13 + c
    if compose:
        n += c                                        # alpha
        if bloom:
            n += 2 * _AXIS + 3 * _TAP + 3 * 5 + 3     # sample, gamma, add
        if rays:
            n += 2 * _AXIS + _TAP + c + (3 if bloom else 0)
        if noise:
            n += 2 * _AXIS + _TAP + 3 + 3
    return oh * ow * n


def render_cases(state: FluidState, config: FluidConfig, out_hw=None, dither: bool = True,
                 compose: bool = True) -> List[Case]:
    """Every kernel call of one frame from ``state`` at ``out_hw`` (default
    the canvas), in the render's order: the bloom chain's stages, then the
    display. ``dither=False`` leaves the dither out of the display and
    ``compose=False`` makes it the shaded center alone: neither is what
    render_frame calls, both are what the display kernel takes."""
    out_hw = tuple(out_hw or (config.CANVAS_HEIGHT, config.CANVAS_WIDTH))
    dye = state.dye.to(torch.float32)
    cases: List[Case] = []

    def stage(src, hw, dst=None, prefilter=None, scale=None):
        cases.append(Case(
            f"bloom_blur4:{len(cases)}", "bloom_blur4", _bloom.blur4_stage,
            _bloom.blur4_stage_plain, (src, hw, dst, prefilter, scale),
            _bytes(src, dst) + 4 * 3 * hw[0] * hw[1],
            _blur4_flops(hw, src[0].numel() if prefilter else 0)))
        return _bloom.blur4_stage_plain(src, hw, dst, prefilter, scale)

    bloom = rays = noise = None
    if config.BLOOM:
        bw, bh = config.bloom_size
        mips = config.bloom_mip_sizes()
        if len(mips) < 2:
            bloom = torch.zeros((3, bh, bw), dtype=torch.float32, device=dye.device)
        else:
            bloom = _bloom_ops.pyramid(stage, resample_bilinear(dye, (bh, bw)), mips,
                                       config.BLOOM_THRESHOLD, config.BLOOM_SOFT_KNEE,
                                       config.BLOOM_INTENSITY)
        if dither:
            noise = blue_noise(dye.device)
    if config.SUNRAYS:
        sw, sh = config.sunrays_size
        rays = apply_sunrays(dye, (sh, sw), config.SUNRAYS_WEIGHT)
    if not compose:
        bloom = rays = noise = None
    c = state.dye.shape[0]
    n_out = (c + 1 if compose else c) * out_hw[0] * out_hw[1]
    cases.append(Case(
        "display" if compose else "display:base", "display", _display.display,
        _display.display_plain,
        (state.dye, out_hw, config.SHADING, bloom, rays, noise, compose),
        _bytes(state.dye, bloom, rays, noise) + 4 * n_out,
        _display_flops(out_hw, c, config.SHADING, bloom is not None, rays is not None,
                       noise is not None, compose)))
    return cases


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
