"""Hold each CUDA kernel against its plain version on the same inputs.

``step_cases`` takes a state and a splat batch and lays out every kernel
call one step makes, in order, each with the inputs the step would give it
(computed by the plain versions, so the kernel and its plain version see the
very same tensors). The kernel tests and chip_smoke.py compare and time
these cases on the card.

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
from tpufluid_torch.ops.cuda import advect as _advect
from tpufluid_torch.ops.cuda import jacobi as _jacobi
from tpufluid_torch.ops.cuda import stencil as _stencil
from tpufluid_torch.ops.splat import SPLAT_B, SPLAT_DX, SPLAT_DY, SPLAT_R, splat_factors
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


def compare(out, want) -> Tuple[float, float]:
    """(max abs error, tolerance) of a kernel's output(s) against the plain
    version's, over every output of the call."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    err = tol = 0.0
    for o, w in zip(outs, wants):
        if o.dtype != w.dtype or o.shape != w.shape:
            raise AssertionError(f"kernel output {o.dtype} {tuple(o.shape)} != "
                                 f"plain {w.dtype} {tuple(w.shape)}")
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
