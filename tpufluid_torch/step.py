"""The simulation step — the reference's ``step(dt)`` with its inputs.

Pass order, that of tpufluid/step.py's kernel path: splat bump + curl +
vorticity confinement + divergence -> Jacobi x N with the warm start fused
into the first sweep and the gradient subtract into the last launch
(jacobi_project) -> velocity self-advection -> dye advection with the dye
splat bump fused into the gather: five launches a step at 20 sweeps.

Nothing is updated in place: every pass writes fresh tensors from PyTorch's
caching allocator, which hands the previous step's buffers back once the
caller drops them, and the state passed in stays valid.

The same step body runs one sim or a batch of B independent sims
(tpufluid_torch/batch.py): one set of splat factor ops for the batch, then
the same passes, each kernel launched once for all B sims. A batch's
dt is a number (lock-step, like a single sim's, with no copy to the card)
or a table of each sim's clamped dt and decay, computed on the host in
float32 (``dt_table``) and copied once. So does a lane-packed fleet
(tpufluid_torch/batch_packed.py): its fields (C, H, B*W) through the packed
passes (dispatch.packed), its splat factors per sim as a batch's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufluid_torch.config import MAX_DT, FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.ops.splat import (SPLAT_B, SPLAT_DX, SPLAT_DY, SPLAT_R,
                                      apply_splat_batch, splat_factors)
from tpufluid_torch.spans import span
from tpufluid_torch.state import FluidState, resolve_device


def clamp_dt(dt) -> float:
    """min(float32(dt), float32(MAX_DT)), the reference's dt clamp at its
    literal 0.016666, as a Python float holding a float32 value."""
    return float(np.minimum(np.float32(float(dt)), np.float32(MAX_DT)))


def dt_table(dt, dissipations) -> np.ndarray:
    """(..., len(dissipations), B, 2) float32 of per-sim dts (..., B): for
    each dissipation k, every sim's (clamped dt, decay 1 + k * dt), computed
    in numpy float32 exactly as clamp_dt and ops/advect.decay_factor compute
    them for one sim, so a kernel reading the table never recomputes them."""
    d = np.minimum(np.asarray(dt, np.float32), np.float32(MAX_DT))
    cols = [np.stack([d, np.float32(1.0) + np.float32(k) * d], axis=-1) for k in dissipations]
    return np.ascontiguousarray(np.stack(cols, axis=-3))


def _step(state: FluidState, dt, splats, config: FluidConfig,
          passes: dispatch.Passes) -> FluidState:
    """One step of one sim or a batch. ``dt``: every sim's clamped dt (a
    number), or a (2, B, 2) table on the state's device (dt_table of the
    velocity's and the dye's dissipation)."""
    with span("step"):
        vel_dt, dye_dt = (dt[0], dt[1]) if isinstance(dt, torch.Tensor) else (dt, dt)
        with span("upload"):
            splats = torch.as_tensor(splats, dtype=torch.float32, device=state.velocity.device)
        # bf16 dye goes through RGB9E5 before it is sampled (config.DYE_RGB9E5).
        dye_quant = ("rgb9e5" if config.DYE_RGB9E5 and config.dtype == torch.bfloat16
                     else None)
        radius, aspect = config.splat_radius_uv(), config.aspect_ratio
        dh, dw = passes.grid(state.dye)
        vh, vw = passes.grid(state.velocity)
        with span("splat_factors"):
            dye_factors = splat_factors(splats, dh, dw, radius, aspect,
                                        slice(SPLAT_R, SPLAT_B + 1))
            vel_factors = splat_factors(splats, vh, vw, radius, aspect,
                                        slice(SPLAT_DX, SPLAT_DY + 1))

        with span("pre_pressure"):
            vel, div = passes.pre_pressure(state.velocity, config.CURL, vel_dt,
                                           splat_factors=vel_factors)
        # The projected velocity goes through storage before the advection reads it.
        with span("projection"):
            pressure, vel = passes.jacobi_project(state.pressure, div, vel,
                                                  config.PRESSURE_ITERATIONS,
                                                  prescale=config.PRESSURE)
        with span("velocity_advection"):
            vel = passes.advect(vel, vel, vel_dt, config.VELOCITY_DISSIPATION)
        with span("dye_advection"):
            dye = passes.advect(vel, state.dye, dye_dt, config.DENSITY_DISSIPATION,
                                splat_factors=dye_factors, quant=dye_quant)
        return FluidState(velocity=vel, dye=dye, pressure=pressure)


def apply_splats(state: FluidState, splats, config: FluidConfig) -> FluidState:
    """Inject a (MAX_SPLATS, 8) batch of impulses into the velocity and the
    dye (the reference's splat()), as PyTorch ops on the state's device; the
    pressure is kept. The step fuses the same bumps into its kernels."""
    splats = torch.as_tensor(splats, dtype=torch.float32, device=state.velocity.device)
    velocity, dye = apply_splat_batch(state.velocity, state.dye, splats,
                                      radius=config.splat_radius_uv(),
                                      aspect=config.aspect_ratio)
    return FluidState(velocity=velocity, dye=dye, pressure=state.pressure)


def fluid_step(state: FluidState, dt, splats, config: FluidConfig) -> FluidState:
    """One simulation step. ``dt`` in seconds (a number), ``splats`` a
    (MAX_SPLATS, 8) event batch (rows with active = 0 are no-ops). Runs the
    CUDA kernels on a CUDA state, their plain versions on a CPU state."""
    return _step(state, clamp_dt(dt), splats, config, dispatch.ROUTED)


def plain_step(state: FluidState, dt, splats, config: FluidConfig) -> FluidState:
    """fluid_step through the kernels' plain versions on any device: the
    reference the kernel step is held to on the card."""
    return _step(state, clamp_dt(dt), splats, config, dispatch.PLAIN)


def _require(state: FluidState, device: torch.device) -> None:
    if state.velocity.device.type != device.type:
        raise ValueError(f"state on {state.velocity.device}, step made for {device}")


def make_step(config: FluidConfig, device="cuda"):
    """step(state, dt, splats) -> state on ``device`` (default the GPU)."""
    device = resolve_device(device)

    def step(state: FluidState, dt, splats) -> FluidState:
        _require(state, device)
        return fluid_step(state, dt, splats, config)

    return step


def make_multi_step(config: FluidConfig, device="cuda"):
    """multi_step(state, dt, splats_seq) -> state: T steps in a Python loop.

    ``splats_seq`` has shape (T, MAX_SPLATS, 8), one event batch per step;
    it is copied to the device once. ``dt`` is a scalar (constant rate) or a
    (T,) per-step array (Trace v2).
    """
    device = resolve_device(device)

    def multi(state: FluidState, dt, splats_seq) -> FluidState:
        _require(state, device)
        with span("multi_step"):
            with span("upload"):
                seq = torch.as_tensor(splats_seq, dtype=torch.float32,
                                      device=state.velocity.device)
            t = seq.shape[0]
            dts = np.broadcast_to(np.asarray(dt, np.float32).reshape(-1), (t,))
            for k in range(t):
                state = fluid_step(state, dts[k], seq[k], config)
            return state

    return multi
