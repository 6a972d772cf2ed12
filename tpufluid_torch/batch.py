"""Batched serving mode: B independent sims advanced, and rendered, by one
set of launches.

Counterpart of the single-device half of tpufluid/batch.py (lines 50-165).
There ``jax.vmap`` over ``pallas_call`` adds a leading grid dimension to
each TPU kernel and dt becomes a (B, 1, 1) operand. Here every step kernel
takes the batch itself (the grid's z axis is the sim) and dt in one of two
forms: a number, every sim's (lock-step), or a table of each sim's clamped
dt and decay, computed on the host in float32 (step.dt_table) and copied to
the card once a call. A batched step makes the launches of one single-sim
step (6 at 20 Jacobi sweeps) and one set of splat factor ops, whatever B is.

Every field leads with the batch axis: velocity (B, 2, H, W), dye (B, 3,
Hd, Wd), pressure (B, H, W), splats (B, MAX_SPLATS, 8). Each sim of a
batched step equals the single-sim step on that sim, with its dt and its
splats, bit for bit: the kernels run each sim's operations unchanged, and
the plain versions run a CPU batch sim by sim.

A batched frame (``make_batched_render``) is one bloom pyramid launch and
one display launch for the B sims, with the sunrays' PyTorch ops run once
on the whole batch and one dither tile for every sim, as the JAX vmap
broadcasts it; each sim's frame equals render_frame on that sim, bit for
bit.

Left out: the mesh functions (tpufluid/batch.py:168-339).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.render import plain_render, render_frame
from tpufluid_torch.state import FluidState, init_state, resolve_device
from tpufluid_torch.step import _step, clamp_dt, dt_table

_FIELDS = ("velocity", "dye", "pressure")


def init_batch(config: FluidConfig, batch: int, device="cuda") -> FluidState:
    """Zeroed batched state: every field gains a leading (batch,) axis."""
    one = init_state(config, device=device)
    return FluidState(*(torch.zeros((batch,) + tuple(getattr(one, f).shape),
                                    dtype=config.dtype, device=one.velocity.device)
                        for f in _FIELDS))


def stack_states(states: Sequence[FluidState]) -> FluidState:
    """Stack per-sim states into one batched state (leading batch axis)."""
    return FluidState(*(torch.stack([getattr(s, f) for s in states]) for f in _FIELDS))


def unstack_state(batched: FluidState, i: int) -> FluidState:
    """Sim ``i`` of a batched state (views of its fields)."""
    return FluidState(*(getattr(batched, f)[i] for f in _FIELDS))


def _host(dt) -> np.ndarray:
    if isinstance(dt, torch.Tensor):
        dt = dt.detach().cpu().numpy()
    return np.asarray(dt, np.float32)


def _table(dts: np.ndarray, config: FluidConfig, device) -> torch.Tensor:
    """dt_table of the velocity's and the dye's dissipation on ``device``:
    (..., 2, B, 2), one copy."""
    table = dt_table(dts, (config.VELOCITY_DISSIPATION, config.DENSITY_DISSIPATION))
    return torch.from_numpy(table).to(device)


def step_dt(dt, batch: int, config: FluidConfig, device):
    """The dt a batched step passes its kernels: a number (lock-step) as
    clamp_dt gives it, with no copy to the card; a (batch,) array as its
    (2, batch, 2) table on ``device``."""
    a = _host(dt)
    if a.ndim == 0:
        return clamp_dt(a)
    if a.shape != (batch,):
        raise ValueError(f"dt of shape {a.shape}: a batched step takes a scalar or one dt "
                         f"a sim, ({batch},)")
    return _table(a, config, device)


def _require_batch(state: FluidState, device: torch.device) -> int:
    if state.velocity.device.type != device.type:
        raise ValueError(f"state on {state.velocity.device}, made for {device}")
    if state.velocity.ndim != 4 or state.dye.ndim != 4:
        raise ValueError(f"a batched step or frame takes a batched state (B, 2, H, W), got "
                         f"velocity {tuple(state.velocity.shape)}")
    return state.velocity.shape[0]


def plain_batched_step(state: FluidState, dt, splats, config: FluidConfig) -> FluidState:
    """A batched step through the kernels' plain versions on any device, sim
    by sim: the reference the batched kernels are held to on the card."""
    b = state.velocity.shape[0]
    return _step(state, step_dt(dt, b, config, state.velocity.device), splats, config,
                 dispatch.PLAIN)


def make_batched_step(config: FluidConfig, device="cuda"):
    """step(batched_state, dt, splats) -> batched_state on ``device``
    (default the GPU): the kernels on the card, their plain versions on the
    CPU. ``splats`` is (B, MAX_SPLATS, 8); ``dt`` a scalar (lock-step) or
    (B,) per sim."""
    device = resolve_device(device)

    def step(state: FluidState, dt, splats) -> FluidState:
        b = _require_batch(state, device)
        return _step(state, step_dt(dt, b, config, state.velocity.device), splats, config,
                     dispatch.ROUTED)

    return step


def make_batched_multi_step(config: FluidConfig, device="cuda"):
    """multi(batched_state, dt, splats_seq) -> batched_state: T batched
    steps in a Python loop. ``splats_seq`` is (T, B, MAX_SPLATS, 8); ``dt``
    a scalar or (T,) (lock-step across sims) or (T, B) per sim. The splats
    and a per-sim dt table go to the card once a call."""
    device = resolve_device(device)

    def multi(state: FluidState, dt, splats_seq) -> FluidState:
        b = _require_batch(state, device)
        seq = torch.as_tensor(splats_seq, dtype=torch.float32, device=state.velocity.device)
        t = seq.shape[0]
        if seq.ndim != 4 or seq.shape[1] != b:
            raise ValueError(f"splats_seq {tuple(seq.shape)}, expected ({t}, {b}, S, 8)")
        a = _host(dt)
        # A 1-D dt is per time step, never per sim: a (B,) dt here raises
        # rather than being read as a time sequence (tpufluid/batch.py:109).
        if a.ndim == 1 and a.shape[0] not in (1, t):
            raise ValueError(f"1-D dt has length {a.shape[0]} but there are {t} steps; "
                             f"per-sim dts for multi-step must be (T, B) = ({t}, {b})")
        if a.ndim == 2:
            if a.shape != (t, b):
                raise ValueError(f"per-sim dt of shape {a.shape}, expected ({t}, {b})")
            dts = _table(a, config, state.velocity.device)
        elif a.ndim <= 1:
            dts = [clamp_dt(x) for x in np.broadcast_to(a.reshape(-1), (t,))]
        else:
            raise ValueError(f"dt of shape {a.shape}: a scalar, (T,) or (T, B)")
        for k in range(t):
            state = _step(state, dts[k], seq[k], config, dispatch.ROUTED)
        return state

    return multi


# A batched frame through the kernels' plain versions on any device, sim by
# sim: the reference the batched render kernels are held to on the card.
# plain_render takes a batched state as it is.
plain_batched_render = plain_render


def make_batched_render(config: FluidConfig, out_hw: Optional[Tuple[int, int]] = None,
                        to_screen: bool = True, device="cuda"):
    """render(batched_state, dither=None) -> (B, 4, h, w) float32 frames on
    ``device`` (default the GPU): one bloom and one display launch for the
    B sims on the card, their plain versions on the CPU. ``dither`` is one
    (h, w) tile shared by every sim (tpufluid/batch.py:150-151)."""
    device = resolve_device(device)

    def render(state: FluidState, dither: Optional[torch.Tensor] = None) -> torch.Tensor:
        _require_batch(state, device)
        return render_frame(state, config, out_hw, to_screen, dither)

    return render
