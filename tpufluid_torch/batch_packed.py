"""Lane-packed fleet: B independent sims side by side along the rows.

Counterpart of tpufluid/batch_packed.py. There the packed layout exists for
the TPU's 128-wide lanes: a small sim pads its width in storage and compute,
and one ``(C, H, B*W)`` array divides the lanes exactly. The H100 pads
nothing, so the port keeps the layout and its semantics, not its reason:
every field of a packed state is ``(C, H, B*W)`` (packed column b*W + j is
sim b's column j), and each of the step's kernels reads and writes that
layout in place, one launch for the fleet, each sim with its own walls
(ops/cuda/dispatch.py ``packed``; the TPU kernels' ``sim_w`` walls). The
step body is the batched step's (step._step): one set of splat factor ops
for the fleet, both splat bumps fused into pre_pressure and the dye's
advect_dye, 5 launches at 20 sweeps whatever B is. JAX pre-applies the
bumps with an einsum (tpufluid/batch_packed.py:115-167) and rounds them to
storage where the fused bumps do, so the port computes what it computes
without the einsum.

Each packed sim equals the batched step's sim (and so make_step on it
alone) bit for bit: the kernels run a batched sim's operations at the
packed strides, and a CPU fleet runs the plain versions as a batch.

Restrictions, JAX's: dt is lock-step, one clock for the fleet (a per-sim dt
raises: it is the batched mode's job, tpufluid_torch/batch.py); the packed
kernels need sim grid == dye grid and a float32 or bfloat16 state
(``packed_supported``). Other geometry (the demo's cross grid, float16)
steps as JAX's does off its kernels: unpack, the batched step, pack; on a
CUDA state that is the batched kernels, never the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufluid_torch.batch import _host, init_batch
from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.ops.cuda.build import MAX_BATCH, pack_fleet, unpack_fleet
from tpufluid_torch.state import FluidState, resolve_device
from tpufluid_torch.step import _step, clamp_dt

__all__ = ["pack_fleet", "unpack_fleet", "pack_state", "unpack_state", "init_packed",
           "packed_supported", "packed_fluid_step", "plain_packed_step", "make_packed_step",
           "make_packed_multi_step"]

_FIELDS = ("velocity", "dye", "pressure")


def pack_state(batched: FluidState) -> FluidState:
    """Batched state (leading B axis, tpufluid_torch/batch.py) -> packed."""
    return FluidState(*(pack_fleet(getattr(batched, f)) for f in _FIELDS))


def unpack_state(packed: FluidState, batch: int) -> FluidState:
    """Packed state -> batched state of ``batch`` sims."""
    return FluidState(*(unpack_fleet(getattr(packed, f), batch) for f in _FIELDS))


def init_packed(config: FluidConfig, batch: int, device="cuda") -> FluidState:
    """Zeroed packed fleet state: every field (C, H, batch * W)."""
    return pack_state(init_batch(config, batch, device=device))


def packed_supported(config: FluidConfig, batch: int) -> bool:
    """True when the packed kernels step this (config, batch): sim grid ==
    dye grid and a float32 or bfloat16 state, JAX's rules
    (tpufluid/batch_packed.py:84-111) without its TPU tiling ones (the
    packed width a multiple of 128 lanes, rows of the tile's alignment,
    no padding): the port's kernels take any shape."""
    return (tuple(config.sim_size) == tuple(config.dye_size)
            and config.dtype in (torch.float32, torch.bfloat16)
            and 1 <= batch <= MAX_BATCH)


def _lockstep_dt(dt) -> float:
    a = _host(dt)
    if a.ndim != 0:
        raise ValueError(f"dt of shape {a.shape}: a packed fleet steps on one clock; per-sim "
                         "dt is the batched mode's job (make_batched_step)")
    return clamp_dt(a)


def _packed_step(state: FluidState, dt: float, splats, config: FluidConfig, batch: int,
                 plain: bool) -> FluidState:
    """One step of a packed fleet at the clamped ``dt``: the packed passes
    where packed_supported, else unpack, the batched step, pack."""
    if packed_supported(config, batch):
        return _step(state, dt, splats, config, dispatch.packed(config.sim_size[0], plain))
    passes = dispatch.PLAIN if plain else dispatch.ROUTED
    return pack_state(_step(unpack_state(state, batch), dt, splats, config, passes))


def packed_fluid_step(state: FluidState, dt, splats, config: FluidConfig,
                      batch: int) -> FluidState:
    """One lock-step fleet step of a packed state (C, H, batch * W);
    ``splats`` is (batch, MAX_SPLATS, 8), ``dt`` a number. The kernels on a
    CUDA state, their plain versions on a CPU state."""
    return _packed_step(state, _lockstep_dt(dt), splats, config, batch, plain=False)


def plain_packed_step(state: FluidState, dt, splats, config: FluidConfig,
                      batch: int) -> FluidState:
    """packed_fluid_step through the kernels' plain versions on any device:
    the reference the packed kernels are held to on the card."""
    return _packed_step(state, _lockstep_dt(dt), splats, config, batch, plain=True)


def _require_packed(state: FluidState, config: FluidConfig, batch: int,
                    device: torch.device) -> None:
    if state.velocity.device.type != device.type:
        raise ValueError(f"state on {state.velocity.device}, made for {device}")
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    want = ((2, sh, batch * sw), (3, dh, batch * dw), (sh, batch * sw))
    got = tuple(tuple(getattr(state, f).shape) for f in _FIELDS)
    if got != want:
        raise ValueError(f"a packed fleet of {batch} sims is {want}, got {got}")


def make_packed_step(config: FluidConfig, batch: int, device="cuda"):
    """step(packed_state, dt, splats) -> packed_state on ``device`` (default
    the GPU); ``splats`` (batch, MAX_SPLATS, 8), ``dt`` a number."""
    device = resolve_device(device)

    def step(state: FluidState, dt, splats) -> FluidState:
        _require_packed(state, config, batch, device)
        return packed_fluid_step(state, dt, splats, config, batch)

    return step


def make_packed_multi_step(config: FluidConfig, batch: int, device="cuda"):
    """multi(packed_state, dt, splats_seq) -> packed_state: T lock-step
    fleet steps in a Python loop. ``splats_seq`` is (T, batch, MAX_SPLATS,
    8), copied to the device once a call; ``dt`` a scalar or (T,)."""
    device = resolve_device(device)

    def multi(state: FluidState, dt, splats_seq) -> FluidState:
        _require_packed(state, config, batch, device)
        seq = torch.as_tensor(splats_seq, dtype=torch.float32, device=state.velocity.device)
        if seq.ndim != 4 or seq.shape[1] != batch:
            raise ValueError(f"splats_seq {tuple(seq.shape)}, expected (T, {batch}, S, 8): one "
                             "event batch a sim a step")
        t = seq.shape[0]
        a = _host(dt)
        if a.ndim > 1 or (a.ndim == 1 and a.shape[0] not in (1, t)):
            raise ValueError(f"dt of shape {a.shape}: a packed fleet takes a scalar or one dt "
                             f"a step, ({t},); per-sim dt is the batched mode's job")
        for k, d in enumerate(np.broadcast_to(a.reshape(-1), (t,))):
            state = _packed_step(state, clamp_dt(d), seq[k], config, batch, plain=False)
        return state

    return multi
