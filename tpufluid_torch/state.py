"""FluidState — the simulation fields as a dataclass of tensors.

Layout is channels-first (C, H, W), as in the JAX package: row i is the
``v`` axis (v = (i + 0.5) / H, bottom-up), column j is ``u``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from tpufluid_torch.config import FluidConfig


@dataclasses.dataclass
class FluidState:
    """velocity: (2, H, W), channel 0 = u, 1 = v, in sim-grid texels/second.
    dye:      (3, Hd, Wd) RGB density.
    pressure: (H, W), carried across steps for the warm start."""

    velocity: torch.Tensor
    dye: torch.Tensor
    pressure: torch.Tensor

    @property
    def sim_shape(self) -> Tuple[int, int]:
        return tuple(self.velocity.shape[-2:])

    @property
    def dye_shape(self) -> Tuple[int, int]:
        return tuple(self.dye.shape[-2:])


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist — the entry
    points never drop to the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return device


def device_from_env() -> torch.device:
    """The command-line entry points' device: the GPU, or the CPU where the
    environment sets TPUFLUID_DEVICE=cpu (the JAX CLI's own switch). No
    other path leads to the CPU."""
    if os.environ.get("TPUFLUID_DEVICE", "").lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set TPUFLUID_DEVICE=cpu to "
                           "run the plain versions on the CPU")
    return torch.device("cuda")


def init_state(config: FluidConfig, device="cuda") -> FluidState:
    """Zeroed fields per config (reference initFramebuffers)."""
    device = resolve_device(device)
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    dt = config.dtype
    return FluidState(
        velocity=torch.zeros((2, sh, sw), dtype=dt, device=device),
        dye=torch.zeros((3, dh, dw), dtype=dt, device=device),
        pressure=torch.zeros((sh, sw), dtype=dt, device=device),
    )


def resize_state(state: FluidState, config: FluidConfig) -> FluidState:
    """Resample a running state into the sizes of ``config``: velocity and
    dye resample bilinearly, pressure restarts at zero (the reference
    re-creates its pressure buffer on resize)."""
    from tpufluid_torch.ops.sampling import resample_bilinear

    sw, sh = config.sim_size
    dw, dh = config.dye_size
    dt = config.dtype

    def maybe(field, h, w):
        if tuple(field.shape[-2:]) == (h, w):
            return field.to(dt)
        return resample_bilinear(field.to(torch.float32), (h, w)).to(dt)

    return FluidState(
        velocity=maybe(state.velocity, sh, sw),
        dye=maybe(state.dye, dh, dw),
        pressure=torch.zeros((sh, sw), dtype=dt, device=state.pressure.device),
    )


def state_bytes(state: FluidState) -> int:
    """Bytes the fields hold on their device."""
    return sum(t.numel() * t.element_size()
               for t in (state.velocity, state.dye, state.pressure))
