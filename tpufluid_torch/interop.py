"""Carry a configuration and a state across from the JAX package.

The simulator has no weights: what makes two runs comparable is the config
and the fields. Both cross as plain data — a dict (``dataclasses.asdict`` of
a ``tpufluid`` config) and numpy arrays — so this module needs nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tpufluid_torch.config import _DTYPES, FluidConfig
from tpufluid_torch.state import FluidState, resolve_device


def config_from_dict(d: Dict) -> FluidConfig:
    """FluidConfig from ``dataclasses.asdict`` of either package's config;
    an unknown field raises."""
    d = dict(d)
    d["BACK_COLOR"] = tuple(d.get("BACK_COLOR", (0, 0, 0)))
    return FluidConfig(**d).validate()


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # numpy has no bfloat16: arrays in it (the ml_dtypes type JAX hands out)
    # go through float32, which holds every bf16 and f16 value exactly.
    dtype = _DTYPES.get(np.asarray(a).dtype.name, torch.float32)
    return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)


def state_from_numpy(velocity, dye, pressure, device="cuda") -> FluidState:
    """FluidState on ``device`` from numpy fields (2, H, W), (3, Hd, Wd),
    (H, W), or a batch of them with a leading B (tpufluid.batch's layout);
    a lane-packed fleet's (C, H, B*W) fields (tpufluid.batch_packed) cross
    as one sim's do, and batch_packed.unpack_state splits them. The storage
    dtype follows the arrays' (float32, bfloat16 or float16; anything else
    is stored as float32)."""
    device = resolve_device(device)
    v, d, p = (np.asarray(a) for a in (velocity, dye, pressure))
    lead = v.shape[:-3]
    if v.ndim not in (3, 4) or v.shape[-3] != 2 or d.shape[:-3] != lead \
            or p.shape[:-2] != lead or d.ndim != v.ndim:
        raise ValueError(f"fields {v.shape}, {d.shape}, {p.shape}: expected (2, H, W), "
                         "(C, Hd, Wd), (H, W), each with the same leading B or none")
    return FluidState(velocity=_tensor(v, device), dye=_tensor(d, device),
                      pressure=_tensor(p, device))


def state_to_numpy(state: FluidState) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(velocity, dye, pressure) as float32 numpy arrays (exact for every
    storage dtype), one sim's or a batch's."""
    return tuple(t.detach().to(device="cpu", dtype=torch.float32).numpy()
                 for t in (state.velocity, state.dye, state.pressure))
