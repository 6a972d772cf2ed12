"""Semi-Lagrangian advection: the CUDA kernel (csrc/advect.cu) and its plain
PyTorch version.

One kernel stands for both TPU advection kernels (tpufluid/ops/pallas/
advect.py:301 and advect_hbm.py:108): same grid (velocity self-advection,
dye at the sim resolution) and dye on a finer grid than the velocity. The
optional splat bump is added to the source and rounded to storage before it
is sampled; quant="rgb9e5" then sends the (bf16, 3-channel) source through
RGB9E5; the result rounds to storage once.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops import advect as A
from tpufluid_torch.ops.cuda.build import (F, I, P, Kernel, check_factors,
                                           check_storage, ptr, stream)
from tpufluid_torch.ops.splat import splat_bump

ADVECT = Kernel("advect", "advect", "fluid_advect",
                [P, I, I, P, P, I, I, I, F, F, P, P, P, I, I, I, P],
                replaces=("tpufluid/ops/pallas/advect.py:301, "
                          "tpufluid/ops/pallas/advect_hbm.py:108"))


def _check(velocity: torch.Tensor, source: torch.Tensor, quant):
    if velocity.ndim != 3 or velocity.shape[0] != 2:
        raise ValueError(f"velocity must be (2, Hs, Ws), got {tuple(velocity.shape)}")
    if source.ndim != 3 or not 1 <= source.shape[0] <= 3:
        raise ValueError(f"source must be (C <= 3, H, W), got {tuple(source.shape)}")
    if quant not in (None, "rgb9e5"):
        raise ValueError(f"unknown quant {quant!r}")
    if quant and (source.shape[0] != 3 or source.dtype != torch.bfloat16):
        raise ValueError("rgb9e5 quantizes 3-channel bfloat16 sources only")


def advect(velocity: torch.Tensor, source: torch.Tensor, dt: float,
           dissipation: float, splat_factors=None, quant=None) -> torch.Tensor:
    """Advect ``source`` (C, H, W) through ``velocity`` (2, Hs, Ws) on the card."""
    _check(velocity, source, quant)
    code = check_storage(velocity, source)
    c, h, w = source.shape
    gy, gx, amt, s = check_factors(splat_factors, source.device, h, w, c)
    out = torch.empty_like(source)
    ADVECT(ptr(velocity), velocity.shape[1], velocity.shape[2], ptr(source), ptr(out),
           c, h, w, float(dt), float(A.decay_factor(dissipation, dt)),
           ptr(gy), ptr(gx), ptr(amt), s, 1 if quant else 0, code, stream())
    return out


def advect_plain(velocity: torch.Tensor, source: torch.Tensor, dt: float,
                 dissipation: float, splat_factors=None, quant=None) -> torch.Tensor:
    """Plain version of advect, same operations and rounding points."""
    _check(velocity, source, quant)
    if splat_factors is not None:
        source = (source.to(torch.float32) + splat_bump(*splat_factors)).to(source.dtype)
    return A.advect(velocity, source, dt, dissipation, quant=quant)
