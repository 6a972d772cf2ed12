"""Jacobi pressure solve: the CUDA sweep kernel (csrc/jacobi.cu) and its
plain PyTorch version.

Counterpart of tpufluid/ops/pallas/jacobi.py:139. The warm start
(p *= PRESSURE) is applied at the first sweep's load and not rounded on its
own; the sweeps run in float32 and the result rounds to storage once, after
the last sweep.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops import stencil as S
from tpufluid_torch.ops.cuda.build import F, I, P, Kernel, check_storage, ptr, stream

JACOBI_SWEEP = Kernel("jacobi_sweep", "jacobi", "fluid_jacobi_sweep",
                      [P, I, P, P, I, F, I, I, I, P],
                      replaces="tpufluid/ops/pallas/jacobi.py:139")


def _warm_start_only(pressure: torch.Tensor, prescale: float) -> torch.Tensor:
    return (pressure.to(torch.float32) * prescale).to(pressure.dtype)


def jacobi_pressure(pressure: torch.Tensor, div: torch.Tensor, iterations: int,
                    prescale: float = 1.0) -> torch.Tensor:
    """``iterations`` sweeps on the card, one launch each, ping-ponging two
    float32 buffers between the stored input and the stored result."""
    if pressure.ndim != 2 or pressure.shape != div.shape:
        raise ValueError(f"pressure {tuple(pressure.shape)} / div {tuple(div.shape)}")
    code = check_storage(pressure, div)
    if iterations == 0:
        return _warm_start_only(pressure, prescale)
    h, w = pressure.shape
    out = torch.empty_like(pressure)
    bufs = [torch.empty((h, w), dtype=torch.float32, device=pressure.device)
            for _ in range(min(iterations - 1, 2))]
    src, src_f32, scale = pressure, 0, float(prescale)
    for k in range(iterations):
        last = k == iterations - 1
        dst = out if last else bufs[k % 2]
        JACOBI_SWEEP(ptr(src), src_f32, ptr(div), ptr(dst), 0 if last else 1,
                     scale, h, w, code, stream())
        src, src_f32, scale = dst, 1, 1.0
    return out


def jacobi_plain(pressure: torch.Tensor, div: torch.Tensor, iterations: int,
                 prescale: float = 1.0) -> torch.Tensor:
    """Plain version of jacobi_pressure, same operations and rounding."""
    if iterations == 0:
        return _warm_start_only(pressure, prescale)
    p = pressure.to(torch.float32) * prescale
    return S.jacobi_pressure(p, div.to(torch.float32), iterations).to(pressure.dtype)
