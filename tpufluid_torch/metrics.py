"""Run metrics: the per-run diagnostics of tpufluid/metrics.py, logged as
JSONL.

steps/s, max |v|, divergence, kinetic energy, dye mass and a velocity
checksum, each computed on the state's device with the plain stencil ops and
brought to the host in one transfer per report.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops import stencil
from tpufluid_torch.state import FluidState

# The TPU advection kernels' window constants (tpufluid/ops/pallas/advect.py
# HALO, common.py row_align): a copy, so records of both packages compare.
_TPU_HALO = 24
_TPU_SUBLANE = 8


def halo_contract_speed(config) -> float:
    """Per-AXIS velocity (texels/s) the TPU advection kernels' gather window
    covers at the dt <= 1/60 clamp: (halo - 2) * 60, with the halo rounded
    up to the storage type's row alignment (float16 taken as 4 bytes, as the
    TPU staged it through float32): 1320 in float32 and float16, 1800 in
    bfloat16. This is the TPU kernels' window contract, kept so that records
    of both packages compare: the port's gather reads global memory and
    clamps only at the grid edge, so no backtrace of the port clamps early."""
    itemsize = 2 if config.dtype == torch.bfloat16 else 4
    align = 2 * _TPU_SUBLANE if itemsize == 2 else _TPU_SUBLANE
    halo = -(-_TPU_HALO // align) * align
    return (halo - 2) * 60.0


def diagnostics(state: FluidState, config: FluidConfig) -> dict:
    """Diagnostics on the state's device -> host dict of Python floats."""
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    v = state.velocity.to(torch.float32)
    d = state.dye.to(torch.float32)
    div = stencil.divergence(v)
    # The speed the next step's gather backtraces with: the pre-advection
    # chain re-run at the dt = 1/60 clamp without splats, whose gradient
    # kick is not re-clamped (tpufluid/metrics.py:58-73).
    vb = stencil.vorticity_confinement(v, stencil.curl(v), config.CURL, 1.0 / 60.0)
    pb = stencil.jacobi_pressure(state.pressure.to(torch.float32) * config.PRESSURE,
                                 stencil.divergence(vb), config.PRESSURE_ITERATIONS)
    vb = stencil.gradient_subtract(vb, pb)
    energy = torch.sum(v * v) * 0.5
    mass = torch.sum(d)
    on_device = {
        "max_speed": torch.max(torch.sqrt(v[0] ** 2 + v[1] ** 2)),
        "max_component_speed": torch.max(torch.abs(v)),
        "backtrace_speed": torch.max(torch.abs(vb)),
        "kinetic_energy": energy,
        "energy_per_cell": energy / float(sw * sh),
        "dye_mass": mass,
        "dye_mean": mass / float(dw * dh),
        "dye_max": torch.max(d),
        "div_rms": torch.sqrt(torch.mean(div * div)),
        "div_max": torch.max(torch.abs(div)),
        "vel_checksum": torch.sum(torch.abs(v)),
        "nonfinite": torch.sum(~torch.isfinite(v)) + torch.sum(~torch.isfinite(d)),
    }
    values = torch.stack([t.to(torch.float64) for t in on_device.values()]).tolist()
    return {**dict(zip(on_device, values)),
            "halo_contract_speed": halo_contract_speed(config)}


def contract_warning(rec: dict) -> Optional[str]:
    """Warning text when a diagnostics record shows the kick-inclusive
    backtrace speed exceeding the gather-halo contract, else None: the same
    condition and leading text as tpufluid.metrics, so that records of both
    packages compare. The port's gather does not clamp at that contract
    (see halo_contract_speed), so the warning says that a TPU run of the
    same state would, not that this one did. backtrace_speed is the quantity
    the gather consumes (the pre-advection chain re-run, including the
    un-clamped gradient kick), not the stored-field proxy
    max_component_speed."""
    if rec["backtrace_speed"] > rec["halo_contract_speed"]:
        return (f"backtrace speed {rec['backtrace_speed']:.0f} texels/s "
                f"exceeds the gather-halo contract "
                f"({rec['halo_contract_speed']:.0f}); this port clamps only at "
                "the grid edge: the value is the TPU kernels' window contract, "
                "kept for comparison")
    return None


class MetricsLogger:
    """JSONL metrics stream. Each record: step index, wall time, diagnostics."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._own = False
        if stream is not None:
            self.stream = stream
        elif path is not None:
            self.stream = open(path, "a")
            self._own = True
        else:
            self.stream = None
        self.t0 = time.time()

    def log(self, step: int, state: FluidState, config: FluidConfig, **extra) -> dict:
        rec = {"step": step, "wall_s": round(time.time() - self.t0, 3)}
        rec.update(diagnostics(state, config))
        rec.update(extra)
        if self.stream is not None:
            self.stream.write(json.dumps(rec) + "\n")
            self.stream.flush()
        return rec

    def close(self):
        if self._own and self.stream is not None:
            self.stream.close()
            self.stream = None
