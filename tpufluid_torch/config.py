"""FluidConfig — every tunable of the simulator, as a frozen dataclass.

Field names and defaults are those of ``tpufluid.config.FluidConfig`` so that
``dataclasses.asdict`` of a JAX config builds the same config here
(``tpufluid_torch.interop.config_from_dict``). ``USE_PALLAS`` selects
TPU-only machinery and is kept for that reason alone: on a CUDA tensor the
step always runs the CUDA kernels, on a CPU tensor their plain PyTorch
versions. ``OVERLAP_HALO`` is read by the sharded step (``overlap_halo``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Storage dtypes. The simulator's reference stores fields as half-float
# textures; float32 exceeds that fidelity and is the default, bfloat16 and
# float16 are the 16-bit storage modes. Math always runs in float32.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# dt ceiling: the LITERAL 0.016666 of the reference's calcDeltaTime, not
# 1/60 = 0.01666667. At 60 fps the clamp always binds, so every frame steps
# at exactly this value.
MAX_DT = 0.016666


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """All simulation/display tunables. Defaults == reference defaults."""

    SIM_RESOLUTION: int = 128
    DYE_RESOLUTION: int = 1024
    CAPTURE_RESOLUTION: int = 512

    DENSITY_DISSIPATION: float = 1.0
    VELOCITY_DISSIPATION: float = 0.2
    PRESSURE: float = 0.8          # warm-start scale on previous pressure
    PRESSURE_ITERATIONS: int = 20  # Jacobi iterations
    CURL: float = 30.0             # vorticity confinement strength

    SPLAT_RADIUS: float = 0.25
    SPLAT_FORCE: float = 6000.0

    SHADING: bool = True
    COLORFUL: bool = True
    COLOR_UPDATE_SPEED: float = 10.0
    PAUSED: bool = False
    BACK_COLOR: Tuple[int, int, int] = (0, 0, 0)
    TRANSPARENT: bool = False

    BLOOM: bool = True
    BLOOM_ITERATIONS: int = 8
    BLOOM_RESOLUTION: int = 256
    BLOOM_INTENSITY: float = 0.8
    BLOOM_THRESHOLD: float = 0.6
    BLOOM_SOFT_KNEE: float = 0.7

    SUNRAYS: bool = True
    SUNRAYS_RESOLUTION: int = 196
    SUNRAYS_WEIGHT: float = 1.0

    CANVAS_WIDTH: int = 1280
    CANVAS_HEIGHT: int = 720
    DTYPE: str = "float32"
    MAX_SPLATS: int = 16
    USE_PALLAS: bool = True
    # bfloat16 only: the dye source is quantized through shared-exponent
    # RGB9E5 before it is sampled (ops/quant.py); inert for other dtypes.
    DYE_RGB9E5: bool = True
    # Sharded step only (parallel/sharded_step.py): split each row-halo
    # phase into an interior band that needs no ghost and two boundary
    # strips. None takes the default of ``overlap_halo``; True or False
    # forces it.
    OVERLAP_HALO: Optional[bool] = None

    # The JAX package's split-phase crossover (tpufluid/config.py): on from
    # this sim extent up, measured there on a TPU, where the split lets the
    # exchange overlap the interior's compute. Kept so that a config means
    # the same step in both packages. Here one process runs the phases in
    # turn on one stream, so the split overlaps nothing; it changes the
    # copies and the launches (PERF.md times both forms at 16384^2).
    OVERLAP_CROSSOVER = 8192

    @property
    def overlap_halo(self) -> bool:
        """Whether the sharded step splits its row-halo phases: OVERLAP_HALO
        if set, else on where the shorter sim extent is at least
        OVERLAP_CROSSOVER."""
        if self.OVERLAP_HALO is not None:
            return self.OVERLAP_HALO
        return min(self.sim_size) >= self.OVERLAP_CROSSOVER

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.DTYPE]

    @property
    def aspect_ratio(self) -> float:
        return self.CANVAS_WIDTH / self.CANVAS_HEIGHT

    @property
    def sim_size(self) -> Tuple[int, int]:
        """(width, height) of the velocity/pressure grid."""
        return get_resolution(self.SIM_RESOLUTION, self.CANVAS_WIDTH, self.CANVAS_HEIGHT)

    @property
    def dye_size(self) -> Tuple[int, int]:
        return get_resolution(self.DYE_RESOLUTION, self.CANVAS_WIDTH, self.CANVAS_HEIGHT)

    @property
    def bloom_size(self) -> Tuple[int, int]:
        return get_resolution(self.BLOOM_RESOLUTION, self.CANVAS_WIDTH, self.CANVAS_HEIGHT)

    @property
    def sunrays_size(self) -> Tuple[int, int]:
        return get_resolution(self.SUNRAYS_RESOLUTION, self.CANVAS_WIDTH, self.CANVAS_HEIGHT)

    @property
    def capture_size(self) -> Tuple[int, int]:
        return get_resolution(self.CAPTURE_RESOLUTION, self.CANVAS_WIDTH, self.CANVAS_HEIGHT)

    def bloom_mip_sizes(self) -> Tuple[Tuple[int, int], ...]:
        """Sizes of the bloom mip chain below the base: mip i is
        base >> (i+1), stopping when either side drops below 2."""
        w, h = self.bloom_size
        sizes = []
        for i in range(self.BLOOM_ITERATIONS):
            mw, mh = w >> (i + 1), h >> (i + 1)
            if mw < 2 or mh < 2:
                break
            sizes.append((mw, mh))
        return tuple(sizes)

    def splat_radius_uv(self) -> float:
        """Aspect-corrected splat radius (reference correctRadius)."""
        radius = self.SPLAT_RADIUS / 100.0
        if self.aspect_ratio > 1:
            radius *= self.aspect_ratio
        return radius

    def validate(self) -> "FluidConfig":
        if self.DTYPE not in _DTYPES:
            raise ValueError(f"DTYPE must be one of {list(_DTYPES)}, got {self.DTYPE!r}")
        for name in ("SIM_RESOLUTION", "DYE_RESOLUTION", "BLOOM_RESOLUTION",
                     "SUNRAYS_RESOLUTION", "CANVAS_WIDTH", "CANVAS_HEIGHT",
                     "MAX_SPLATS"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.PRESSURE_ITERATIONS < 0:
            raise ValueError("PRESSURE_ITERATIONS must be >= 0")
        return self


def get_resolution(resolution: int, canvas_w: int, canvas_h: int) -> Tuple[int, int]:
    """Aspect-fitted (width, height) for a scalar resolution: the shorter
    canvas side gets ``resolution`` texels, the longer side
    ``round(resolution * aspect)``."""
    aspect = canvas_w / canvas_h
    if aspect < 1:
        aspect = 1.0 / aspect
    lo = round(resolution)
    hi = round(resolution * aspect)
    if canvas_w > canvas_h:
        return (hi, lo)
    return (lo, hi)


# The demo's degraded configs, as presets.
def mobile_config(**overrides) -> FluidConfig:
    """Mobile preset: dye 1024 -> 512."""
    return FluidConfig(DYE_RESOLUTION=512, **overrides)


def low_capability_config(**overrides) -> FluidConfig:
    """No-linear-filtering preset: dye 512, shading, bloom and sunrays off."""
    return FluidConfig(DYE_RESOLUTION=512, SHADING=False, BLOOM=False,
                       SUNRAYS=False, **overrides)
