"""The step's passes and the frame's kernels, routed by device: a CUDA
tensor goes to the kernel, a CPU tensor to the kernel's plain version. There
is no fallback: a CUDA tensor the kernel cannot take (a dtype it lacks, a
failed build or launch) raises.

Counterpart of tpufluid/ops/pallas/dispatch.py:152-284, 287-363, without its
TPU padding and tiling policy: the kernels read global memory at any shape.

The step's passes take one sim or a batch of B sims (every field with a
leading B, dt a number or a (B, 2) table a sim): a CUDA batch goes to the
kernels, B sims in each launch; a CPU batch to the plain versions, sim by
sim. So do the frame's kernels: the bloom pyramid, the sunrays (two
launches) and the display take one sim or a batch (B leading).

The lane-packed fleet (tpufluid_torch/batch_packed.py) has its own pair,
``packed(sim_w)`` routed and ``packed(sim_w, plain=True)``: the same
passes with every field (C, H, B*sim_w), each kernel launched once for the
fleet, a CUDA fleet to the kernels and a CPU fleet to the plain versions.

The sharded step (tpufluid_torch/parallel) runs the same passes on a
shard's halo-padded blocks: ``pre_pressure(..., true_bounds=...)`` with the
grid's walls inside the block, and ``advect_same_grid``
(tpufluid/ops/pallas/dispatch.py:415), the advection with the velocity
already on the source's grid.
"""

from __future__ import annotations

import functools
import math

from tpufluid_torch.ops.cuda import advect as _advect
from tpufluid_torch.ops.cuda import bloom as _bloom
from tpufluid_torch.ops.cuda import display as _display
from tpufluid_torch.ops.cuda import jacobi as _jacobi
from tpufluid_torch.ops.cuda import stencil as _stencil
from tpufluid_torch.ops.cuda import sunrays as _sunrays
from tpufluid_torch.ops.sunrays import apply_sunrays


def _routed(kernel, plain):
    """Call ``kernel`` for a CUDA first argument, ``plain`` for a CPU one."""
    def run(field, *args, **kwargs):
        if field.is_cuda:
            return kernel(field, *args, **kwargs)
        if field.device.type == "cpu":
            return plain(field, *args, **kwargs)
        raise ValueError(f"no kernel or plain version for device {field.device}")
    run.__name__ = kernel.__name__
    run.__doc__ = kernel.__doc__
    return run


class Passes:
    """The passes of one step, of one sim or a batch, through one
    implementation; or of a packed fleet of sims ``sim_w`` wide. The step
    runs pre_pressure, jacobi_project (the solve with the gradient subtract
    fused into its last launch: (pressure, projected velocity)) and advect;
    the sharded step, whose pressure crosses a halo exchange between the
    solve and the gradient, runs jacobi_pressure and gradient_subtract
    apart."""

    def __init__(self, pre_pressure, jacobi_pressure, gradient_subtract, jacobi_project, advect,
                 sim_w=None):
        self.pre_pressure = pre_pressure
        self.jacobi_pressure = jacobi_pressure
        self.gradient_subtract = gradient_subtract
        self.jacobi_project = jacobi_project
        self.advect = advect
        self.sim_w = sim_w

    def grid(self, field):
        """(H, W) of one sim of ``field``."""
        h, w = field.shape[-2:]
        return (h, w) if self.sim_w is None else (h, self.sim_w)

    def advect_same_grid(self, velocity, source, dt, dissipation, max_disp_y, max_disp_x,
                         splat_factors=None, quant=None):
        """advect with ``velocity`` (2, H, W) on the source's own grid, in
        source texels a second. ``max_disp_y`` / ``max_disp_x`` are the
        caller's bound of a backtrace in source texels (the sharded step
        sizes its ghosts from it). The JAX package sizes its gather window
        from them; the port's gathers read the whole array, so a backtrace
        past them is still gathered right and they size nothing here. They
        must be finite and non-negative."""
        for name, bound in (("max_disp_y", max_disp_y), ("max_disp_x", max_disp_x)):
            if not (math.isfinite(bound) and bound >= 0):
                raise ValueError(f"{name} must be finite and >= 0, got {bound}")
        if tuple(velocity.shape[-2:]) != tuple(source.shape[-2:]):
            raise ValueError(f"velocity {tuple(velocity.shape)} is not on the grid of source "
                             f"{tuple(source.shape)}")
        return self.advect(velocity, source, dt, dissipation, splat_factors=splat_factors,
                           quant=quant)


# Kernels on the card, plain versions on the CPU: what fluid_step runs.
ROUTED = Passes(
    _routed(_stencil.pre_pressure, _stencil.pre_pressure_plain),
    _routed(_jacobi.jacobi_pressure, _jacobi.jacobi_plain),
    _routed(_stencil.gradient_subtract, _stencil.gradient_subtract_plain),
    _routed(_jacobi.jacobi_project, _jacobi.jacobi_project_plain),
    _routed(_advect.advect, _advect.advect_plain),
)

# The plain versions on any device: the reference the kernels are held to.
PLAIN = Passes(_stencil.pre_pressure_plain, _jacobi.jacobi_plain,
               _stencil.gradient_subtract_plain, _jacobi.jacobi_project_plain,
               _advect.advect_plain)



@functools.lru_cache(maxsize=None)
def packed(sim_w: int, plain: bool = False) -> Passes:
    """The passes of a packed fleet of sims ``sim_w`` wide (fields (C, H,
    B*sim_w)): routed, or the plain versions on any device with ``plain``."""
    if plain:
        fns = (_stencil.pre_pressure_plain, _jacobi.jacobi_plain,
               _stencil.gradient_subtract_plain, _jacobi.jacobi_project_plain,
               _advect.advect_plain)
    else:
        fns = (ROUTED.pre_pressure, ROUTED.jacobi_pressure, ROUTED.gradient_subtract,
               ROUTED.jacobi_project, ROUTED.advect)
    return Passes(*(functools.partial(f, sim_w=sim_w) for f in fns), sim_w=sim_w)


pre_pressure = ROUTED.pre_pressure
jacobi_pressure = ROUTED.jacobi_pressure
gradient_subtract = ROUTED.gradient_subtract
jacobi_project = ROUTED.jacobi_project
advect = ROUTED.advect
advect_same_grid = ROUTED.advect_same_grid


class RenderPasses:
    """The kernels of one frame, of one sim or a batch, through one
    implementation: ``bloom_chain(dye_rgb, base_hw, mip_sizes, threshold,
    soft_knee, intensity)``, ``sunrays(dye_rgb, out_hw, weight)`` and
    ``display(dye, out_hw, shading, bloom, sunrays, dither, compose=True)``,
    the dither one tile for every sim."""

    def __init__(self, bloom_chain, sunrays, display):
        self.bloom_chain = bloom_chain
        self.sunrays = sunrays
        self.display = display


ROUTED_RENDER = RenderPasses(_routed(_bloom.bloom_chain, _bloom.bloom_chain_plain),
                             _routed(_sunrays.sunrays, apply_sunrays),
                             _routed(_display.display, _display.display_plain))
PLAIN_RENDER = RenderPasses(_bloom.bloom_chain_plain, apply_sunrays, _display.display_plain)

bloom_chain = ROUTED_RENDER.bloom_chain


def display_full(dye_rgb, out_hw, shading: bool, bloom_tex, sunrays_tex, dither_tex):
    """The whole display composite -> (C + 1, h, w) premultiplied RGBA."""
    return ROUTED_RENDER.display(dye_rgb, out_hw, shading, bloom_tex, sunrays_tex, dither_tex)


def display_base(dye_rgb, out_hw, shading: bool):
    """The shaded display center alone -> (C, h, w)."""
    return ROUTED_RENDER.display(dye_rgb, out_hw, shading, compose=False)
