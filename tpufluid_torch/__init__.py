"""tpufluid_torch — the stable-fluids simulator of ``tpufluid`` in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The simulation step runs four kernel families (csrc/): the pre-pressure
stencil, the Jacobi sweeps, the gradient subtract and the advection (the
velocity's gather and the dye's windowed gather, one launch each), for one
sim, a batch of B sims or a lane-packed fleet of B sims in one launch.
The frame runs two, one launch each, for one sim or a batch: the bloom
pyramid and the display composite. Every kernel has a plain PyTorch version beside it; a CPU state
runs those, a CUDA state runs the kernels. The entry points default to
``device="cuda"`` and raise without a GPU unless the caller passes
``device="cpu"``. The package imports neither JAX nor ``tpufluid``.

Public API:
    FluidConfig, MAX_DT        — tunables (field names and defaults of tpufluid's)
    FluidState, init_state     — fields and their allocation
    resize_state               — resample into another config's sizes
    fluid_step, make_step, make_multi_step — the simulation step
    apply_splats               — a splat batch as PyTorch ops (reference splat())
    init_batch, stack_states, unstack_state, make_batched_step,
    make_batched_multi_step, make_batched_render
                               — B sims in one set of launches, dt per sim
    make_batched_tick, make_substepped_tick, make_tick_program,
    BatchFluidServer           — the multi-tenant fleet server: its batched
                                 tick, the K-substep fast-forward tick, the
                                 per-(padded batch, kind) programs and the
                                 server (python -m tpufluid_torch.serve_batch)
    batch_packed (module)      — the lane-packed fleet: B sims side by side
                                 along the rows, (C, H, B*W), lock-step
    make_mesh, shard_state, exchange_halo_rows, make_sharded_step,
    make_sharded_multi_step, sharded_fluid_step
                               — the sharded step over a mesh of devices
    make_auto_sharded_step     — the sharded state through the one-device
                                 step (gather, step, reshard): a baseline
    shard_batch, gather_batch, make_batch_sharded_multi_step,
    make_batch_sharded_substepped_tick
                               — batch data parallelism over a mesh
    make_batch_spatial_mesh, shard_batch_spatial, gather_batch_spatial,
    make_batch_spatial_multi_step
                               — batch x spatial: each group of sims
                                 sharded over its own (ny, nx) sub-mesh
    dryrun (module)            — entry() and dryrun_multichip(n), the
                                 multi-device certifications
    Pointer, PointerTracer, generate_color, random_splats, Trace,
    swirl_trace                — deterministic splat input, record and replay
    render_frame, make_render, capture_frame — the frame (float32 RGBA)
    frame_u8, tick_body, make_step_and_render — the servers' uint8 frame
    io, checkpoint (modules)   — PNG / GIF / dither I/O; .npz checkpoints
                                 that load in either package
    app, server (modules)      — the headless app (python -m
                                 tpufluid_torch.app) and the interactive
                                 server (python -m tpufluid_torch.server)
"""

from tpufluid_torch.batch import (gather_batch, gather_batch_spatial, init_batch,
                                  make_batch_sharded_multi_step, make_batch_spatial_mesh,
                                  make_batch_spatial_multi_step, make_batched_multi_step,
                                  make_batched_render, make_batched_step, shard_batch,
                                  shard_batch_spatial, stack_states, unstack_state)
from tpufluid_torch.config import MAX_DT, FluidConfig, get_resolution
from tpufluid_torch.parallel import (exchange_halo_rows, make_auto_sharded_step, make_mesh,
                                     make_sharded_multi_step, make_sharded_step, shard_state,
                                     sharded_fluid_step)
from tpufluid_torch.render import (capture_frame, frame_u8, make_render,
                                   make_step_and_render, render_frame, tick_body)
from tpufluid_torch.serve_batch import (BatchFluidServer, make_batch_sharded_substepped_tick,
                                       make_batched_tick, make_substepped_tick, make_tick_program)
from tpufluid_torch.state import FluidState, init_state, resize_state
from tpufluid_torch.step import apply_splats, fluid_step, make_multi_step, make_step
from tpufluid_torch.trace import (Pointer, PointerTracer, Trace, generate_color, random_splats,
                                  swirl_trace)

__all__ = [
    "MAX_DT",
    "FluidConfig",
    "get_resolution",
    "FluidState",
    "init_state",
    "resize_state",
    "fluid_step",
    "make_step",
    "make_multi_step",
    "apply_splats",
    "init_batch",
    "stack_states",
    "unstack_state",
    "make_batched_step",
    "make_batched_multi_step",
    "make_batched_render",
    "make_batched_tick",
    "make_substepped_tick",
    "make_tick_program",
    "BatchFluidServer",
    "Pointer",
    "PointerTracer",
    "generate_color",
    "random_splats",
    "Trace",
    "swirl_trace",
    "render_frame",
    "make_render",
    "capture_frame",
    "frame_u8",
    "tick_body",
    "make_step_and_render",
    "make_mesh",
    "shard_state",
    "exchange_halo_rows",
    "make_sharded_step",
    "make_sharded_multi_step",
    "sharded_fluid_step",
    "make_auto_sharded_step",
    "shard_batch",
    "gather_batch",
    "make_batch_sharded_multi_step",
    "make_batch_sharded_substepped_tick",
    "make_batch_spatial_mesh",
    "shard_batch_spatial",
    "gather_batch_spatial",
    "make_batch_spatial_multi_step",
]
