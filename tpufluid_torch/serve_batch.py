"""The multi-tenant server's batched tick: one step and one frame for a
whole batch of sims.

Counterpart of tpufluid/serve_batch.py:122-157 (``_batched_tick_body``,
``make_batched_tick``), which vmaps tick_body, step + render + uint8
quantize + vertical flip, over the sessions in one dispatch. Here a tick is
one batched step (the step's 7 launches at 20 Jacobi sweeps, whatever B is)
and one batched frame (one bloom pyramid and one display launch), and each
sim's state and frame equal make_step_and_render's on that sim alone, bit
for bit.

The rest of tpufluid/serve_batch.py (the server: padded batch sizes, CUDA
graphs, resize, the generation fence, fast-forward substeps, checkpoints)
waits for ROADMAP.md Queue 1 #11.
"""

from __future__ import annotations

from tpufluid_torch.batch import _require_batch, step_dt
from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.render import frame_u8
from tpufluid_torch.state import FluidState, resolve_device
from tpufluid_torch.step import _step


def _batched_tick_body(config: FluidConfig):
    """tick(batched_state, dt, splats) -> (batched_state, (B, h, w, 3)
    uint8): a batched step, ``dt`` a scalar (the server's one clock) or (B,)
    per sim, then the batched frame quantized and flipped on the state's
    device, as tick_body for one sim."""

    def tick(state: FluidState, dt, splats):
        b = state.velocity.shape[0]
        state = _step(state, step_dt(dt, b, config, state.velocity.device), splats, config,
                      dispatch.ROUTED)
        return state, frame_u8(state, config)

    return tick


def make_batched_tick(config: FluidConfig, device="cuda"):
    """tick(batched_state, dt, splats) -> (batched_state, (B, h, w, 3)
    uint8 frames) on ``device`` (default the GPU): the kernels on the card,
    their plain versions on the CPU. ``splats`` is (B, MAX_SPLATS, 8)."""
    device = resolve_device(device)
    body = _batched_tick_body(config)

    def tick(state: FluidState, dt, splats):
        _require_batch(state, device)
        return body(state, dt, splats)

    return tick
