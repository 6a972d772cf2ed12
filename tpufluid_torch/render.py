"""render(state) -> RGBA frame — the reference's render(target)
(script.js:1296-1348), counterpart of ``tpufluid.render``.

Order, that of the reference: bloom chain -> sunrays (mask, march, 1x blur)
-> background (flat BACK_COLOR, or a checkerboard in transparent screen
mode) -> display composite, blended premultiplied (ONE, ONE_MINUS_SRC_ALPHA)
unless rendering an offscreen transparent capture (no blend, raw RGBA).

On a CUDA state the bloom pyramid (1 launch), the sunrays (2 launches: the
march, then the blur) and the display composite (1 launch) run the CUDA
kernels; on a CPU state their plain versions. The dye cast, the bloom's base
resample, the backdrop and the blend are PyTorch ops on either device. The
output is a float32 (4, H, W) RGBA tensor on the state's device; frame_u8
quantizes it to the servers' wire format.

A state whose fields lead with a batch axis of B sims (tpufluid_torch.batch)
renders as a batch: (B, 4, H, W), one bloom launch, the sunrays' two and
one display launch for the B sims, one backdrop broadcast over them. Each
sim's frame is the single-sim frame of that sim, bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.io import load_dither
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.ops.display import blend_premultiplied, checkerboard
from tpufluid_torch.spans import span
from tpufluid_torch.state import FluidState, resolve_device
from tpufluid_torch.step import fluid_step
from tpufluid_torch.utils.bluenoise import blue_noise_64

@functools.lru_cache(maxsize=None)
def blue_noise(device: torch.device) -> torch.Tensor:
    """The 64x64 blue-noise dither tile as a float32 tensor on ``device``,
    one copy per device, shared by every frame (read only)."""
    return torch.from_numpy(blue_noise_64()).to(device)


def _render(state: FluidState, config: FluidConfig, out_hw, to_screen: bool, dither,
            passes: dispatch.RenderPasses) -> torch.Tensor:
    if out_hw is None:
        out_hw = (config.CANVAS_HEIGHT, config.CANVAS_WIDTH)
    out_hw = tuple(out_hw)
    with span("frame"):
        with span("dye_cast"):
            dye = state.dye.to(torch.float32)
        device = dye.device

        bloom_tex = None
        if config.BLOOM:
            bw, bh = config.bloom_size
            bloom_tex = passes.bloom_chain(dye, (bh, bw), config.bloom_mip_sizes(),
                                           config.BLOOM_THRESHOLD, config.BLOOM_SOFT_KNEE,
                                           config.BLOOM_INTENSITY)

        sunrays_tex = None
        if config.SUNRAYS:
            sw, sh = config.sunrays_size
            with span("sunrays"):
                sunrays_tex = passes.sunrays(dye, (sh, sw), config.SUNRAYS_WEIGHT)

        if config.BLOOM and dither is None:
            dither = blue_noise(device)

        # The display reads the dye in its storage type (its plain version
        # casts); the backdrop, (4, h, w), broadcasts over a batch in the blend.
        with span("display"):
            display = passes.display(state.dye, out_hw, config.SHADING, bloom_tex, sunrays_tex,
                                     dither if config.BLOOM else None)

        blend = to_screen or not config.TRANSPARENT  # script.js:1304-1310
        with span("backdrop"):
            if not config.TRANSPARENT:
                back = torch.ones((4,) + out_hw, dtype=torch.float32, device=device)
                for ch, value in enumerate(config.BACK_COLOR):
                    back[ch] = value / 255.0
            elif to_screen:
                back = checkerboard(out_hw, config.aspect_ratio, device=device)
            else:
                back = None

        if blend and back is not None:
            with span("blend"):
                return blend_premultiplied(display, back)
        return display


def render_frame(state: FluidState, config: FluidConfig,
                 out_hw: Optional[Tuple[int, int]] = None, to_screen: bool = True,
                 dither: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The full display pipeline -> (4, out_h, out_w) float32 RGBA, or
    (B, 4, out_h, out_w) for a batched state.

    to_screen=False is the offscreen-capture path (captureScreenshot,
    script.js:287-299): with TRANSPARENT it skips background and blending.
    ``dither`` replaces the built-in blue noise (a (h, w) float32 tensor on
    the state's device)."""
    return _render(state, config, out_hw, to_screen, dither, dispatch.ROUTED_RENDER)


def plain_render(state: FluidState, config: FluidConfig,
                 out_hw: Optional[Tuple[int, int]] = None, to_screen: bool = True,
                 dither: Optional[torch.Tensor] = None) -> torch.Tensor:
    """render_frame through the kernels' plain versions on any device: the
    reference the kernel render is held to on the card."""
    return _render(state, config, out_hw, to_screen, dither, dispatch.PLAIN_RENDER)


def _require(state: FluidState, device: torch.device) -> None:
    if state.dye.device.type != device.type:
        raise ValueError(f"state on {state.dye.device}, render made for {device}")


def make_render(config: FluidConfig, out_hw: Optional[Tuple[int, int]] = None,
                to_screen: bool = True, device="cuda"):
    """render(state, dither=None) -> (4, h, w) frame on ``device`` (default
    the GPU)."""
    device = resolve_device(device)

    def render(state: FluidState, dither: Optional[torch.Tensor] = None) -> torch.Tensor:
        _require(state, device)
        return render_frame(state, config, out_hw=out_hw, to_screen=to_screen, dither=dither)

    return render


def capture_frame(state: FluidState, config: FluidConfig,
                  dither: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Offscreen capture at CAPTURE_RESOLUTION (captureScreenshot, script.js:287-299)."""
    cw, ch = config.capture_size
    return render_frame(state, config, out_hw=(ch, cw), to_screen=False, dither=dither)


def load_dither_tensor(path: Optional[str], device) -> Optional[torch.Tensor]:
    """io.load_dither's (h, w) float32 texture as a tensor on ``device``,
    or None for no path."""
    if path is None:
        return None
    return torch.from_numpy(load_dither(path)).to(device)


def _quantize(frame: torch.Tensor) -> torch.Tensor:
    with span("quantize"):
        rgb = (frame[..., :3, :, :].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return torch.flip(rgb.movedim(-3, -1), dims=(-3,)).contiguous()


def frame_u8(state: FluidState, config: FluidConfig,
             out_hw: Optional[Tuple[int, int]] = None,
             dither_path: Optional[str] = None) -> torch.Tensor:
    """The rendered frame in the servers' wire format, computed on the
    state's device: render + clip01 * 255 quantize (truncating) + vertical
    flip -> (h, w, 3) uint8, top row first; for a batched state (B, h, w, 3),
    each sim flipped on its own row axis. ``dither_path``: a dither PNG
    (io.load_dither) in place of the built-in blue noise, read on every
    call; make_step_and_render reads it once."""
    dither = load_dither_tensor(dither_path, state.dye.device)
    return _quantize(render_frame(state, config, out_hw=out_hw, dither=dither))


def _tick_body(config: FluidConfig, out_hw, dither: Optional[torch.Tensor]):
    def tick(state: FluidState, dt, splats):
        state = fluid_step(state, dt, splats, config)
        d = None if dither is None else dither.to(state.dye.device)
        return state, _quantize(render_frame(state, config, out_hw=out_hw, dither=d))

    return tick


def tick_body(config: FluidConfig, out_hw: Optional[Tuple[int, int]] = None,
              dither_path: Optional[str] = None):
    """The per-frame body, step + render + uint8 quantize + flip:
    tick(state, dt, splats) -> (state, (h, w, 3) uint8 frame). The dither
    PNG, if any, is read once, here."""
    return _tick_body(config, out_hw, load_dither_tensor(dither_path, "cpu"))


def make_step_and_render(config: FluidConfig, out_hw: Optional[Tuple[int, int]] = None,
                         dither_path: Optional[str] = None, device="cuda"):
    """tick(state, dt, splats) -> (state, frame_u8) on ``device`` (default
    the GPU): one simulation step and its frame, as an interactive server
    issues them. The dither PNG, if any, is read and copied to ``device``
    once, here, not every tick."""
    device = resolve_device(device)
    body = _tick_body(config, out_hw, load_dither_tensor(dither_path, device))

    def tick(state: FluidState, dt, splats):
        _require(state, device)
        return body(state, dt, splats)

    return tick
