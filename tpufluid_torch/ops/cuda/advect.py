"""Semi-Lagrangian advection: the CUDA prepare and gather kernels
(csrc/advect.cu) and their plain PyTorch versions.

One gather stands for both TPU advection kernels (tpufluid/ops/pallas/
advect.py:301 and advect_hbm.py:108): same grid (velocity self-advection,
dye at the sim resolution) and dye on a finer grid than the velocity. The
optional splat bump is added to the source and rounded to storage before it
is sampled; quant="rgb9e5" then sends the (bf16, 3-channel) source through
RGB9E5; the result rounds to storage once.

Where the source has a bump or a quantization (the dye), the prepare kernel
does both once per source texel and writes the prepared source: one RGB9E5
word a texel, or the storage values interleaved and padded to 4; the gather
then reads 4 prepared corners. A source with neither (the velocity) is
gathered from its planes directly.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops import advect as A
from tpufluid_torch.ops.cuda.build import (F, I, P, Kernel, check_factors,
                                           check_storage, ptr, stream)
from tpufluid_torch.ops.quant import rgb9e5_pack, rgb9e5_unpack
from tpufluid_torch.ops.splat import splat_bump

_REPLACES = "tpufluid/ops/pallas/advect.py:301, tpufluid/ops/pallas/advect_hbm.py:108"
ADVECT = Kernel("advect", "advect", "fluid_advect",
                [P, I, I, P, I, P, I, I, I, F, F, I, P], replaces=_REPLACES)
ADVECT_PREPARE = Kernel("advect_prepare", "advect", "fluid_advect_prepare",
                        [P, P, I, I, I, P, P, P, I, I, I, P], replaces=_REPLACES)

# Source layouts of the gather (csrc/advect.cu Layout): the (C, H, W) planes,
# (H, W, 4) storage quads, (H, W) RGB9E5 words.
PLANES, QUADS, WORDS = 0, 1, 2


def _check(velocity: torch.Tensor, source: torch.Tensor, quant):
    if velocity.ndim != 3 or velocity.shape[0] != 2:
        raise ValueError(f"velocity must be (2, Hs, Ws), got {tuple(velocity.shape)}")
    if source.ndim != 3 or not 1 <= source.shape[0] <= 3:
        raise ValueError(f"source must be (C <= 3, H, W), got {tuple(source.shape)}")
    if quant not in (None, "rgb9e5"):
        raise ValueError(f"unknown quant {quant!r}")
    if quant and (source.shape[0] != 3 or source.dtype != torch.bfloat16):
        raise ValueError("rgb9e5 quantizes 3-channel bfloat16 sources only")


def prepare(source: torch.Tensor, splat_factors=None, quant=None) -> torch.Tensor:
    """The prepared source on the card: (H, W) int32 RGB9E5 words with
    quant="rgb9e5", else (H, W, 4) storage quads (channels, then zeros)."""
    code = check_storage(source)
    c, h, w = source.shape
    gy, gx, amt, s = check_factors(splat_factors, source.device, h, w, c)
    shape, dtype = ((h, w), torch.int32) if quant else ((h, w, 4), source.dtype)
    prep = torch.empty(shape, dtype=dtype, device=source.device)
    ADVECT_PREPARE(ptr(source), ptr(prep), c, h, w, ptr(gy), ptr(gx), ptr(amt), s,
                   1 if quant else 0, code, stream())
    return prep


def gather(velocity: torch.Tensor, src: torch.Tensor, layout: int, channels: int, dt: float,
           dissipation: float) -> torch.Tensor:
    """The gather on the card from ``src`` in ``layout`` (the source's
    planes, or prepare's quads or words) -> (channels, H, W) in the
    velocity's storage type."""
    if layout == WORDS:
        code = check_storage(velocity)
        if src.dtype != torch.int32 or src.ndim != 2 or src.device != velocity.device \
                or not src.is_contiguous():
            raise ValueError("RGB9E5 words must be a contiguous (H, W) int32 tensor on "
                             "the velocity's device")
        h, w = src.shape
    else:
        code = check_storage(velocity, src)
        h, w = src.shape[-2:] if layout == PLANES else src.shape[:2]
    out = torch.empty((channels, h, w), dtype=velocity.dtype, device=velocity.device)
    ADVECT(ptr(velocity), velocity.shape[1], velocity.shape[2], ptr(src), layout, ptr(out),
           channels, h, w, float(dt), float(A.decay_factor(dissipation, dt)), code, stream())
    return out


def advect(velocity: torch.Tensor, source: torch.Tensor, dt: float,
           dissipation: float, splat_factors=None, quant=None) -> torch.Tensor:
    """Advect ``source`` (C, H, W) through ``velocity`` (2, Hs, Ws) on the card."""
    _check(velocity, source, quant)
    check_storage(velocity, source)
    if splat_factors is not None or quant:
        src, layout = prepare(source, splat_factors, quant), WORDS if quant else QUADS
    else:
        src, layout = source, PLANES
    return gather(velocity, src, layout, source.shape[0], dt, dissipation)


def advect_plain(velocity: torch.Tensor, source: torch.Tensor, dt: float,
                 dissipation: float, splat_factors=None, quant=None) -> torch.Tensor:
    """Plain version of advect, same operations and rounding points."""
    _check(velocity, source, quant)
    if splat_factors is not None:
        source = (source.to(torch.float32) + splat_bump(*splat_factors)).to(source.dtype)
    return A.advect(velocity, source, dt, dissipation, quant=quant)


def prepare_plain(source: torch.Tensor, splat_factors=None, quant=None) -> torch.Tensor:
    """Plain version of prepare: the bump added in float32 and rounded to
    storage, then packed to RGB9E5 words or laid out as storage quads."""
    if splat_factors is not None:
        source = (source.to(torch.float32) + splat_bump(*splat_factors)).to(source.dtype)
    if quant:
        return rgb9e5_pack(source)
    pad = torch.zeros((4 - source.shape[0],) + tuple(source.shape[1:]), dtype=source.dtype,
                      device=source.device)
    return torch.cat([source, pad]).permute(1, 2, 0).contiguous()


def gather_plain(velocity: torch.Tensor, prepared: torch.Tensor, channels: int, dt: float,
                 dissipation: float) -> torch.Tensor:
    """Plain version of the gather from a prepared source: its texels decoded
    to float32 (exactly, as the kernel's loads do), sampled, rounded once to
    storage (bf16 for RGB9E5 words)."""
    if prepared.dtype == torch.int32:
        src, out_dtype = rgb9e5_unpack(prepared), torch.bfloat16
    else:
        src = prepared[..., :channels].permute(2, 0, 1).to(torch.float32)
        out_dtype = prepared.dtype
    return A.advect(velocity, src, dt, dissipation).to(out_dtype)
