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

Every launch takes one sim or a batch of B sims: the fields, the factors
and the prepared source lead with B, and dt is a number for every sim or a
(B, 2) table of (clamped dt, decay) a sim (build.check_dt), its decay
column made for the ``dissipation`` passed beside it (step.dt_table). The
plain versions run a batch sim by sim.

The lane-packed fleet (tpufluid/batch_packed.py), ``sim_w=`` the width of a
sim: velocity (2, H, B*sim_w) and source (C, H, B*sim_w) on one grid, the
output packed, the prepared source (B, H, sim_w[, 4]) as a batch's. Each
sim's backtrace clamps at its own walls, in its own coordinates (the TPU
kernel's per-lane clamp, tpufluid/ops/pallas/advect.py:450-461); the plain
versions unpack the fleet, run it as a batch and pack the result.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops import advect as A
from tpufluid_torch.ops.cuda.build import (BATCHED, PACKED, F, I, P, Kernel, as_batch,
                                           batch_factors, check_dt, check_factors,
                                           check_storage, pack_fleet, packed_batch, per_sim, ptr,
                                           stream, unpack_fleet)
from tpufluid_torch.ops.quant import rgb9e5_pack, rgb9e5_unpack
from tpufluid_torch.ops.splat import splat_bump

_REPLACES = "tpufluid/ops/pallas/advect.py:301, tpufluid/ops/pallas/advect_hbm.py:108"
ADVECT = Kernel("advect", "advect", "fluid_advect",
                [P, I, I, P, I, P, I, I, I, I, F, F, P, I, I, P], replaces=_REPLACES)
ADVECT_PREPARE = Kernel("advect_prepare", "advect", "fluid_advect_prepare",
                        [P, P, I, I, I, I, P, P, P, I, I, I, I, P], replaces=_REPLACES)

# Source layouts of the gather (csrc/advect.cu Layout): the (C, H, W) planes,
# (H, W, 4) storage quads, (H, W) RGB9E5 words.
PLANES, QUADS, WORDS = 0, 1, 2


def _check(velocity: torch.Tensor, source: torch.Tensor, quant):
    """(velocity, source) as batches (B, 2, Hs, Ws), (B, C, H, W), single)."""
    vel, single = as_batch(velocity, 3)
    src, _ = as_batch(source, 3)
    if vel.shape[1] != 2:
        raise ValueError(f"velocity must be (2, Hs, Ws) or (B, 2, Hs, Ws), got "
                         f"{tuple(velocity.shape)}")
    if source.ndim != velocity.ndim or src.shape[0] != vel.shape[0] \
            or not 1 <= src.shape[1] <= 3:
        raise ValueError(f"source must be (C <= 3, H, W), or (B, C, H, W) beside a "
                         f"(B, 2, Hs, Ws) velocity, got {tuple(source.shape)}")
    _check_quant(source, src.shape[1], quant)
    return vel, src, single


def _check_quant(source: torch.Tensor, channels: int, quant) -> None:
    if quant not in (None, "rgb9e5"):
        raise ValueError(f"unknown quant {quant!r}")
    if quant and (channels != 3 or source.dtype != torch.bfloat16):
        raise ValueError("rgb9e5 quantizes 3-channel bfloat16 sources only")


def _check_packed(velocity: torch.Tensor, source: torch.Tensor, quant, sim_w: int) -> int:
    """B of a packed fleet's velocity (2, H, B*sim_w) and source
    (C <= 3, H, B*sim_w), on one grid."""
    b = packed_batch(velocity, 3, sim_w)
    if velocity.shape[0] != 2 or source.ndim != 3 or not 1 <= source.shape[0] <= 3 \
            or tuple(source.shape[1:]) != tuple(velocity.shape[1:]):
        raise ValueError(f"a packed fleet advects a (C <= 3, H, B*W) source through a "
                         f"(2, H, B*W) velocity on its grid, got {tuple(source.shape)} and "
                         f"{tuple(velocity.shape)}")
    _check_quant(source, source.shape[0], quant)
    return b


def prepare(source: torch.Tensor, splat_factors=None, quant=None, sim_w=None) -> torch.Tensor:
    """The prepared source on the card: (H, W) int32 RGB9E5 words with
    quant="rgb9e5", else (H, W, 4) storage quads (channels, then zeros);
    a batch (B, C, H, W) gives (B, H, W) or (B, H, W, 4), and so does a
    packed fleet (C, H, B*sim_w)."""
    code = check_storage(source)
    if sim_w is not None:
        src, single, fields = source, False, PACKED
        b, (c, h), w = packed_batch(source, 3, sim_w), source.shape[:2], sim_w
    else:
        src, single = as_batch(source, 3)
        (b, c, h, w), fields = src.shape, BATCHED
    gy, gx, amt, s = check_factors(batch_factors(splat_factors, single), src.device, b, h, w, c)
    shape, dtype = ((b, h, w), torch.int32) if quant else ((b, h, w, 4), source.dtype)
    prep = torch.empty(shape, dtype=dtype, device=src.device)
    ADVECT_PREPARE(ptr(src), ptr(prep), b, c, h, w, ptr(gy), ptr(gx), ptr(amt), s,
                   1 if quant else 0, fields, code, stream())
    return prep[0] if single else prep


def _packed_source(velocity: torch.Tensor, src: torch.Tensor, layout: int, sim_w: int):
    """(storage code, B) of a packed fleet's gather: the velocity
    (2, H, B*sim_w) and its packed planes or its batched prepared source."""
    b, h = packed_batch(velocity, 3, sim_w), velocity.shape[1]
    if layout == PLANES:
        _check_packed(velocity, src, None, sim_w)
        return check_storage(velocity, src), b
    code = check_storage(velocity) if layout == WORDS else check_storage(velocity, src)
    want = (b, h, sim_w) if layout == WORDS else (b, h, sim_w, 4)
    if tuple(src.shape) != want or src.device != velocity.device \
            or not src.is_contiguous() or (layout == WORDS and src.dtype != torch.int32):
        raise ValueError(f"a packed fleet's prepared source is {want} "
                         f"{'int32' if layout == WORDS else 'storage'}, contiguous on the "
                         f"velocity's device, got {tuple(src.shape)} {src.dtype}")
    return code, b


def gather(velocity: torch.Tensor, src: torch.Tensor, layout: int, channels: int, dt,
           dissipation: float, sim_w=None) -> torch.Tensor:
    """The gather on the card from ``src`` in ``layout`` (the source's
    planes, or prepare's quads or words) -> (channels, H, W) in the
    velocity's storage type; a batch (B, 2, Hs, Ws) velocity and its
    batch of sources give (B, channels, H, W); a packed fleet's velocity
    (2, H, B*sim_w) and its packed planes or batched prepared source give
    (channels, H, B*sim_w)."""
    if sim_w is not None:
        code, b = _packed_source(velocity, src, layout, sim_w)
        vel, single, fields = velocity, False, PACKED
        hv = h = velocity.shape[1]
        wv = w = sim_w
        out_shape = (channels, h, b * sim_w)
    else:
        vel, single = as_batch(velocity, 3)
        b, hv, wv, fields = vel.shape[0], vel.shape[2], vel.shape[3], BATCHED
        if layout == WORDS:
            code = check_storage(velocity)
            if src.dtype != torch.int32 or src.ndim != velocity.ndim - 1 \
                    or src.device != velocity.device or not src.is_contiguous():
                raise ValueError("RGB9E5 words must be a contiguous (H, W) int32 tensor, or "
                                 "(B, H, W) for a batch, on the velocity's device")
            h, w = src.shape[-2:]
        else:
            code = check_storage(velocity, src)
            if src.ndim != velocity.ndim:
                raise ValueError(f"source {tuple(src.shape)} beside velocity "
                                 f"{tuple(velocity.shape)}")
            h, w = src.shape[-2:] if layout == PLANES else src.shape[-3:-1]
        if not single and src.shape[0] != b:
            raise ValueError(f"a batch of {src.shape[0]} sources beside {b} velocities")
        out_shape = (b, channels, h, w)
    dt, dts = check_dt(dt, b, vel.device)
    # The table carries each sim's decay; a scalar dt's is computed here.
    decay = float(A.decay_factor(dissipation, dt)) if dts.value is None else 0.0
    out = torch.empty(out_shape, dtype=velocity.dtype, device=velocity.device)
    ADVECT(ptr(vel), hv, wv, ptr(src), layout, ptr(out), b, channels, h, w, dt, decay, dts,
           fields, code, stream())
    return out[0] if single else out


def advect(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
           splat_factors=None, quant=None, sim_w=None) -> torch.Tensor:
    """Advect ``source`` (C, H, W) through ``velocity`` (2, Hs, Ws) on the
    card, a batch (B, C, H, W) through (B, 2, Hs, Ws), or a packed fleet of
    sims ``sim_w`` wide (C, H, B*sim_w) through (2, H, B*sim_w)."""
    check_storage(velocity, source)
    if sim_w is not None:
        _check_packed(velocity, source, quant, sim_w)
    else:
        _check(velocity, source, quant)
    if splat_factors is not None or quant:
        src, layout = prepare(source, splat_factors, quant, sim_w), WORDS if quant else QUADS
    else:
        src, layout = source, PLANES
    return gather(velocity, src, layout, source.shape[-3], dt, dissipation, sim_w)


def _advect_sim(velocity, source, dt, dissipation, splat_factors, quant):
    if splat_factors is not None:
        source = (source.to(torch.float32) + splat_bump(*splat_factors)).to(source.dtype)
    return A.advect(velocity, source, dt, dissipation, quant=quant)


def advect_plain(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
                 splat_factors=None, quant=None, sim_w=None) -> torch.Tensor:
    """Plain version of advect, same operations and rounding points; a
    batch sim by sim, each with its dt (its decay recomputed from
    ``dissipation`` as the table's was); a packed fleet unpacked, run as a
    batch, packed."""
    if sim_w is not None:
        b = _check_packed(velocity, source, quant, sim_w)
        return pack_fleet(advect_plain(unpack_fleet(velocity, b), unpack_fleet(source, b), dt,
                                       dissipation, splat_factors, quant))
    _, _, single = _check(velocity, source, quant)
    return per_sim(_advect_sim, not single,
                   (velocity, source, dt, dissipation, splat_factors, quant),
                   fields=(0, 1), dt_at=2, factors_at=4)


def _prepare_sim(source, splat_factors, quant):
    if splat_factors is not None:
        source = (source.to(torch.float32) + splat_bump(*splat_factors)).to(source.dtype)
    if quant:
        return rgb9e5_pack(source)
    pad = torch.zeros((4 - source.shape[0],) + tuple(source.shape[1:]), dtype=source.dtype,
                      device=source.device)
    return torch.cat([source, pad]).permute(1, 2, 0).contiguous()


def prepare_plain(source: torch.Tensor, splat_factors=None, quant=None,
                  sim_w=None) -> torch.Tensor:
    """Plain version of prepare: the bump added in float32 and rounded to
    storage, then packed to RGB9E5 words or laid out as storage quads; a
    batch sim by sim; a packed fleet unpacked, prepared as a batch."""
    if sim_w is not None:
        source = unpack_fleet(source, packed_batch(source, 3, sim_w))
    return per_sim(_prepare_sim, source.ndim == 4, (source, splat_factors, quant),
                   factors_at=1)


def _gather_sim(velocity, prepared, channels, dt, dissipation):
    if prepared.dtype == torch.int32:
        src, out_dtype = rgb9e5_unpack(prepared), torch.bfloat16
    else:
        src = prepared[..., :channels].permute(2, 0, 1).to(torch.float32)
        out_dtype = prepared.dtype
    return A.advect(velocity, src, dt, dissipation).to(out_dtype)


def gather_plain(velocity: torch.Tensor, prepared: torch.Tensor, channels: int, dt,
                 dissipation: float, sim_w=None) -> torch.Tensor:
    """Plain version of the gather from a prepared source: its texels decoded
    to float32 (exactly, as the kernel's loads do), sampled, rounded once to
    storage (bf16 for RGB9E5 words); a batch sim by sim; a packed fleet's
    velocity unpacked beside its batched prepared source, the result
    packed."""
    if sim_w is not None:
        b = packed_batch(velocity, 3, sim_w)
        return pack_fleet(gather_plain(unpack_fleet(velocity, b), prepared, channels, dt,
                                       dissipation))
    return per_sim(_gather_sim, velocity.ndim == 4,
                   (velocity, prepared, channels, dt, dissipation), fields=(0, 1), dt_at=3)
