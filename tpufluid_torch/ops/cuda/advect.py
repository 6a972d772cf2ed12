"""Semi-Lagrangian advection: the CUDA kernels (csrc/advect.cu) and their
plain PyTorch versions.

The two kernels stand for both TPU advection kernels (tpufluid/ops/pallas/
advect.py:301 and advect_hbm.py:108): same grid (velocity self-advection,
dye at the sim resolution) and dye on a finer grid than the velocity. The
optional splat bump is added to the source and rounded to storage before it
is sampled; quant="rgb9e5" then sends the (bf16, 3-channel) source through
RGB9E5; the result rounds to storage once.

A source with a bump or a quantization (the dye) goes to advect_dye, one
launch: each block stages the window its target tile reads, bumped,
rounded and packed once per source texel (``dye_window_plan`` gives its
tiles, boxes and the share that fits the shared memory). A source with
neither (the velocity) is gathered from its planes by advect. A dye call
takes a float32 velocity beside a bf16 or f16 dye (the sharded step's
velocity resampled on the dye's grid); the dye's storage type is the
output's.

Every launch takes one sim or a batch of B sims: the fields and the
factors lead with B, and dt is a number for every sim or a (B, 2) table of
(clamped dt, decay) a sim (build.check_dt), its decay column made for the
``dissipation`` passed beside it (step.dt_table). The plain versions run a
batch sim by sim.

The lane-packed fleet (tpufluid/batch_packed.py), ``sim_w=`` the width of a
sim: velocity (2, H, B*sim_w) and source (C, H, B*sim_w) on one grid and in
one storage type, the output packed, the splat factors a batch's. Each
sim's backtrace clamps at its own walls, in its own coordinates (the TPU
kernel's per-lane clamp, tpufluid/ops/pallas/advect.py:450-461); the plain
versions unpack the fleet, run it as a batch and pack the result.

``prepare_plain`` and ``gather_plain`` are the plain versions of the dye
kernel's two stages: a window's prepared texels (RGB9E5 words or storage
quads), and the gather from them.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops.advect import advect as plain_advect
from tpufluid_torch.ops.advect import backtrace, decay_factor
from tpufluid_torch.ops.cuda.build import (BATCHED, PACKED, STORAGE_CODES, F, I, P, Kernel,
                                           as_batch, batch_factors, check_dt, check_factors,
                                           check_storage, pack_fleet, packed_batch, per_sim,
                                           ptr, stream, unpack_fleet)
from tpufluid_torch.ops.quant import rgb9e5_pack, rgb9e5_unpack
from tpufluid_torch.ops.sampling import bilinear_taps
from tpufluid_torch.ops.splat import splat_bump

_REPLACES = "tpufluid/ops/pallas/advect.py:301, tpufluid/ops/pallas/advect_hbm.py:108"
ADVECT = Kernel("advect", "advect", "fluid_advect",
                [P, I, I, P, P, I, I, I, I, F, F, P, I, I, P], replaces=_REPLACES)
ADVECT_DYE = Kernel("advect_dye", "advect", "fluid_advect_dye",
                    [P, I, I, I, P, P, I, I, I, I, F, F, P, P, P, P, I, I, I, I, P],
                    replaces=_REPLACES)

# advect_dye's target tile (rows, columns) and its shared-memory budget in
# bytes (csrc/advect.cu kDyeTileH, kDyeTileW, kDyeSmem); the most splat
# rows it takes, whose list and amt may fill half the budget.
DYE_TILE = (32, 32)
DYE_SMEM = 24 * 1024
DYE_MAX_SPLAT_ROWS = DYE_SMEM // (2 * 4 * (1 + 3))


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


def _check_dye_storage(velocity: torch.Tensor, source: torch.Tensor, packed: bool):
    """(velocity's, source's storage code) of a dye call: both CUDA and
    contiguous on one device, the source in a storage type, the velocity
    in the same or, beside a 16-bit source in the batched layout, float32."""
    if velocity.dtype == source.dtype or packed:
        code = check_storage(velocity, source)
        return code, code
    if velocity.dtype != torch.float32:
        raise ValueError(f"a dye of {source.dtype} takes a velocity of its storage type or "
                         f"float32, got {velocity.dtype}")
    code = check_storage(source)
    if not velocity.is_cuda or not velocity.is_contiguous() \
            or velocity.device != source.device:
        raise ValueError("the velocity must be contiguous on the dye's CUDA device")
    return STORAGE_CODES[torch.float32], code


def _launch(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float, quant,
            sim_w):
    """(vel, src, single, fields, (B, C, H, W, hv, wv), dt, dts, decay, out)
    of a launch on one sim, a batch or a packed fleet: the fields as the
    kernels take them, the scalar dt and the dt table's pointer
    (build.check_dt), the scalar dt's decay (a table carries each sim's),
    and the output, in the source's storage type."""
    if sim_w is not None:
        b = _check_packed(velocity, source, quant, sim_w)
        vel, src, single, fields = velocity, source, False, PACKED
        dims = (b, source.shape[0], source.shape[1], sim_w, source.shape[1], sim_w)
    else:
        vel, src, single = _check(velocity, source, quant)
        dims, fields = (*src.shape, *vel.shape[2:]), BATCHED
    dt, dts = check_dt(dt, dims[0], src.device)
    decay = float(decay_factor(dissipation, dt)) if dts.value is None else 0.0
    return vel, src, single, fields, dims, dt, dts, decay, torch.empty_like(src)


def _gather(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
            sim_w=None) -> torch.Tensor:
    """The velocity's gather on the card: ``source`` from its planes, no
    bump, no quantization."""
    code = check_storage(velocity, source)
    vel, src, single, fields, (b, c, h, w, hv, wv), dt, dts, decay, out = _launch(
        velocity, source, dt, dissipation, None, sim_w)
    ADVECT(ptr(vel), hv, wv, ptr(src), ptr(out), b, c, h, w, dt, decay, dts, fields, code,
           stream(src))
    return out[0] if single else out


def _advect_dye(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
                splat_factors, quant, sim_w=None) -> torch.Tensor:
    """advect_dye on the card: one launch for the sim, the batch or the
    packed fleet."""
    vcode, code = _check_dye_storage(velocity, source, sim_w is not None)
    vel, src, single, fields, (b, c, h, w, hv, wv), dt, dts, decay, out = _launch(
        velocity, source, dt, dissipation, quant, sim_w)
    gy, gx, amt, s = check_factors(batch_factors(splat_factors, single), src.device, b, h, w, c)
    if 8 * s * (1 + c) > DYE_SMEM:
        raise ValueError(f"advect_dye takes at most {DYE_MAX_SPLAT_ROWS} splat rows, got {s}")
    if max(h, w) > 65535:
        raise ValueError(f"advect_dye takes grids of at most 65535 texels a side, got {h}x{w}")
    ADVECT_DYE(ptr(vel), hv, wv, vcode, ptr(src), ptr(out), b, c, h, w, dt, decay, dts,
               ptr(gy), ptr(gx), ptr(amt), s, 1 if quant else 0, fields, code, stream(src))
    return out[0] if single else out


def advect(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
           splat_factors=None, quant=None, sim_w=None) -> torch.Tensor:
    """Advect ``source`` (C, H, W) through ``velocity`` (2, Hs, Ws) on the
    card, a batch (B, C, H, W) through (B, 2, Hs, Ws), or a packed fleet of
    sims ``sim_w`` wide (C, H, B*sim_w) through (2, H, B*sim_w): advect_dye
    where there are splat factors or a quantization, else the gather."""
    if splat_factors is not None or quant:
        return _advect_dye(velocity, source, dt, dissipation, splat_factors, quant, sim_w)
    return _gather(velocity, source, dt, dissipation, sim_w)


def _advect_sim(velocity, source, dt, dissipation, splat_factors, quant):
    if splat_factors is not None:
        source = (source.to(torch.float32) + splat_bump(*splat_factors)).to(source.dtype)
    return plain_advect(velocity, source, dt, dissipation, quant=quant)


def advect_plain(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation: float,
                 splat_factors=None, quant=None, sim_w=None) -> torch.Tensor:
    """Plain version of advect, same operations and rounding points (the
    velocity, of any float type, taken in float32); a batch sim by sim,
    each with its dt (its decay recomputed from ``dissipation`` as the
    table's was); a packed fleet unpacked, run as a batch, packed."""
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
    """Plain version of advect_dye's staging: the bump added in float32 and
    rounded to storage, then packed to RGB9E5 words (H, W) int32 or laid
    out as storage quads (H, W, 4) (channels, then zeros); a batch sim by
    sim; a packed fleet unpacked, prepared as a batch."""
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
    return plain_advect(velocity, src, dt, dissipation).to(out_dtype)


def gather_plain(velocity: torch.Tensor, prepared: torch.Tensor, channels: int, dt,
                 dissipation: float, sim_w=None) -> torch.Tensor:
    """Plain version of advect_dye's gather from prepared texels: decoded to
    float32 (exactly, as the kernel's reads do), sampled, rounded once to
    storage (bf16 for RGB9E5 words); a batch sim by sim; a packed fleet's
    velocity unpacked beside its batched prepared texels, the result
    packed."""
    if sim_w is not None:
        b = packed_batch(velocity, 3, sim_w)
        return pack_fleet(gather_plain(unpack_fleet(velocity, b), prepared, channels, dt,
                                       dissipation))
    return per_sim(_gather_sim, velocity.ndim == 4,
                   (velocity, prepared, channels, dt, dissipation), fields=(0, 1), dt_at=3)


def dye_window_bytes(rows, cols, channels: int, itemsize: int, quant, splat_rows: int,
                     active_rows: int):
    """Shared-memory bytes of advect_dye's window of ``rows`` x ``cols``
    source texels: the list of the sim's active splat rows (those whose amt
    is not all zero) and their amt, 4 * splat_rows * (1 + channels); gy *
    amt of the window's rows and gx of its columns for each active row, in
    float32; its prepared texels (a 4-byte RGB9E5 word, else the storage
    values)."""
    texel = 4 if quant else channels * itemsize
    return (4 * splat_rows * (1 + channels) + 4 * active_rows * (rows * channels + cols)
            + rows * cols * texel)


def _window_plan_sim(velocity, shape, dtype, dt, factors, quant) -> dict:
    c, h, w = shape
    r0, r1, q0, q1, fy, fx = bilinear_taps(h, w, *backtrace(velocity, h, w, dt))
    th, tw = DYE_TILE
    nty, ntx = -(-h // th), -(-w // tw)

    def per_tile(x, reduce, fill):
        pad = torch.full((nty * th, ntx * tw), fill, dtype=x.dtype, device=x.device)
        pad[:h, :w] = x
        return reduce(reduce(pad.reshape(nty, th, ntx, tw), dim=3), dim=1)

    big = h + w + 1
    box = torch.stack([per_tile(r0, torch.amin, big), per_tile(r1, torch.amax, -big),
                       per_tile(q0, torch.amin, big), per_tile(q1, torch.amax, -big)], -1)
    rows, cols = box[..., 1] - box[..., 0] + 1, box[..., 3] - box[..., 2] + 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    splat_rows = 0 if factors is None else factors[2].shape[0]
    active = 0 if factors is None else int((factors[2] != 0).any(dim=1).sum())
    window = dye_window_bytes(rows, cols, c, itemsize, quant, splat_rows, active)
    return {"corners": torch.stack([r0, r1, q0, q1]), "weights": torch.stack([fy, fx]),
            "box": box, "fits": window <= DYE_SMEM}


def dye_window_plan(velocity: torch.Tensor, source: torch.Tensor, dt, dissipation=None,
                    splat_factors=None, quant=None, sim_w=None) -> dict:
    """advect_dye's tiles and windows for advect's arguments (the
    dissipation plays no part), in plain torch:
    ``corners`` (4, H, W) int64, each target texel's clamped corner rows
    r0, r1 and columns q0, q1; ``weights`` (2, H, W) float32, its lerp
    weights fy, fx; ``box`` (ny, nx, 4) int64, each DYE_TILE tile's window
    R0, R1, Q0, Q1 (the bounding box of its texels' corners, clamped to the
    sim's grid); ``fits`` (ny, nx), whether the window and its factors fit
    DYE_SMEM (the others read device memory); ``share``, the share of tiles
    that fit. A batch (or a packed fleet, in its sims' own coordinates)
    gives every tensor a leading B; ``share`` is over all of them."""
    if sim_w is not None:
        b = _check_packed(velocity, source, quant, sim_w)
        velocity, source = unpack_fleet(velocity, b), unpack_fleet(source, b)
    vel, src, single = _check(velocity, source, quant)
    factors = batch_factors(splat_factors, single)
    plans = []
    for k in range(vel.shape[0]):
        d = float(dt[k, 0]) if isinstance(dt, torch.Tensor) else dt
        f = None if factors is None else tuple(t[k] for t in factors)
        plans.append(_window_plan_sim(vel[k], src.shape[1:], src.dtype, d, f, quant))
    out = {key: plans[0][key] if single else torch.stack([p[key] for p in plans])
           for key in plans[0]}
    out["share"] = float(out["fits"].float().mean())
    return out
