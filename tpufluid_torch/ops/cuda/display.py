"""The display composite: the CUDA kernel (csrc/display.cu) and its plain
PyTorch version.

Counterpart of tpufluid/ops/pallas/display.py:262 (display_pallas, and
resample_shade_pallas with compose=False). One launch per frame writes the
premultiplied (C + 1, oh, ow) RGBA, or the shaded (C, oh, ow) center when
compose=False, at any output size. A block owns a TILE of the output and
stages the dye window its taps touch in shared memory; ``window`` gives the
largest such window of a launch from the same axis math. Where that window
does not fit a block (a canvas much smaller than its dye), the kernel's
direct form reads each tap from device memory instead, with the same bits;
``form`` picks one of the two from the shape and the device's limit before
the launch, and each form counts its own launches (DISPLAY, DISPLAY_DIRECT).
The kernel reads the dye in its storage type; the plain version casts it to
float32 first, as the render does.

A batch of B sims is one launch too (tpufluid/batch.py vmaps the TPU
kernel): dye (B, C, H, W), bloom (B, 3, bh, bw), sunrays (B, sh, sw), one
dither tile for every sim, as the JAX package's vmap broadcasts it, ->
(B, C + 1, oh, ow). The plain version runs a batch sim by sim.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from tpufluid_torch.ops import display as D
from tpufluid_torch.ops.cuda.build import (F, I, P, Kernel, as_batch, check_storage, per_sim,
                                           ptr, smem_optin, stream)
from tpufluid_torch.ops.sampling import affine_axis_plan

_ARGS = [P, I, I, I, I, I, P, I, I, I, I, F, F, F, P, I, I, P, I, I, P, I, I, F, F]
DISPLAY = Kernel("display", "display", "display_frame", _ARGS + [I, I, P],
                 replaces="tpufluid/ops/pallas/display.py:262")
DISPLAY_DIRECT = Kernel("display_direct", "display", "display_frame_direct", _ARGS + [P],
                        replaces="tpufluid/ops/pallas/display.py:262")

TILE = (16, 64)          # output rows x columns a block (csrc/display.cu kTileH, kTileW)
# Static shared memory of a block: the tap tables, 2 x 3 x (kTileH + kTileW)
# entries of 12 bytes (csrc/display.cu rows, cols, xrows, xcols).
TABLES_SMEM = 12 * 6 * (TILE[0] + TILE[1])
FORMS = ("staged", "direct")


@functools.lru_cache(maxsize=64)
def window(h: int, w: int, out_h: int, out_w: int, shading: bool) -> Tuple[int, int]:
    """(rows, columns) of the largest dye window a TILE of an (out_h, out_w)
    output reads from an (h, w) dye: over every tile, the lowest corner of
    its first row or column (the center tap, or with shading the -1 texel
    tap) to the highest of its last (the center, or the +1 tap), from the
    plain version's axis plans, which compute the kernel's coordinates."""
    tx, ty, _ = D.shading_constants((out_h, out_w))

    def extent(n_in, n_out, t, off):
        off = off if shading else 0.0
        lo = affine_axis_plan(n_in, n_out, off=-off)[0]
        hi = affine_axis_plan(n_in, n_out, off=off)[1]
        first = torch.arange(0, n_out, t)
        last = (first + t).clamp(max=n_out) - 1
        return int((hi[last] - lo[first]).max()) + 1

    return extent(h, out_h, TILE[0], ty), extent(w, out_w, TILE[1], tx)


def smem_bytes(channels: int, win_h: int, win_w: int, shading: bool, itemsize: int) -> int:
    """Shared memory of a staged block, in bytes (csrc/display.cu
    display_smem_bytes plus TABLES_SMEM): the window in the dye's storage
    type, win_w + 1 columns rounded up to even, padded to 16 bytes; the
    float32 column stage at the tile's columns for every window row; with
    shading the float32 row stage at the tile's rows for every window
    column."""
    pitch = (win_w + 2) & ~1
    staged = (channels * win_h * pitch * itemsize + 15) // 16 * 16 + 4 * channels * win_h * TILE[1]
    if shading:
        staged += 4 * channels * TILE[0] * pitch
    return staged + TABLES_SMEM


def form(channels: int, h: int, w: int, out_h: int, out_w: int, shading: bool, itemsize: int,
         limit: int) -> str:
    """The kernel's form for an (h, w) dye of ``channels`` channels stored
    in ``itemsize`` bytes shown at (out_h, out_w): "staged" where a tile's
    largest window (``window``) and its stages fit ``limit`` bytes of
    shared memory a block (the device's opt-in limit, build.smem_optin),
    else "direct"."""
    win = window(h, w, out_h, out_w, bool(shading))
    return "staged" if smem_bytes(channels, *win, bool(shading), itemsize) <= limit else "direct"


def kernel_of(dye: torch.Tensor, out_hw: Tuple[int, int], shading: bool) -> str:
    """Name of the Kernel that display launches for ``dye`` on the card: by
    ``form`` on a CUDA tensor. A CPU tensor runs the plain version, which
    launches none; its name there is DISPLAY's."""
    if not dye.is_cuda:
        return DISPLAY.name
    c, h, w = dye.shape[-3:]
    chosen = form(c, h, w, *out_hw, shading, dye.element_size(), smem_optin(dye.device))
    return DISPLAY.name if chosen == "staged" else DISPLAY_DIRECT.name


def _check(dye, bloom_tex, sunrays_tex, dither_tex, compose):
    """The extras the display reads, (bloom, sunrays, dither), after
    checking their shapes against the dye's: one sim's (C, H, W) or a
    batch's (B, C, H, W), whose bloom and sunrays lead with the same B."""
    if dye.ndim not in (3, 4) or not 1 <= dye.shape[-3] <= 4:
        raise ValueError(f"dye must be (C <= 4, H, W) or (B, C, H, W), got {tuple(dye.shape)}")
    if not compose:
        return None, None, None
    lead = tuple(dye.shape[:-3])
    if bloom_tex is not None and (tuple(bloom_tex.shape[:-2]) != lead + (3,)
                                  or dye.shape[-3] != 3):
        raise ValueError(f"bloom {tuple(bloom_tex.shape)} needs {lead + (3,)} + (h, w) over "
                         f"3-channel dye {tuple(dye.shape)}")
    for name, t, want in (("sunrays", sunrays_tex, lead), ("dither", dither_tex, ())):
        if t is not None and (t.ndim != len(want) + 2 or tuple(t.shape[:-2]) != want):
            raise ValueError(f"{name} must be {want} + (h, w), got {tuple(t.shape)}")
    return bloom_tex, sunrays_tex, dither_tex if bloom_tex is not None else None


def display(dye: torch.Tensor, out_hw: Tuple[int, int], shading: bool,
            bloom_tex: Optional[torch.Tensor] = None,
            sunrays_tex: Optional[torch.Tensor] = None,
            dither_tex: Optional[torch.Tensor] = None, compose: bool = True,
            force: Optional[str] = None) -> torch.Tensor:
    """The display pass on the card -> float32 (C + 1, oh, ow) premultiplied
    RGBA, or with compose=False the shaded (C, oh, ow) center; for a batch
    (B, C, H, W), (B, C + 1, oh, ow) in one launch, in the form ``form``
    picks from the shape and the device's shared memory, or in ``force``
    ("staged" or "direct", to time or test one form where the other would
    run). A staged window past a block's shared memory, or B past the
    kernel's 65535, is refused by the launch, which raises in Kernel."""
    if force not in (None,) + FORMS:
        raise ValueError(f"force must be one of {FORMS}, got {force!r}")
    bloom, rays, dither = _check(dye, bloom_tex, sunrays_tex, dither_tex, compose)
    code = check_storage(dye)
    extras = [t for t in (bloom, rays, dither) if t is not None]
    if extras and check_storage(*extras) != 0:
        raise ValueError("bloom, sunrays and dither must be float32")
    if extras and extras[0].device != dye.device:
        raise ValueError("display inputs on different devices")
    b, c, h, w = as_batch(dye, 3)[0].shape
    oh, ow = out_hw
    out = torch.empty(dye.shape[:-3] + (c + 1 if compose else c, oh, ow), dtype=torch.float32,
                      device=dye.device)
    tx, ty, nz = D.shading_constants(out_hw)
    bh, bw = bloom.shape[-2:] if bloom is not None else (0, 0)
    sh, sw = rays.shape[-2:] if rays is not None else (0, 0)
    dh, dw = dither.shape if dither is not None else (0, 0)
    args = (ptr(dye), b, c, h, w, code, ptr(out), oh, ow, int(shading), int(compose),
            tx, ty, nz, ptr(bloom), bh, bw, ptr(rays), sh, sw, ptr(dither), dh, dw,
            ow / dw if dw else 0.0, oh / dh if dh else 0.0)
    chosen = force or form(c, h, w, oh, ow, shading, dye.element_size(), smem_optin(dye.device))
    if chosen == "staged":
        DISPLAY(*args, *window(h, w, oh, ow, bool(shading)), stream(dye))
    else:
        DISPLAY_DIRECT(*args, stream(dye))
    return out


def display_plain(dye: torch.Tensor, out_hw: Tuple[int, int], shading: bool,
                  bloom_tex: Optional[torch.Tensor] = None,
                  sunrays_tex: Optional[torch.Tensor] = None,
                  dither_tex: Optional[torch.Tensor] = None,
                  compose: bool = True) -> torch.Tensor:
    """Plain version of display: ops/display.display_composite (or, with
    compose=False, shaded_base) on the dye cast to float32; a batch sim by
    sim, with the one dither."""
    bloom, rays, dither = _check(dye, bloom_tex, sunrays_tex, dither_tex, compose)
    return per_sim(_display_plain, dye.ndim == 4, (dye, out_hw, shading, bloom, rays, dither,
                                                   compose), fields=(0, 3, 4))


def _display_plain(dye, out_hw, shading, bloom, rays, dither, compose):
    dye = dye.to(torch.float32)
    if not compose:
        return D.shaded_base(dye, out_hw, shading)
    return D.display_composite(dye, out_hw, shading, bloom, rays, dither)
