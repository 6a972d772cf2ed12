"""The display composite: the CUDA kernel (csrc/display.cu) and its plain
PyTorch version.

Counterpart of tpufluid/ops/pallas/display.py:262 (display_pallas, and
resample_shade_pallas with compose=False). One launch per frame writes the
premultiplied (C + 1, oh, ow) RGBA, or the shaded (C, oh, ow) center when
compose=False, at any output size. A block owns a TILE of the output and
stages the dye window its taps touch in shared memory; ``window`` gives the
largest such window of a launch from the same axis math. The kernel reads
the dye in its storage type; the plain version casts it to float32 first,
as the render does.

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
                                           ptr, stream)
from tpufluid_torch.ops.sampling import affine_axis_plan

DISPLAY = Kernel("display", "display", "display_frame",
                 [P, I, I, I, I, I, P, I, I, I, I, F, F, F, P, I, I, P, I, I, P, I, I, F, F, I,
                  I, P],
                 replaces="tpufluid/ops/pallas/display.py:262")

TILE = (16, 64)          # output rows x columns a block (csrc/display.cu kTileH, kTileW)


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
            dither_tex: Optional[torch.Tensor] = None, compose: bool = True) -> torch.Tensor:
    """The display pass on the card -> float32 (C + 1, oh, ow) premultiplied
    RGBA, or with compose=False the shaded (C, oh, ow) center; for a batch
    (B, C, H, W), (B, C + 1, oh, ow) in one launch. A window past the shared
    memory a block may have, or B past the kernel's 65535, is refused by the
    launch, which raises in Kernel."""
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
    win = window(h, w, oh, ow, bool(shading))
    bh, bw = bloom.shape[-2:] if bloom is not None else (0, 0)
    sh, sw = rays.shape[-2:] if rays is not None else (0, 0)
    dh, dw = dither.shape if dither is not None else (0, 0)
    DISPLAY(ptr(dye), b, c, h, w, code, ptr(out), oh, ow, int(shading), int(compose),
            tx, ty, nz, ptr(bloom), bh, bw, ptr(rays), sh, sw, ptr(dither), dh, dw,
            ow / dw if dw else 0.0, oh / dh if dh else 0.0, *win, stream())
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
