"""The sunrays: the CUDA kernels (csrc/sunrays.cu) and their plain PyTorch
version.

No TPU kernel: tpufluid/ops/sunrays.py:70 apply_sunrays is jnp ops. The
plain version is ops/sunrays.apply_sunrays itself, which takes a batch's
leading axis as it is. On the card the pass is two launches for one sim or
a batch of B: the march (SUNRAYS), which masks each band of the dye once in
shared memory and writes every tap's sample to a (B, 17, h, w) scratch,
and the blur (SUNRAYS_BLUR), which sums each texel's taps into the rays
and blurs them over shared-memory tiles.

Every stage's corner indices and weights come from ``tables``, built once
per (dye size, sunrays size, device) from ops/sampling.affine_axis_plan,
the plain version's own plans, so the kernels' taps are the plain
version's bit for bit; the march's bands from ``band_bounds``, built from
the same plans.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from tpufluid_torch.ops import sunrays as S
from tpufluid_torch.ops.cuda.build import I, P, Kernel, as_batch, check_storage, ptr, stream
from tpufluid_torch.ops.sampling import affine_axis_plan

SUNRAYS = Kernel("sunrays", "sunrays", "sunrays_march", [P, P, I, I, I, I, I, P, P, P],
                 replaces="none: tpufluid/ops/sunrays.py:70 apply_sunrays, jnp ops")
SUNRAYS_BLUR = Kernel("sunrays_blur", "sunrays", "sunrays_blur", [P, P, I, I, I, I, I, P, P, P],
                      replaces="none: tpufluid/ops/sunrays.py:54 blur_separable, jnp ops")

TAPS = S.SUNRAYS_ITERATIONS + 1     # csrc/sunrays.cu kTaps
HALO = 3                            # csrc/sunrays.cu kHalo
BAND = (16, 256)                    # csrc/sunrays.cu kBandRows, kBandCols
BLUR_OFFSET = 1.33333333            # texels, ops/sunrays.blur_separable
_DECAY_ARRAY = ctypes.c_float * TAPS


def march_maps() -> List[Tuple[float, float]]:
    """(scale, offset) of each of the march's taps, as
    ops/sunrays.sunrays_march computes them: the identity, then step k at
    uv * (1 - k * Density / 16) + 0.5 * k * Density / 16."""
    step = S._DENSITY / S.SUNRAYS_ITERATIONS
    return [(1.0, 0.0)] + [(1.0 - k * step, 0.5 * k * step)
                           for k in range(1, S.SUNRAYS_ITERATIONS + 1)]


def blur_offsets(n: int) -> Tuple[float, float, float]:
    """The offsets of a blur pass's taps along an axis of n texels (center,
    minus, plus), as ops/sunrays.blur_separable computes them."""
    t = BLUR_OFFSET / n
    return (0.0, -t, t)


def decay_weights(weight: float) -> List[float]:
    """decay[k] of each tap k >= 1, float32(0.95^(k-1) * weight) with the
    power taken in doubles as sunrays_march takes it; decay[0] unused."""
    out, decay = [0.0], 1.0
    for _ in range(S.SUNRAYS_ITERATIONS):
        out.append(float(torch.tensor(decay * weight, dtype=torch.float32)))
        decay *= S._DECAY
    return out


@functools.lru_cache(maxsize=16)
def _decay(weight: float):
    return _DECAY_ARRAY(*decay_weights(weight))


def _rows(n_in: int, n_out: int, scale: float, off: float, device) -> torch.Tensor:
    """(n_out, 4) int32: i0, i1 and the float32 bits of 1 - f and f of one
    stage's plan, 1 - f computed as ops/sampling.sample_affine_axis
    computes it."""
    i0, i1, f = affine_axis_plan(n_in, n_out, scale, off, device=device)
    return torch.stack([i0.to(torch.int32), i1.to(torch.int32), (1 - f).view(torch.int32),
                        f.view(torch.int32)], dim=-1)


def _check_reach(rows: torch.Tensor, reach: int) -> None:
    k = torch.arange(rows.shape[0], device=rows.device, dtype=torch.int32)[:, None]
    if int((rows[:, :2] - k).abs().max()) > reach:
        raise ValueError(f"a blur tap reaches past {reach} texels: the kernel's halo is {HALO}")


@functools.lru_cache(maxsize=64)
def _tables(dye_hw: Tuple[int, int], out_hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
    (dh, dw), (h, w) = dye_hw, out_hw
    maps = march_maps()
    parts = [_rows(dw, w, s, o, device) for s, o in maps]
    parts += [_rows(dh, h, s, o, device) for s, o in maps]
    blur_cols = [_rows(w, w, 1.0, o, device) for o in blur_offsets(w)]
    blur_rows = [_rows(h, h, 1.0, o, device) for o in blur_offsets(h)]
    # The column pass's taps and the row pass's identity column stage add
    # up to the halo, and so do the row pass's taps and the column pass's
    # identity row stage.
    for stages in (blur_cols, blur_rows):
        _check_reach(stages[0], 1)
        for t in stages[1:]:
            _check_reach(t, HALO - 1)
    return torch.cat(parts + blur_cols + blur_rows).contiguous()


def tables(dye_hw: Tuple[int, int], out_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """The kernels' tap tables for an (H, W) dye and (h, w) rays, int32
    rows of (i0, i1, bits of 1 - f, bits of f), in csrc/sunrays.cu's order:
    the march's column stages (TAPS x w) and row stages (TAPS x h), then the
    blur's column stages (3 x w) and row stages (3 x h), each group center,
    minus, plus. Cached per geometry and device; callers must not write to
    them."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return _tables(tuple(map(int, dye_hw)), tuple(map(int, out_hw)), dev)


def _bounds(first: torch.Tensor, n_in: int, band: int) -> torch.Tensor:
    """(stages, ceil(n_in / band) + 1) int32: for each stage (a row of
    first corners, which rise with the output index), the first output
    index whose corner lies in each band, and the output size last."""
    n = (n_in + band - 1) // band
    edges = (torch.arange(n + 1, dtype=torch.int32, device=first.device) * band).clamp(max=n_in)
    edges = edges.expand(first.shape[0], -1).contiguous()
    return torch.searchsorted(first.contiguous(), edges).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _band_bounds(dye_hw, out_hw, device) -> torch.Tensor:
    (dh, dw), (h, w) = dye_hw, out_hw
    tab = _tables(dye_hw, out_hw, device)
    cols, rows = tab[:TAPS * w, 0].view(TAPS, w), tab[TAPS * w:TAPS * (w + h), 0].view(TAPS, h)
    if bool((cols[:, 1:] < cols[:, :-1]).any() or (rows[:, 1:] < rows[:, :-1]).any()):
        raise ValueError("a march plan's corners do not rise with the output index")
    return torch.cat([_bounds(rows, dh, BAND[0]).flatten(),
                      _bounds(cols, dw, BAND[1]).flatten()]).contiguous()


def band_bounds(dye_hw: Tuple[int, int], out_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """The march's bands, int32: for each tap, the first output row whose
    first corner row lies in each band of BAND[0] dye rows (and h last),
    TAPS x (row bands + 1); then the same of the columns over bands of
    BAND[1] dye columns, TAPS x (column bands + 1). Cached per geometry
    and device; callers must not write to them."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return _band_bounds(tuple(map(int, dye_hw)), tuple(map(int, out_hw)), dev)


def sunrays(dye: torch.Tensor, out_hw: Tuple[int, int], weight: float) -> torch.Tensor:
    """apply_sunrays on the card: float32 dye (3, H, W) -> rays (h, w), or a
    batch (B, 3, H, W) -> (B, h, w), in two launches, the march and then the
    blur. A refused launch (B past 65535) raises in Kernel."""
    if dye.ndim not in (3, 4) or dye.shape[-3] != 3:
        raise ValueError(f"sunrays dye must be (3, H, W) or (B, 3, H, W), got "
                         f"{tuple(dye.shape)}")
    if check_storage(dye) != 0:
        raise ValueError(f"the sunrays kernels take a float32 dye, got {dye.dtype}")
    b, _, dh, dw = as_batch(dye, 3)[0].shape
    h, w = out_hw
    tab, bounds = tables((dh, dw), (h, w), dye.device), band_bounds((dh, dw), (h, w), dye.device)
    taps = torch.empty((b, TAPS, h, w), dtype=torch.float32, device=dye.device)
    out = torch.empty(dye.shape[:-3] + (h, w), dtype=torch.float32, device=dye.device)
    SUNRAYS(ptr(dye), ptr(taps), b, dh, dw, h, w, ptr(tab), ptr(bounds), stream(dye))
    SUNRAYS_BLUR(ptr(taps), ptr(out), b, dh, dw, h, w, ptr(tab), _decay(float(weight)), stream(dye))
    return out
