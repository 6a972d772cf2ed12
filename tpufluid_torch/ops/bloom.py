"""Bloom: soft-knee prefilter + mip pyramid blur (reference applyBloom,
script.js:1350-1394, shaders 614-674). Mirrors ``tpufluid.ops.bloom``.

Pipeline (sizes from FluidConfig.bloom_size / bloom_mip_sizes):
  1. prefilter: dye resampled to the bloom base, soft-knee thresholded
     (curve = (T - knee, 2*knee, 0.25/knee), knee = T*K + 1e-4).
  2. downsample: 4-tap cross blur (taps at +/-1 *source* texel, bilinear,
     averaged) into each successively halved mip.
  3. upsample: the same 4-tap blur, added into the next larger mip.
  4. final: 4-tap blur of mip 0 into the base size, scaled by intensity.

Skipped (zeros) when the chain has < 2 mips (script.js:1351-1352).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpufluid_torch.ops.sampling import resample_bilinear, sample_affine


def knee_curve(threshold: float, soft_knee: float) -> Tuple[float, float, float]:
    """(curve0, curve1, curve2) of the soft knee, computed in Python doubles
    as the JAX package does; each rounds to float32 where it is used."""
    knee = threshold * soft_knee + 1e-4
    return threshold - knee, knee * 2.0, 0.25 / knee


def knee_threshold(c: torch.Tensor, threshold: float, soft_knee: float) -> torch.Tensor:
    """The prefilter's threshold on already-resampled texels (..., 3, H, W)."""
    curve0, curve1, curve2 = knee_curve(threshold, soft_knee)
    br = c.amax(dim=-3)
    rq = (br - curve0).clamp(0.0, curve1)
    rq = curve2 * rq * rq
    scale = torch.maximum(rq, br - threshold) / br.clamp_min(1e-4)
    return c * scale.unsqueeze(-3)


def bloom_prefilter(dye_rgb: torch.Tensor, out_hw: Tuple[int, int],
                    threshold: float, soft_knee: float) -> torch.Tensor:
    """Soft-knee threshold (bloomPrefilterShader, script.js:614-631)."""
    return knee_threshold(resample_bilinear(dye_rgb, out_hw), threshold, soft_knee)


def blur4(src: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """4-tap cross average at +/-1 source texel (bloomBlurShader,
    script.js:633-652): taps at u -/+ 1/sw, then v -/+ 1/sh, summed in that
    order, times 0.25."""
    sh, sw = src.shape[-2], src.shape[-1]
    tx, ty = 1.0 / sw, 1.0 / sh
    s = sample_affine(src, out_hw, ou=-tx)
    s = s + sample_affine(src, out_hw, ou=tx)
    s = s + sample_affine(src, out_hw, ov=-ty)
    s = s + sample_affine(src, out_hw, ov=ty)
    return s * 0.25


def pyramid(stage, base: torch.Tensor, mip_sizes: Sequence[Tuple[int, int]],
            threshold: float, soft_knee: float, intensity: float) -> torch.Tensor:
    """The chain after the base resample, as 2 * len(mip_sizes) calls of
    ``stage(src, out_hw, dst=None, prefilter=None, scale=None)``, which
    returns ``[dst +] blur4(knee_threshold(src) if prefilter else src) [* scale]``.
    The first down stage prefilters its source on read."""
    knee = (threshold, soft_knee)
    last = base
    mips = []
    for k, (mw, mh) in enumerate(mip_sizes):
        last = stage(last, (mh, mw), prefilter=knee if k == 0 else None)
        mips.append(last)
    for i in range(len(mips) - 2, -1, -1):
        mips[i] = stage(last, tuple(mips[i].shape[-2:]), dst=mips[i])
        last = mips[i]
    return stage(last, tuple(base.shape[-2:]), scale=intensity)


def blur4_stage(src: torch.Tensor, out_hw: Tuple[int, int], dst=None, prefilter=None,
                scale=None) -> torch.Tensor:
    """One stage of the chain in plain ops (see ``pyramid``)."""
    if prefilter is not None:
        src = knee_threshold(src, *prefilter)
    s = blur4(src, out_hw)
    if dst is not None:
        s = dst + s
    if scale is not None:
        s = s * scale
    return s


def apply_bloom(dye_rgb: torch.Tensor, base_hw: Tuple[int, int],
                mip_sizes: Sequence[Tuple[int, int]], threshold: float,
                soft_knee: float, intensity: float) -> torch.Tensor:
    """Full bloom chain (..., 3, H, W) -> (..., 3, base_h, base_w), or zeros
    when < 2 mips."""
    if len(mip_sizes) < 2:
        return torch.zeros(dye_rgb.shape[:-3] + (3,) + tuple(base_hw), dtype=dye_rgb.dtype,
                           device=dye_rgb.device)
    base = resample_bilinear(dye_rgb, base_hw)
    return pyramid(blur4_stage, base, mip_sizes, threshold, soft_knee, intensity)
