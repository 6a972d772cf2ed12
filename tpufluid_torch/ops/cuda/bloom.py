"""The bloom pyramid: the CUDA stage kernel (csrc/bloom.cu) and its plain
PyTorch version.

Counterpart of tpufluid/ops/pallas/bloom.py:91, whose one program runs the
whole chain; here the chain is ops/bloom.pyramid with one kernel launch per
stage (2 * mips: 14 at the demo and 1024x1024 configs). The first down
stage prefilters its source on read. Everything is float32: the render casts
the dye before the base resample, which stays outside the kernel (as on the
TPU) in ops/sampling.resample_bilinear.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpufluid_torch.ops import bloom as B
from tpufluid_torch.ops.cuda.build import F, I, P, Kernel, check_storage, ptr, stream
from tpufluid_torch.ops.sampling import resample_bilinear

BLOOM_BLUR4 = Kernel("bloom_blur4", "bloom", "bloom_blur4",
                     [P, I, I, P, P, I, I, F, F, I, F, F, F, F, I, F, P],
                     replaces="tpufluid/ops/pallas/bloom.py:91")


def _check(src: torch.Tensor, out_hw, dst) -> None:
    if src.ndim != 3 or src.shape[0] != 3:
        raise ValueError(f"bloom source must be (3, H, W), got {tuple(src.shape)}")
    if dst is not None and tuple(dst.shape) != (3,) + tuple(out_hw):
        raise ValueError(f"bloom dst {tuple(dst.shape)} for output {tuple(out_hw)}")


def blur4_stage(src: torch.Tensor, out_hw: Tuple[int, int], dst=None, prefilter=None,
                scale=None) -> torch.Tensor:
    """One stage on the card: ``[dst +] blur4(knee_threshold(src) if prefilter
    else src) [* scale]`` -> (3, out_h, out_w) float32. ``prefilter`` is
    (threshold, soft_knee); the knee's curve and the tap offsets 1/sw, 1/sh
    are computed here in Python doubles and round to float32 at the call,
    as in the plain version."""
    _check(src, out_hw, dst)
    if check_storage(*(t for t in (src, dst) if t is not None)) != 0:
        raise ValueError(f"the bloom kernel takes float32, got {src.dtype}")
    _, sh, sw = src.shape
    oh, ow = out_hw
    out = torch.empty((3, oh, ow), dtype=torch.float32, device=src.device)
    threshold, curve = (prefilter[0], B.knee_curve(*prefilter)) if prefilter else (0.0, (0.0,) * 3)
    BLOOM_BLUR4(ptr(src), sh, sw, ptr(dst), ptr(out), oh, ow, 1.0 / sw, 1.0 / sh,
                1 if prefilter else 0, threshold, *curve, 0 if scale is None else 1,
                0.0 if scale is None else float(scale), stream())
    return out


def blur4_stage_plain(src: torch.Tensor, out_hw: Tuple[int, int], dst=None, prefilter=None,
                      scale=None) -> torch.Tensor:
    """Plain version of blur4_stage, same operations in the same order."""
    _check(src, out_hw, dst)
    return B.blur4_stage(src, out_hw, dst=dst, prefilter=prefilter, scale=scale)


def bloom_pyramid(base: torch.Tensor, mip_sizes: Sequence[Tuple[int, int]], threshold: float,
                  soft_knee: float, intensity: float) -> torch.Tensor:
    """The chain after the base resample, one kernel launch per stage."""
    return B.pyramid(blur4_stage, base, mip_sizes, threshold, soft_knee, intensity)


def bloom_pyramid_plain(base: torch.Tensor, mip_sizes: Sequence[Tuple[int, int]],
                        threshold: float, soft_knee: float, intensity: float) -> torch.Tensor:
    """Plain version of bloom_pyramid: ops/bloom.apply_bloom after its base
    resample."""
    return B.pyramid(blur4_stage_plain, base, mip_sizes, threshold, soft_knee, intensity)


def bloom_chain(dye_rgb: torch.Tensor, base_hw: Tuple[int, int],
                mip_sizes: Sequence[Tuple[int, int]], threshold: float, soft_knee: float,
                intensity: float) -> torch.Tensor:
    """apply_bloom on the card: the base resample in PyTorch ops, then the
    kernel chain; zeros and no launch below 2 mips."""
    if len(mip_sizes) < 2:
        return torch.zeros((3,) + tuple(base_hw), dtype=dye_rgb.dtype, device=dye_rgb.device)
    return bloom_pyramid(resample_bilinear(dye_rgb, base_hw), mip_sizes, threshold,
                         soft_knee, intensity)


bloom_chain_plain = B.apply_bloom
