"""The bloom pyramid: the CUDA kernel (csrc/bloom.cu) and its plain PyTorch
version.

Counterpart of tpufluid/ops/pallas/bloom.py:91, whose one program runs the
whole chain. Here too the chain after the base resample is one launch, a
cooperative one: the large levels run grid-wide with a grid barrier after
each stage, every level of at most SMALL_TEXELS texels and all below it run
in one block's shared memory (``stage_plan``). Everything is float32: the
render casts the dye before the base resample, which stays outside the
kernel (as on the TPU) in ops/sampling.resample_bilinear.

A batch of B sims, (B, 3, bh, bw), is one launch as well (tpufluid/batch.py
vmaps the TPU kernel): the grid-wide stages stride over every sim's texels,
and in the block phase each block takes whole sims in turn. The plain
version runs a batch sim by sim.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from tpufluid_torch.ops import bloom as B
from tpufluid_torch.ops.cuda.build import (F, I, P, Kernel, as_batch, check_storage, per_sim,
                                           ptr, stream)
from tpufluid_torch.ops.sampling import resample_bilinear
from tpufluid_torch.spans import span

BLOOM_PYRAMID = Kernel("bloom_pyramid", "bloom", "bloom_pyramid",
                       [P, I, I, I, P, P, P, I, I, F, F, F, F, F, P],
                       replaces="tpufluid/ops/pallas/bloom.py:91")

# A level of at most this many texels, and every level below it, runs in
# one block, a sim at a time: at both main-path configs m3 (16x28, 16x16)
# and below.
SMALL_TEXELS = 512
MAX_MIPS = 24          # csrc/bloom.cu kMaxMips


def small_level(level_hw: Sequence[Tuple[int, int]], small_texels: int = SMALL_TEXELS) -> int:
    """Index of the first level (m0 first, (h, w) each) of at most
    ``small_texels`` texels: it and every level below it run in one block.
    len(level_hw) when none is that small."""
    for k, (h, w) in enumerate(level_hw):
        if h * w <= small_texels:
            return k
    return len(level_hw)


def stage_plan(n: int, small: int) -> List[Tuple[str, List[Tuple[str, int]]]]:
    """The kernel's phases for n mips with levels >= small in one block:
    ("grid", [stage]) or ("block", [stages]), in order, each stage
    ("down", k) m{k-1} -> m_k (the base for k = 0), ("up", k) m_k +=
    blur(m{k+1}) or ("final", -1) m0 -> the output. A grid barrier follows
    every phase but the last."""
    grid_down, grid_up = min(small, n), min(small, n - 1)
    phases = [("grid", [("down", k)]) for k in range(grid_down)]
    block = [("down", k) for k in range(grid_down, n)]
    block += [("up", k) for k in range(n - 2, grid_up - 1, -1)]
    if block:
        phases.append(("block", block))
    phases += [("grid", [("up", k)]) for k in range(grid_up - 1, -1, -1)]
    return phases + [("grid", [("final", -1)])]


@functools.lru_cache(maxsize=64)
def _sizes(level_hw: Tuple[Tuple[int, int], ...]):
    return (ctypes.c_int * (2 * len(level_hw)))(*(v for hw in level_hw for v in hw))


def _check(base: torch.Tensor, mip_sizes) -> Tuple[Tuple[int, int], ...]:
    if base.ndim not in (3, 4) or base.shape[-3] != 3:
        raise ValueError(f"bloom base must be (3, H, W) or (B, 3, H, W), got "
                         f"{tuple(base.shape)}")
    if not 2 <= len(mip_sizes) <= MAX_MIPS:
        raise ValueError(f"the bloom kernel takes 2..{MAX_MIPS} mips, got {len(mip_sizes)}")
    return tuple((int(mh), int(mw)) for mw, mh in mip_sizes)


def bloom_pyramid(base: torch.Tensor, mip_sizes: Sequence[Tuple[int, int]], threshold: float,
                  soft_knee: float, intensity: float) -> torch.Tensor:
    """The chain after the base resample on the card, one launch:
    (3, bh, bw) float32 base -> (3, bh, bw) float32 bloom, or a batch
    (B, 3, bh, bw) -> (B, 3, bh, bw). ``mip_sizes`` are (w, h) pairs as
    FluidConfig.bloom_mip_sizes gives them. The knee's curve is computed here
    in Python doubles and rounds to float32 at the call, as in the plain
    version. A refused launch (B past the kernel's 65535, a grid larger than
    the card holds at once) raises in Kernel."""
    level_hw = _check(base, mip_sizes)
    if check_storage(base) != 0:
        raise ValueError(f"the bloom kernel takes float32, got {base.dtype}")
    small = small_level(level_hw)
    b, _, bh, bw = as_batch(base, 3)[0].shape
    mips = torch.empty(b * 3 * sum(h * w for h, w in level_hw), dtype=torch.float32,
                       device=base.device)
    out = torch.empty_like(base)
    BLOOM_PYRAMID(ptr(base), b, bh, bw, ptr(mips), ptr(out), _sizes(level_hw), len(level_hw),
                  small, threshold, *B.knee_curve(threshold, soft_knee), intensity, stream(base))
    return out


def bloom_pyramid_plain(base: torch.Tensor, mip_sizes: Sequence[Tuple[int, int]],
                        threshold: float, soft_knee: float, intensity: float) -> torch.Tensor:
    """Plain version of bloom_pyramid: ops/bloom.apply_bloom after its base
    resample, one plain stage at a time; a batch sim by sim."""
    _check(base, mip_sizes)
    return per_sim(functools.partial(B.pyramid, B.blur4_stage), base.ndim == 4,
                   (base, mip_sizes, threshold, soft_knee, intensity))


def bloom_chain(dye_rgb: torch.Tensor, base_hw: Tuple[int, int],
                mip_sizes: Sequence[Tuple[int, int]], threshold: float, soft_knee: float,
                intensity: float) -> torch.Tensor:
    """apply_bloom on the card, of one sim or a batch: the base resample in
    PyTorch ops, then the pyramid kernel; zeros and no launch below 2 mips."""
    if len(mip_sizes) < 2:
        with span("bloom_pyramid"):
            return B.apply_bloom(dye_rgb, base_hw, mip_sizes, threshold, soft_knee, intensity)
    with span("bloom_resample"):
        base = resample_bilinear(dye_rgb, base_hw)
    with span("bloom_pyramid"):
        return bloom_pyramid(base, mip_sizes, threshold, soft_knee, intensity)


def bloom_chain_plain(dye_rgb: torch.Tensor, base_hw: Tuple[int, int],
                      mip_sizes: Sequence[Tuple[int, int]], threshold: float,
                      soft_knee: float, intensity: float) -> torch.Tensor:
    """Plain version of bloom_chain: ops/bloom.apply_bloom, a batch's
    pyramid sim by sim after its base resample."""
    if len(mip_sizes) < 2:
        with span("bloom_pyramid"):
            return B.apply_bloom(dye_rgb, base_hw, mip_sizes, threshold, soft_knee, intensity)
    with span("bloom_resample"):
        base = resample_bilinear(dye_rgb, base_hw)
    with span("bloom_pyramid"):
        return bloom_pyramid_plain(base, mip_sizes, threshold, soft_knee, intensity)
