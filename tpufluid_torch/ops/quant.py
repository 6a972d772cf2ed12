"""Shared-exponent RGB9E5 quantization of the bf16 dye.

The OpenGL/WebGL RGB9E5 format: three 9-bit unsigned mantissas and one
5-bit exponent (bias 15) in one uint32. With ``DYE_RGB9E5`` on (the bf16
default) the dye source goes through this format before it is sampled, so
the port reproduces the JAX package's bf16 step. 9 mantissa bits per channel
beat bf16's 8 for channels within 2^9 of the texel's max; negative dye
clamps to 0. The quantization is re-derived from storage every step and does
not accumulate.

Pure bit math on int32/float32 tensors, exactly the JAX package's
procedure (and the advect kernel's, csrc/advect.cu).
"""

from __future__ import annotations

import torch

# Largest representable value: mantissa 511/512 at shared exponent 31-15=16.
MAX_RGB9E5 = (511.0 / 512.0) * float(1 << 16)  # 65408.0


def _pow2_from_biased(e: torch.Tensor) -> torch.Tensor:
    """float32 2^(e - 127) built from exponent bits (e in [1, 254])."""
    return torch.bitwise_left_shift(e, 23).view(torch.float32)


def rgb9e5_pack(rgb: torch.Tensor) -> torch.Tensor:
    """(3, ...) float -> (...) int32 holding the uint32 bit pattern. Layout:
    m_r bits 0..8, m_g 9..17, m_b 18..26, biased shared exponent E bits
    27..31; channel i is m_i * 2^(E - 24)."""
    r, g, b = (rgb[i].to(torch.float32).clamp(0.0, MAX_RGB9E5) for i in range(3))
    maxc = torch.maximum(r, torch.maximum(g, b)).contiguous()
    # floor(log2(maxc)) from the float32 exponent field (zero maxc gives
    # E = 0 and zero mantissas).
    e = torch.bitwise_right_shift(maxc.view(torch.int32), 23) - 127
    big_e = (e + 16).clamp(0, 31)
    scale = _pow2_from_biased(151 - big_e)  # 2^(24 - E)
    m = [torch.floor(c * scale + 0.5).to(torch.int32) for c in (r, g, b)]
    # Round-up overflow: re-round every mantissa at the bumped exponent.
    over = torch.maximum(m[0], torch.maximum(m[1], m[2])) > 511
    half = scale * 0.5
    m = [torch.where(over, torch.floor(c * half + 0.5).to(torch.int32), mc)
         for c, mc in zip((r, g, b), m)]
    big_e = torch.where(over, big_e + 1, big_e)
    return (m[0] | torch.bitwise_left_shift(m[1], 9)
            | torch.bitwise_left_shift(m[2], 18)
            | torch.bitwise_left_shift(big_e, 27))


def rgb9e5_unpack(p: torch.Tensor) -> torch.Tensor:
    """(...) int32 bit pattern -> (3, ...) float32."""
    mask = 0x1FF
    m_r = (p & mask).to(torch.float32)
    m_g = (torch.bitwise_right_shift(p, 9) & mask).to(torch.float32)
    m_b = (torch.bitwise_right_shift(p, 18) & mask).to(torch.float32)
    big_e = torch.bitwise_right_shift(p, 27) & 0x1F
    scale = _pow2_from_biased(big_e + 103)  # 2^(E - 24)
    return torch.stack([m_r * scale, m_g * scale, m_b * scale])


def rgb9e5_roundtrip(rgb: torch.Tensor) -> torch.Tensor:
    """Quantize a (3, ...) field through RGB9E5 storage (float32 out)."""
    return rgb9e5_unpack(rgb9e5_pack(rgb))
