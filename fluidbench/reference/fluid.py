"""The stable-fluids step of the WebGL reference (script.js step(dt)) in
plain PyTorch, for B independent sims at once.

Order: splat impulses into the velocity; curl; vorticity confinement;
divergence; the pressure's warm start (times PRESSURE) and
PRESSURE_ITERATIONS Jacobi sweeps; the pressure gradient subtracted;
velocity self-advection; splat impulses into the dye; dye advection through
the velocity sampled at the dye's texel centers. Advection divides by
1 + dissipation * dt. Every field holds storage values: ``store`` rounds a
float32 result to the configuration's storage type, after the passes that
write a field (the splat, the confinement and divergence, the solve, the
subtract, each advection). A bfloat16 dye with DYE_RGB9E5 goes through the
shared-exponent RGB9E5 format before it is sampled.

Fields are float32 tensors: velocity (B, 2, H, W), dye (B, 3, Hd, Wd),
pressure (B, H, W). ``dts`` is a (B,) array of each sim's dt.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from fluidbench.reference import geometry
from fluidbench.reference.sampling import centers, div, sample_bilinear

Store = Callable[[torch.Tensor], torch.Tensor]

MAX_RGB9E5 = (511.0 / 512.0) * 65536.0


def storage(dtype_name: str) -> Store:
    """Rounding of a float32 tensor to a storage type, back in float32:
    float32 is exact; float8_e4m3fn saturates at its largest finite value."""
    if dtype_name == "float32":
        return lambda x: x
    dtype = getattr(torch, dtype_name)
    if dtype == torch.float8_e4m3fn:
        big = torch.finfo(dtype).max
        return lambda x: x.clamp(-big, big).to(dtype).to(torch.float32)
    return lambda x: x.to(dtype).to(torch.float32)


def clamped_dts(dts) -> np.ndarray:
    """min(float32(dt), float32(MAX_DT)) of each sim."""
    return np.minimum(np.asarray(dts, np.float32), np.float32(geometry.MAX_DT))


def _per_sim(values: np.ndarray, device, ndim: int) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(device)
    return t.reshape((-1,) + (1,) * (ndim - 1))


def splat_bump(splats: torch.Tensor, h: int, w: int, radius: float, aspect: float,
               cols: slice) -> torch.Tensor:
    """(B, C, h, w): the sum over each sim's splat rows of
    exp(-(dx^2 + dy^2) / radius) times the row's amount (its ``cols``, zero
    where the row is inactive), dx scaled by the aspect. The gaussian is a
    product of a row factor and a column factor; rows add in order."""
    u, v = centers(w, splats.device), centers(h, splats.device)
    px = (u - splats[..., 0, None]) * aspect
    py = v - splats[..., 1, None]
    gx = torch.exp(div(-(px * px), radius))           # (B, S, w)
    gy = torch.exp(div(-(py * py), radius))           # (B, S, h)
    amt = splats[..., cols] * splats[..., 7:8]         # (B, S, C)
    b, s_rows, c = amt.shape
    acc = torch.zeros((b, c, h, w), dtype=torch.float32, device=splats.device)
    for s in range(s_rows):
        acc = acc + (gy[:, None, s, :, None] * amt[:, s, :, None, None]) * gx[:, None, s, None, :]
    return acc


def neighbors(f: torch.Tensor):
    """(L, R, T, B) of (..., H, W) with clamp-to-edge; T is row + 1."""
    L = torch.cat([f[..., :, :1], f[..., :, :-1]], dim=-1)
    R = torch.cat([f[..., :, 1:], f[..., :, -1:]], dim=-1)
    B = torch.cat([f[..., :1, :], f[..., :-1, :]], dim=-2)
    T = torch.cat([f[..., 1:, :], f[..., -1:, :]], dim=-2)
    return L, R, T, B


def curl(vel: torch.Tensor) -> torch.Tensor:
    Lv, Rv, _, _ = neighbors(vel[:, 1])
    _, _, Tu, Bu = neighbors(vel[:, 0])
    return 0.5 * (Rv - Lv - Tu + Bu)


def confine(vel: torch.Tensor, cf: torch.Tensor, strength: float, dt: torch.Tensor):
    """Vorticity confinement: velocity + dt * force, clamped to +/-1000."""
    L, R, T, B = neighbors(cf)
    fx = 0.5 * (torch.abs(T) - torch.abs(B))
    fy = 0.5 * (torch.abs(R) - torch.abs(L))
    inv_len = torch.reciprocal(torch.sqrt(fx * fx + fy * fy) + 1e-4)
    scale = strength * cf * inv_len
    fx = fx * scale
    fy = -(fy * scale)
    out = torch.stack([vel[:, 0] + fx * dt, vel[:, 1] + fy * dt], dim=1)
    return torch.clamp(out, -1000.0, 1000.0)


def divergence(vel: torch.Tensor) -> torch.Tensor:
    """0.5 * (R.x - L.x + T.y - B.y); a tap past a wall reads the negated
    center (the velocity reflects)."""
    u, v = vel[:, 0], vel[:, 1]
    Ru = torch.cat([u[..., 1:], -u[..., -1:]], dim=-1)
    Lu = torch.cat([-u[..., :1], u[..., :-1]], dim=-1)
    Tv = torch.cat([v[..., 1:, :], -v[..., -1:, :]], dim=-2)
    Bv = torch.cat([-v[..., :1, :], v[..., :-1, :]], dim=-2)
    return 0.5 * (Ru - Lu + Tv - Bv)


def jacobi(p: torch.Tensor, d: torch.Tensor, iterations: int) -> torch.Tensor:
    for _ in range(iterations):
        L, R, T, B = neighbors(p)
        p = (L + R + T + B - d) * 0.25
    return p


def subtract_gradient(vel: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The reference's gradient subtract, without the central difference's
    0.5 (script.js gradientSubtractShader)."""
    L, R, T, B = neighbors(p)
    return torch.stack([vel[:, 0] - (R - L), vel[:, 1] - (T - B)], dim=1)


def rgb9e5(rgb: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) through RGB9E5 storage (EXT_texture_shared_exponent):
    channels clamped to [0, MAX]; shared exponent E = floor(log2(max)) + 16,
    at least 0; 9-bit mantissas round(c * 2^(24 - E)), E raised by one
    where the largest rounds to 512; decoded as m * 2^(E - 24)."""
    c = rgb.clamp(0.0, MAX_RGB9E5)
    maxc = c.amax(dim=1, keepdim=True)
    _, ex = torch.frexp(maxc)                 # maxc = m * 2^ex, m in [0.5, 1)
    e = (ex - 1 + 16).clamp(0, 31)
    one = torch.ones_like(maxc)
    m = torch.floor(c * torch.ldexp(one, 24 - e) + 0.5)
    over = m.amax(dim=1, keepdim=True) > 511
    e = torch.where(over, e + 1, e)
    m = torch.floor(c * torch.ldexp(one, 24 - e) + 0.5)
    return m * torch.ldexp(one, e - 24)


def advect(vel: torch.Tensor, src: torch.Tensor, dt: torch.Tensor,
           decay: torch.Tensor) -> torch.Tensor:
    """Semi-Lagrangian advection of ``src`` (B, C, h, w) on its own grid:
    backtrace uv - dt * velocity / sim size, the velocity sampled at the
    target's texel centers where the grids differ, sample, / decay."""
    b, _, h, w = src.shape
    sh, sw = vel.shape[-2:]
    u = centers(w, src.device)[None, :].expand(h, w)
    v = centers(h, src.device)[:, None].expand(h, w)
    u, v = u.expand(b, h, w), v.expand(b, h, w)
    if (sh, sw) == (h, w):
        vu, vv = vel[:, 0], vel[:, 1]
    else:
        vs = sample_bilinear(vel, u, v)
        vu, vv = vs[:, 0], vs[:, 1]
    cu = u - div(dt * vu, float(sw))
    cv = v - div(dt * vv, float(sh))
    return sample_bilinear(src, cu, cv) / decay


def step(fields: Dict[str, torch.Tensor], dts, splats: torch.Tensor, cfg: Dict,
         store: Store, rgb9e5_dye: bool) -> Dict[str, torch.Tensor]:
    """One step of B sims. ``splats`` (B, S, 8): x, y, dx, dy, r, g, b,
    active. Returns new fields; the inputs are not changed."""
    vel, dye, p = fields["velocity"], fields["dye"], fields["pressure"]
    dev = vel.device
    d = clamped_dts(dts)
    dt3 = _per_sim(d, dev, 3)
    vdecay = _per_sim(np.float32(1.0) + np.float32(cfg["VELOCITY_DISSIPATION"]) * d, dev, 4)
    ddecay = _per_sim(np.float32(1.0) + np.float32(cfg["DENSITY_DISSIPATION"]) * d, dev, 4)
    radius, aspect = geometry.splat_radius(cfg), geometry.aspect(cfg)
    splats = splats.to(device=dev, dtype=torch.float32)
    sh, sw = vel.shape[-2:]
    dh, dw = dye.shape[-2:]

    vel = store(vel + splat_bump(splats, sh, sw, radius, aspect, slice(2, 4)))
    conf = confine(vel, curl(vel), cfg["CURL"], dt3)
    vel, dv = store(conf), store(divergence(conf))
    p = store(jacobi(p * cfg["PRESSURE"], dv, cfg["PRESSURE_ITERATIONS"]))
    vel = store(subtract_gradient(vel, p))
    vel = store(advect(vel, vel, dt3, vdecay))
    src = store(dye + splat_bump(splats, dh, dw, radius, aspect, slice(4, 7)))
    if rgb9e5_dye:
        src = rgb9e5(src)
    dye = store(advect(vel, src, dt3, ddecay))
    return {"velocity": vel, "dye": dye, "pressure": p}


def substep_tick(fields, dts: np.ndarray, splats: torch.Tensor, cfg: Dict, store: Store,
                 rgb9e5_dye: bool):
    """K substeps of B sims from a (K, B) dt table: substep 0 with the
    splats; substeps 1 .. K - 1 with none, each sim keeping its fields where
    its dt entry is 0."""
    fields = step(fields, dts[0], splats, cfg, store, rgb9e5_dye)
    zero = torch.zeros_like(splats)
    for k in range(1, dts.shape[0]):
        stepped = step(fields, dts[k], zero, cfg, store, rgb9e5_dye)
        moving = torch.from_numpy(clamped_dts(dts[k]) > 0).to(fields["velocity"].device)
        fields = {f: torch.where(moving.view((-1,) + (1,) * (x.ndim - 1)), x, fields[f])
                  for f, x in stepped.items()}
    return fields
