"""The port's plain ops and the plain versions of its CUDA kernels against
their JAX counterparts, on the CPU, with inputs made by numpy from a seed.

Tolerances:
  * float32: the port repeats the JAX package's operations in its order, so
    the results differ only by what the two libraries' CPU kernels round
    differently (exp, sqrt, the splat sum's order); 1e-5 of the field's
    scale covers that with room, and ~1e-2 would be the first visible error.
  * bfloat16 / float16: the port computes in float32 and rounds to storage
    where the TPU kernels do; it is held against the JAX float32 oracle on
    the upcast inputs with the 16-bit tolerances of tests/test_pallas.py
    (0.02 on a [0, 1] source, 0.02 / 0.05 of the scale for velocity /
    divergence, 0.05 for 12 Jacobi sweeps): a few storage ulps (2^-8 for
    bf16) through one pass.
  * RGB9E5 bits: exact — it is integer bit math on both sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufluid.ops import quant as jquant
from tpufluid.ops import sampling as jsampling
from tpufluid.ops import splat as jsplat
from tpufluid.ops import stencil as jstencil
from tpufluid.ops.advect import advect as jax_advect
from tpufluid.ops.pallas import dispatch as jdispatch
from tpufluid_torch.ops.advect import decay_factor
from tpufluid_torch.ops import quant as tquant
from tpufluid_torch.ops import sampling as tsampling
from tpufluid_torch.ops import splat as tsplat
from tpufluid_torch.ops import stencil as tstencil
from tpufluid_torch.ops.cuda import advect as kadvect
from tpufluid_torch.ops.cuda import jacobi as kjacobi
from tpufluid_torch.ops.cuda import stencil as kstencil

H, W = 48, 72          # sim grid of the tests' config (sim 48, canvas 192x128)
HD, WD = 96, 144       # its dye grid
DT = np.float32(1 / 60)
RADIUS, ASPECT = 0.25 / 100 * 1.5, 1.5
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DTYPES[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _velocity(rng, h=H, w=W):
    return np.clip(rng.standard_normal((2, h, w)) * 400, -1000, 1000).astype(np.float32)


def _splats(rng, n=4):
    s = np.zeros((n, 8), np.float32)
    s[:, 0:2] = rng.random((n, 2))
    s[:, 2:4] = (rng.random((n, 2)) - 0.5) * 1000
    s[:, 4:7] = rng.random((n, 3)) * 1.5
    s[:, 7] = [1, 1, 0, 1][:n]  # one inactive row
    return s


def _factors_both(splats, h, w, cols):
    """(torch factors, jax factors) of one splat batch on an (h, w) grid."""
    t = tsplat.splat_factors(torch.from_numpy(splats), h, w, RADIUS, ASPECT, cols)
    j = jsplat.splat_factors(jnp.asarray(splats), h, w, RADIUS, ASPECT, cols)
    return t, j


# ---------------------------------------------------------------- splats

def test_splat_factors_match(rng):
    splats = _splats(rng)
    for h, w, cols in ((H, W, slice(2, 4)), (HD, WD, slice(4, 7))):
        t, j = _factors_both(splats, h, w, cols)
        for a, b in zip(t, j):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    assert float(t[2][2].abs().max()) == 0.0  # the inactive row is zeroed


def test_splat_bump_matches_einsum(rng):
    (gy, gx, amt), (jgy, jgx, jamt) = _factors_both(_splats(rng), HD, WD, slice(4, 7))
    want = jnp.einsum("sc,hs,sw->chw", jamt, jgy, jgx,
                      precision=jax.lax.Precision.HIGHEST)
    assert _rel(tsplat.splat_bump(gy, gx, amt), want) < 1e-5


def test_apply_splat_batch_matches(rng):
    vel, dye, splats = _velocity(rng), rng.random((3, HD, WD)), _splats(rng)
    tv, td = tsplat.apply_splat_batch(_t(vel), _t(dye), torch.from_numpy(splats),
                                      RADIUS, ASPECT)
    jv, jd = jsplat.apply_splat_batch(_j(vel), _j(dye), jnp.asarray(splats),
                                      RADIUS, ASPECT)
    assert _rel(tv, jv) < 1e-5 and _rel(td, jd) < 1e-5


# ---------------------------------------------------------------- RGB9E5

def test_rgb9e5_exact(rng):
    rgb = rng.random((3, 64, 64)).astype(np.float32) * 4.0
    rgb[:, 0, :8] = [[0.0, 1e-30, -0.5, 65408.0, 70000.0, 0.99951172, 511.5 / 512, 1.0]] * 3
    rgb[1, 1, :] *= 1e-4  # channels far below the texel max
    packed_t = tquant.rgb9e5_pack(torch.from_numpy(rgb))
    packed_j = jquant.rgb9e5_pack(jnp.asarray(rgb))
    np.testing.assert_array_equal(packed_t.numpy().view(np.uint32),
                                  np.asarray(packed_j))
    np.testing.assert_array_equal(tquant.rgb9e5_roundtrip(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(jquant.rgb9e5_roundtrip(jnp.asarray(rgb))))


# ---------------------------------------------------------------- sampling

def test_sampling_matches(rng):
    tex = rng.standard_normal((3, H, W)).astype(np.float32)
    u = rng.random((HD, WD)).astype(np.float32) * 1.2 - 0.1
    v = rng.random((HD, WD)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_allclose(
        _np(tsampling.sample_bilinear(_t(tex), _t(u), _t(v))),
        _np(jsampling.sample_bilinear(_j(tex), _j(u), _j(v))), rtol=1e-6, atol=1e-6)
    for got, want in zip(tsampling.uv_grid(HD, WD), jsampling.uv_grid(HD, WD)):
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_allclose(
        _np(tsampling.resample_bilinear(_t(tex), (HD, WD))),
        _np(jsampling.resample_bilinear(_j(tex), (HD, WD))), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- stencils

def test_stencil_ops_match(rng):
    vel, p, d = _velocity(rng), rng.standard_normal((H, W)), rng.standard_normal((H, W))
    c_t, c_j = tstencil.curl(_t(vel)), jstencil.curl(_j(vel))
    assert _rel(c_t, c_j) < 1e-6
    assert _rel(tstencil.vorticity_confinement(_t(vel), c_t, 30.0, float(DT)),
                jstencil.vorticity_confinement(_j(vel), c_j, 30.0, DT)) < 1e-5
    assert _rel(tstencil.divergence(_t(vel)), jstencil.divergence(_j(vel))) < 1e-6
    assert _rel(tstencil.jacobi_pressure(_t(p), _t(d), 12),
                jstencil.jacobi_pressure(_j(p), _j(d), 12)) < 1e-6
    assert _rel(tstencil.gradient_subtract(_t(vel), _t(p)),
                jstencil.gradient_subtract(_j(vel), _j(p))) < 1e-6


# Tolerance of the 16-bit kernels' plain versions against the JAX float32
# oracle (see the module docstring), per output.
TOL16 = {"vel": 0.02, "div": 0.05, "jacobi": 0.05, "gs": 0.02, "advect": 0.02}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_pre_pressure_plain_matches(dtype, rng):
    vel, splats = _velocity(rng), _splats(rng)
    (tf, jf) = _factors_both(splats, H, W, slice(2, 4))
    got_v, got_d = kstencil.pre_pressure_plain(_t(vel, dtype), 30.0, float(DT), tf)
    assert got_v.dtype == TORCH_DTYPES[dtype] and got_d.dtype == TORCH_DTYPES[dtype]
    if dtype == "float32":
        want_v, want_d = jdispatch.pre_pressure(_j(vel), 30.0, DT, splat_factors=jf)
        assert _rel(got_v, want_v) < 1e-5
        assert _rel(got_d, want_d) < 1e-5
        return
    # 16-bit: the float32 oracle on the upcast input, bump rounded to storage.
    vb = jdispatch._apply_bump_rounded(_j(vel, dtype), jf).astype(jnp.float32)
    want_v = jstencil.vorticity_confinement(vb, jstencil.curl(vb), 30.0, DT)
    want_d = jstencil.divergence(want_v)
    scale = float(jnp.abs(want_v).max())
    assert float(np.abs(_np(got_v) - _np(want_v)).max()) < TOL16["vel"] * scale
    assert float(np.abs(_np(got_d) - _np(want_d)).max()) < TOL16["div"] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_jacobi_plain_matches(dtype, rng):
    p, d = rng.standard_normal((H, W)), rng.standard_normal((H, W))
    got = kjacobi.jacobi_plain(_t(p, dtype), _t(d, dtype), 12, prescale=0.8)
    assert got.dtype == TORCH_DTYPES[dtype]
    want = jdispatch.jacobi_pressure(_j(p, dtype).astype(jnp.float32),
                                     _j(d, dtype).astype(jnp.float32), 12, prescale=0.8)
    if dtype == "float32":
        assert _rel(got, want) < 1e-6
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL16["jacobi"])
    # iterations=0 is the warm start alone
    np.testing.assert_allclose(_np(kjacobi.jacobi_plain(_t(p), _t(d), 0, prescale=0.8)),
                               np.float32(p) * np.float32(0.8), rtol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_gradient_subtract_plain_matches(dtype, rng):
    vel, p = _velocity(rng), rng.standard_normal((H, W)) * 50
    got = kstencil.gradient_subtract_plain(_t(vel, dtype), _t(p, dtype))
    want = jstencil.gradient_subtract(_j(vel, dtype).astype(jnp.float32),
                                      _j(p, dtype).astype(jnp.float32))
    tol = 1e-6 if dtype == "float32" else TOL16["gs"]
    assert _rel(got, want) < tol


# (source grid, splat bump, quant, dtype); RGB9E5 applies to bfloat16 only.
ADVECT_CASES = [(g, b, None, d) for g in ("same", "cross") for b in (False, True)
                for d in ("float32", "bfloat16", "float16")]
ADVECT_CASES += [("same", True, "rgb9e5", "bfloat16"), ("cross", True, "rgb9e5", "bfloat16")]


@pytest.mark.parametrize("grid,bump,quant,dtype", ADVECT_CASES)
def test_advect_plain_matches(grid, bump, quant, dtype, rng):
    h, w = (H, W) if grid == "same" else (HD, WD)
    vel, src = _velocity(rng), rng.random((3, h, w)).astype(np.float32)
    tf = jf = None
    if bump:
        tf, jf = _factors_both(_splats(rng), h, w, slice(4, 7))
    got = kadvect.advect_plain(_t(vel, dtype), _t(src, dtype), float(DT), 1.0,
                               splat_factors=tf, quant=quant)
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (3, h, w)
    # The JAX oracle: bump added and rounded to storage, then sampled (its
    # jnp fallback of the fused kernels), on the float32-upcast fields.
    jsrc = _j(src, dtype)
    if jf is not None:
        jsrc = jdispatch._apply_bump_rounded(jsrc, jf)
    jsrc = jsrc.astype(jnp.float32)
    if quant:
        jsrc = jquant.rgb9e5_roundtrip(jsrc)
    want = jax_advect(_j(vel, dtype).astype(jnp.float32), jsrc, DT, 1.0)
    if dtype == "float32":
        assert _rel(got, want) < 1e-5
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=TOL16["advect"] * float(np.abs(_np(want)).max()))


def test_advect_velocity_matches_jax_oracle(rng):
    """Self-advection of the velocity (2 channels, dissipation 0.2) against
    the JAX jnp oracle, float32."""
    vel = _velocity(rng)
    got = kadvect.advect_plain(_t(vel), _t(vel), float(DT), 0.2)
    assert _rel(got, jax_advect(_j(vel), _j(vel), DT, 0.2)) < 1e-5
    assert np.float32(decay_factor(0.2, DT)) == np.float32(1) + np.float32(0.2) * DT


def test_dispatch_routes_cpu_to_plain_and_refuses_other_devices(rng):
    """A CPU tensor runs the plain version; a device with neither a kernel
    nor a plain version raises instead of falling back."""
    from tpufluid_torch.ops.cuda import dispatch

    vel, p = _t(_velocity(rng)), _t(rng.standard_normal((H, W)))
    got_v, got_d = dispatch.pre_pressure(vel, 30.0, float(DT))
    want_v, want_d = kstencil.pre_pressure_plain(vel, 30.0, float(DT))
    assert torch.equal(got_v, want_v) and torch.equal(got_d, want_d)
    assert torch.equal(dispatch.jacobi_pressure(p, got_d, 5, prescale=0.8),
                       kjacobi.jacobi_plain(p, got_d, 5, prescale=0.8))
    pp, vp = dispatch.jacobi_project(p, got_d, vel, 5, prescale=0.8)
    assert torch.equal(pp, kjacobi.jacobi_plain(p, got_d, 5, prescale=0.8))
    assert torch.equal(vp, kstencil.gradient_subtract_plain(vel, pp))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dispatch.gradient_subtract(vel.to("meta"), p.to("meta"))
