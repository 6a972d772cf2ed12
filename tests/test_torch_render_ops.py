"""The port's render ops and the plain versions of its render kernels
against their JAX counterparts, on the CPU, with inputs made by numpy from a
seed.

Tolerance, float32 throughout (the render computes in float32 for every
storage dtype): the port repeats the JAX package's operations in its order,
so results differ only where the two libraries' CPU kernels round a library
function differently (pow, sqrt) or XLA contracts a multiply-add; 1e-5
absolute and relative covers that with room. The Pallas kernels run in
interpret mode, patched as tests/test_pallas.py does; they sum in other
orders (hat-matrix products in the bloom, a row-first dither), still within
1e-5. The plans' corner indices are integers and must agree exactly.
"""

import functools
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufluid import FluidConfig as JaxConfig
from tpufluid.ops import bloom as jbloom
from tpufluid.ops import display as jdisplay
from tpufluid.ops import sampling as jsampling
from tpufluid.ops import sunrays as jsunrays
from tpufluid_torch.ops import bloom as tbloom
from tpufluid_torch.ops import display as tdisplay
from tpufluid_torch.ops import sampling as tsampling
from tpufluid_torch.ops import sunrays as tsunrays
from tpufluid_torch.ops.cuda import bloom as kbloom
from tpufluid_torch.ops.cuda import display as kdisplay

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _jax(fn, *args, **kwargs):
    """fn(*args, **kwargs) through jax.jit, every argument but the arrays
    static: eager jnp ops compile one by one and take seconds. Only for the
    bloom and sunrays chains, where XLA's rewrites of the coordinate math
    under jit (a multiply by the reciprocal, a fused multiply-add) stay
    within 1e-5; the sampling and display tests call JAX eagerly, the jnp
    semantics the port mirrors."""
    static = tuple(i for i, a in enumerate(args) if not isinstance(a, (np.ndarray, jax.Array)))
    return jax.jit(functools.partial(fn, **kwargs), static_argnums=static)(*args)


def _interp(module):
    orig = module.pl.pallas_call
    return mock.patch.object(module.pl, "pallas_call",
                             lambda *a, **k: orig(*a, interpret=True, **k))


def _rand(rng, shape, scale=1.0):
    return (rng.random(shape) * scale).astype(np.float32)


PLANS = [  # (n_in, n_out, scale, off, wrap)
    (100, 37, 1.0, 0.0, False),           # downsample
    (37, 100, 1.0, -1.0 / 37, False),     # upsample, a -1 source texel tap
    (455, 1280, 1.0, 1.0 / 1280, False),  # the demo display's +tx shading tap
    (64, 910, 910 / 64, 0.0, True),       # the dither at the capture width
    (64, 360, 360 / 64, 0.0, True),
    (348, 348, 1 - 7 * 0.3 / 16, 0.5 * 7 * 0.3 / 16, False),  # a sunrays step
    (64, 100, 1.0, -0.02, True),          # REPEAT below 0: corner -2 wraps to 62
]


@pytest.mark.parametrize("n_in,n_out,scale,off,wrap", PLANS)
def test_affine_axis_plan_matches_jax(n_in, n_out, scale, off, wrap):
    got = tsampling.affine_axis_plan(n_in, n_out, scale, off, wrap)
    want = jsampling.affine_axis_plan(n_in, n_out, scale, off, wrap)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(got[2], want[2])
    if wrap:  # REPEAT is floor modulo (torch.remainder), never C's negative %
        assert 0 <= int(got[0].min()) and int(got[1].max()) < n_in
    if off < 0 and wrap:
        assert int(got[0][0]) == n_in - 2 and int(got[1][0]) == n_in - 1


@pytest.mark.parametrize("axis", [-1, -2])
def test_sample_affine_axis_matches_jax(axis, rng):
    tex = _rand(rng, (3, 41, 67))
    for n_out, scale, off, wrap in ((29, 1.0, 0.0, False), (90, 1.0, 1 / 90, False),
                                    (50, 1.7, -0.1, True)):
        got = tsampling.sample_affine_axis(torch.from_numpy(tex), n_out, axis, scale, off, wrap)
        want = jsampling.sample_affine_axis(jnp.asarray(tex), n_out, axis, scale, off, wrap)
        assert got.shape == want.shape
        _close(got, want)


def test_sample_affine_matches_jax(rng):
    tex = _rand(rng, (3, 33, 58))
    for kw in (dict(), dict(ou=-1 / 58), dict(ov=1 / 33),
               dict(su=0.9, ou=0.05, sv=0.9, ov=0.05), dict(su=3.1, sv=2.2, wrap=True)):
        got = tsampling.sample_affine(torch.from_numpy(tex), (45, 70), **kw)
        want = jsampling.sample_affine(jnp.asarray(tex), (45, 70), **kw)
        _close(got, want, err_msg=str(kw))
    got = tsampling.sample_affine(torch.from_numpy(tex[0]), (20, 30))  # a 2-D texture
    _close(got, jsampling.sample_affine(jnp.asarray(tex[0]), (20, 30)))


def test_sample_bilinear_repeat_matches_jax(rng):
    tex = _rand(rng, (2, 16, 24))
    u = (rng.random((9, 13)) * 3 - 1).astype(np.float32)
    v = (rng.random((9, 13)) * 3 - 1).astype(np.float32)
    got = tsampling.sample_bilinear_repeat(torch.from_numpy(tex), torch.from_numpy(u),
                                           torch.from_numpy(v))
    want = jsampling.sample_bilinear_repeat(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))
    _close(got, want)


def test_bloom_ops_match_jax(rng):
    dye = _rand(rng, (3, 60, 100), 2.0)
    t, j = torch.from_numpy(dye), jnp.asarray(dye)
    _close(tbloom.bloom_prefilter(t, (24, 43), 0.6, 0.7),
           _jax(jbloom.bloom_prefilter, j, (24, 43), 0.6, 0.7))
    for out_hw in ((12, 21), (47, 90)):  # down and up
        _close(tbloom.blur4(t, out_hw), _jax(jbloom.blur4, j, out_hw))
    mips = ((21, 12), (10, 6), (5, 3))
    _close(tbloom.apply_bloom(t, (24, 43), mips, 0.6, 0.7, 0.8),
           _jax(jbloom.apply_bloom, j, (24, 43), mips, 0.6, 0.7, 0.8))
    zero = tbloom.apply_bloom(t, (24, 43), ((21, 12),), 0.6, 0.7, 0.8)
    assert zero.shape == (3, 24, 43) and not zero.any()


def test_sunrays_ops_match_jax(rng):
    dye = _rand(rng, (3, 50, 90), 0.1)  # dark enough that the mask varies
    t, j = torch.from_numpy(dye), jnp.asarray(dye)
    mask_t, mask_j = tsunrays.sunrays_mask(t), _jax(jsunrays.sunrays_mask, j)
    _close(mask_t, mask_j)
    _close(tsunrays.sunrays_march(mask_t, (20, 36), 1.0),
           _jax(jsunrays.sunrays_march, mask_j, (20, 36), 1.0))
    rays = _rand(rng, (20, 36))
    _close(tsunrays.blur_separable(torch.from_numpy(rays)),
           _jax(jsunrays.blur_separable, jnp.asarray(rays)))
    _close(tsunrays.apply_sunrays(t, (20, 36), 0.8), _jax(jsunrays.apply_sunrays, j, (20, 36), 0.8))


def test_display_ops_match_jax(rng):
    c = (rng.random(200) * 3 - 0.5).astype(np.float32)
    _close(tdisplay.linear_to_gamma(torch.from_numpy(c)), jdisplay.linear_to_gamma(jnp.asarray(c)))
    dye = _rand(rng, (3, 50, 77), 1.5)
    for shading in (True, False):
        _close(tdisplay.shaded_base(torch.from_numpy(dye), (36, 61), shading),
               jdisplay.shaded_base(jnp.asarray(dye), (36, 61), shading))
    _close(tdisplay.checkerboard((30, 50), 1.7), jdisplay.checkerboard((30, 50), 1.7))
    src, dst = _rand(rng, (4, 5, 6)), _rand(rng, (4, 5, 6))
    _close(tdisplay.blend_premultiplied(torch.from_numpy(src), torch.from_numpy(dst)),
           jdisplay.blend_premultiplied(jnp.asarray(src), jnp.asarray(dst)))


def _display_inputs(rng):
    """The shapes of tests/test_pallas.py's composite test: dye (3, 100, 171),
    bloom (3, 44, 57), sunrays (42, 43), the blue-noise dither."""
    from tpufluid.utils.bluenoise import blue_noise_64

    return (_rand(rng, (3, 100, 171)), _rand(rng, (3, 44, 57), 2.0),
            _rand(rng, (42, 43)), blue_noise_64())


def _pick(on, a):
    return a if on else None


VARIANTS = [  # (shading, bloom, sunrays, dither), those of tests/test_pallas.py
    (True, True, True, True), (True, True, False, True), (False, False, True, False),
    (True, True, True, False), (False, False, False, False)]


def test_display_plain_matches_jax_composite(rng):
    """The display kernel's plain version == ops.display.display_composite
    at a width that is not a multiple of 128 (the TPU kernel's limit)."""
    out_hw = (37, 200)
    dye, bloom, rays, dither = _display_inputs(rng)
    for shading, bl, sr, di in VARIANTS:
        got = kdisplay.display_plain(
            torch.from_numpy(dye), out_hw, shading, _pick(bl, torch.from_numpy(bloom)),
            _pick(sr, torch.from_numpy(rays)), _pick(di, torch.from_numpy(dither)))
        want = jdisplay.display_composite(
            jnp.asarray(dye), out_hw, shading, _pick(bl, jnp.asarray(bloom)),
            _pick(sr, jnp.asarray(rays)), _pick(di, jnp.asarray(dither)))
        assert got.shape == (4,) + out_hw
        _close(got, want, err_msg=str((shading, bl, sr, di)))


def test_display_plain_matches_pallas_interpret(rng):
    """Against the TPU kernel itself, display_pallas in interpret mode."""
    import tpufluid.ops.pallas.display as pdl

    dye, bloom, rays, dither = _display_inputs(rng)
    for shading, bl, sr, di in (VARIANTS[0], VARIANTS[2]):
        got = kdisplay.display_plain(
            torch.from_numpy(dye), (48, 256), shading, _pick(bl, torch.from_numpy(bloom)),
            _pick(sr, torch.from_numpy(rays)), _pick(di, torch.from_numpy(dither)))
        with _interp(pdl):
            want = pdl.display_pallas(jnp.asarray(dye), (48, 256), shading,
                                      _pick(bl, jnp.asarray(bloom)), _pick(sr, jnp.asarray(rays)),
                                      _pick(di, jnp.asarray(dither)))
        _close(got, want, err_msg=str((shading, bl, sr, di)))


@pytest.mark.parametrize("shape,shading", [((48, 300, 32, 128), True),
                                           ((96, 128, 96, 128), False)])
def test_display_base_plain_matches_pallas_interpret(shape, shading, rng):
    """compose=False against resample_shade_pallas (tests/test_pallas.py's
    shapes: a ragged downsample and the golden config's identity rows)."""
    import tpufluid.ops.pallas.display as pdl

    h, w, oh, ow = shape
    dye = _rand(rng, (3, h, w))
    got = kdisplay.display_plain(torch.from_numpy(dye), (oh, ow), shading, compose=False)
    with _interp(pdl):
        want = pdl.resample_shade_pallas(jnp.asarray(dye), (oh, ow), shading)
    assert got.shape == (3, oh, ow)
    _close(got, want)


def test_display_plain_reads_storage_dtypes(rng):
    """The plain version casts 16-bit dye to float32 first, as the render
    does: a bf16 / f16 dye gives the float32 result of its exact upcast."""
    dye, bloom, rays, dither = _display_inputs(rng)
    args = ((48, 100), True, torch.from_numpy(bloom), torch.from_numpy(rays),
            torch.from_numpy(dither))
    for dtype in (torch.bfloat16, torch.float16):
        low = torch.from_numpy(dye).to(dtype)
        got = kdisplay.display_plain(low, *args)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      kdisplay.display_plain(low.float(), *args).numpy())


def test_bloom_pyramid_plain_matches_pallas_interpret(rng):
    """bloom_pyramid_plain == bloom_pyramid_pallas (interpret mode) on a
    small base of 3 mips, and == ops.bloom.apply_bloom after its resample."""
    import tpufluid.ops.pallas.bloom as pb

    cfg = JaxConfig(BLOOM_RESOLUTION=24, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720).validate()
    bw, bh = cfg.bloom_size
    mips = cfg.bloom_mip_sizes()
    assert len(mips) >= 2 and pb.supported((bh, bw), tuple(mips))
    dye = _rand(rng, (3, 60, 107), 2.0)
    base = _jax(jsampling.resample_bilinear, jnp.asarray(dye), (bh, bw))
    args = (mips, cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE, cfg.BLOOM_INTENSITY)
    got = kbloom.bloom_pyramid_plain(torch.from_numpy(np.array(base)), *args)
    with _interp(pb):
        want = _jax(pb.bloom_pyramid_pallas, base, *args)
    _close(got, want)
    _close(got, _jax(jbloom.apply_bloom, jnp.asarray(dye), (bh, bw), *args))


def test_bloom_stage_plain_matches_jax(rng):
    """Each stage kind of the kernel's chain: the prefiltered first down
    stage, an additive up stage and the scaled final stage."""
    src = torch.from_numpy(_rand(rng, (3, 24, 43), 2.0))
    dst = torch.from_numpy(_rand(rng, (3, 24, 43)))
    j = jnp.asarray(src.numpy())
    _close(tbloom.blur4_stage(src, (12, 21), prefilter=(0.6, 0.7)),
           _jax(jbloom.blur4, _jax(jbloom.bloom_prefilter, j, (24, 43), 0.6, 0.7), (12, 21)))
    _close(tbloom.blur4_stage(src, (24, 43), dst=dst),
           jnp.asarray(dst.numpy()) + _jax(jbloom.blur4, j, (24, 43)))
    _close(tbloom.blur4_stage(src, (48, 86), scale=0.8), _jax(jbloom.blur4, j, (48, 86)) * 0.8)


def test_blue_noise_equals_jax():
    from tpufluid.utils.bluenoise import blue_noise_64 as jax_noise
    from tpufluid_torch.utils.bluenoise import blue_noise_64

    got = blue_noise_64()
    assert got.dtype == np.float32 and got.shape == (64, 64)
    np.testing.assert_array_equal(got, jax_noise())


def test_kernels_refuse_cpu_tensors():
    """On a CPU tensor the wrappers raise: the plain versions run only
    through the dispatch."""
    x = torch.zeros((3, 8, 8))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kbloom.bloom_pyramid(x, ((4, 4), (2, 2)), 0.6, 0.7, 0.8)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kdisplay.display(x, (8, 8), True)


def test_dispatch_routes_cpu_to_plain(rng):
    """On CPU tensors the routed entry points run the plain versions."""
    from tpufluid_torch.ops.cuda import dispatch

    dye, bloom, rays, dither = (torch.from_numpy(a) for a in _display_inputs(rng))
    np.testing.assert_array_equal(
        dispatch.display_full(dye, (30, 50), True, bloom, rays, dither).numpy(),
        kdisplay.display_plain(dye, (30, 50), True, bloom, rays, dither).numpy())
    np.testing.assert_array_equal(dispatch.display_base(dye, (30, 50), False).numpy(),
                                  tdisplay.shaded_base(dye, (30, 50), False).numpy())
    mips = ((21, 12), (10, 6), (5, 3))
    np.testing.assert_array_equal(
        dispatch.bloom_chain(dye, (24, 43), mips, 0.6, 0.7, 0.8).numpy(),
        tbloom.apply_bloom(dye, (24, 43), mips, 0.6, 0.7, 0.8).numpy())
