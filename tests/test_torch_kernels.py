"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one every test
skips with its reason. On the card run
    python -m pytest tests/test_torch_kernels.py -q
chip_smoke.py makes the same comparisons at the main path's full shapes.
Tolerances: tpufluid_torch/ops/cuda/check.py.
"""

import math

import numpy as np
import pytest
import torch

from tpufluid_torch import FluidConfig, init_state, make_multi_step, swirl_trace
from tpufluid_torch.ops import floors as plain_floors
from tpufluid_torch.ops.cuda import (advect, bloom, build, check, display, floors, jacobi, stencil,
                                     sunrays)
from tpufluid_torch.ops.sunrays import apply_sunrays
from tpufluid_torch.ops.splat import splat_factors
from tpufluid_torch.render import make_render, plain_render
from tpufluid_torch.step import plain_step

CONFIGS = {
    # small: the CPU tests' grid; ragged: odd sizes that fill no block evenly
    "small": dict(SIM_RESOLUTION=48, DYE_RESOLUTION=96, CANVAS_WIDTH=192,
                  CANVAS_HEIGHT=128, MAX_SPLATS=4),
    "ragged": dict(SIM_RESOLUTION=37, DYE_RESOLUTION=131, CANVAS_WIDTH=1280,
                   CANVAS_HEIGHT=720, MAX_SPLATS=8),
}


@pytest.fixture
def cuda():
    """The card; skips the test where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("size", sorted(CONFIGS))
@pytest.mark.parametrize("dtype,rgb9e5", [("float32", False), ("bfloat16", True),
                                          ("bfloat16", False), ("float16", False)])
def test_kernels_match_plain(size, dtype, rgb9e5, cuda):
    cfg = FluidConfig(DTYPE=dtype, DYE_RGB9E5=rgb9e5, **CONFIGS[size]).validate()
    state, splats = check.random_state(cfg, seed=11, device=cuda)
    for case in check.step_cases(state, splats, cfg):
        before = build.KERNELS[case.kernel_name].launches
        err, tol = check.compare(case.run(), case.run(plain=True))
        torch.cuda.synchronize()
        assert build.KERNELS[case.kernel_name].launches > before, case.label
        assert err <= tol, (case.label, err, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_step_matches_plain_step(dtype, cuda):
    cfg = FluidConfig(DTYPE=dtype, **CONFIGS["small"]).validate()
    trace = swirl_trace(cfg, 3, seed=3)
    got = make_multi_step(cfg)(init_state(cfg), trace.dts, trace.batches)
    want = init_state(cfg)
    for t in range(3):
        want = plain_step(want, trace.dts[t], trace.batches[t], cfg)
    for g, w in ((got.velocity, want.velocity), (got.dye, want.dye),
                 (got.pressure, want.pressure)):
        w32 = w.float()
        assert float((g.float() - w32).abs().max()) <= 1e-3 * float(w32.abs().max())


K = jacobi.SWEEPS
JACOBI_ITERS = sorted({0, 1, K - 1, K, K + 1, 20, 23})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(5, 7), (100, 300), (37, 66), (128, 228), (530, 1090)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_chunk_matches_plain(shape, dtype, cuda):
    """N sweeps in launches of K (and of 1, 4 and the tiles' most): bit-equal
    to jacobi_plain in ceil(N / K) launches. Grids smaller than one tile, not
    a multiple of it, the ragged config's 37x66 sim grid and the demo's, all
    on the small tiles, and one on the large tiles (143 blocks at K = 10)."""
    gen = np.random.default_rng(shape[0] * 1000 + shape[1])
    p = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    d = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    tiles = jacobi.tiles_for(*shape, jacobi.sm_count(p.device))
    assert tiles == (jacobi.LARGE if shape == (530, 1090) else jacobi.SMALL)
    for n in JACOBI_ITERS:
        want = jacobi.jacobi_plain(p, d, n, 0.8)
        before = jacobi.JACOBI_CHUNK.launches
        got = jacobi.jacobi_pressure(p, d, n, 0.8)
        torch.cuda.synchronize()
        assert jacobi.JACOBI_CHUNK.launches - before == math.ceil(n / K), n
        assert torch.equal(got, want), n
        if n == 0:
            continue
        for k in (1, 4, jacobi.TILES[tiles].max_sweeps()):
            before = jacobi.JACOBI_CHUNK.launches
            got = jacobi.run_chunks(p, d, 0.8, jacobi.chunks(n, k))
            torch.cuda.synchronize()
            assert jacobi.JACOBI_CHUNK.launches - before == math.ceil(n / k)
            err = float((got.float() - want.float()).abs().max())
            assert err == 0.0, (n, k, err)


PROJECT_ITERS = sorted({0, 1, K - 1, K, K + 1, 20, 23})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(5, 7), (100, 300), (37, 66), (128, 228), (530, 1090)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_project_matches_plain(shape, dtype, cuda):
    """The step's solve, its last launch jacobi_project (a halo one cell
    deeper, the pressure rounded to storage before the gradient): the
    pressure and the projected velocity bit-equal to jacobi_plain then
    gradient_subtract_plain, in ceil(N / K) - 1 chunk launches and one
    fused launch (of no sweep for N = 0), on the small tiles and, at
    530x1090, the large ones."""
    gen = np.random.default_rng(shape[0] * 1000 + shape[1] + 1)
    p = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    d = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    vel = np.clip(gen.standard_normal((2,) + shape) * 400, -1000, 1000).astype(np.float32)
    v = torch.from_numpy(vel).to(cuda, dtype)
    tiles = jacobi.tiles_for(*shape, jacobi.sm_count(p.device))
    assert tiles == (jacobi.LARGE if shape == (530, 1090) else jacobi.SMALL)
    for n in PROJECT_ITERS:
        want = jacobi.jacobi_project_plain(p, d, v, n, 0.8)
        chunk, fused = jacobi.JACOBI_CHUNK.launches, jacobi.JACOBI_PROJECT.launches
        got = jacobi.jacobi_project(p, d, v, n, 0.8)
        torch.cuda.synchronize()
        assert jacobi.JACOBI_CHUNK.launches - chunk == max(math.ceil(n / K) - 1, 0), n
        assert jacobi.JACOBI_PROJECT.launches - fused == 1, n
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, n
            assert torch.equal(g, w), (n, float((g.float() - w.float()).abs().max()))


def test_refused_project_launch_raises(cuda):
    """The fused launch refuses a halo that leaves no tile and a batch past
    the grid's z axis, and the wrapper raises; a cut the tiles cannot run
    and a velocity off the pressure's grid raise before any launch."""
    from tpufluid_torch.ops.cuda.build import BATCHED, ptr, stream

    p = torch.zeros((64, 64), device=cuda)
    vel = torch.zeros((2, 64, 64), device=cuda)
    top = jacobi.TILES[jacobi.SMALL].max_sweeps(project=True)
    before = jacobi.JACOBI_PROJECT.launches
    for k, b in ((top + 1, 1), (0, 65536)):
        with pytest.raises(RuntimeError, match="jacobi_project failed to launch"):
            jacobi.JACOBI_PROJECT(ptr(p), 0, ptr(p), ptr(vel), ptr(p), ptr(vel), 0.8, b, 64, 64,
                                  k, jacobi.SMALL, BATCHED, 0, stream())
    with pytest.raises(ValueError, match="cannot run sweeps"):
        jacobi.run_project(p, p, vel, 0.8, [10, top + 1])
    with pytest.raises(ValueError, match="not on the pressure's grid"):
        jacobi.jacobi_project(p, p, vel[:, :32].contiguous(), 20, 0.8)
    assert jacobi.JACOBI_PROJECT.launches == before
    got = jacobi.run_project(p, p, vel, 0.8, [top])     # the deepest fused launch runs
    torch.cuda.synchronize()
    assert jacobi.JACOBI_PROJECT.launches == before + 1 and not got[1].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_launches_five_kernels(dtype, cuda):
    """A step at 20 sweeps launches 5 kernels: pre_pressure, one chunk, the
    fused jacobi_project, the velocity's and the dye's advection; no
    standalone gradient subtract."""
    cfg = FluidConfig(DTYPE=dtype, **CONFIGS["small"]).validate()
    trace = swirl_trace(cfg, 3, seed=3)
    build.reset_launches()
    make_multi_step(cfg)(init_state(cfg), trace.dts, trace.batches)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    assert launches == {"pre_pressure": 3, "jacobi_chunk": 3, "jacobi_project": 3,
                        "advect": 3, "advect_dye": 3}
    assert sum(launches.values()) == 5 * 3


@pytest.mark.parametrize("dtype,quant", [(torch.float32, None), (torch.bfloat16, "rgb9e5"),
                                         (torch.bfloat16, None), (torch.float16, None)],
                         ids=["float32", "bfloat16-rgb9e5", "bfloat16", "float16"])
@pytest.mark.parametrize("splats", [0, 8])
@pytest.mark.parametrize("dye_hw", [(256, 448), (250, 437)], ids=["256x448", "250x437"])
def test_advect_far_backtraces_match_plain(dye_hw, splats, dtype, quant, cuda):
    """Velocity at +/-1000 on a grid ~8x coarser than the dye (the demo's
    ratio): backtraces of ~130 dye texels, far past any tile, clamped at the
    grid's edge. With and without a splat bump, RGB9E5 on and off, a width
    that fills no row of threads evenly: bit-equal to advect_plain; one
    advect_dye launch where there is a bump or RGB9E5 (its windows past the
    budget: each corner prepared from device memory), else one advect
    launch."""
    gen = np.random.default_rng(21)
    vel = np.clip(gen.standard_normal((2, 32, 56)) * 3000, -1000, 1000).astype(np.float32)
    dye = (gen.random((3,) + dye_hw) * 1.5).astype(np.float32)
    v = torch.from_numpy(vel).to(cuda, dtype)
    s = torch.from_numpy(dye).to(cuda, dtype)
    factors = None
    if splats:
        rows = np.zeros((splats, 8), np.float32)
        rows[:, 0:2] = gen.random((splats, 2))
        rows[:, 4:7] = gen.random((splats, 3)) * 1.5
        rows[:-1, 7] = 1.0
        factors = splat_factors(torch.from_numpy(rows).to(cuda), *dye_hw, 0.0025, 1.75,
                                slice(4, 7))
    before = (advect.ADVECT.launches, advect.ADVECT_DYE.launches)
    got = advect.advect(v, s, 1 / 60, 1.0, splat_factors=factors, quant=quant)
    torch.cuda.synchronize()
    dye = 1 if (factors is not None or quant) else 0
    assert (advect.ADVECT.launches - before[0],
            advect.ADVECT_DYE.launches - before[1]) == (1 - dye, dye)
    want = advect.advect_plain(v, s, 1 / 60, 1.0, splat_factors=factors, quant=quant)
    assert float((got.float() - want.float()).abs().max()) == 0.0
    if dye:
        assert advect.dye_window_plan(v, s, 1 / 60, 1.0, factors, quant)["share"] < 0.5
    # the velocity's self-advection at +/-1000: the gather
    before = (advect.ADVECT.launches, advect.ADVECT_DYE.launches)
    got = advect.advect(v, v, 1 / 60, 0.2)
    assert (advect.ADVECT.launches, advect.ADVECT_DYE.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, advect.advect_plain(v, v, 1 / 60, 0.2))


def _swirl(h, w, scale):
    """A swirl velocity (2, h, w) float32: smooth across any tile."""
    y, x = torch.meshgrid(torch.linspace(-1, 1, h), torch.linspace(-1, 1, w), indexing="ij")
    return torch.stack([-y, x]) * scale * torch.exp(-(x * x + y * y))


@pytest.mark.parametrize("velocity", ["swirl", "noise", "half"])
@pytest.mark.parametrize("vel_f32", [False, True], ids=["vel-storage", "vel-f32"])
@pytest.mark.parametrize("grid", ["same", "cross"])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, None), (torch.bfloat16, "rgb9e5"),
                                         (torch.bfloat16, None), (torch.float16, None)],
                         ids=["float32", "bfloat16-rgb9e5", "bfloat16", "float16"])
def test_advect_dye_windows_match_plain(dtype, quant, grid, vel_f32, velocity, cuda):
    """advect_dye's two paths, alone and mixed in one launch: a swirl
    (every tile's window staged in shared memory), noise (backtraces of
    up to ~130 dye texels: most windows past the budget, each corner
    prepared from device memory) and a swirl with noise in its top half
    (both), same grid and 8x cross grid, the velocity
    in storage or float32 beside a 16-bit dye, on a 250 x 437 dye that fills
    no tile evenly: bit-equal to advect_plain, one launch."""
    if vel_f32 and dtype == torch.float32:
        pytest.skip("a float32 dye's velocity is float32 already")
    h, w = 250, 437
    vh, vw = (h, w) if grid == "same" else (32, 56)
    gen = np.random.default_rng(5)
    vel = _swirl(vh, vw, 300.0 if grid == "cross" else 60.0)
    reach = 1000.0 if grid == "cross" else 8000.0
    noise = torch.from_numpy(np.clip(gen.standard_normal((2, vh, vw)) * 3 * reach, -reach,
                                     reach).astype(np.float32))
    if velocity == "noise":
        vel = noise
    elif velocity == "half":
        vel[:, :vh // 2] = noise[:, :vh // 2]
    v = vel.to(cuda, torch.float32 if vel_f32 else dtype)
    s = torch.from_numpy(gen.random((3, h, w), dtype=np.float32) * 1.5).to(cuda, dtype)
    rows = np.zeros((8, 8), np.float32)
    rows[:, 0:2] = gen.random((8, 2))
    rows[:, 4:7] = gen.random((8, 3)) * 1.5
    rows[:-1, 7] = 1.0
    factors = splat_factors(torch.from_numpy(rows).to(cuda), h, w, 0.0025, 1.75, slice(4, 7))
    share = advect.dye_window_plan(v, s, 1 / 60, 1.0, factors, quant)["share"]
    assert {"swirl": share == 1.0, "noise": share < 0.3, "half": 0.3 < share < 1.0}[velocity]
    before = (advect.ADVECT.launches, advect.ADVECT_DYE.launches)
    got = advect.advect(v, s, 1 / 60, 1.0, splat_factors=factors, quant=quant)
    torch.cuda.synchronize()
    assert (advect.ADVECT.launches, advect.ADVECT_DYE.launches) == (before[0], before[1] + 1)
    want = advect.advect_plain(v, s, 1 / 60, 1.0, splat_factors=factors, quant=quant)
    assert got.dtype == dtype and torch.equal(got, want), (
        float((got.float() - want.float()).abs().max()), share)


def test_kernel_rejects_cpu_and_bad_dtype(cuda):
    vel = torch.zeros((2, 8, 8), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        stencil.pre_pressure(vel, 30.0, 1 / 60)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        stencil.pre_pressure(torch.zeros((2, 8, 8)), 30.0, 1 / 60)


RENDER_VARIANTS = [dict(), dict(SHADING=False), dict(BLOOM=False), dict(SUNRAYS=False),
                   dict(BLOOM_RESOLUTION=4)]  # the last: < 2 mips, zero bloom


def _check_cases(cases):
    for case in cases:
        before = build.KERNELS[case.kernel_name].launches
        err, tol = check.compare(case.run(), case.run(plain=True))
        torch.cuda.synchronize()
        assert build.KERNELS[case.kernel_name].launches == before + 1, case.label
        assert err <= tol, (case.label, err, tol)


@pytest.mark.parametrize("flags", RENDER_VARIANTS, ids=lambda f: ",".join(f) or "all")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_render_kernels_match_plain(flags, dtype, cuda):
    """bloom_pyramid, the sunrays and display against their plain versions
    at small shapes: odd canvas, every flag variant, each storage dtype."""
    cfg = FluidConfig(DTYPE=dtype, **{**CONFIGS["ragged"], "CANVAS_WIDTH": 333,
                                      "CANVAS_HEIGHT": 201, **flags}).validate()
    state, _ = check.random_state(cfg, seed=5, device=cuda)
    cases = check.render_cases(state, cfg)
    pyramid = cfg.BLOOM and len(cfg.bloom_mip_sizes()) >= 2
    assert [c.kernel_name for c in cases] == ["bloom_pyramid"] * pyramid + ["display"]
    _check_cases(cases)
    rays = check.sunrays_cases(state, cfg)
    assert [c.kernel_name for c in rays] == ["sunrays"] * cfg.SUNRAYS
    _check_cases(rays)
    _check_cases(check.render_cases(state, cfg, out_hw=(50, 77), dither=False))
    _check_cases(check.render_cases(state, cfg, out_hw=(64, 130), compose=False))


def test_render_kernels_match_plain_at_capture_shape(cuda):
    """The demo's capture, 512x910 from a 1024x1820 dye: a width the TPU
    display kernel refused."""
    cfg = FluidConfig(MAX_SPLATS=8).validate()
    cw, ch = cfg.capture_size
    assert (ch, cw) == (512, 910)
    state, _ = check.random_state(cfg, seed=9, device=cuda)
    _check_cases(check.render_cases(state, cfg, out_hw=(ch, cw)))


# (bloom resolution, canvas w x h, BLOOM_ITERATIONS, the first level in the
# block): 2, 3, 5 and 7 mips with odd sizes; every level in the block (a
# base under the small-level threshold), every level grid-wide (a 256 base
# with 2 or 3 mips), split between them, the two main paths' pyramids.
PYRAMIDS = [(64, (1280, 720), 2, 1), (37, (333, 201), 3, 1), (101, (1280, 720), 8, 2),
            (24, (1280, 720), 8, 0), (256, (1280, 720), 2, 2), (256, (1280, 720), 3, 3),
            (256, (1280, 720), 8, 3), (256, (1024, 1024), 8, 3)]


@pytest.mark.parametrize("res,canvas,iters,small", PYRAMIDS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_bloom_pyramid_matches_plain(res, canvas, iters, small, cuda):
    """The whole pyramid in one launch, bit-equal to bloom_pyramid_plain,
    at each split the configs give: all levels in the block, all grid-wide,
    and between."""
    cfg = FluidConfig(BLOOM_RESOLUTION=res, CANVAS_WIDTH=canvas[0], CANVAS_HEIGHT=canvas[1],
                      BLOOM_ITERATIONS=iters).validate()
    mips = cfg.bloom_mip_sizes()
    assert bloom.small_level([(h, w) for w, h in mips]) == small
    bw, bh = cfg.bloom_size
    gen = np.random.default_rng(res)
    base = torch.from_numpy((gen.random((3, bh, bw)) * 2.0).astype(np.float32)).to(cuda)
    args = (base, mips, cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE, cfg.BLOOM_INTENSITY)
    want = bloom.bloom_pyramid_plain(*args)
    before = bloom.BLOOM_PYRAMID.launches
    got = bloom.bloom_pyramid(*args)
    torch.cuda.synchronize()
    assert bloom.BLOOM_PYRAMID.launches == before + 1
    assert torch.equal(got, want), float((got - want).abs().max())


# Output sizes the render asks for: the canvases, the captures, the tick.
DISPLAY_SHAPES = [((1024, 1820), (720, 1280)), ((1024, 1820), (512, 910)),
                  ((1024, 1820), (360, 640)), ((1024, 1024), (1024, 1024)),
                  ((1024, 1024), (512, 512)), ((1024, 1024), (360, 640))]


@pytest.mark.parametrize("dye_hw,out_hw", DISPLAY_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_display_matches_plain_at_render_sizes(dye_hw, out_hw, dtype, cuda):
    """The display at each output size the render gives it, each storage
    type, shaded and not, composed and not: bit-equal to display_plain."""
    gen = np.random.default_rng(out_hw[0] + out_hw[1])

    def t(*shape):
        return torch.from_numpy((gen.random(shape) * 1.5).astype(np.float32)).to(cuda)

    dye = t(3, *dye_hw).to(dtype)
    extras = (t(3, 256, 455), t(196, 348), t(64, 64))
    for shading in (True, False):
        for compose in (True, False):
            before = display.DISPLAY.launches
            got = display.display(dye, out_hw, shading, *extras, compose=compose)
            torch.cuda.synchronize()
            assert display.DISPLAY.launches == before + 1
            want = display.display_plain(dye, out_hw, shading, *extras, compose=compose)
            assert torch.equal(got, want), (shading, compose)


# (dye, sunrays grid) of every render config of these tests and of
# tests/test_torch_batch_render_kernels.py: the demo's canvas (the fleet's
# geometry), 1024^2, 256^2, and the ragged and small configs, whose dyes
# are smaller than the sunrays grid (the taps upsample).
SUNRAYS_CONFIGS = {
    "demo": dict(DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720),
    "1024": dict(DYE_RESOLUTION=1024, CANVAS_WIDTH=1024, CANVAS_HEIGHT=1024),
    "256": dict(DYE_RESOLUTION=256, CANVAS_WIDTH=256, CANVAS_HEIGHT=256),
    "ragged": {**CONFIGS["ragged"], "CANVAS_WIDTH": 333, "CANVAS_HEIGHT": 201},
    "small": CONFIGS["small"],
}


def _sunrays_inputs(shape, batch, device, seed):
    """A float32 dye of config ``shape`` (one sim for batch 1, else
    (batch, 3, H, W)) with values about the mask's knees, and the sunrays
    grid (h, w)."""
    cfg = FluidConfig(**SUNRAYS_CONFIGS[shape]).validate()
    (dw, dh), (sw, sh) = cfg.dye_size, cfg.sunrays_size
    lead = () if batch == 1 else (batch,)
    gen = np.random.default_rng(seed)
    dye = (gen.random(lead + (3, dh, dw)) * 0.06 - 0.01).astype(np.float32)
    return torch.from_numpy(dye).to(device), (sh, sw)


def _sunrays_matches_plain(dye, rays_hw, weight):
    """The march and blur launches, one each, bit-equal to apply_sunrays
    (NaN where it has NaN)."""
    want = apply_sunrays(dye, rays_hw, weight)
    before = {k: v.launches for k, v in build.KERNELS.items()}
    got = sunrays.sunrays(dye, rays_hw, weight)
    torch.cuda.synchronize()
    ran = {k: v.launches - before[k] for k, v in build.KERNELS.items() if v.launches != before[k]}
    assert ran == {"sunrays": 1, "sunrays_blur": 1}, ran
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok]), float((got - want)[ok].abs().max())


@pytest.mark.parametrize("shape", sorted(SUNRAYS_CONFIGS))
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_sunrays_matches_plain_at_render_sizes(shape, batch, cuda):
    """The sunrays kernels at each render config's dye and sunrays grid,
    one sim and batches of 3 and 16 in one launch each: max abs error 0
    against apply_sunrays, with the default weight and another."""
    dye, rays_hw = _sunrays_inputs(shape, batch, cuda, seed=batch)
    _sunrays_matches_plain(dye, rays_hw, 1.0)
    _sunrays_matches_plain(dye, rays_hw, 0.7)


def test_sunrays_keeps_nan_and_infinities(cuda):
    """A NaN channel makes the rays NaN wherever apply_sunrays has NaN; an
    infinite or negative-zero channel clamps as the plain ops clamp it."""
    dye, rays_hw = _sunrays_inputs("ragged", 2, cuda, seed=4)
    dye[0, 1, 10, 20] = float("nan")
    dye[0, 0, 30, 50] = float("inf")
    dye[1, 2, 5, 5] = -float("inf")
    dye[1, :, 20, 30] = -0.0
    _sunrays_matches_plain(dye, rays_hw, 1.0)


def test_sunrays_reads_any_contiguous_dye(cuda):
    """The march's 16-byte loads need every dye row 16-byte aligned; a
    contiguous dye that starts one float past its storage's start, or whose
    width is not a multiple of 4, takes the 4-byte loads, with the same
    bits."""
    dye, rays_hw = _sunrays_inputs("demo", 2, cuda, seed=6)
    shifted = torch.empty(dye.numel() + 1, device=cuda)[1:].view(dye.shape)
    shifted.copy_(dye)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    _sunrays_matches_plain(shifted, rays_hw, 1.0)
    _sunrays_matches_plain(dye[..., :-1].contiguous(), rays_hw, 1.0)


def _display_extras(cfg, gen, device, batch=()):
    """Bloom, sunrays and dither textures at ``cfg``'s sizes, from numpy."""
    (bw, bh), (sw, sh) = cfg.bloom_size, cfg.sunrays_size

    def t(*shape):
        return torch.from_numpy((gen.random(shape) * 1.5).astype(np.float32)).to(device)

    return t(*batch, 3, bh, bw), t(*batch, sh, sw), t(64, 64)


def _display_forms_match_plain(dye, out_hw, extras, want_kernel=None):
    """Each shading and compose of the display at ``out_hw``: the wrapper
    launches the form kernel_of names, and only it (with shading,
    ``want_kernel`` where given), and it and the direct form, forced, are
    bit-equal to display_plain."""
    for shading in (True, False):
        for compose in (True, False):
            want = display.display_plain(dye, out_hw, shading, *extras, compose=compose)
            before = {k: build.KERNELS[k].launches for k in ("display", "display_direct")}
            got = display.display(dye, out_hw, shading, *extras, compose=compose)
            forced = display.display(dye, out_hw, shading, *extras, compose=compose,
                                     force="direct")
            torch.cuda.synchronize()
            picked = display.kernel_of(dye, out_hw, shading)
            after = {k: build.KERNELS[k].launches for k in before}
            if shading and want_kernel:
                assert picked == want_kernel, (out_hw, picked)
            runs = {picked: 1}
            runs["display_direct"] = runs.get("display_direct", 0) + 1
            assert {k: after[k] - before[k] for k in after} == \
                {k: runs.get(k, 0) for k in after}, (shading, compose, picked)
            assert torch.equal(got, want), (shading, compose, float((got - want).abs().max()))
            assert torch.equal(forced, want), (shading, compose)


@pytest.mark.parametrize("label", sorted(check.DIRECT_GEOMETRIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_display_direct_form_at_small_canvases(label, dtype, cuda):
    """Every small canvas of check.DIRECT_GEOMETRIES, where the staged
    window does not fit a block with shading in the geometry's own dtype:
    the wrapper takes the direct form there (without shading, or in 16 bits
    at a float32 geometry, the staged one where its window fits), each
    storage type, shaded and not, composed and not, bit-equal to
    display_plain."""
    (h, w), out_hw = check.direct_geometry(label)
    res, cw, ch, own = check.DIRECT_GEOMETRIES[label]
    cfg = FluidConfig(DYE_RESOLUTION=res, CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch).validate()
    gen = np.random.default_rng(res + cw)
    dye = torch.empty((3, h, w), device=cuda).uniform_(0.0, 1.5).to(dtype)
    _display_forms_match_plain(dye, out_hw, _display_extras(cfg, gen, cuda),
                               "display_direct" if dtype == own else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=lambda d: str(d)[6:])
def test_display_direct_form_batched(dtype, cuda):
    """A batch of 4 dyes of 512 at a 200x112 canvas, one direct launch for
    the 4 sims, bit-equal to display_plain sim by sim; and the staged form
    at the demo is still what the wrapper picks."""
    cfg = FluidConfig(DYE_RESOLUTION=512, CANVAS_WIDTH=200, CANVAS_HEIGHT=112).validate()
    dw, dh = cfg.dye_size
    gen = np.random.default_rng(4)
    dye = torch.empty((4, 3, dh, dw), device=cuda).uniform_(0.0, 1.5).to(dtype)
    _display_forms_match_plain(dye, (112, 200), _display_extras(cfg, gen, cuda, (4,)),
                               "display_direct" if dtype == torch.float32 else None)
    demo = torch.zeros((2, 3, 1024, 1820), device=cuda, dtype=dtype)
    assert display.kernel_of(demo, (720, 1280), True) == "display"
    assert display.kernel_of(demo[0], (1024, 1024), True) == "display"


def test_kernel_render_matches_plain_render(cuda):
    cfg = FluidConfig(DTYPE="bfloat16", **CONFIGS["small"]).validate()
    state, _ = check.random_state(cfg, seed=2, device=cuda)
    build.reset_launches()
    got = make_render(cfg)(state)
    launches = {k: v.launches for k, v in build.KERNELS.items() if v.launches}
    assert launches == {"bloom_pyramid": 1, "sunrays": 1, "sunrays_blur": 1, "display": 1}
    err, tol = check.compare(got, plain_render(state, cfg))
    assert err <= tol, (err, tol)


def test_render_kernels_reject_bad_inputs(cuda):
    with pytest.raises(ValueError, match="takes float32"):
        bloom.bloom_pyramid(torch.zeros((3, 8, 8), device=cuda, dtype=torch.bfloat16),
                            ((4, 4), (2, 2)), 0.6, 0.7, 0.8)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        display.display(torch.zeros((3, 8, 8), device=cuda, dtype=torch.float64), (8, 8), True)
    with pytest.raises(ValueError, match="must be float32"):
        display.display(torch.zeros((3, 8, 8), device=cuda), (8, 8), True,
                        torch.zeros((3, 4, 4), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="float32 dye"):
        sunrays.sunrays(torch.zeros((3, 8, 8), device=cuda, dtype=torch.bfloat16), (4, 4), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sunrays.sunrays(torch.zeros((3, 8, 16), device=cuda)[..., ::2], (4, 4), 1.0)


def test_refused_render_launches_raise(cuda):
    """A launch the card refuses raises, with no plain fallback: the bloom
    kernel's block phase and the display's window past the shared memory a
    block may have, through the wrapper too, and shapes the entry points
    reject. The next launch runs."""
    import ctypes

    from tpufluid_torch.ops.cuda.build import ptr, stream

    base = torch.zeros((3, 256, 455), device=cuda)
    sizes = (ctypes.c_int * 4)(128, 227, 64, 113)
    mips = torch.empty(3 * (128 * 227 + 64 * 113), device=cuda)
    before = bloom.BLOOM_PYRAMID.launches
    with pytest.raises(RuntimeError, match="failed to launch"):   # 436 KB of levels in a block
        bloom.BLOOM_PYRAMID(ptr(base), 1, 256, 455, ptr(mips), ptr(base), sizes, 2, 0, 0.6,
                            0.0, 0.0, 0.0, 0.8, stream())
    with pytest.raises(RuntimeError, match="failed to launch"):   # one mip
        bloom.BLOOM_PYRAMID(ptr(base), 1, 256, 455, ptr(mips), ptr(base), sizes, 1, 0, 0.6,
                            0.0, 0.0, 0.0, 0.8, stream())
    assert bloom.BLOOM_PYRAMID.launches == before
    dye, out = torch.zeros((3, 64, 64), device=cuda), torch.empty((4, 64, 64), device=cuda)
    for win in ((64, 2000), (0, 64)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            display.DISPLAY(ptr(dye), 1, 3, 64, 64, 0, ptr(out), 64, 64, 1, 0, 0.0, 0.0, 0.0,
                            None, 0, 0, None, 0, 0, None, 0, 0, 0.0, 0.0, *win, stream())
    # a dye window past a block's shared memory (a 4096x7282 dye shown at
    # 200x360): the staged form, forced, is refused and raises; the wrapper
    # takes the direct form there, bit-equal to display_plain
    big = torch.empty((3, 4096, 7282), device=cuda).uniform_(0.0, 1.5)
    before = display.DISPLAY.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        display.display(big, (200, 360), True, force="staged")
    assert display.DISPLAY.launches == before
    direct = display.DISPLAY_DIRECT.launches
    got = display.display(big, (200, 360), True)
    torch.cuda.synchronize()
    assert torch.equal(got, display.display_plain(big, (200, 360), True))
    assert display.DISPLAY_DIRECT.launches == direct + 1
    assert display.DISPLAY.launches == before
    dye, base = dye.uniform_(), base.uniform_()
    got = display.display(dye, (64, 64), True)
    bloom_args = (base, ((227, 128), (113, 64)), 0.6, 0.7, 0.8)
    glow = bloom.bloom_pyramid(*bloom_args)
    torch.cuda.synchronize()
    assert torch.equal(got, display.display_plain(dye, (64, 64), True))
    assert torch.equal(glow, bloom.bloom_pyramid_plain(*bloom_args))
    assert display.DISPLAY.launches == before + 1


@pytest.mark.parametrize("ragged", [False, True], ids=["default", "ragged"])
def test_floors_kernels_match_plain(ragged, cuda):
    """floor_taa and floor_roll bit-equal to their plain versions, the
    sweep within tolerance, at the microbenchmarks' shapes and ragged ones,
    on the microbenchmarks' inputs and on random ones."""
    _check_cases(check.floors_cases(cuda, ragged))
    _check_cases(check.random_floors_cases(cuda, ragged, seed=3))


def test_floor_sweep_runs_any_number_of_sweeps_in_one_launch(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    seed = torch.rand((64, 96), generator=gen, device=cuda)
    x = torch.randn((64, 96), generator=gen, device=cuda)
    for chunks, sweeps in ((1, 1), (1, 2), (3, 7)):
        before = floors.FLOOR_SWEEP.launches
        got = floors.sweep(seed, x, chunks, sweeps)
        torch.cuda.synchronize()
        assert floors.FLOOR_SWEEP.launches == before + 1
        err, tol = check.compare(got, plain_floors.sweep_plain(seed, x, chunks, sweeps))
        assert err <= tol, (chunks, sweeps, err, tol)
    with pytest.raises(ValueError, match="chunks \\* sweeps >= 1"):
        floors.sweep(seed, x, 0, 20)
    with pytest.raises(ValueError, match="takes torch.float32"):
        floors.sweep(seed.half(), x.half(), 1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        big = torch.zeros((4096, 4096), device=cuda)
        floors.sweep(big, big, 1, 20)


@pytest.mark.parametrize("k", [1, 2, 4, 5, 10, 20])
def test_floor_sweep_every_k_bit_equal(k, cuda):
    """floor_sweep on sweep_plan's geometry for K sweeps between barriers
    (4 rows a thread, or 8 where K-deep halos need them), at the default
    field (random, so every neighbour counts) and the ragged one, with
    totals K does not divide."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    for (h, w), total in (((256, 1024), 2 * k + 3), ((37, 131), 6)):
        seed = torch.rand((h, w), generator=gen, device=cuda)
        x = torch.randn((h, w), generator=gen, device=cuda)
        plan = floors.sweep_plan(h, w, total, build.sm_count(cuda), k)
        got = floors.run_sweep(seed, x, plan)
        assert torch.equal(got, plain_floors.sweep_plain(seed, x, total, 1)), (h, w, k, plan.r)


@pytest.mark.parametrize("splits", [1, 2, 8, 16])
def test_floor_taa_every_split_bit_equal(splits, cuda):
    """floor_taa with each word's (trip, rep) terms cut over ``splits``
    threads, on the random default and ragged cases."""
    for ragged in (False, True):
        seed, idx, op, trips, reps = check.random_floors_cases(cuda, ragged, seed=5)[0].args
        plan = floors.taa_plan(op.shape[0], idx.shape[0], reps, trips, *seed.shape,
                               build.sm_count(cuda), splits)
        got = floors.run_taa(seed, idx, op, trips, plan)
        assert torch.equal(got, plain_floors.taa_plain(seed, idx, op, trips, reps)), splits


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows", [4, 8])
def test_floor_roll_every_plan_bit_equal(rows, splits, cuda):
    """floor_roll with R rows a thread and each word's trips cut over
    ``splits`` threads, on the random default and ragged cases and on the
    microbenchmark's own default inputs."""
    cases = [check.random_floors_cases(cuda, ragged, seed=6)[1].args for ragged in (False, True)]
    cases.append(check.floors_cases(cuda)[1].args)
    for seed, op, trips in cases:
        plan = floors.roll_plan(*op.shape, trips, build.sm_count(cuda), rows, splits)
        before = floors.FLOOR_ROLL.launches
        got = floors.run_roll(seed, op, plan)
        torch.cuda.synchronize()
        assert floors.FLOOR_ROLL.launches == before + 1
        assert torch.equal(got, plain_floors.roll_plain(seed, op, trips)), (op.shape, plan)
    with pytest.raises(ValueError, match="trips >= 0"):
        floors.roll(seed, op, -1)
    assert torch.equal(floors.roll(seed, op, 0), seed)


def test_profile_counts_every_launch(cuda):
    cfg = FluidConfig(DTYPE="bfloat16", **CONFIGS["small"]).validate()
    state, _ = check.random_state(cfg, seed=4, device=cuda)
    times, other = floors.profile_step_kernels(cfg, state, 1 / 60, steps=3)
    events = {k: v["events"] for k, v in other["kernel_events"].items()}
    chunks = math.ceil(cfg.PRESSURE_ITERATIONS / 10)  # the chunk kernel's 10 sweeps a launch
    # the last chunk is the fused jacobi_project: no standalone gradient subtract
    assert events == {"advect": 3, "advect_dye": 3, "jacobi_project": 3,
                      "jacobi_chunk": 3 * (chunks - 1), "pre_pressure": 3}
    assert set(times) == {"velocity_gather", "dye_gather", "jacobi", "stencil",
                          "gradient_subtract"}
    assert times["gradient_subtract"] == 0.0
    assert all(v > 0 for k, v in times.items() if k != "gradient_subtract")


def test_reference_rates_run(cuda):
    before = {k: build.KERNELS[k].launches for k in ("floor_taa", "floor_roll", "floor_sweep")}
    assert floors.measure_taa_row_rate(planes=2, n_idx=2, reps=2, trips=2) > 0
    assert floors.measure_roll_rate(2, 96, 384, trips=8) > 0
    assert floors.measure_sweep_rate(chunks=1, sweeps=2) > 0
    assert floors.measure_hbm_bandwidth_gbps() > 0
    for k, n in before.items():
        # queued_ms: 1 warm-up, 3 x 10 to time the enqueue, 3 x 10 timed
        assert build.KERNELS[k].launches == n + 61, k
