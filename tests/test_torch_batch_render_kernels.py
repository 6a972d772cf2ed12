"""The frame's kernels on a batch of B sims in one launch, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one every test
skips with its reason. They import no JAX, so on the card run
    python -m pytest --noconftest tests/test_torch_batch_render_kernels.py -q
Every comparison is exact (max abs error 0): the batched bloom pyramid,
sunrays and display against their plain versions (the pyramid's and the
display's run the batch sim by sim), and each sim against the kernel
launched on that sim alone, at the render shapes
of the demo (dye 1024x1820, canvas 720x1280, bloom base 256x455), of the
256^2 and of the 1024^2 serving cells; a batch of more sims than the
pyramid's cooperative grid has blocks; the batched frame and tick against
make_render and make_step_and_render on each sim. tests/
test_torch_batch_render.py holds the batched frame to tpufluid's on the CPU.
"""

import ctypes

import numpy as np
import pytest
import torch

from tpufluid_torch import (FluidConfig, make_batched_render, make_batched_tick, make_render,
                            make_step_and_render, swirl_trace, unstack_state)
from tpufluid_torch.batch import plain_batched_render
from tpufluid_torch.ops.cuda import bloom, build, check, display, floors, sunrays
from tpufluid_torch.ops.cuda.build import ptr, stream
from tpufluid_torch.ops.sunrays import apply_sunrays

FIELDS = ("velocity", "dye", "pressure")
SHAPES = {
    "demo": dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720),
    "256": dict(SIM_RESOLUTION=256, DYE_RESOLUTION=256, CANVAS_WIDTH=256, CANVAS_HEIGHT=256),
    "1024": dict(SIM_RESOLUTION=1024, DYE_RESOLUTION=1024, CANVAS_WIDTH=1024,
                 CANVAS_HEIGHT=1024),
}
DTYPES = ["float32", "bfloat16", "float16"]
PER_STEP = {"pre_pressure": 1, "jacobi_chunk": 1, "jacobi_project": 1, "advect": 1,
            "advect_dye": 1}
PER_FRAME = {"bloom_pyramid": 1, "sunrays": 1, "sunrays_blur": 1, "display": 1}


@pytest.fixture
def cuda():
    """The card; skips the test where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg(shape, dtype="float32", **kw):
    return FluidConfig(DTYPE=dtype, MAX_SPLATS=8, **{**SHAPES[shape], **kw}).validate()


def _equal(got, want, label):
    assert got.dtype == want.dtype and got.shape == want.shape, label
    assert torch.equal(got, want), (label, float((got.float() - want.float()).abs().max()))


def _single(case, b):
    """The case's kernel launched on sim b alone."""
    if case.kernel_name == "bloom_pyramid":
        base, *rest = case.args
        return bloom.bloom_pyramid(base[b], *rest)
    if case.kernel_name == "sunrays":
        dye, rays_hw, weight = case.args
        return sunrays.sunrays(dye[b], rays_hw, weight)
    dye, out_hw, shading, glow, rays, noise, compose = case.args
    return display.display(dye[b], out_hw, shading, None if glow is None else glow[b],
                           None if rays is None else rays[b], noise, compose)


def _check_batched(cases):
    for case in cases:
        before = build.KERNELS[case.kernel_name].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS[case.kernel_name].launches == before + 1, case.label
        _equal(got, case.run(plain=True), case.label)
        for b in range(got.shape[0]):
            _equal(got[b], _single(case, b), f"{case.label} sim {b}")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_batched_render_kernels_match_plain(batch, dtype, shape, cuda):
    """The batched pyramid (after its batched base resample), sunrays and
    display, one call each for the B sims: bit-equal to the plain versions
    and, sim by sim, to the single-sim launches."""
    cfg = _cfg(shape, dtype)
    state, _ = check.random_batch(cfg, batch, seed=batch, device=cuda)
    cases = check.batched_render_cases(state, cfg)
    assert [c.kernel_name for c in cases] == ["bloom_pyramid", "display"]
    _check_batched(cases + check.sunrays_cases(state, cfg, f":b{batch}"))


def test_batched_render_kernel_variants_match_plain(cuda):
    """The display without dither, the shaded center alone (compose off),
    without shading, bloom or sunrays, at the 360x640 tick, B = 5; the
    sunrays of each."""
    for flags in (dict(), dict(SHADING=False), dict(BLOOM=False), dict(SUNRAYS=False)):
        cfg = _cfg("demo", "bfloat16", **flags)
        state, _ = check.random_batch(cfg, 5, seed=2, device=cuda)
        _check_batched(check.batched_render_cases(state, cfg, out_hw=(360, 640))
                       + check.sunrays_cases(state, cfg, ":b5"))
        _check_batched(check.batched_render_cases(state, cfg, dither=False))
        _check_batched(check.batched_render_cases(state, cfg, compose=False))


def test_batched_pyramid_loops_past_the_grid(cuda):
    """133 sims on a 64x114 bloom base (m1 and below in the block phase):
    more sims than the cooperative grid's blocks (one a streaming
    multiprocessor, 132 on the H100), so blocks take several sims in turn.
    Every sim equals the plain version and its single-sim launch."""
    cfg = FluidConfig(BLOOM_RESOLUTION=64, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720).validate()
    mips = cfg.bloom_mip_sizes()
    level_hw = [(h, w) for w, h in mips]
    assert 0 < bloom.small_level(level_hw) < len(mips)
    assert 133 > build.sm_count(cuda)
    bw, bh = cfg.bloom_size
    gen = np.random.default_rng(133)
    base = torch.from_numpy((gen.random((133, 3, bh, bw)) * 2.0).astype(np.float32)).to(cuda)
    args = (mips, cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE, cfg.BLOOM_INTENSITY)
    before = bloom.BLOOM_PYRAMID.launches
    got = bloom.bloom_pyramid(base, *args)
    torch.cuda.synchronize()
    assert bloom.BLOOM_PYRAMID.launches == before + 1
    _equal(got, bloom.bloom_pyramid_plain(base, *args), "133 sims")
    for b in (0, 1, 131, 132):
        _equal(got[b], bloom.bloom_pyramid(base[b], *args), f"sim {b}")


@pytest.mark.parametrize("shape,dtype", [("demo", "float32"), ("256", "bfloat16")])
def test_batched_frame_and_tick_equal_each_sim(shape, dtype, cuda):
    """make_batched_render launches 1 bloom_pyramid, the sunrays' 2 and 1
    display for the B sims, equals the plain batched render, and each sim
    make_render on it alone; three make_batched_tick ticks with a dt a sim
    launch 5 + 4 each,
    and each sim's state and uint8 frame equal make_step_and_render's."""
    cfg = _cfg(shape, dtype)
    b = 4
    state, _ = check.random_batch(cfg, b, seed=5, device=cuda)
    build.reset_launches()
    frames = make_batched_render(cfg)(state)
    torch.cuda.synchronize()
    assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == PER_FRAME
    _equal(frames, plain_batched_render(state, cfg), "plain batched render")
    render = make_render(cfg)
    for i in range(b):
        _equal(frames[i], render(unstack_state(state, i)), f"frame sim {i}")
    seq = np.stack([swirl_trace(cfg, 3, seed=42 + i).batches for i in range(b)], axis=1)
    dts = check.per_sim_dts(b)
    tick, single = make_batched_tick(cfg), make_step_and_render(cfg)
    sims = [unstack_state(state, i) for i in range(b)]
    for t in range(3):
        build.reset_launches()
        state, pixels = tick(state, dts, seq[t])
        torch.cuda.synchronize()
        assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == \
            {**PER_STEP, **PER_FRAME}
        assert pixels.shape == (b, cfg.CANVAS_HEIGHT, cfg.CANVAS_WIDTH, 3)
        for i in range(b):
            sims[i], want = single(sims[i], dts[i], seq[t, i])
            _equal(pixels[i], want, f"tick {t} pixels sim {i}")
            for f in FIELDS:
                _equal(getattr(unstack_state(state, i), f), getattr(sims[i], f),
                       f"tick {t} {f} sim {i}")


def test_profile_counts_each_batched_frame_launch(cuda):
    """profile_frame_kernels on a batched state profiles make_batched_render:
    one event of each render kernel a batched frame, counted between the
    window's marker kernels, and device time beside them."""
    cfg = _cfg("256", "bfloat16")
    state, _ = check.random_batch(cfg, 3, seed=4, device=cuda)
    profile = floors.profile_frame_kernels(cfg, state, frames=4)
    assert {k: row["events"] for k, row in profile["kernel_events"].items()} == \
        {k: 4 * n for k, n in PER_FRAME.items()}
    assert all(row["us"] > 0 for row in profile["kernel_events"].values())
    assert profile["frame_device_us"] > profile["other_device_us"] > 0


def test_refused_batched_render_launches_raise(cuda):
    """B outside 1..65535 is refused by the launchers (the pyramid's
    cooperative grid would not grow with B in any case; the display's and
    the sunrays' grid z holds at most 65535), and raises; so does a batch whose bloom or
    sunrays do not lead with the dye's B. The next launches run."""
    base = torch.zeros((2, 3, 64, 64), device=cuda)
    sizes = (ctypes.c_int * 4)(32, 32, 16, 16)
    mips = torch.empty(2 * 3 * (32 * 32 + 16 * 16), device=cuda)
    out = torch.empty_like(base)
    dye, frame = torch.zeros((2, 3, 64, 64), device=cuda), torch.empty((2, 4, 64, 64),
                                                                       device=cuda)
    tab, decay = sunrays.tables((64, 64), (32, 32), cuda), sunrays._decay(1.0)
    bounds = sunrays.band_bounds((64, 64), (32, 32), cuda)
    build.reset_launches()
    for batch in (0, 65536):
        with pytest.raises(RuntimeError, match="failed to launch"):
            bloom.BLOOM_PYRAMID(ptr(base), batch, 64, 64, ptr(mips), ptr(out), sizes, 2, 1,
                                0.6, 0.0, 0.0, 0.0, 0.8, stream())
        with pytest.raises(RuntimeError, match="failed to launch"):
            display.DISPLAY(ptr(dye), batch, 3, 64, 64, 0, ptr(frame), 64, 64, 1, 0, 0.0, 0.0,
                            0.0, None, 0, 0, None, 0, 0, None, 0, 0, 0.0, 0.0, 64, 64, stream())
        with pytest.raises(RuntimeError, match="failed to launch"):
            sunrays.SUNRAYS(ptr(dye), ptr(frame), batch, 64, 64, 32, 32, ptr(tab), ptr(bounds),
                            stream())
        with pytest.raises(RuntimeError, match="failed to launch"):
            sunrays.SUNRAYS_BLUR(ptr(frame), ptr(frame), batch, 64, 64, 32, 32, ptr(tab), decay,
                                 stream())
    with pytest.raises(ValueError, match="bloom"):
        display.display(dye, (64, 64), True, base[:1])
    with pytest.raises(ValueError, match="sunrays"):
        display.display(dye, (64, 64), True, base, torch.zeros((3, 64, 64), device=cuda))
    assert not any(k.launches for k in build.KERNELS.values())
    base.uniform_()
    dye.uniform_()
    args = (((32, 32), (16, 16)), 0.6, 0.7, 0.8)
    _equal(bloom.bloom_pyramid(base, *args), bloom.bloom_pyramid_plain(base, *args), "bloom")
    _equal(display.display(dye, (64, 64), True), display.display_plain(dye, (64, 64), True),
           "display")
    _equal(sunrays.sunrays(dye, (32, 32), 1.0), apply_sunrays(dye, (32, 32), 1.0),
           "sunrays")
