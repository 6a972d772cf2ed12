"""The port's render against tpufluid's on the CPU: render_frame,
capture_frame, frame_u8, tick_body and make_step_and_render, on states
carried across from JAX with interop.state_from_numpy.

Tolerances:
  * float frames: 2e-5 absolute and relative, the bound of
    tests/test_render.py:51 — both render in float32 in the same order, and
    differ where the libraries' CPU pow and sqrt round differently.
  * uint8 frames: at most 1 count, and on few pixels: a value within 2e-5
    of a quantization edge (k/255) truncates to k-1 on one side and k on
    the other.
  * the golden frame (tests/golden_frame.npz), on a state JAX stepped over
    the golden trace: its own bounds, 2/255 max and 0.25/255 mean.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufluid import FluidConfig as JaxConfig
from tpufluid import init_state as jax_init
from tpufluid.render import capture_frame as jax_capture
from tpufluid.render import frame_u8 as jax_frame_u8
from tpufluid.render import render_frame as jax_render
from tpufluid.render import tick_body as jax_tick_body
from tpufluid.step import fluid_step as jax_step
from tpufluid.trace import swirl_trace as jax_trace
import tpufluid_torch as T
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
BASE = dict(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=128, CANVAS_HEIGHT=96,
            BLOOM_RESOLUTION=32, SUNRAYS_RESOLUTION=24, MAX_SPLATS=4, USE_PALLAS=False)


def _cfgs(**kw):
    jcfg = JaxConfig(**{**BASE, **kw}).validate()
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _states(jcfg, seed=0):
    """A JAX state with numpy-made dye U(0, 1.5) and velocity, in the
    config's dtype, and the port's copy of it on the CPU."""
    rng = np.random.default_rng(seed)
    (sw, sh), (dw, dh) = jcfg.sim_size, jcfg.dye_size
    s = jax_init(jcfg)
    s.dye = jnp.asarray((rng.random((3, dh, dw)) * 1.5).astype(np.float32)).astype(jcfg.DTYPE)
    s.velocity = jnp.asarray((rng.standard_normal((2, sh, sw)) * 100).astype(np.float32)
                             ).astype(jcfg.DTYPE)
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    return s, ts


def _close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **{**TOL, **kw})


def _u8_close(got, want):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_render_frame_matches_jax(dtype):
    jcfg, cfg = _cfgs(DTYPE=dtype)
    s, ts = _states(jcfg)
    got = T.render_frame(ts, cfg)
    assert got.shape == (4, 96, 128) and got.dtype == torch.float32
    _close(got, jax_render(s, jcfg))


@pytest.mark.parametrize("flags", [dict(DTYPE="float32"), dict(DTYPE="bfloat16", DYE_RGB9E5=True)],
                         ids=["float32", "bfloat16_rgb9e5"])
def test_small_canvas_render_matches_jax(flags):
    """A 512 dye at a 112x200 canvas, the server's CLI dye in a small
    browser window: on the card the display takes its direct form there
    (its staged window does not fit a block); here the plain version."""
    jcfg, cfg = _cfgs(DYE_RESOLUTION=512, CANVAS_WIDTH=200, CANVAS_HEIGHT=112, **flags)
    assert tuple(cfg.dye_size) == (914, 512)
    s, ts = _states(jcfg, seed=8)
    got = T.render_frame(ts, cfg)
    assert got.shape == (4, 112, 200)
    _close(got, jax_render(s, jcfg))


@pytest.mark.parametrize("flags", [dict(SHADING=False), dict(BLOOM=False),
                                   dict(SUNRAYS=False), dict(BLOOM_RESOLUTION=4),
                                   dict(BACK_COLOR=(10, 200, 30))],
                         ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_render_variants_match_jax(flags):
    jcfg, cfg = _cfgs(**flags)
    s, ts = _states(jcfg, seed=1)
    _close(T.render_frame(ts, cfg, out_hw=(50, 77)), jax_render(s, jcfg, out_hw=(50, 77)))


@pytest.mark.parametrize("to_screen", [True, False])
def test_transparent_render_matches_jax(to_screen):
    """TRANSPARENT on screen: the checkerboard backdrop; off screen: the raw
    display RGBA, alpha = max(rgb)."""
    jcfg, cfg = _cfgs(TRANSPARENT=True)
    s, ts = _states(jcfg, seed=2)
    got = T.render_frame(ts, cfg, to_screen=to_screen)
    _close(got, jax_render(s, jcfg, to_screen=to_screen))
    if not to_screen:
        np.testing.assert_array_equal(got[3].numpy(), got[:3].amax(dim=0).numpy())


def test_capture_and_dither_match_jax():
    jcfg, cfg = _cfgs(DTYPE="bfloat16", TRANSPARENT=True)
    s, ts = _states(jcfg, seed=3)
    got = T.capture_frame(ts, cfg)
    cw, ch = cfg.capture_size
    assert got.shape == (4, ch, cw)
    _close(got, jax_capture(s, jcfg))
    dither = np.random.default_rng(4).random((64, 64)).astype(np.float32)
    _close(T.render_frame(ts, cfg, dither=torch.from_numpy(dither)),
           jax_render(s, jcfg, dither=jnp.asarray(dither)))


def test_frame_u8_matches_jax(tmp_path):
    """frame_u8, also with a dither PNG (dither_path, read by io.load_dither
    in both packages) in place of the blue noise."""
    from PIL import Image

    jcfg, cfg = _cfgs()
    s, ts = _states(jcfg, seed=5)
    _u8_close(T.frame_u8(ts, cfg, out_hw=(60, 90)), jax_frame_u8(s, jcfg, out_hw=(60, 90)))
    # a dim dye, where the frame does not saturate and the dither shows
    s.dye, ts.dye = s.dye * 0.05, ts.dye * 0.05
    path = str(tmp_path / "dither.png")
    Image.fromarray(np.random.default_rng(6).integers(0, 256, (32, 48, 3), dtype=np.uint8),
                    "RGB").save(path)
    got = T.frame_u8(ts, cfg, out_hw=(60, 90), dither_path=path)
    _u8_close(got, jax_frame_u8(s, jcfg, out_hw=(60, 90), dither_path=path))
    assert not torch.equal(got, T.frame_u8(ts, cfg, out_hw=(60, 90)))


def test_tick_body_matches_jax():
    """One step and its frame from a carried-across running state; the
    step is held as tests/test_torch_step.py holds it (1e-4 of the scale)."""
    jcfg, cfg = _cfgs()
    trace = jax_trace(jcfg, 4, seed=6)
    s = jax_init(jcfg)
    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, jcfg))
    dt = np.float32(1 / 60)
    for t in range(3):
        s = step(s, dt, jnp.asarray(trace.batches[t]))
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    want_state, want_u8 = jax_tick_body(jcfg)(s, dt, jnp.asarray(trace.batches[3]))
    got_state, got_u8 = T.tick_body(cfg)(ts, dt, trace.batches[3])
    for g, w in zip(state_to_numpy(got_state), (want_state.velocity, want_state.dye,
                                                want_state.pressure)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    _u8_close(got_u8, want_u8)
    tick = T.make_step_and_render(cfg, device="cpu")
    again_state, again_u8 = tick(ts, dt, trace.batches[3])
    assert torch.equal(again_u8, got_u8) and torch.equal(again_state.dye, got_state.dye)


def test_golden_frame_through_the_port_render():
    """tests/golden_frame.npz rendered by the port from JAX's state after
    the golden trace (tests/test_golden.py: 90 steps, seed 2024). The port's
    own 90-step run is not compared: the flow is chaotic, and a 5e-6
    relative perturbation of JAX's own state after step 1 diverges as far
    by step 90 as the port's float32 rounding differences do."""
    from tests.test_golden import CFG, GOLDEN, STEPS

    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, CFG))
    trace = jax_trace(CFG, STEPS, seed=2024)
    s = jax_init(CFG)
    for t in range(STEPS):
        s = step(s, jnp.float32(trace.dt), jnp.asarray(trace.batches[t]))
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    frame = T.render_frame(ts, config_from_dict(dataclasses.asdict(CFG)), out_hw=(96, 128))
    want = np.load(GOLDEN)["frame"]
    err = np.abs(np.clip(frame.numpy(), 0, 1) - np.clip(want, 0, 1))
    assert frame.shape == want.shape
    assert err.max() < 2.0 / 255.0 and err.mean() < 0.25 / 255.0, (err.max(), err.mean())


def test_render_cases_follow_the_render():
    """The per-kernel cases that chip_smoke.py and the kernel tests compare
    on the card are the render's own calls: the bloom pyramid, one call
    after its base resample, and one display, whose plain versions chained
    reproduce the frame bit for bit."""
    from tpufluid_torch.ops.cuda import check

    for dtype in ("float32", "bfloat16"):
        _, cfg = _cfgs(DTYPE=dtype, TRANSPARENT=True)
        state, _ = check.random_state(cfg, seed=7, device="cpu")
        cases = check.render_cases(state, cfg)
        assert len(cfg.bloom_mip_sizes()) >= 2
        assert [c.kernel_name for c in cases] == ["bloom_pyramid", "display"]
        assert all(c.nbytes > 0 and c.flops > 0 for c in cases)
        np.testing.assert_array_equal(cases[-1].run(plain=True).numpy(),
                                      T.render_frame(state, cfg, to_screen=False).numpy())
        base = check.render_cases(state, cfg, out_hw=(40, 70), compose=False)[-1]
        assert base.run(plain=True).shape == (3, 40, 70)


def test_make_render_device():
    _, cfg = _cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_render(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_step_and_render(cfg)
    _, ts = _states(_cfgs()[0], seed=8)
    np.testing.assert_array_equal(T.make_render(cfg, device="cpu")(ts).numpy(),
                                  T.render_frame(ts, cfg).numpy())


def test_floors_work_counts():
    """The work of the three unported microbenchmarks, whose bounds
    PERF.md lists: the gather benchmark's default (8 trips x 32 reps x 8
    index sets x 2 planes of 64x128 words) and the sweep's (16 x 20 sweeps
    of 256x1024)."""
    from tpufluid_torch.ops.cuda import check

    work = check.floors_work()
    assert len(work) == 3 and all(b > 0 and o > 0 for b, o in work.values())
    assert work["floors.py:92 _taa_kernel"][1] == 8 * 32 * 8 * 2 * 64 * 128
    assert work["floors.py:163 _sweep_kernel"] == (3 * 4 * 256 * 1024,
                                                  16 * 20 * 256 * 1024 * 5)
