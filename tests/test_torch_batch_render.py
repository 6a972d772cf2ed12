"""The port's batched frame (tpufluid_torch.batch.make_batched_render) and
batched tick (tpufluid_torch.serve_batch.make_batched_tick) on the CPU,
against tpufluid's and against the port's own single sim; the batched
pyramid's work split held bit for bit by a numpy model.

The port renders a CPU batch through the kernels' plain versions sim by
sim; JAX vmaps render_frame (and the tick's step + render) over the batch.
Tolerances, those of tests/test_torch_render.py: float frames within 2e-5
absolute and relative of JAX's render_frame of each sim (what the vmap
computes), and of JAX's batched frame within that plus JAX's own vmap
noise on the same inputs (|batched - per sim|: the vmap regroups XLA's
fused sums, tests/test_batch.py; up to 4.2e-5 on the bfloat16 transparent
capture with a given dither); uint8 frames at most 1 count on few pixels;
the tick's state within 1e-4 of each field's scale. Within the port every comparison is
bit for bit: each sim of a batched frame or tick against render_frame or
make_step_and_render on that sim alone. The batched render kernels
themselves are held on the card by tests/test_torch_batch_render_kernels.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render_kernels import _emulate_pyramid
from tpufluid import FluidConfig as JaxConfig
from tpufluid.batch import init_batch as jax_init_batch
from tpufluid.batch import make_batched_render as jax_batched_render
from tpufluid.batch import unstack_state as jax_unstack
from tpufluid.render import render_frame as jax_render
from tpufluid.serve_batch import make_batched_tick as jax_batched_tick
import tpufluid_torch as T
from tpufluid_torch import FluidConfig
from tpufluid_torch.batch import plain_batched_render
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from tpufluid_torch.ops import bloom as tbloom
from tpufluid_torch.ops import display as tdisplay
from tpufluid_torch.ops import sunrays as tsunrays
from tpufluid_torch.ops.cuda import bloom as kbloom
from tpufluid_torch.ops.cuda import check
from tpufluid_torch.ops.cuda import display as kdisplay

TOL = dict(rtol=2e-5, atol=2e-5)
BASE = dict(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=128, CANVAS_HEIGHT=96,
            BLOOM_RESOLUTION=32, SUNRAYS_RESOLUTION=24, MAX_SPLATS=4, USE_PALLAS=False)
B = 3
DTS = np.array([1 / 60, 1 / 90, 1 / 120], np.float32)
FIELDS = ("velocity", "dye", "pressure")


def _cfgs(**kw):
    jcfg = JaxConfig(**{**BASE, **kw}).validate()
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _states(jcfg, seed=0, dye_max=1.5):
    """A JAX batch of B sims with numpy-made dye U(0, dye_max) and velocity
    N(0, 100), as tests/test_torch_render.py makes one sim, in the config's
    dtype, and the port's copy of it on the CPU."""
    rng = np.random.default_rng(seed)
    (sw, sh), (dw, dh) = jcfg.sim_size, jcfg.dye_size
    s = jax_init_batch(jcfg, B)
    s.dye = jnp.asarray((rng.random((B, 3, dh, dw)) * dye_max).astype(np.float32)
                        ).astype(jcfg.DTYPE)
    s.velocity = jnp.asarray((rng.standard_normal((B, 2, sh, sw)) * 100).astype(np.float32)
                             ).astype(jcfg.DTYPE)
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    return s, ts


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)


def _close_to_jax(got, s, jcfg, dither=None, **kw):
    """``got`` against JAX: within TOL of render_frame of each sim alone,
    and of make_batched_render within TOL plus JAX's own vmap noise."""
    jd = None if dither is None else jnp.asarray(dither)
    singles = np.stack([np.asarray(jax_render(jax_unstack(s, i), jcfg, dither=jd, **kw))
                        for i in range(B)])
    _close(got, singles)
    batched = np.asarray(jax_batched_render(jcfg, kw.get("out_hw"), kw.get("to_screen", True))(
        s, jd), np.float32)
    bound = TOL["atol"] + TOL["rtol"] * np.abs(batched) + np.abs(batched - singles)
    err = np.abs(got.numpy() - batched)
    assert (err <= bound).all(), float((err - bound).max())


def _u8_close(got, want):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _each_sim_equal(batched, single):
    """Each sim of ``batched`` bit-equal to ``single(i)``."""
    for i in range(batched.shape[0]):
        want = single(i)
        assert batched[i].dtype == want.dtype and batched[i].shape == want.shape
        assert torch.equal(batched[i], want), (i, float((batched[i].float() - want.float())
                                                        .abs().max()))


# ---------------------------------------------------------------- against JAX

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_batched_render_matches_jax(dtype):
    """make_batched_render against JAX's (its vmap of render_frame) with
    SHADING, BLOOM and SUNRAYS on; bfloat16 with the RGB9E5 dye."""
    jcfg, cfg = _cfgs(DTYPE=dtype)
    assert cfg.SHADING and cfg.BLOOM and cfg.SUNRAYS and cfg.DYE_RGB9E5
    s, ts = _states(jcfg)
    got = T.make_batched_render(cfg, device="cpu")(ts)
    assert got.shape == (B, 4, 96, 128) and got.dtype == torch.float32
    _close_to_jax(got, s, jcfg)


def test_batched_transparent_capture_and_dither_match_jax():
    """The offscreen transparent variant (to_screen=False: the raw display
    RGBA, alpha = max(rgb)) with a given dither, one tile for every sim."""
    jcfg, cfg = _cfgs(DTYPE="bfloat16", TRANSPARENT=True)
    s, ts = _states(jcfg, seed=1)
    dither = np.random.default_rng(4).random((64, 64)).astype(np.float32)
    got = T.make_batched_render(cfg, out_hw=(50, 77), to_screen=False, device="cpu")(
        ts, torch.from_numpy(dither))
    _close_to_jax(got, s, jcfg, dither, out_hw=(50, 77), to_screen=False)
    np.testing.assert_array_equal(got[:, 3].numpy(), got[:, :3].amax(dim=1).numpy())
    _close_to_jax(T.make_batched_render(cfg, device="cpu")(ts), s, jcfg)


@pytest.mark.parametrize("per_sim", [False, True], ids=["lockstep", "per-sim"])
def test_batched_tick_matches_jax(per_sim):
    """make_batched_tick against tpufluid.serve_batch.make_batched_tick, dt
    a scalar (the server's one clock) or one a sim: the state within 1e-4
    of each field's scale, the uint8 frames within a count."""
    jcfg, cfg = _cfgs()
    s, ts = _states(jcfg, seed=2)
    splats = np.stack([T.swirl_trace(cfg, 1, seed=42 + i).batches[0] for i in range(B)])
    dt = DTS if per_sim else np.float32(1 / 60)
    got_state, got_u8 = T.make_batched_tick(cfg, device="cpu")(ts, dt, splats)
    want_state, want_u8 = jax_batched_tick(jcfg)(s, jnp.asarray(dt), jnp.asarray(splats))
    for g, w in zip(state_to_numpy(got_state), (want_state.velocity, want_state.dye,
                                                want_state.pressure)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    assert got_u8.shape == (B, 96, 128, 3)
    _u8_close(got_u8, want_u8)


# ------------------------------------------------ against the port's own sim

RENDER_VARIANTS = [dict(), dict(TRANSPARENT=True), dict(SHADING=False), dict(BLOOM_ITERATIONS=1)]


@pytest.mark.parametrize("flags", RENDER_VARIANTS, ids=lambda f: ",".join(f) or "all")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_each_sim_equals_the_single_sim_render(dtype, flags):
    """Each sim of make_batched_render, on screen and off screen, with the
    built-in and a given dither, equals render_frame on that sim alone, and
    the plain batched render equals it too (on the CPU the same calls)."""
    _, cfg = _cfgs(DTYPE=dtype, **flags)
    _, ts = _states(_cfgs(DTYPE=dtype)[0], seed=3)
    dither = torch.from_numpy(np.random.default_rng(5).random((64, 64)).astype(np.float32))
    for to_screen in (True, False):
        for d in (None, dither):
            render = T.make_batched_render(cfg, to_screen=to_screen, device="cpu")
            got = render(ts, d)
            _each_sim_equal(got, lambda i: T.render_frame(T.unstack_state(ts, i), cfg,
                                                          to_screen=to_screen, dither=d))
            assert torch.equal(plain_batched_render(ts, cfg, to_screen=to_screen, dither=d),
                               got)


@pytest.mark.parametrize("per_sim", [False, True], ids=["lockstep", "per-sim"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_sim_tick_equals_make_step_and_render(dtype, per_sim):
    """Two batched ticks from a running batch: each sim's state and uint8
    frame equal make_step_and_render's on that sim alone, with its dt."""
    _, cfg = _cfgs(DTYPE=dtype)
    _, ts = _states(_cfgs(DTYPE=dtype)[0], seed=6)
    seq = np.stack([T.swirl_trace(cfg, 2, seed=42 + i).batches for i in range(B)], axis=1)
    tick, single = T.make_batched_tick(cfg, device="cpu"), T.make_step_and_render(cfg, device="cpu")
    sims = [T.unstack_state(ts, i) for i in range(B)]
    for t in range(2):
        ts, frames = tick(ts, DTS if per_sim else 1 / 60, seq[t])
        assert frames.shape == (B, 96, 128, 3) and frames.dtype == torch.uint8
        for i in range(B):
            sims[i], frame = single(sims[i], DTS[i] if per_sim else 1 / 60, seq[t, i])
            assert torch.equal(frames[i], frame), (t, i)
            for f in FIELDS:
                assert torch.equal(getattr(T.unstack_state(ts, i), f), getattr(sims[i], f)), \
                    (t, i, f)


# -------------------------------------- the spots that were not batch-aware

def _differing_batch(seed, shape, batch=5):
    """``batch`` sims of ``shape`` from numpy, each with its own scale, so
    that a reduction or slice over the wrong axis shows."""
    rng = np.random.default_rng(seed)
    scale = np.arange(1, batch + 1, dtype=np.float32).reshape((batch,) + (1,) * len(shape))
    return torch.from_numpy((rng.random((batch,) + shape) * scale).astype(np.float32))


@pytest.mark.parametrize("op", ["sunrays_mask", "knee_threshold", "shaded_base",
                                "display_composite", "blend_premultiplied"])
def test_render_ops_take_a_batch(op):
    """Each op on a batch of 5 sims that differ equals the op sim by sim:
    the channel axis is -3 (a reduction or a slice on axis 0 takes sims).
    The composite is taken without bloom: PyTorch's CPU pow in the bloom's
    gamma rounds by an element's place in its vector loop, which is why the
    plain display runs a batch sim by sim."""
    x = _differing_batch(0, (3, 12, 20))
    rays = _differing_batch(1, (9, 11))
    rgba = torch.cat([x, x.amax(dim=1, keepdim=True) * 0.5], dim=1)
    back = torch.from_numpy(np.random.default_rng(4).random((4, 12, 20)).astype(np.float32))
    calls = {
        "sunrays_mask": lambda i: tsunrays.sunrays_mask(x[i]),
        "knee_threshold": lambda i: tbloom.knee_threshold(x[i], 0.6, 0.7),
        "shaded_base": lambda i: tdisplay.shaded_base(x[i], (15, 18), True),
        "display_composite": lambda i: tdisplay.display_composite(
            x[i], (15, 18), True, None, rays[i], None),
        "blend_premultiplied": lambda i: tdisplay.blend_premultiplied(rgba[i], back),
    }
    batched = {
        "sunrays_mask": lambda: tsunrays.sunrays_mask(x),
        "knee_threshold": lambda: tbloom.knee_threshold(x, 0.6, 0.7),
        "shaded_base": lambda: tdisplay.shaded_base(x, (15, 18), True),
        "display_composite": lambda: tdisplay.display_composite(
            x, (15, 18), True, None, rays, None),
        "blend_premultiplied": lambda: tdisplay.blend_premultiplied(rgba, back),
    }
    got = batched[op]()
    assert got.shape[0] == 5
    _each_sim_equal(got, calls[op])


def test_frame_u8_takes_a_batch():
    """frame_u8 of a batch: (B, h, w, 3), each sim flipped on its own row
    axis, equal to frame_u8 of each sim; the batched state's frames differ
    (a dim dye, so that they do not saturate)."""
    _, cfg = _cfgs()
    _, ts = _states(_cfgs()[0], seed=7, dye_max=0.2)
    got = T.frame_u8(ts, cfg, out_hw=(60, 90))
    assert got.shape == (B, 60, 90, 3) and got.dtype == torch.uint8
    _each_sim_equal(got, lambda i: T.frame_u8(T.unstack_state(ts, i), cfg, out_hw=(60, 90)))
    assert not torch.equal(got[0], got[1])


# ------------------------------------------- the batched kernels' structure

# (bloom resolution, canvas w x h, BLOOM_ITERATIONS, sims, blocks): 7 mips at
# the serving configs' base cut small, 3 mips, every level in the block;
# more sims than blocks, so that a block takes several in turn.
BATCHED_PYRAMIDS = [(40, (256, 256), 8, 3, 2), (37, (333, 201), 3, 5, 2),
                    (24, (1280, 720), 8, 4, 3), (64, (1280, 720), 8, 3, 132)]


@pytest.mark.parametrize("res,canvas,iters,sims,blocks", BATCHED_PYRAMIDS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_batched_pyramid_structure_equals_plain(res, canvas, iters, sims, blocks):
    """The batched kernel's phases, transliterated (tests/
    test_torch_render_kernels.py _emulate_pyramid: grid-wide stages over the
    items of every sim, the block phase a sim at a time, block b the sims
    b, b + blocks, ...), give bloom_pyramid_plain's bits on each sim, at
    the default split and with every level grid-wide or in the block."""
    cfg = FluidConfig(BLOOM_RESOLUTION=res, CANVAS_WIDTH=canvas[0], CANVAS_HEIGHT=canvas[1],
                      BLOOM_ITERATIONS=iters).validate()
    mips = cfg.bloom_mip_sizes()
    bw, bh = cfg.bloom_size
    level_hw = [(h, w) for w, h in mips]
    base = _differing_batch(res, (3, bh, bw), sims).numpy() * 2.0
    args = (cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE, cfg.BLOOM_INTENSITY)
    want = kbloom.bloom_pyramid_plain(torch.from_numpy(base), mips, *args).numpy()
    for small in sorted({kbloom.small_level(level_hw), 0, len(mips)}):
        got = _emulate_pyramid(base, mips, *args, small, blocks)
        np.testing.assert_array_equal(got, want)
    for i in range(sims):
        np.testing.assert_array_equal(
            want[i], kbloom.bloom_pyramid_plain(torch.from_numpy(base[i]), mips, *args).numpy())


def test_batched_render_cases_follow_the_batched_render():
    """batched_render_cases are the batched render's calls: the pyramid
    after its batched base resample and the display, whose plain versions
    chained give the batched frame bit for bit, with B times one sim's
    operations and the dither read once."""
    _, cfg = _cfgs(DTYPE="bfloat16", TRANSPARENT=True)
    state, _ = check.random_batch(cfg, B, seed=7, device="cpu")
    cases = check.batched_render_cases(state, cfg)
    assert [c.label for c in cases] == [f"bloom_pyramid:b{B}", f"display:b{B}"]
    np.testing.assert_array_equal(
        cases[-1].run(plain=True).numpy(),
        T.make_batched_render(cfg, to_screen=False, device="cpu")(state).numpy())
    one = check.render_cases(T.unstack_state(state, 0), cfg)
    for c, o in zip(cases, one):
        assert c.flops == B * o.flops
    noise = 64 * 64 * 4
    assert cases[0].nbytes == B * one[0].nbytes
    assert cases[1].nbytes - noise == B * (one[1].nbytes - noise)
    with pytest.raises(ValueError, match="leads with B"):
        check.batched_render_cases(T.unstack_state(state, 0), cfg)


def test_batched_render_inputs_are_checked():
    """The render kernels' wrappers (and their plain versions) refuse a
    batch whose bloom or sunrays do not lead with the dye's B, and the
    batched entry points a state without a batch axis; they run on the card
    by default."""
    x = _differing_batch(0, (3, 12, 20), 3)
    with pytest.raises(ValueError, match="bloom"):
        kdisplay.display_plain(x, (8, 8), True, x[:2, :, :7, :9])
    with pytest.raises(ValueError, match="sunrays"):
        kdisplay.display_plain(x, (8, 8), True, None, x[0, 0])
    with pytest.raises(ValueError, match="bloom base"):
        kbloom.bloom_pyramid_plain(x[:, :2], ((4, 4), (2, 2)), 0.6, 0.7, 0.8)
    _, cfg = _cfgs()
    _, ts = _states(_cfgs()[0], seed=8)
    one = T.unstack_state(ts, 0)
    with pytest.raises(ValueError, match="batched state"):
        T.make_batched_render(cfg, device="cpu")(one)
    with pytest.raises(ValueError, match="batched state"):
        T.make_batched_tick(cfg, device="cpu")(one, 1 / 60, np.zeros((4, 8), np.float32))
    if not torch.cuda.is_available():
        for make in (T.make_batched_render, T.make_batched_tick):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(cfg)
