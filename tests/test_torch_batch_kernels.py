"""The step's kernels on a batch of B sims in one launch, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one every test
skips with its reason. They import no JAX, so on the card run
    python -m pytest --noconftest tests/test_torch_batch_kernels.py -q
Every comparison is exact (max abs error 0): the batched kernels against
their plain versions (which run the batch sim by sim), each sim against the
kernel launched on that sim alone, on both tiles of pre_pressure and of
jacobi_chunk, in both forms of dt (a number for every sim, or a (B, 2)
table of each sim's clamped dt and decay). tests/test_torch_batch.py holds
the batched step to tpufluid's on the CPU.
"""

import numpy as np
import pytest
import torch

from tpufluid_torch import (FluidConfig, init_batch, make_batched_multi_step, make_batched_step,
                            make_step, stack_states, swirl_trace, unstack_state)
from tpufluid_torch.batch import plain_batched_step, step_dt
from tpufluid_torch.ops.cuda import advect, build, check, jacobi, stencil
from tpufluid_torch.ops.splat import splat_factors
from tpufluid_torch.step import clamp_dt

FIELDS = ("velocity", "dye", "pressure")
CONFIGS = {
    # cross grid (dye 2x the sim); ragged: odd sizes, dye 131 on sim 37; same grid
    "small": dict(SIM_RESOLUTION=48, DYE_RESOLUTION=96, CANVAS_WIDTH=192,
                  CANVAS_HEIGHT=128, MAX_SPLATS=4),
    "ragged": dict(SIM_RESOLUTION=37, DYE_RESOLUTION=131, CANVAS_WIDTH=1280,
                   CANVAS_HEIGHT=720, MAX_SPLATS=8),
    "same": dict(SIM_RESOLUTION=64, DYE_RESOLUTION=64, CANVAS_WIDTH=64,
                 CANVAS_HEIGHT=64, MAX_SPLATS=8),
}
DTYPES = [("float32", False), ("bfloat16", True), ("bfloat16", False), ("float16", False)]
PER_STEP = {"pre_pressure": 1, "jacobi_chunk": 1, "jacobi_project": 1, "advect": 1,
            "advect_dye": 1}


@pytest.fixture
def cuda():
    """The card; skips the test where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg(size, dtype="float32", rgb9e5=False):
    return FluidConfig(DTYPE=dtype, DYE_RGB9E5=rgb9e5, **CONFIGS[size]).validate()


def _equal(got, want, label):
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for g, w in zip(gots, wants):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.equal(g, w), (label, float((g.float() - w.float()).abs().max()))


@pytest.mark.parametrize("size", sorted(CONFIGS))
@pytest.mark.parametrize("dtype,rgb9e5", DTYPES, ids=["float32", "bfloat16-rgb9e5", "bfloat16",
                                                      "float16"])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_batched_kernels_match_plain(batch, size, dtype, rgb9e5, cuda):
    """Every batched kernel call of a step, both forms of dt, one launch
    each, bit-equal to the plain versions run sim by sim."""
    cfg = _cfg(size, dtype, rgb9e5)
    for case in check.batched_step_cases(cfg, batch, seed=11, device=cuda):
        before = build.KERNELS[case.kernel_name].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS[case.kernel_name].launches > before, case.label
        _equal(got, case.run(plain=True), case.label)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_batched_tiles_equal_single_launches(dtype, cuda):
    """A batch of 16 sims of 256^2 takes the large tiles of pre_pressure
    and jacobi_chunk (32 and 18 blocks a sim), one sim the small ones: each
    sim of the batch equals its own single-sim launch bit for bit, on
    either tile, with its own dt from the table."""
    sms = build.sm_count(cuda)
    assert stencil.plan(256, 256, sms, 16) == stencil.LARGE
    assert stencil.plan(256, 256, sms) == stencil.SMALL
    assert jacobi.tiles_for(256, 256, sms, 16) == jacobi.LARGE
    assert jacobi.tiles_for(256, 256, sms) == jacobi.SMALL
    cfg = FluidConfig(SIM_RESOLUTION=256, DYE_RESOLUTION=256, CANVAS_WIDTH=256,
                      CANVAS_HEIGHT=256, MAX_SPLATS=8, DTYPE=str(dtype)[6:],
                      DYE_RGB9E5=dtype == torch.bfloat16).validate()
    state, splats = check.random_batch(cfg, 16, seed=3, device=cuda)
    dts = check.per_sim_dts(16)
    table = step_dt(dts, 16, cfg, cuda)
    vf = splat_factors(splats, 256, 256, cfg.splat_radius_uv(), cfg.aspect_ratio, slice(2, 4))
    for tiles in range(len(stencil.TILES)):
        vel, div = stencil.run_tiles(state.velocity, cfg.CURL, table[0], vf, tiles)
        for b in range(16):
            one = stencil.run_tiles(state.velocity[b], cfg.CURL, clamp_dt(dts[b]),
                                    tuple(t[b] for t in vf), stencil.SMALL)
            _equal((vel[b], div[b]), one, f"pre_pressure tile {tiles} sim {b}")
    p = jacobi.jacobi_pressure(state.pressure, div, 20, 0.8)
    for b in range(16):
        _equal(p[b], jacobi.jacobi_pressure(state.pressure[b], div[b], 20, 0.8),
               f"jacobi sim {b}")
    g = stencil.gradient_subtract(vel, p)
    # the fused solve: the batch on the large tiles, each sim on the small
    _equal(jacobi.jacobi_project(state.pressure, div, vel, 20, 0.8), (p, g), "jacobi_project")
    for b in range(16):
        _equal(jacobi.jacobi_project(state.pressure[b], div[b], vel[b], 20, 0.8), (p[b], g[b]),
               f"jacobi_project sim {b}")
    a = advect.advect(g, state.dye, table[1], cfg.DENSITY_DISSIPATION,
                      splat_factors(splats, 256, 256, cfg.splat_radius_uv(),
                                    cfg.aspect_ratio, slice(4, 7)),
                      "rgb9e5" if cfg.DYE_RGB9E5 else None)
    for b in range(16):
        _equal(g[b], stencil.gradient_subtract(vel[b], p[b]), f"gradient_subtract sim {b}")
        df = splat_factors(splats[b], 256, 256, cfg.splat_radius_uv(), cfg.aspect_ratio,
                           slice(4, 7))
        _equal(a[b], advect.advect(g[b], state.dye[b], clamp_dt(dts[b]),
                                   cfg.DENSITY_DISSIPATION, df,
                                   "rgb9e5" if cfg.DYE_RGB9E5 else None), f"advect sim {b}")


@pytest.mark.parametrize("size", ["small", "same"])
@pytest.mark.parametrize("dtype,rgb9e5", [("float32", False), ("bfloat16", True)])
def test_batched_steps_equal_single_steps(size, dtype, rgb9e5, cuda):
    """Three batched steps, per-sim dts and each sim its own swirl trace:
    every sim equals make_step on that sim alone bit for bit, and the batch
    equals the plain batched step; lock-step 1/60 equals a table of 1/60.
    Each batched step launches what one single-sim step launches."""
    cfg = _cfg(size, dtype, rgb9e5)
    b, t = 3, 3
    traces = [swirl_trace(cfg, t, seed=42 + i) for i in range(b)]
    seq = np.stack([tr.batches for tr in traces], axis=1)          # (T, B, S, 8)
    dts = np.stack([np.full(t, d, np.float32) for d in (1 / 60, 1 / 90, 1 / 120)], axis=1)
    step = make_batched_step(cfg)
    build.reset_launches()
    state = init_batch(cfg, b)
    want = init_batch(cfg, b)
    for k in range(t):
        state = step(state, dts[k], seq[k])
        want = plain_batched_step(want, dts[k], torch.as_tensor(seq[k], device=cuda), cfg)
    torch.cuda.synchronize()
    assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == \
        {k: n * t for k, n in PER_STEP.items()}
    single = make_step(cfg)
    for i in range(b):
        s = unstack_state(init_batch(cfg, b), i)
        for k in range(t):
            s = single(s, dts[k, i], seq[k, i])
        for f in FIELDS:
            _equal(getattr(unstack_state(state, i), f), getattr(s, f), f"sim {i} {f}")
    for f in FIELDS:
        _equal(getattr(state, f), getattr(want, f), f"plain {f}")
    multi = make_batched_multi_step(cfg)
    lock = multi(init_batch(cfg, b), 1 / 60, seq)
    table = multi(init_batch(cfg, b), np.full((t, b), 1 / 60, np.float32), seq)
    for f in FIELDS:
        _equal(getattr(lock, f), getattr(table, f), f"lock-step {f}")


def test_batched_step_launches_seven_whatever_b(cuda):
    """The batched step's launches whatever B is: the test keeps its name
    from when they were seven; since the dye's kernel six, since the fused
    jacobi_project five."""
    cfg = _cfg("small")
    for b in (1, 5):
        state = stack_states([check.random_state(cfg, i, cuda)[0] for i in range(b)])
        splats = torch.stack([check.random_state(cfg, i, cuda)[1] for i in range(b)])
        build.reset_launches()
        make_batched_step(cfg)(state, np.full(b, 1 / 60), splats)
        torch.cuda.synchronize()
        assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == PER_STEP
        assert sum(PER_STEP.values()) == 5


def test_bad_dt_table_raises(cuda):
    """A dt table on the wrong device, of the wrong type, not contiguous or
    of the wrong B raises in the wrapper, before any launch."""
    cfg = _cfg("small")
    state, splats = check.random_batch(cfg, 3, seed=1, device=cuda)
    good = step_dt(check.per_sim_dts(3), 3, cfg, cuda)[0]
    bad = {"device": good.cpu(), "dtype": good.double(),
           "contiguous": torch.zeros((2, 3), device=cuda).t(),
           "batch": step_dt(check.per_sim_dts(4), 4, cfg, cuda)[0]}
    build.reset_launches()
    for name, dt in bad.items():
        with pytest.raises(ValueError, match="dt table"):
            stencil.pre_pressure(state.velocity, cfg.CURL, dt)
        with pytest.raises(ValueError, match="dt table"):
            advect.advect(state.velocity, state.dye, dt, 1.0)
    assert not any(k.launches for k in build.KERNELS.values())
    assert not bad["contiguous"].is_contiguous()


def test_wide_batches_take_64_bit_offsets(cuda):
    """Batches with more than 2^31 values in a field (the 64-bit index path
    of csrc/common.cuh DISPATCH_INDEX; B >= 43 at 4096^2 for the dye):
    the first and the last sim each equal their own single-sim launch (the
    32-bit path) bit for bit. bf16 at 1024^2, so that one kernel at a time
    holds at most ~22 GB."""
    h = w = 1024
    big = 2 ** 31

    def rand(*shape):
        return torch.empty(shape, device=cuda, dtype=torch.bfloat16).normal_(0, 100)

    def check_ends(batched, single, n):
        got = batched()
        for b in (0, n - 1):
            _equal(got[b], single(b), f"sim {b} of {n}")
        del got
        torch.cuda.empty_cache()

    n = big // (2 * h * w) + 1                       # gradient_subtract: 2 B H W > 2^31
    vel, p = rand(n, 2, h, w), rand(n, h, w)
    check_ends(lambda: stencil.gradient_subtract(vel, p), lambda b: stencil.gradient_subtract(
        vel[b], p[b]), n)
    del vel, p
    n = big // (2 * h * w) + 1                       # jacobi_project: 2 B H W > 2^31
    vel, p, d = rand(n, 2, h, w), rand(n, h, w), rand(n, h, w)
    got = jacobi.jacobi_project(p, d, vel, 20, 0.8)
    for b in (0, n - 1):
        _equal((got[0][b], got[1][b]), jacobi.jacobi_project(p[b], d[b], vel[b], 20, 0.8),
               f"jacobi_project sim {b} of {n}")
    del vel, p, d, got
    torch.cuda.empty_cache()
    n = big // (h * w) + 1                           # jacobi_chunk: B H W > 2^31
    p, d = rand(n, h, w), rand(n, h, w)
    check_ends(lambda: jacobi.jacobi_pressure(p, d, 20, 0.8),
               lambda b: jacobi.jacobi_pressure(p[b], d[b], 20, 0.8), n)
    del p, d
    torch.cuda.empty_cache()
    n = big // (3 * h * w) + 1                       # advect_dye and advect: 3 B H W > 2^31
    vel, dye = rand(n, 2, h, w), rand(n, 3, h, w).abs_()
    check_ends(lambda: advect.advect(vel, dye, 1 / 60, 1.0, None, "rgb9e5"),
               lambda b: advect.advect(vel[b], dye[b], 1 / 60, 1.0, None, "rgb9e5"), n)
    check_ends(lambda: advect.advect(vel, dye, 1 / 60, 1.0),
               lambda b: advect.advect(vel[b], dye[b], 1 / 60, 1.0), n)
