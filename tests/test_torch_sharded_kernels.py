"""pre_pressure's true-wall form and the sharded step on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one every test
skips with its reason. They import no JAX, so on the card run
    python -m pytest --noconftest tests/test_torch_sharded_kernels.py -q
Every comparison is exact (max abs error 0): the kernel on the window of a
shard's walls (check.bounded_cases, both tiles) against its plain version,
the dye kernel with the sharded step's float32 velocity beside a 16-bit dye
against advect_plain,
and the sharded step through the kernels against the sharded step through
the plain versions on the same card, the shards of a mesh on the cards
there are, round robin. The batch-mesh modes likewise: both kernel forms
on a batch with per-sim dt tables (check.batched_bounded_cases,
check.batched_f32_velocity_dye_cases), the batch x spatial multi-step
against its plain passes, batch DP against the unsharded batch.
tests/test_torch_sharding.py and tests/test_torch_batch_mesh.py hold
these modes to tpufluid's on the CPU.
"""

import pytest
import torch

import numpy as np

from tpufluid_torch import (FluidConfig, gather_batch, gather_batch_spatial, init_batch,
                            init_state, make_batch_sharded_multi_step,
                            make_batch_spatial_mesh, make_batch_spatial_multi_step,
                            make_batched_multi_step, make_sharded_step, shard_batch,
                            shard_batch_spatial, shard_state, swirl_trace)
from tpufluid_torch.ops.cuda import build, check
from tpufluid_torch.ops.cuda import stencil as kstencil
from tpufluid_torch.parallel.mesh import gather_state, make_mesh
from tpufluid_torch.parallel.sharded_step import _G_STENCIL, _GC, plain_sharded_step

FIELDS = ("velocity", "dye", "pressure")
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
GHOSTS = (_G_STENCIL, _GC)   # pre_pressure's padded block in the sharded step


@pytest.fixture
def cuda():
    """The card; skips the test where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mesh(shape):
    n = torch.cuda.device_count()
    return make_mesh(devices=[f"cuda:{k % n}" for k in range(shape[0] * shape[1])],
                     shape=shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_bounded_pre_pressure_matches_plain(dtype, cuda):
    """Every wall of check.shard_bounds on both shard shapes, one launch
    each, bit-equal to the plain version inside the walls: the unbounded
    chain on the window (outside, the outputs are unspecified)."""
    for case in check.bounded_cases(cuda, dtype, GHOSTS, seed=5):
        before = build.KERNELS["pre_pressure"].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS["pre_pressure"].launches == before + 1, case.label
        for g, w in zip(got, case.run(plain=True)):
            assert torch.equal(g, w), (case.label, float((g.float() - w.float()).abs().max()))


@pytest.mark.parametrize("dtype,rgb9e5", [("bfloat16", True), ("bfloat16", False),
                                          ("float16", False)])
@pytest.mark.parametrize("grid", ["demo", "ragged"])
def test_dye_with_a_float32_velocity_matches_plain(grid, dtype, rgb9e5, cuda):
    """advect_dye with the float32 velocity the sharded step gives a 16-bit
    dye (check.f32_velocity_dye_cases: the coarse velocity, and the
    velocity resampled on the dye's grid), one launch each, bit-equal to
    advect_plain, at the demo's geometry and a ragged one."""
    kw = (dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720)
          if grid == "demo" else dict(SIM_RESOLUTION=37, DYE_RESOLUTION=131,
                                      CANVAS_WIDTH=1280, CANVAS_HEIGHT=720))
    cfg = FluidConfig(DTYPE=dtype, DYE_RGB9E5=rgb9e5, MAX_SPLATS=8, **kw).validate()
    for case in check.f32_velocity_dye_cases(cfg, seed=3, device=cuda):
        assert case.args[0].dtype == torch.float32 and case.args[1].dtype == cfg.dtype
        before = build.KERNELS["advect_dye"].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS["advect_dye"].launches == before + 1, case.label
        want = case.run(plain=True)
        assert torch.equal(got, want), (case.label, float((got.float() - want.float()).abs().max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_bounded_tiles_equal_the_window_copy(dtype, cuda):
    """On either tile, the kernel on a window in place equals the kernel on
    a contiguous copy of the window and its factors, bit for bit."""
    for case in check.bounded_cases(cuda, dtype, GHOSTS, seed=6, shards=((96, 160),)):
        vel, cs, dt, (gy, gx, amt), bounds = case.args
        r0, c0, h, w = kstencil.window(*vel.shape[-2:], bounds)
        rows, cols = slice(r0, r0 + h), slice(c0, c0 + w)
        copy = (vel[:, rows, cols].contiguous(), cs, dt,
                (gy[rows].contiguous(), gx[:, cols].contiguous(), amt))
        for n in range(len(kstencil.TILES)):
            got = kstencil.run_tiles(*case.args[:4], n, bounds)
            want = kstencil.run_tiles(*copy, n)
            torch.cuda.synchronize()
            assert torch.equal(got[0][:, rows, cols], want[0]), (case.label, n)
            assert torch.equal(got[1][rows, cols], want[1]), (case.label, n)


def test_bounds_that_leave_no_texel_raise(cuda):
    vel = torch.zeros((2, 16, 16), device=cuda)
    with pytest.raises(ValueError, match="leave no texel"):
        kstencil.pre_pressure(vel, 30.0, 1 / 60, None, (20, 1 << 30, 0, 15))


@pytest.mark.parametrize("name,kw,shape", [
    ("cross-grid-2x2", dict(SIM_RESOLUTION=64, DYE_RESOLUTION=256, CANVAS_WIDTH=512,
                            CANVAS_HEIGHT=256), (2, 2)),
    ("bf16-4x1", dict(SIM_RESOLUTION=256, DYE_RESOLUTION=256, CANVAS_WIDTH=256,
                      CANVAS_HEIGHT=256, DTYPE="bfloat16"), (4, 1)),
    ("bf16-overlap-2x2", dict(SIM_RESOLUTION=256, DYE_RESOLUTION=256, CANVAS_WIDTH=256,
                              CANVAS_HEIGHT=256, DTYPE="bfloat16", OVERLAP_HALO=True), (2, 2)),
])
def test_sharded_step_kernels_equal_plain(name, kw, shape, cuda):
    """Three sharded steps through the kernels equal three through the
    plain versions on the same card, every shard bit for bit, and the
    kernels launched on every shard: 6 launches a shard a step, 18 where
    every phase splits (an interior band and two strips)."""
    cfg = FluidConfig(MAX_SPLATS=8, **kw).validate()
    mesh = _mesh(shape)
    trace = swirl_trace(cfg, 3, seed=4)
    step = make_sharded_step(cfg, mesh)
    a = shard_state(init_state(cfg, device=cuda), mesh)
    b = shard_state(init_state(cfg, device=cuda), mesh)
    build.reset_launches()
    for t in range(3):
        a = step(a, trace.dts[t], trace.batches[t])
    torch.cuda.synchronize()
    launches = sum(k.launches for k in build.KERNELS.values())
    per_shard = 18 if cfg.overlap_halo else 6
    assert launches == 3 * per_shard * shape[0] * shape[1], launches
    for t in range(3):
        b = plain_sharded_step(b, trace.dts[t], trace.batches[t], cfg)
    ga, gb = gather_state(a), gather_state(b)
    for f in FIELDS:
        x, y = getattr(ga, f), getattr(gb, f)
        assert bool(torch.isfinite(x.float()).all()), (name, f)
        assert torch.equal(x, y), (name, f, float((x.float() - y.float()).abs().max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_batched_bounded_pre_pressure_matches_plain(dtype, cuda):
    """The true-wall form on a batch of 3 sims with a per-sim dt table,
    every wall, one launch each, bit-equal to the plain version (each
    sim's window) inside the walls."""
    for case in check.batched_bounded_cases(cuda, dtype, GHOSTS, seed=5):
        before = build.KERNELS["pre_pressure"].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS["pre_pressure"].launches == before + 1, case.label
        for g, w in zip(got, case.run(plain=True)):
            assert torch.equal(g, w), (case.label, float((g.float() - w.float()).abs().max()))


@pytest.mark.parametrize("dtype,rgb9e5", [("bfloat16", True), ("bfloat16", False),
                                          ("float16", False)])
def test_batched_dye_with_a_float32_velocity_matches_plain(dtype, rgb9e5, cuda):
    """advect_dye on a batch of 3 with a float32 velocity beside the 16-bit
    dye and the dye's per-sim dt table, one launch, bit-equal to
    advect_plain, at a ragged cross grid."""
    cfg = FluidConfig(SIM_RESOLUTION=37, DYE_RESOLUTION=131, CANVAS_WIDTH=1280,
                      CANVAS_HEIGHT=720, DTYPE=dtype, DYE_RGB9E5=rgb9e5, MAX_SPLATS=8).validate()
    for case in check.batched_f32_velocity_dye_cases(cfg, seed=3, device=cuda):
        before = build.KERNELS["advect_dye"].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS["advect_dye"].launches == before + 1, case.label
        want = case.run(plain=True)
        assert torch.equal(got, want), (case.label, float((got.float() - want.float()).abs().max()))


def _bs_mesh(shape):
    n = torch.cuda.device_count()
    return make_batch_spatial_mesh(shape, [f"cuda:{k % n}" for k in range(int(np.prod(shape)))])


@pytest.mark.parametrize("kw,shape", [
    (dict(SIM_RESOLUTION=64, DYE_RESOLUTION=256, CANVAS_WIDTH=512, CANVAS_HEIGHT=256,
          DTYPE="bfloat16"), (2, 2, 2)),
    (dict(SIM_RESOLUTION=256, DYE_RESOLUTION=512, CANVAS_WIDTH=256, CANVAS_HEIGHT=256,
          OVERLAP_HALO=True), (2, 2, 1)),
], ids=["cross-grid-bf16-222", "split-221"])
def test_batch_spatial_kernels_equal_plain(kw, shape, cuda):
    """Two batch x spatial steps (two sims a group, per-sim dts) through the
    kernels equal the same through the plain passes, bit for bit; a
    group's launches are a sharded step's, whatever its batch."""
    cfg = FluidConfig(MAX_SPLATS=8, **kw).validate()
    mesh = _bs_mesh(shape)
    b = 2 * shape[0]
    seq = np.stack([swirl_trace(cfg, 2, seed=4 + i).batches for i in range(b)], axis=1)
    dts = np.broadcast_to(check.per_sim_dts(b), (2, b))
    build.reset_launches()
    a = make_batch_spatial_multi_step(cfg, mesh)(
        shard_batch_spatial(init_batch(cfg, b, device=cuda), mesh), dts, seq)
    torch.cuda.synchronize()
    per_shard = 18 if cfg.overlap_halo else 6
    assert sum(k.launches for k in build.KERNELS.values()) == 2 * per_shard * int(np.prod(shape))
    p = make_batch_spatial_multi_step(cfg, mesh, plain=True)(
        shard_batch_spatial(init_batch(cfg, b, device=cuda), mesh), dts, seq)
    ga, gp = gather_batch_spatial(a), gather_batch_spatial(p)
    for f in FIELDS:
        assert torch.equal(getattr(ga, f), getattr(gp, f)), f


def test_batch_dp_equals_unsharded_on_the_card(cuda):
    """Batch DP on a (4, 1) mesh (2 sims a slice, per-sim dts) equals the
    unsharded batched multi-step bit for bit: 5 launches a slice a step
    (the batched step's, its solve's last launch jacobi_project)."""
    cfg = FluidConfig(SIM_RESOLUTION=64, DYE_RESOLUTION=128, CANVAS_WIDTH=128,
                      CANVAS_HEIGHT=128, MAX_SPLATS=8, DTYPE="bfloat16").validate()
    b, t = 8, 3
    seq = np.stack([swirl_trace(cfg, t, seed=9 + i).batches for i in range(b)], axis=1)
    dts = np.broadcast_to(check.per_sim_dts(b), (t, b))
    want = make_batched_multi_step(cfg, device=cuda)(init_batch(cfg, b, device=cuda), dts, seq)
    mesh = _mesh((4, 1))
    build.reset_launches()
    got = make_batch_sharded_multi_step(cfg, mesh)(
        shard_batch(init_batch(cfg, b, device=cuda), mesh), dts, seq)
    torch.cuda.synchronize()
    assert sum(k.launches for k in build.KERNELS.values()) == 5 * 4 * t
    whole = gather_batch(got, want.velocity.device)
    for f in FIELDS:
        assert torch.equal(getattr(whole, f), getattr(want, f)), f
