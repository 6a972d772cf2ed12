"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one every test
skips with its reason. On the card run
    python -m pytest tests/test_torch_kernels.py -q
chip_smoke.py makes the same comparisons at the main path's full shapes.
Tolerances: tpufluid_torch/ops/cuda/check.py.
"""

import pytest
import torch

from tpufluid_torch import FluidConfig, init_state, make_multi_step, swirl_trace
from tpufluid_torch.ops import floors as plain_floors
from tpufluid_torch.ops.cuda import bloom, build, check, display, floors, stencil
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


def test_kernel_rejects_cpu_and_bad_dtype(cuda):
    vel = torch.zeros((2, 8, 8), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel for dtype"):
        stencil.splat_curl(vel)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        stencil.splat_curl(torch.zeros((2, 8, 8)))


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
    """bloom_blur4 and display against their plain versions at small
    shapes: odd canvas, every flag variant, each storage dtype."""
    cfg = FluidConfig(DTYPE=dtype, **{**CONFIGS["ragged"], "CANVAS_WIDTH": 333,
                                      "CANVAS_HEIGHT": 201, **flags}).validate()
    state, _ = check.random_state(cfg, seed=5, device=cuda)
    cases = check.render_cases(state, cfg)
    bloom_stages = 2 * len(cfg.bloom_mip_sizes()) if cfg.BLOOM and len(
        cfg.bloom_mip_sizes()) >= 2 else 0
    assert [c.kernel_name for c in cases] == ["bloom_blur4"] * bloom_stages + ["display"]
    _check_cases(cases)
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


def test_kernel_render_matches_plain_render(cuda):
    cfg = FluidConfig(DTYPE="bfloat16", **CONFIGS["small"]).validate()
    state, _ = check.random_state(cfg, seed=2, device=cuda)
    build.reset_launches()
    got = make_render(cfg)(state)
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    assert launches["bloom_blur4"] == 2 * len(cfg.bloom_mip_sizes())
    assert launches["display"] == 1
    err, tol = check.compare(got, plain_render(state, cfg))
    assert err <= tol, (err, tol)


def test_render_kernels_reject_bad_inputs(cuda):
    with pytest.raises(ValueError, match="takes float32"):
        bloom.blur4_stage(torch.zeros((3, 8, 8), device=cuda, dtype=torch.bfloat16), (4, 4))
    with pytest.raises(ValueError, match="no kernel for dtype"):
        display.display(torch.zeros((3, 8, 8), device=cuda, dtype=torch.float64), (8, 8), True)
    with pytest.raises(ValueError, match="must be float32"):
        display.display(torch.zeros((3, 8, 8), device=cuda), (8, 8), True,
                        torch.zeros((3, 4, 4), device=cuda, dtype=torch.float16))


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


def test_profile_counts_every_launch(cuda):
    cfg = FluidConfig(DTYPE="bfloat16", **CONFIGS["small"]).validate()
    state, _ = check.random_state(cfg, seed=4, device=cuda)
    times, other = floors.profile_step_kernels(cfg, state, 1 / 60, steps=3)
    events = {k: v["events"] for k, v in other["kernel_events"].items()}
    assert events == {"advect": 6, "confine_divergence": 3, "gradient_subtract": 3,
                      "jacobi_sweep": 60, "splat_curl": 3}
    assert set(times) == {"velocity_gather", "dye_gather", "jacobi", "stencil",
                          "gradient_subtract"}
    assert all(v > 0 for v in times.values())


def test_reference_rates_run(cuda):
    before = {k: build.KERNELS[k].launches for k in ("floor_taa", "floor_roll", "floor_sweep")}
    assert floors.measure_taa_row_rate(planes=2, n_idx=2, reps=2, trips=2) > 0
    assert floors.measure_roll_rate(2, 96, 384, trips=8) > 0
    assert floors.measure_sweep_rate(chunks=1, sweeps=2) > 0
    assert floors.measure_hbm_bandwidth_gbps() > 0
    for k, n in before.items():
        assert build.KERNELS[k].launches == n + 40, k     # 10 warm-up + 3 x 10 timed
