"""The step's kernels on a lane-packed fleet (tpufluid_torch/batch_packed.py),
on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one every test
skips with its reason. They import no JAX, so on the card run
    python -m pytest --noconftest tests/test_torch_packed_kernels.py -q
Every comparison is exact (max abs error 0): each packed kernel against its
plain version (the fleet unpacked and run as a batch), in float32,
bfloat16 (with and without RGB9E5) and float16, on fleets of sims that
differ; a width whose rows are not whole 16-byte units; each packed sim
against the batched step; the packed launches with 64-bit indices against
single-sim launches. tests/test_torch_packed.py holds the packed step to
tpufluid's on the CPU.
"""

import numpy as np
import pytest
import torch

from tpufluid_torch import (FluidConfig, init_batch, make_batched_multi_step, make_step,
                            swirl_trace, unstack_state)
from tpufluid_torch.batch_packed import (init_packed, make_packed_multi_step,
                                         make_packed_step, pack_fleet, pack_state,
                                         plain_packed_step, unpack_state)
from tpufluid_torch.ops.cuda import advect, build, check, jacobi, stencil

FIELDS = ("velocity", "dye", "pressure")
CONFIGS = {
    # same grid 64^2; ragged: 37 rows of 66 columns (no 16-byte rows in any
    # dtype); the demo's sim grid, 128 x 228 (456-byte bf16 rows, 912-byte f32)
    "same": dict(SIM_RESOLUTION=64, DYE_RESOLUTION=64, CANVAS_WIDTH=64, CANVAS_HEIGHT=64,
                 MAX_SPLATS=8),
    "ragged": dict(SIM_RESOLUTION=37, DYE_RESOLUTION=37, CANVAS_WIDTH=1280,
                   CANVAS_HEIGHT=720, MAX_SPLATS=8),
    "demo_w228": dict(SIM_RESOLUTION=128, DYE_RESOLUTION=128, CANVAS_WIDTH=1280,
                      CANVAS_HEIGHT=720, MAX_SPLATS=8),
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
def test_packed_kernels_match_plain(batch, size, dtype, rgb9e5, cuda):
    """Every packed kernel call of a step, one launch each, bit-equal to
    the plain versions; sims that differ, with different numbers of active
    splat rows."""
    cfg = _cfg(size, dtype, rgb9e5)
    for case in check.packed_step_cases(cfg, batch, seed=11, device=cuda):
        before = build.KERNELS[case.kernel_name].launches
        got = case.run()
        torch.cuda.synchronize()
        assert build.KERNELS[case.kernel_name].launches > before, case.label
        _equal(got, case.run(plain=True), case.label)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_packed_kernels_equal_batched_kernels(dtype, cuda):
    """A fleet of 16 sims of 128 x 228, each kernel of the step packed and
    batched on the same sims, on both tiles of pre_pressure: the packed
    output is the batched output packed, bit for bit (228 bf16 or f16
    values are 456 bytes, so pre_pressure's packed window loads are element
    loads there; 912 f32 bytes are 16-byte units)."""
    cfg = _cfg("demo_w228", str(dtype)[6:], dtype == torch.bfloat16)
    h, w = cfg.sim_size[1], cfg.sim_size[0]
    assert (h, w) == (128, 228)
    state, splats = check.random_batch(cfg, 16, seed=3, device=cuda)
    packed = pack_state(state)
    for case, twin in zip(check.packed_step_cases(cfg, 16, 3, cuda),
                          check.batched_step_cases(cfg, 16, 3, cuda)):
        assert case.label == twin.label.replace(":b16", ":packed:b16"), case.label
        got, want = case.run(), twin.run()
        want = tuple(map(pack_fleet, want)) if isinstance(want, tuple) else pack_fleet(want)
        _equal(got, want, case.label)
    vf = check.splat_factors(splats, h, w, cfg.splat_radius_uv(), cfg.aspect_ratio,
                             slice(2, 4))
    for tiles in range(len(stencil.TILES)):
        got = stencil.run_tiles(packed.velocity, cfg.CURL, 1 / 60, vf, tiles, sim_w=w)
        want = stencil.run_tiles(state.velocity, cfg.CURL, 1 / 60, vf, tiles)
        _equal(got, tuple(pack_fleet(t) for t in want), f"pre_pressure tile {tiles}")


@pytest.mark.parametrize("size", ["same", "ragged"])
@pytest.mark.parametrize("dtype,rgb9e5", [("float32", False), ("bfloat16", True)])
def test_packed_steps_equal_batched_steps(size, dtype, rgb9e5, cuda):
    """Three packed steps, each sim its own swirl trace, lock-step: every
    sim equals make_batched_multi_step's and make_step's on it alone bit
    for bit, and the fleet equals plain_packed_step; each packed step
    launches what one batched step launches."""
    cfg = _cfg(size, dtype, rgb9e5)
    b, t = 5, 3
    seq = np.stack([swirl_trace(cfg, t, seed=42 + i).batches for i in range(b)], axis=1)
    build.reset_launches()
    got = make_packed_multi_step(cfg, b)(init_packed(cfg, b), 1 / 60, seq)
    torch.cuda.synchronize()
    assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == \
        {k: n * t for k, n in PER_STEP.items()}
    want = make_batched_multi_step(cfg)(init_batch(cfg, b), 1 / 60, seq)
    plain = init_packed(cfg, b)
    for k in range(t):
        plain = plain_packed_step(plain, 1 / 60, torch.as_tensor(seq[k], device=cuda), cfg, b)
    unpacked = unpack_state(got, b)
    for f in FIELDS:
        _equal(getattr(unpacked, f), getattr(want, f), f"batched {f}")
        _equal(getattr(got, f), getattr(plain, f), f"plain {f}")
    single = make_step(cfg)
    for i in (0, b - 1):
        s = unstack_state(init_batch(cfg, b), i)
        for k in range(t):
            s = single(s, 1 / 60, seq[k, i])
        for f in FIELDS:
            _equal(getattr(unstack_state(unpacked, i), f), getattr(s, f), f"sim {i} {f}")


@pytest.mark.parametrize("dtype,size", [("float16", "same"), ("float32", "cross")])
def test_unsupported_geometry_steps_through_the_batched_kernels(dtype, size, cuda):
    """float16 and the demo's cross grid are not packed_supported: a packed
    step unpacks, runs the batched kernels on the card (5 launches) and
    packs, equal to the batched step."""
    base = CONFIGS["same"] if size == "same" else dict(CONFIGS["same"], DYE_RESOLUTION=128)
    cfg = FluidConfig(DTYPE=dtype, **base).validate()
    b = 3
    state, splats = check.random_batch(cfg, b, seed=4, device=cuda)
    build.reset_launches()
    got = make_packed_step(cfg, b)(pack_state(state), 1 / 60, splats)
    torch.cuda.synchronize()
    assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == PER_STEP
    want = make_batched_multi_step(cfg)(state, 1 / 60, splats[None])
    for f in FIELDS:
        _equal(getattr(unpack_state(got, b), f), getattr(want, f), f)


def test_refused_packed_launch_raises(cuda):
    """A fleet past the grid's z axis (65535 sims) is refused by the
    launcher, and the wrapper raises; so does a pressure not on the packed
    grid, before any launch."""
    vel = torch.zeros((2, 4, 65536), device=cuda)
    p = torch.zeros((4, 65536), device=cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        stencil.gradient_subtract(vel, p, sim_w=1)
    build.reset_launches()
    with pytest.raises(ValueError, match="!= grid"):
        stencil.gradient_subtract(vel, p[:, :64].contiguous(), sim_w=1)
    with pytest.raises(ValueError, match="whole number of sims"):
        jacobi.jacobi_pressure(p, p, 20, 0.8, sim_w=3)
    with pytest.raises(ValueError, match="not on the pressure's grid"):
        jacobi.jacobi_project(p[:, :64].contiguous(), p[:, :64].contiguous(), vel, 20, 0.8,
                              sim_w=1)
    assert not any(k.launches for k in build.KERNELS.values())
    with pytest.raises(RuntimeError, match="jacobi_project failed to launch"):
        jacobi.jacobi_project(p, p, vel, 0, 0.8, sim_w=1)
    # the step still runs after a refused launch
    one = stencil.gradient_subtract(vel[:, :, :128].contiguous(), p[:, :128].contiguous(),
                                    sim_w=64)
    torch.cuda.synchronize()
    assert one.shape == (2, 4, 128)


def test_wide_packed_fleets_take_64_bit_offsets(cuda):
    """Packed fields with more than 2^31 values (DISPATCH_INDEX counts the
    fleet's C*H*B*W): the first and the last sim of the packed gradient
    subtract, Jacobi solve, velocity self-advection and dye advection each
    equal their own single-sim launch (the 32-bit path) bit for bit. bf16
    at 1024^2."""
    h = w = 1024
    big = 2 ** 31

    def rand(*shape):
        return torch.empty(shape, device=cuda, dtype=torch.bfloat16).normal_(0, 100)

    def sim(x, b):
        return x[..., b * w:(b + 1) * w].contiguous()

    def check_ends(packed, single, n):
        got = packed()
        for b in (0, n - 1):
            _equal(sim(got, b), single(b), f"sim {b} of {n}")
        del got
        torch.cuda.empty_cache()

    n = big // (2 * h * w) + 1                       # 2 H B W > 2^31
    vel, p = rand(2, h, n * w), rand(h, n * w)
    check_ends(lambda: stencil.gradient_subtract(vel, p, sim_w=w),
               lambda b: stencil.gradient_subtract(sim(vel, b), sim(p, b)), n)
    check_ends(lambda: advect.advect(vel, vel, 1 / 60, 0.2, sim_w=w),
               lambda b: advect.advect(sim(vel, b), sim(vel, b), 1 / 60, 0.2), n)
    d = rand(h, n * w)                               # the fused solve: its velocity's 2 H B W
    got = jacobi.jacobi_project(p, d, vel, 20, 0.8, sim_w=w)
    for b in (0, n - 1):
        _equal((sim(got[0], b), sim(got[1], b)),
               jacobi.jacobi_project(sim(p, b), sim(d, b), sim(vel, b), 20, 0.8),
               f"jacobi_project sim {b} of {n}")
    del got, d
    torch.cuda.empty_cache()
    del p
    dye = rand(3, h, n * w).abs_()                   # 3 H B W > 2^31
    check_ends(lambda: advect.advect(vel, dye, 1 / 60, 1.0, None, "rgb9e5", sim_w=w),
               lambda b: advect.advect(sim(vel, b), sim(dye, b), 1 / 60, 1.0, None, "rgb9e5"),
               n)
    del vel, dye
    torch.cuda.empty_cache()
    n = big // (h * w) + 1                           # H B W > 2^31
    p, d = rand(h, n * w), rand(h, n * w)
    check_ends(lambda: jacobi.jacobi_pressure(p, d, 20, 0.8, sim_w=w),
               lambda b: jacobi.jacobi_pressure(sim(p, b), sim(d, b), 20, 0.8), n)
