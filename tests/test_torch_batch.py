"""The port's batched step (tpufluid_torch/batch.py) against tpufluid's on
the CPU, and against its own single-sim step.

The port's batched step runs the kernels' plain versions sim by sim here;
JAX's vmaps its step over the batch, on its kernel path (USE_PALLAS=True,
whose dispatch runs the jnp oracle off-TPU), as tests/test_torch_step.py
holds the single-sim step. Tolerances, those of tests/test_torch_step.py:
float32 after 3 steps within 1e-3 of the field's scale; bfloat16 with the
RGB9E5 dye within 0.08 of the scale after one step, and after three the
port's mean error against the float32 truth within the noise class of
JAX's own bf16 step (at most 1.5x its mean error + 2^-9). Within the port,
every comparison is bit for bit: each sim against the single-sim step,
lock-step against a uniform per-sim dt, the batched multi-step against the
single-sim multi-step. The kernels themselves are held on the card by
tests/test_torch_batch_kernels.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluid import FluidConfig as JaxConfig
from tpufluid.batch import init_batch as jax_init_batch
from tpufluid.batch import make_batched_step as jax_batched_step
from tpufluid.trace import swirl_trace as jax_trace
import tpufluid_torch as T
from tpufluid_torch.batch import plain_batched_step, step_dt
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from tpufluid_torch.ops.advect import decay_factor
from tpufluid_torch.ops.cuda import build, check, jacobi, stencil
from tpufluid_torch.ops.splat import splat_factors
from tpufluid_torch.step import clamp_dt, dt_table

B = 3
DTS = np.array([1 / 60, 1 / 90, 1 / 120], np.float32)
FIELDS = ("velocity", "dye", "pressure")


def _jcfg(dtype="float32", **kw):
    base = dict(SIM_RESOLUTION=48, DYE_RESOLUTION=96, CANVAS_WIDTH=192, CANVAS_HEIGHT=128,
                MAX_SPLATS=4, USE_PALLAS=True, DTYPE=dtype)
    return JaxConfig(**{**base, **kw}).validate()


def _cfg(dtype="float32", **kw):
    return config_from_dict(dataclasses.asdict(_jcfg(dtype, **kw)))


def _seq(cfg, steps, batch=B):
    """(T, B, S, 8): each sim its own swirl trace, seed 42 + i (bench.py's)."""
    return np.stack([T.swirl_trace(cfg, steps, seed=42 + i).batches for i in range(batch)],
                    axis=1)


def _jax_run(jcfg, seq, dts, n):
    step = jax_batched_step(jcfg)
    s = jax_init_batch(jcfg, seq.shape[1])
    for t in range(n):
        s = step(s, jnp.asarray(dts), jnp.asarray(seq[t]))
    return [np.asarray(getattr(s, f), np.float32) for f in FIELDS]


def _port_run(cfg, seq, dts, n):
    step = T.make_batched_step(cfg, device="cpu")
    s = T.init_batch(cfg, seq.shape[1], device="cpu")
    for t in range(n):
        s = step(s, dts, seq[t])
    return list(state_to_numpy(s))


def _max_rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _assert_states_equal(a, b, label=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (label, f)
        assert torch.equal(x, y), (label, f, float((x.float() - y.float()).abs().max()))


def test_batched_float32_steps_match_jax():
    """Per-sim dts [1/60, 1/90, 1/120], each sim its own trace: every sim of
    the port's batched step within 1e-3 of JAX's vmapped step after 3 steps
    (the JAX trace generator's splats, which the port's equals)."""
    jcfg = _jcfg()
    seq = np.stack([jax_trace(jcfg, 3, seed=42 + i).batches for i in range(B)], axis=1)
    np.testing.assert_array_equal(seq, _seq(_cfg(), 3))
    got, want = _port_run(_cfg(), seq, DTS, 3), _jax_run(jcfg, seq, DTS, 3)
    for name, g, w in zip(FIELDS, got, want):
        assert g.shape == w.shape
        for i in range(B):
            assert _max_rel(g[i], w[i]) < 1e-3, (name, i, _max_rel(g[i], w[i]))


def test_batched_bfloat16_rgb9e5_steps_match_jax():
    jcfg = _jcfg("bfloat16")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.DYE_RGB9E5
    seq = _seq(cfg, 3)
    got, want = _port_run(cfg, seq, DTS, 1), _jax_run(jcfg, seq, DTS, 1)
    for g, w in zip(got, want):
        for i in range(B):
            assert _max_rel(g[i], w[i]) < 0.08
    truth = _jax_run(_jcfg(), seq, DTS, 3)
    got, want = _port_run(cfg, seq, DTS, 3), _jax_run(jcfg, seq, DTS, 3)
    for g, w, f in zip(got, want, truth):
        assert np.isfinite(g).all()
        for i in range(B):
            scale = max(float(np.abs(f[i]).max()), 1e-6)
            e_port = float(np.abs(g[i] - f[i]).mean()) / scale
            e_jax = float(np.abs(w[i] - f[i]).mean()) / scale
            assert e_port < 1.5 * e_jax + 2.0 ** -9, (i, e_port, e_jax)
    assert got[1].min() >= 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("grid", ["cross", "same"])
def test_each_sim_equals_the_single_sim_step(dtype, grid):
    """Every sim of a batched step, with its dt and its splats, equals the
    single-sim step on that sim bit for bit: dye on a grid 2x the sim and
    dye on the sim grid (bench.py config 7)."""
    cfg = _cfg(dtype, **({} if grid == "cross" else dict(DYE_RESOLUTION=48)))
    state, splats = check.random_batch(cfg, B, seed=5, device="cpu")
    got = T.make_batched_step(cfg, device="cpu")(state, DTS, splats)
    single = T.make_step(cfg, device="cpu")
    for i in range(B):
        want = single(T.unstack_state(state, i), DTS[i], splats[i])
        _assert_states_equal(T.unstack_state(got, i), want, f"sim {i}")


def test_lockstep_equals_uniform_per_sim_dt():
    """A scalar dt of 1/60 (no table) and a (B,) dt full of 1/60 (the
    table) give the same state bit for bit (tests/test_batch.py:89)."""
    cfg = _cfg("bfloat16")
    state, splats = check.random_batch(cfg, B, seed=6, device="cpu")
    step = T.make_batched_step(cfg, device="cpu")
    a = step(state, 1 / 60, splats)
    b = step(state, np.full(B, 1 / 60, np.float32), splats)
    _assert_states_equal(a, b)
    assert isinstance(step_dt(1 / 60, B, cfg, "cpu"), float)
    assert tuple(step_dt(np.full(B, 1 / 60), B, cfg, "cpu").shape) == (2, B, 2)


@pytest.mark.parametrize("per_sim", [False, True], ids=["lockstep", "per-sim"])
def test_batched_multi_step_equals_single_multi_step(per_sim):
    """T = 3 batched steps in one make_batched_multi_step call, a (T,)
    lock-step or a (T, B) per-sim dt: each sim equals the port's
    make_multi_step on that sim bit for bit."""
    cfg = _cfg()
    seq = _seq(cfg, 3)
    dts = np.array([[0.01, 1 / 90, 1 / 120], [1 / 60, 0.02, 0.005], [0.012, 1 / 60, 0.001]],
                   np.float32)
    dt = dts if per_sim else dts[:, 0]
    got = T.make_batched_multi_step(cfg, device="cpu")(T.init_batch(cfg, B, device="cpu"),
                                                       dt, seq)
    multi = T.make_multi_step(cfg, device="cpu")
    for i in range(B):
        want = multi(T.init_state(cfg, device="cpu"), dts[:, i] if per_sim else dts[:, 0],
                     seq[:, i])
        _assert_states_equal(T.unstack_state(got, i), want, f"sim {i}")


def test_wrong_dt_shapes_raise():
    """A 1-D multi-step dt whose length is neither 1 nor T raises (never
    read as per-sim dts, tpufluid/batch.py:109-118); so do a step dt that
    is neither a scalar nor (B,), and a per-sim multi-step dt not (T, B)."""
    cfg = _cfg()
    seq = _seq(cfg, 4)
    state = T.init_batch(cfg, B, device="cpu")
    multi = T.make_batched_multi_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="1-D dt has length 3 but there are 4 steps"):
        multi(state, DTS, seq)
    with pytest.raises(ValueError, match="expected \\(4, 3\\)"):
        multi(state, np.zeros((3, 4), np.float32), seq)
    step = T.make_batched_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="one dt a sim"):
        step(state, np.full(B + 1, 1 / 60), seq[0])
    with pytest.raises(ValueError, match="batched state"):
        step(T.init_state(cfg, device="cpu"), 1 / 60, seq[0])
    # length 1 and length T both mean lock-step per time step
    a = multi(state, np.full(1, 1 / 60), seq)
    b = multi(state, np.full(4, 1 / 60), seq)
    _assert_states_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_init_stack_unstack_and_interop_round_trip(dtype):
    """init_batch has JAX's batched shapes and zeros; stack then unstack
    gives each sim back; a batched state crosses to numpy and back exactly,
    and a batched JAX state crosses into the port exactly."""
    jcfg = _jcfg(dtype)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    zero = T.init_batch(cfg, B, device="cpu")
    jzero = jax_init_batch(jcfg, B)
    for f in FIELDS:
        assert tuple(getattr(zero, f).shape) == tuple(getattr(jzero, f).shape)
        assert getattr(zero, f).dtype == cfg.dtype and not getattr(zero, f).any()
    sims = [check.random_state(cfg, seed=i, device="cpu")[0] for i in range(B)]
    batched = T.stack_states(sims)
    for i in range(B):
        _assert_states_equal(T.unstack_state(batched, i), sims[i])
    arrays = state_to_numpy(batched)
    assert [a.shape for a in arrays] == [tuple(getattr(zero, f).shape) for f in FIELDS]
    assert arrays[0].shape[:2] == (B, 2) and arrays[1].shape[:2] == (B, 3)
    back = state_from_numpy(*(np.asarray(a).astype(jnp.dtype(dtype)) for a in arrays),
                            device="cpu")
    _assert_states_equal(back, batched)
    jfields = [jnp.asarray(a).astype(getattr(jzero, f).dtype) for f, a in zip(FIELDS, arrays)]
    from_jax = state_from_numpy(*(np.asarray(a) for a in jfields), device="cpu")
    _assert_states_equal(from_jax, batched)
    with pytest.raises(ValueError, match="same leading B"):
        state_from_numpy(arrays[0], arrays[1][0], arrays[2], device="cpu")


def test_batched_splat_factors_equal_per_sim():
    """One set of ops over (B, S, 8) splats gives each sim's factors bit for
    bit, (B, H, S), (B, S, W), (B, S, C)."""
    rng = np.random.default_rng(3)
    splats = torch.from_numpy(rng.random((B, 8, 8), dtype=np.float32))
    splats[..., 7] = torch.tensor([[1, 1, 0, 1, 0, 0, 1, 1]] * B, dtype=torch.float32)
    for h, w, cols in ((48, 96, slice(2, 4)), (37, 131, slice(4, 7))):
        got = splat_factors(splats, h, w, 0.0025, 1.75, cols)
        assert [tuple(t.shape) for t in got] == [(B, h, 8), (B, 8, w),
                                                 (B, 8, cols.stop - cols.start)]
        for i in range(B):
            for g, want in zip(got, splat_factors(splats[i], h, w, 0.0025, 1.75, cols)):
                assert g[i].is_contiguous() and torch.equal(g[i], want)


def test_plans_count_batch_blocks():
    """stencil.plan and jacobi.tiles_for count B x blocks: 16 sims of 256^2
    take the large tiles (32 x 16 = 512 pre_pressure blocks, 18 x 16 = 288
    Jacobi blocks against 132 SMs), one sim the small ones."""
    sms = 132
    assert stencil.TILES[stencil.LARGE].blocks(256, 256) == 32
    assert jacobi.TILES[jacobi.LARGE].blocks(256, 256, jacobi.SWEEPS) == 18
    assert stencil.plan(256, 256, sms, 16) == stencil.LARGE
    assert stencil.plan(256, 256, sms) == stencil.SMALL
    assert jacobi.tiles_for(256, 256, sms, 16) == jacobi.LARGE
    assert jacobi.tiles_for(256, 256, sms) == jacobi.SMALL
    assert stencil.plan(256, 256, sms, 4) == stencil.SMALL      # 4 x 32 = 128 blocks
    assert stencil.plan(256, 256, sms, 5) == stencil.LARGE      # 160
    assert jacobi.plan(256, 256, 20, sms, 8) == (jacobi.LARGE, [10, 10])
    assert jacobi.tiles_for(1024, 1024, 240 * 8, 8) == jacobi.LARGE
    assert jacobi.tiles_for(1024, 1024, 240 * 8 + 1, 8) == jacobi.SMALL


def test_dt_table_is_the_scalar_forms():
    """Each entry of the host's table is clamp_dt and decay_factor of its
    sim's dt, bit for bit, for both dissipations."""
    dts = np.array([[1 / 60, 1 / 90, 0.02], [0.005, 1 / 120, 0.0]], np.float32)
    table = dt_table(dts, (0.2, 1.0))
    assert table.shape == (2, 2, 3, 2) and table.dtype == np.float32
    assert table.flags.c_contiguous
    for t in range(2):
        for k, diss in enumerate((0.2, 1.0)):
            for i in range(3):
                d = clamp_dt(dts[t, i])
                assert table[t, k, i, 0] == np.float32(d)
                assert table[t, k, i, 1] == decay_factor(diss, d)


def test_check_dt_forms():
    """The wrappers' dt check: a number passes as it is with a null table;
    a (B, 2) float32 contiguous table on the field's device passes its
    pointer; any other tensor raises before a launch."""
    table = torch.zeros((B, 2))
    dt, p = build.check_dt(0.5, B, table.device)
    assert dt == 0.5 and p.value is None
    dt, p = build.check_dt(table, B, table.device)
    assert p.value == table.data_ptr()
    for bad in (torch.zeros((B, 2), dtype=torch.float64), torch.zeros((B + 1, 2)),
                torch.zeros((2, B)).t(), torch.zeros((B, 3))):
        with pytest.raises(ValueError, match="dt table"):
            build.check_dt(bad, B, table.device)
    with pytest.raises(ValueError, match="dt table"):
        build.check_dt(table, B, torch.device("meta"))


def test_batched_kernel_cases_follow_the_batched_step():
    """The batched cases that the card compares are the batched step's own
    calls: chained on the CPU, their plain versions give the batched step
    bit for bit, in both forms of dt; sims carry different numbers of
    active splat rows."""
    cfg = _cfg("bfloat16")
    state, splats = check.random_batch(cfg, B, seed=9, device="cpu")
    assert [int(n) for n in (splats[..., 7] != 0).sum(-1)] == [0, 4, 1]
    cases = check.batched_step_cases(cfg, B, seed=9, device="cpu")
    assert [c.kernel_name for c in cases] == 2 * [
        "pre_pressure", "jacobi_project", "advect", "advect_dye", "jacobi_chunk",
        "gradient_subtract"]
    assert all(":b3:" in c.label and c.nbytes > 0 and c.flops > 0 for c in cases)
    for form, dt in ((0, 1 / 60), (6, check.per_sim_dts(B))):
        want = plain_batched_step(state, dt, splats, cfg)
        np.testing.assert_array_equal(cases[form + 1].run(plain=True)[0].float().numpy(),
                                      want.pressure.float().numpy())
        np.testing.assert_array_equal(cases[form + 4].run(plain=True).float().numpy(),
                                      want.pressure.float().numpy())
        np.testing.assert_array_equal(cases[form + 3].run(plain=True).float().numpy(),
                                      want.dye.float().numpy())
    # The batch's work is its sims' work.
    one = check.step_cases(T.unstack_state(state, 1), splats[1], cfg)
    assert cases[0].flops > one[0].flops and cases[1].flops == B * one[1].flops
