"""The port's step against tpufluid's on the CPU, and the interop that
carries a config and a state across.

The port runs the pass order of tpufluid's kernel path (USE_PALLAS=True,
whose dispatch runs the jnp oracle off-TPU); both JAX branches are held
against it. Tolerances:
  * float32, 3 steps: 1e-3 of the field's scale, the class of
    tests/test_step.py::test_multi_step_scan_matches_loop — ulp differences
    (exp, sqrt, the splat sum's order) that the advection and the vorticity
    confinement amplify over steps.
  * bfloat16 with RGB9E5 dye: the JAX jnp path computes stencils and lerps in
    bf16 arithmetic, the port in float32 with storage rounding at the TPU
    kernels' points, so the two differ by storage noise, not by an ulp. One
    step: within 0.08 of the scale (a bf16 ulp is 2^-8 of a value; the
    confinement amplifies it near zero-gradient texels). Three steps: the
    port's mean error against the float32 truth stays within the noise class
    of JAX's own bf16 step (at most 1.5x its mean error + 2^-9).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufluid import FluidConfig as JaxConfig
from tpufluid import init_state as jax_init
from tpufluid.state import resize_state as jax_resize
from tpufluid.step import fluid_step as jax_step
from tpufluid.trace import swirl_trace as jax_trace
import tpufluid_torch as T
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from tpufluid_torch.step import clamp_dt

DT = np.float32(1 / 60)


def _cfg(dtype="float32", use_pallas=True, **kw):
    base = dict(SIM_RESOLUTION=48, DYE_RESOLUTION=96, CANVAS_WIDTH=192,
                CANVAS_HEIGHT=128, MAX_SPLATS=4, USE_PALLAS=use_pallas, DTYPE=dtype)
    return JaxConfig(**{**base, **kw}).validate()


def _jax_run(cfg, trace, n, state=None):
    s = jax_init(cfg) if state is None else state
    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, cfg))
    for t in range(n):
        s = step(s, DT, jnp.asarray(trace.batches[t]))
    return [np.asarray(x, np.float32) for x in (s.velocity, s.dye, s.pressure)]


def _port_run(cfg, trace, n, state=None):
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    s = T.init_state(tcfg, device="cpu") if state is None else state
    step = T.make_step(tcfg, device="cpu")
    for t in range(n):
        s = step(s, DT, trace.batches[t])
    return list(state_to_numpy(s))


def _max_rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_float32_steps_match_jax(use_pallas):
    cfg = _cfg(use_pallas=use_pallas)
    trace = jax_trace(cfg, 3, seed=3)
    for n, tol in ((1, 1e-4), (3, 1e-3)):
        got, want = _port_run(cfg, trace, n), _jax_run(cfg, trace, n)
        for name, g, w in zip(("velocity", "dye", "pressure"), got, want):
            assert g.shape == w.shape
            assert _max_rel(g, w) < tol, (n, name, _max_rel(g, w))


def test_bfloat16_rgb9e5_steps_match_jax():
    cfg = _cfg("bfloat16")
    assert cfg.DYE_RGB9E5
    trace = jax_trace(cfg, 3, seed=3)
    got = _port_run(cfg, trace, 1)
    want = _jax_run(cfg, trace, 1)
    for g, w in zip(got, want):
        assert _max_rel(g, w) < 0.08
    truth = _jax_run(_cfg(), trace, 3)
    got = _port_run(cfg, trace, 3)
    want = _jax_run(cfg, trace, 3)
    for g, w, f in zip(got, want, truth):
        scale = max(float(np.abs(f).max()), 1e-6)
        e_port = float(np.abs(g - f).mean()) / scale
        e_jax = float(np.abs(w - f).mean()) / scale
        assert np.isfinite(g).all()
        assert e_port < 1.5 * e_jax + 2.0 ** -9, (e_port, e_jax)
    assert got[1].min() >= 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_interop_round_trip(dtype):
    """A running JAX state crosses into the port exactly (every dtype), and
    the port's arrays cross back exactly."""
    cfg = _cfg(dtype)
    trace = jax_trace(cfg, 4, seed=1)
    s = jax_init(cfg)
    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, cfg))
    for t in range(4):
        s = step(s, DT, jnp.asarray(trace.batches[t]))
    arrays = [np.asarray(x) for x in (s.velocity, s.dye, s.pressure)]
    ts = state_from_numpy(*arrays, device="cpu")
    assert ts.velocity.dtype == config_from_dict(dataclasses.asdict(cfg)).dtype
    for a, b in zip(state_to_numpy(ts), arrays):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    back = state_from_numpy(*state_to_numpy(ts), device="cpu")
    assert back.velocity.dtype == torch.float32
    np.testing.assert_array_equal(state_to_numpy(back)[1], state_to_numpy(ts)[1])


def test_step_from_carried_state_matches_jax():
    """Both packages continue one float32 state made by JAX: the fields the
    port receives through interop step like JAX's own."""
    cfg = _cfg()
    trace = jax_trace(cfg, 9, seed=4)
    s = jax_init(cfg)
    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, cfg))
    for t in range(8):
        s = step(s, DT, jnp.asarray(trace.batches[t]))
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    got = state_to_numpy(T.fluid_step(ts, DT, trace.batches[8], tcfg))
    want = step(s, DT, jnp.asarray(trace.batches[8]))
    for g, w in zip(got, (want.velocity, want.dye, want.pressure)):
        assert _max_rel(g, np.asarray(w)) < 1e-4


def test_multi_step_per_step_dt_equals_loop():
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    trace = T.swirl_trace(cfg, 4, seed=2)
    dts = np.array([0.01, 1 / 60, 0.02, 0.005], np.float32)
    multi = T.make_multi_step(cfg, device="cpu")(T.init_state(cfg, device="cpu"),
                                                 dts, trace.batches)
    s = T.init_state(cfg, device="cpu")
    for k in range(4):
        s = T.fluid_step(s, dts[k], trace.batches[k], cfg)
    for a, b in zip(state_to_numpy(multi), state_to_numpy(s)):
        np.testing.assert_array_equal(a, b)
    # the 0.02 step ran at the literal clamp, which is below 1/60
    assert clamp_dt(0.02) == clamp_dt(1 / 60) == float(np.float32(0.016666))


def test_resize_state_matches_jax():
    cfg, big = _cfg(), _cfg(SIM_RESOLUTION=64, DYE_RESOLUTION=80)
    trace = jax_trace(cfg, 3, seed=3)
    s = jax_init(cfg)
    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, cfg))
    for t in range(3):
        s = step(s, DT, jnp.asarray(trace.batches[t]))
    want = jax_resize(s, big)
    got = T.resize_state(state_from_numpy(np.asarray(s.velocity), np.asarray(s.dye),
                                          np.asarray(s.pressure), device="cpu"),
                         config_from_dict(dataclasses.asdict(big)))
    for g, w in zip(state_to_numpy(got), (want.velocity, want.dye, want.pressure)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
    assert not got.pressure.any()


def test_kernel_cases_follow_the_step():
    """The per-kernel cases that chip_smoke.py and the kernel tests compare
    on the card are the step's own calls: on the CPU their plain versions,
    chained, reproduce fluid_step bit for bit, and each carries a byte and
    operation count for its bound. After them, the standalone solve and
    gradient subtract that the fused jacobi_project replaces give its
    pressure and velocity."""
    from tpufluid_torch.ops.cuda import check

    for dtype in ("float32", "bfloat16"):
        cfg = config_from_dict(dataclasses.asdict(_cfg(dtype)))
        state, splats = check.random_state(cfg, seed=5, device="cpu")
        cases = check.step_cases(state, splats, cfg)
        assert [c.kernel_name for c in cases] == [
            "pre_pressure", "jacobi_project", "advect", "advect_dye", "jacobi_chunk",
            "gradient_subtract"]
        want = T.fluid_step(state, 1 / 60, splats, cfg)
        pressure, projected = cases[1].run(plain=True)
        np.testing.assert_array_equal(pressure.float().numpy(), want.pressure.float().numpy())
        assert torch.equal(cases[4].run(plain=True), pressure)
        assert torch.equal(cases[5].run(plain=True), projected)
        np.testing.assert_array_equal(cases[3].run(plain=True).float().numpy(),
                                      want.dye.float().numpy())
        assert all(c.nbytes > 0 and c.flops > 0 for c in cases)
        err, tol = check.compare(want.dye, cases[3].run(plain=True))
        assert err == 0.0 and tol > 0.0
