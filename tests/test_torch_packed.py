"""The port's lane-packed fleet (tpufluid_torch/batch_packed.py) against
tpufluid's on the CPU, and against the port's batched step.

Here the port's packed step runs the kernels' plain versions (the fleet
unpacked and run as a batch); JAX's off the TPU unpacks, vmaps its step and
packs (tpufluid/batch_packed.py:190-206). Tolerances, those of
tests/test_torch_batch.py: float32 after 3 steps within 1e-3 of each
field's scale; bfloat16 with the RGB9E5 dye within 0.08 of the scale after
one step, and after three the port's mean error against the float32 truth
within the noise class of JAX's own bf16 step (at most 1.5x its mean error
+ 2^-9). Within the port every comparison is bit for bit. Each packed
kernel's plain version is held to JAX's sim_w Pallas kernel run in
interpret mode (as tests/test_packed.py runs them): the pre-pressure
chain, the Jacobi solve and the gradient subtract within check.py's 1e-5
of the scale, the advection within tests/test_packed.py's 2e-4 on smooth
fields. The kernels themselves are held on the card by
tests/test_torch_packed_kernels.py.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid.ops.pallas.advect as pa
import tpufluid.ops.pallas.dispatch as D
import tpufluid.ops.pallas.jacobi as pj
import tpufluid.ops.pallas.stencil as ps
from tpufluid import FluidConfig as JaxConfig
from tpufluid import batch_packed as jbp
from tpufluid.state import FluidState as JaxState
import tpufluid_torch as T
from tpufluid_torch import batch_packed as bp
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from tpufluid_torch.ops.cuda import advect, check, jacobi, stencil

B = 4
FIELDS = ("velocity", "dye", "pressure")


def _jcfg(res, dtype="float32", **kw):
    base = dict(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res, CANVAS_HEIGHT=res,
                MAX_SPLATS=4, USE_PALLAS=True, DTYPE=dtype)
    return JaxConfig(**{**base, **kw}).validate()


def _cfg(res, dtype="float32", **kw):
    return config_from_dict(dataclasses.asdict(_jcfg(res, dtype, **kw)))


def _seq(cfg, steps, batch=B):
    """(T, B, S, 8): each sim its own swirl trace, seed 42 + i (bench.py's)."""
    return np.stack([T.swirl_trace(cfg, steps, seed=42 + i).batches for i in range(batch)],
                    axis=1)


def _jax_run(jcfg, seq, n):
    step = jbp.make_packed_step(jcfg, seq.shape[1])
    s = jbp.init_packed(jcfg, seq.shape[1])
    for t in range(n):
        s = step(s, jnp.float32(1 / 60), jnp.asarray(seq[t]))
    return [np.asarray(jbp.unpack_fleet(getattr(s, f), seq.shape[1]), np.float32)
            for f in FIELDS]


def _port_run(cfg, seq, n):
    step = bp.make_packed_step(cfg, seq.shape[1], device="cpu")
    s = bp.init_packed(cfg, seq.shape[1], device="cpu")
    for t in range(n):
        s = step(s, 1 / 60, seq[t])
    return list(state_to_numpy(bp.unpack_state(s, seq.shape[1])))


def _max_rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _assert_states_equal(a, b, label=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (label, f)
        assert torch.equal(x, y), (label, f, float((x.float() - y.float()).abs().max()))


# ---------------------------------------------------------------- (a) layout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unpack_match_jax(dtype, rng):
    """pack_fleet / unpack_fleet round-trip and equal JAX's on the same
    array; pack_state, unpack_state and init_packed have JAX's shapes, and a
    JAX packed state crosses into the port (interop) as the port's own
    packing of the unpacked state."""
    x = rng.standard_normal((3, 2, 16, 24)).astype(np.float32)
    got = bp.pack_fleet(torch.from_numpy(x))
    assert got.shape == (2, 16, 72) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbp.pack_fleet(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:, :, 24:48].numpy(), x[1])
    np.testing.assert_array_equal(bp.unpack_fleet(got, 3).numpy(), x)
    with pytest.raises(ValueError, match="no whole 5 sims"):
        bp.unpack_fleet(got, 5)

    jcfg = _jcfg(24, dtype)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    zero, jzero = bp.init_packed(cfg, 3, device="cpu"), jbp.init_packed(jcfg, 3)
    for f in FIELDS:
        assert tuple(getattr(zero, f).shape) == tuple(getattr(jzero, f).shape)
        assert getattr(zero, f).dtype == cfg.dtype and not getattr(zero, f).any()
    state, _ = check.random_batch(cfg, 3, seed=2, device="cpu")
    packed = bp.pack_state(state)
    _assert_states_equal(bp.unpack_state(packed, 3), state)
    jbatched = JaxState(*(jnp.asarray(a).astype(jnp.dtype(dtype))
                          for a in state_to_numpy(state)))
    jpacked = jbp.pack_state(jbatched)
    from_jax = state_from_numpy(*(np.asarray(getattr(jpacked, f)) for f in FIELDS),
                                device="cpu")
    batched = state_from_numpy(*(np.asarray(getattr(jbatched, f)) for f in FIELDS),
                               device="cpu")
    _assert_states_equal(from_jax, bp.pack_state(batched))
    _assert_states_equal(bp.unpack_state(from_jax, 3), batched)
    _assert_states_equal(from_jax, packed)


# ---------------------------------------------------------------- (b) against JAX

def test_packed_float32_steps_match_jax():
    """96^2 float32, 4 sims each its own trace, lock-step 1/60: every sim of
    the port's packed step within 1e-3 of JAX's packed step after 3 steps."""
    jcfg = _jcfg(96)
    seq = _seq(_cfg(96), 3)
    got, want = _port_run(_cfg(96), seq, 3), _jax_run(jcfg, seq, 3)
    for name, g, w in zip(FIELDS, got, want):
        assert g.shape == w.shape
        for i in range(B):
            assert _max_rel(g[i], w[i]) < 1e-3, (name, i, _max_rel(g[i], w[i]))


def test_packed_bfloat16_rgb9e5_steps_match_jax():
    """128^2 bf16 with the RGB9E5 dye: within 0.08 of JAX's after one step;
    after three within the noise class of JAX's own bf16 step, both held
    to JAX's float32 packed step."""
    jcfg = _jcfg(128, "bfloat16")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.DYE_RGB9E5
    seq = _seq(cfg, 3)
    got, want = _port_run(cfg, seq, 1), _jax_run(jcfg, seq, 1)
    for g, w in zip(got, want):
        for i in range(B):
            assert _max_rel(g[i], w[i]) < 0.08
    truth = _jax_run(_jcfg(128), seq, 3)
    got, want = _port_run(cfg, seq, 3), _jax_run(jcfg, seq, 3)
    for g, w, f in zip(got, want, truth):
        assert np.isfinite(g).all()
        for i in range(B):
            scale = max(float(np.abs(f[i]).max()), 1e-6)
            e_port = float(np.abs(g[i] - f[i]).mean()) / scale
            e_jax = float(np.abs(w[i] - f[i]).mean()) / scale
            assert e_port < 1.5 * e_jax + 2.0 ** -9, (i, e_port, e_jax)
    assert got[1].min() >= 0.0


# ---------------------------------------------------------------- (c) against the batched step

@pytest.mark.parametrize("dtype,dye", [("float32", 48), ("bfloat16", 48), ("float16", 48),
                                       ("float32", 96)],
                         ids=["float32", "bfloat16", "float16-fallback", "cross-grid-fallback"])
def test_packed_step_equals_batched_step(dtype, dye):
    """The packed step, and make_packed_multi_step with a scalar and a (T,)
    dt, give the batched step's and make_batched_multi_step's states packed,
    bit for bit: on the packed passes (f32, bf16) and on the fallback
    (f16, the cross grid: unpack, the batched step, pack)."""
    cfg = _cfg(48, dtype, DYE_RESOLUTION=dye)
    assert bp.packed_supported(cfg, 3) == (dtype != "float16" and dye == 48)
    state, splats = check.random_batch(cfg, 3, seed=5, device="cpu")
    got = bp.make_packed_step(cfg, 3, device="cpu")(bp.pack_state(state), 1 / 60, splats)
    want = T.make_batched_step(cfg, device="cpu")(state, 1 / 60, splats)
    _assert_states_equal(bp.unpack_state(got, 3), want, "step")
    seq = _seq(cfg, 3, 3)
    dts = np.array([0.01, 1 / 60, 0.02], np.float32)
    multi = bp.make_packed_multi_step(cfg, 3, device="cpu")
    bmulti = T.make_batched_multi_step(cfg, device="cpu")
    for dt in (1 / 90, dts):
        got = multi(bp.init_packed(cfg, 3, device="cpu"), dt, seq)
        want = bmulti(T.init_batch(cfg, 3, device="cpu"), dt, seq)
        _assert_states_equal(bp.unpack_state(got, 3), want, f"multi dt {dt}")


# ---------------------------------------------------------------- (d) against the sim_w kernels

def _interp():
    """Interpret-mode pallas_call (pj/ps/pa share the pl module)."""
    orig = pj.pl.pallas_call
    return mock.patch.object(pj.pl, "pallas_call",
                             lambda *a, **k: orig(*a, interpret=True, **k))


def _within(got: torch.Tensor, want, tol: float, label: str) -> float:
    w = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - w).max())
    print(f"{label}: max abs err {err:.3e}, scale {float(np.abs(w).max()):.3e}")
    assert err <= tol * max(float(np.abs(w).max()), 1.0), (label, err)
    return err


def test_packed_stencils_and_jacobi_match_pallas_sim_w(rng):
    """The plain packed pre_pressure (no splats), Jacobi solve (8 sweeps,
    warm start 0.8) and gradient subtract against JAX's sim_w kernels in
    interpret mode, 96^2 f32, a fleet of 4 different sims, each pass fed
    JAX's previous output: within 1e-5 of the scale (the port's Jacobi sums
    in the jnp order, the TPU kernel's exact path in another)."""
    s = h = 96
    vel = np.clip(rng.standard_normal((B, 2, h, s)) * 300, -1000, 1000).astype(np.float32)
    p = rng.standard_normal((B, h, s)).astype(np.float32)
    velp, pp = (np.array(jbp.pack_fleet(jnp.asarray(a))) for a in (vel, p))
    dt = 0.016
    with _interp():
        gv, gd = ps.curl_vorticity_divergence(jnp.asarray(velp), 30.0, jnp.float32(dt), sim_w=s)
        gj = pj.jacobi_pressure(jnp.asarray(pp), gd, 8, prescale=0.8, sim_w=s)
        gg = ps.gradient_subtract(gv, gj, sim_w=s)
    tv, td = stencil.pre_pressure_plain(torch.from_numpy(velp), 30.0, dt, sim_w=s)
    _within(tv, gv, 1e-5, "pre_pressure velocity")
    _within(td, gd, 1e-5, "pre_pressure divergence")
    tj = jacobi.jacobi_plain(torch.from_numpy(pp), torch.from_numpy(np.array(gd)), 8, 0.8,
                             sim_w=s)
    _within(tj, gj, 1e-5, "jacobi")
    tg = stencil.gradient_subtract_plain(torch.from_numpy(np.array(gv)),
                                         torch.from_numpy(np.array(gj)), sim_w=s)
    _within(tg, gg, 1e-5, "gradient_subtract")


def test_packed_advect_matches_pallas_sim_w(rng):
    """The plain packed advection of smooth fields against JAX's sim_w
    gather in interpret mode, 96^2 f32, 4 different sims: within 2e-4, the
    coordinate-rounding class of tests/test_packed.py:173 (JAX forms its
    coordinates in packed columns, the port in each sim's own)."""
    s = h = 96
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, h), np.linspace(0, 2 * np.pi, s),
                         indexing="ij")

    def smooth(c, scale):
        out = np.zeros((B, c, h, s), np.float32)
        for i in range(B):
            for j in range(c):
                ph = rng.uniform(0, 2 * np.pi, size=4)
                out[i, j] = scale * (np.sin(yy + ph[0]) * np.cos(xx + ph[1])
                                     + 0.5 * np.sin(2 * xx + ph[2]) * np.cos(yy + ph[3]))
        return np.array(jbp.pack_fleet(jnp.asarray(out)))

    vel, dye = smooth(2, 300.0), smooth(3, 0.4) + 0.5
    halo = pa.halo_for_displacement(D._MAX_DISP_SIM_TEXELS)
    span = pa.group_span_for_displacement(D._MAX_DISP_SIM_TEXELS)
    with _interp():
        want = pa.advect_pallas(jnp.asarray(vel), jnp.asarray(dye), jnp.float32(0.016), 1.0,
                                halo=halo, span=span, max_disp_x=D._MAX_DISP_SIM_TEXELS,
                                sim_w=s)
    got = advect.advect_plain(torch.from_numpy(vel), torch.from_numpy(dye), 0.016, 1.0,
                              sim_w=s)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"advect: max abs err {err:.3e}")
    assert err < 2e-4, err


# ---------------------------------------------------------------- (e) gate and raises

# (res, dtype, batch, dye res): the port's verdict, JAX's (test_supported_gate)
GATE = [
    ((96, "float32", 4, 96), True, True),
    ((128, "bfloat16", 4, 128), True, True),
    # JAX: 3 x 96 = 288 lanes, not a multiple of 128; the port has no lanes
    ((96, "float32", 3, 96), True, False),
    # JAX: bf16 rows pad 96 to 128 (row_align); the port pads nothing
    ((96, "bfloat16", 4, 96), True, False),
    ((96, "float16", 4, 96), False, False),     # f16: the batched mode's, in both
    ((64, "float32", 4, 128), False, False),    # dye grid != sim grid, in both
]


@pytest.mark.parametrize("case,port,jax", GATE, ids=lambda x: str(x))
def test_packed_supported_gate(case, port, jax):
    """packed_supported keeps JAX's rules (sim grid == dye grid, f32 or
    bf16) and drops its TPU tiling ones, so it differs from JAX's exactly
    where a TPU tile pads the packed geometry."""
    res, dtype, batch, dye = case
    jcfg = _jcfg(res, dtype, DYE_RESOLUTION=dye, CANVAS_WIDTH=dye, CANVAS_HEIGHT=dye)
    assert jbp.packed_supported(jcfg, batch) is jax
    assert bp.packed_supported(config_from_dict(dataclasses.asdict(jcfg)), batch) is port


def test_packed_entry_points_raise(monkeypatch):
    """A per-sim dt (a step's (B,), a multi-step's (T, B)), splats_seq of
    another B, a state of another width and a CPU state given to a step
    made for the GPU each raise."""
    cfg = _cfg(32)
    state = bp.init_packed(cfg, 3, device="cpu")
    seq = _seq(cfg, 2, 3)
    step = bp.make_packed_step(cfg, 3, device="cpu")
    multi = bp.make_packed_multi_step(cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="one clock"):
        step(state, np.full(3, 1 / 60, np.float32), seq[0])
    with pytest.raises(ValueError, match="one clock"):
        bp.packed_fluid_step(state, np.full(3, 1 / 60, np.float32), seq[0], cfg, 3)
    with pytest.raises(ValueError, match="batched mode"):
        multi(state, np.full((2, 3), 1 / 60, np.float32), seq)
    with pytest.raises(ValueError, match="batched mode"):
        multi(state, np.full(3, 1 / 60, np.float32), seq)
    with pytest.raises(ValueError, match=r"expected \(T, 3, S, 8\)"):
        multi(state, 1 / 60, _seq(cfg, 2, 4))
    with pytest.raises(ValueError, match="a packed fleet of 3 sims"):
        multi(bp.init_packed(cfg, 4, device="cpu"), 1 / 60, seq)
    with pytest.raises(ValueError, match="a packed fleet of 3 sims"):
        step(T.init_batch(cfg, 3, device="cpu"), 1 / 60, seq[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bp.make_packed_step(cfg, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="state on cpu, made for cuda"):
        bp.make_packed_step(cfg, 3)(state, 1 / 60, seq[0])
    with pytest.raises(ValueError, match="state on cpu, made for cuda"):
        bp.make_packed_multi_step(cfg, 3)(state, 1 / 60, seq)


def test_packed_wrappers_check_their_layout(rng):
    """The kernels' packed wrappers refuse a CPU fleet and a width that is
    not whole sims; the plain versions take only whole sims too."""
    vel = torch.from_numpy(rng.standard_normal((2, 8, 30)).astype(np.float32))
    p = vel[0].contiguous()
    for fn, args in ((stencil.pre_pressure, (vel, 30.0, 1 / 60)),
                     (stencil.gradient_subtract, (vel, p)),
                     (jacobi.jacobi_pressure, (p, p, 4)),
                     (advect.advect, (vel, vel, 1 / 60, 1.0))):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(*args, sim_w=10)
    with pytest.raises(ValueError, match="whole number of sims"):
        stencil.pre_pressure_plain(vel, 30.0, 1 / 60, sim_w=7)
    with pytest.raises(ValueError, match="no true bounds"):
        stencil.pre_pressure_plain(vel, 30.0, 1 / 60, true_bounds=(0, 7, 0, 9), sim_w=10)
    with pytest.raises(ValueError, match="on its grid"):
        advect.advect_plain(vel, vel[:, :4], 1 / 60, 1.0, sim_w=10)


# ---------------------------------------------------------------- (f) the check cases

def test_packed_kernel_cases_follow_the_packed_step():
    """The packed cases that the card compares are the packed step's own
    calls: chained on the CPU, their plain versions give the packed step
    bit for bit; the work of the batched cases' lock-step calls."""
    cfg = _cfg(48, "bfloat16")
    state, splats = check.random_batch(cfg, 3, seed=9, device="cpu")
    cases = check.packed_step_cases(cfg, 3, seed=9, device="cpu")
    assert [c.kernel_name for c in cases] == [
        "pre_pressure", "jacobi_project", "advect", "advect_dye", "jacobi_chunk",
        "gradient_subtract"]
    assert all(c.label.endswith(":packed:b3:lockstep") for c in cases)
    want = bp.plain_packed_step(bp.pack_state(state), 1 / 60, splats, cfg, 3)
    np.testing.assert_array_equal(cases[1].run(plain=True)[0].float().numpy(),
                                  want.pressure.float().numpy())
    np.testing.assert_array_equal(cases[4].run(plain=True).float().numpy(),
                                  want.pressure.float().numpy())
    np.testing.assert_array_equal(cases[3].run(plain=True).float().numpy(),
                                  want.dye.float().numpy())
    batched = check.batched_step_cases(cfg, 3, seed=9, device="cpu")[:len(cases)]
    assert [c.label for c in batched] == [c.label.replace(":packed", "") for c in cases]
    assert [(c.nbytes, c.flops) for c in cases] == [(c.nbytes, c.flops) for c in batched]
