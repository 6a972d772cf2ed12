"""The port's sharded step (tpufluid_torch/parallel) against tpufluid's on
the CPU: the JAX side on the 8 virtual CPU devices of tests/conftest.py,
the port's shards all on the CPU device (its plain versions), at the sizes
of tests/test_sharding.py (sim 64, dye 128) and, where a phase must take
the split-phase path, at 256.

Tolerances, as fractions of the field's largest magnitude:
  * the halo strips and exchanges: equal;
  * pre_pressure's true-wall form against JAX's bounds-aware fallback,
    inside the walls: 1e-6 in float32 (the bump's sum order and exp);
  * the sharded step against JAX's make_sharded_step on the same mesh:
    1e-4 after one step, 1e-3 after three, the class of
    tests/test_torch_step.py (ulp differences the advection and the
    confinement amplify); bfloat16 with the RGB9E5 dye: 0.08 after one
    step (JAX computes its jnp passes in bf16, the port in float32 with
    storage rounding, tests/test_torch_step.py);
  * the sharded step against the port's own single-device step: 4e-4 after
    4 steps, the bound of tests/test_sharding.py (a padded block rounds its
    backtrace coordinates otherwise than the whole grid).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpufluid import FluidConfig as JaxConfig
from tpufluid import init_state as jax_init
from tpufluid.ops import splat as jsplat
from tpufluid.ops.pallas import dispatch as jdispatch
from tpufluid.parallel import halo as jhalo
from tpufluid.parallel import make_mesh as jax_mesh
from tpufluid.parallel import shard_state as jax_shard
from tpufluid.parallel.sharded_step import make_sharded_step as jax_sharded_step
from tpufluid.parallel.sharded_step import overhead_report as jax_overhead_report
from tpufluid.trace import swirl_trace
import tpufluid_torch as T
from tpufluid_torch.interop import config_from_dict
from tpufluid_torch.ops import splat as tsplat
from tpufluid_torch.ops.cuda import check
from tpufluid_torch.ops.cuda import stencil as kstencil
from tpufluid_torch.parallel import halo, sharded_step
from tpufluid_torch.parallel.mesh import Mesh, gather_state

DT = np.float32(1 / 60)
FIELDS = ("velocity", "dye", "pressure")
BASE = dict(CANVAS_WIDTH=256, CANVAS_HEIGHT=256, MAX_SPLATS=4, USE_PALLAS=False)
GHOSTS = (sharded_step._G_STENCIL, sharded_step._GC)   # pre_pressure's padded block
GRIDS = {"same": dict(SIM_RESOLUTION=64, DYE_RESOLUTION=64),
         "dye2x": dict(SIM_RESOLUTION=64, DYE_RESOLUTION=128)}


def _jcfg(**kw):
    return JaxConfig(**{**BASE, **kw}).validate()


def _tcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _tmesh(shape):
    return T.make_mesh(devices=["cpu"] * (shape[0] * shape[1]), shape=shape)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3)


def _run_both(jcfg, shape, steps, seed=11):
    """(port, jax) fields after each of ``steps`` sharded steps."""
    trace = swirl_trace(jcfg, steps, seed=seed)
    jm = jax_mesh(shape[0] * shape[1], shape=shape)
    jstep = jax_sharded_step(jcfg, jm)
    js = jax_shard(jax_init(jcfg), jm)
    tcfg = _tcfg(jcfg)
    tm = _tmesh(shape)
    tstep = T.make_sharded_step(tcfg, tm)
    ts = T.shard_state(T.init_state(tcfg, device="cpu"), tm)
    out = []
    for t in range(steps):
        js = jstep(js, DT, jnp.asarray(trace.batches[t]))
        ts = tstep(ts, DT, trace.batches[t])
        g = gather_state(ts)
        out.append(([getattr(g, f).float().numpy() for f in FIELDS],
                    [np.asarray(getattr(js, f), np.float32) for f in FIELDS]))
    return out


# ---------------------------------------------------------------- halo


def _jax_strips(f, mesh_shape, width, axis):
    """Each shard's (ghost_below, ghost_above) from JAX's ghost_strips on a
    mesh of one row or one column of devices."""
    n = max(mesh_shape)
    name = "y" if axis == -2 else "x"
    spec = P(None, "y", None) if axis == -2 else P(None, None, "x")
    mesh = jax_mesh(n, shape=mesh_shape)
    below, above = jax.jit(jax.shard_map(lambda b: jhalo.ghost_strips(b, width, name, axis),
                                         mesh=mesh, in_specs=spec,
                                         out_specs=(spec, spec)))(jnp.asarray(f))
    below, above = np.asarray(below), np.asarray(above)
    return [(np.split(below, n, axis=axis)[k], np.split(above, n, axis=axis)[k])
            for k in range(n)]


@pytest.mark.parametrize("axis,width", [(-2, 1), (-2, 2), (-2, 3), (-2, 5), (-1, 3),
                                        (-1, 8), (-1, 11)],
                         ids=lambda v: str(v))
def test_ghost_strips_equal_jax(axis, width):
    """Single hop (width <= the block's extent: 2 rows, 8 columns) and
    multi hop, rows over (8, 1) and columns over (1, 8): every strip equal
    to JAX's, and the exchange equal to JAX's exchange_halo."""
    f = np.arange(2 * 16 * 64, dtype=np.float32).reshape(2, 16, 64) * 0.5 - 7.0
    mesh_shape = (8, 1) if axis == -2 else (1, 8)
    blocks = list(torch.chunk(torch.from_numpy(f), 8, dim=axis))
    want = _jax_strips(f, mesh_shape, width, axis)
    got = halo.ghost_strips(blocks, width, axis)
    for (gb, ga), (wb, wa) in zip(got, want):
        np.testing.assert_array_equal(gb.numpy(), wb)
        np.testing.assert_array_equal(ga.numpy(), wa)
    name = "y" if axis == -2 else "x"
    spec = P(None, "y", None) if axis == -2 else P(None, None, "x")
    jout = np.asarray(jax.jit(jax.shard_map(
        lambda b: jhalo.exchange_halo(b, width, name, axis), mesh=jax_mesh(8, shape=mesh_shape),
        in_specs=spec, out_specs=spec))(jnp.asarray(f)))
    for got_k, want_k in zip(halo.exchange_halo(blocks, width, axis),
                             np.split(jout, 8, axis=axis)):
        np.testing.assert_array_equal(got_k.numpy(), want_k)
    rows = halo.exchange_halo_rows if axis == -2 else halo.exchange_halo_cols
    for a, b in zip(rows(blocks, width), halo.exchange_halo(blocks, width, axis)):
        assert torch.equal(a, b)


def test_exchange_counts_the_strips_sent():
    """The traffic counter adds the neighbours' strips, not the walls'
    replicas: a row of 4 shards sends 3 strips each way."""
    blocks = list(torch.chunk(torch.zeros(4 * 8, 16), 4, dim=0))
    halo.SENT.reset()
    halo.exchange_halo_rows(blocks, 2)
    assert halo.SENT.bytes == 2 * 3 * 2 * 16 * 4


# ---------------------------------------------------------------- factors


def test_splat_factors_with_offsets_match_jax(rng):
    """A shard's padded block: rows and columns before and past the grid
    clamp to its edges, as JAX's; inside the grid each row equals the whole
    grid's factors bit for bit."""
    s = np.zeros((6, 8), np.float32)
    s[:, 0:2] = rng.random((6, 2))
    s[:, 2:7] = rng.standard_normal((6, 5)) * 100
    s[:-1, 7] = 1.0
    h_total, w_total = 64, 96
    for row0, col0, h, w in ((-16, -64, 48, 112), (40, 30, 40, 130), (0, 0, 64, 96)):
        t = tsplat.splat_factors(torch.from_numpy(s), h, w, 0.01, 1.5, slice(2, 4), row0=row0,
                                 h_total=h_total, col0=col0, w_total=w_total)
        j = jsplat.splat_factors(jnp.asarray(s), h, w, 0.01, 1.5, slice(2, 4), row0=row0,
                                 h_total=h_total, col0=col0, w_total=w_total)
        for a, b in zip(t, j):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        whole = tsplat.splat_factors(torch.from_numpy(s), h_total, w_total, 0.01, 1.5,
                                     slice(2, 4))
        rows = np.clip(row0 + np.arange(h), 0, h_total - 1)
        cols = np.clip(col0 + np.arange(w), 0, w_total - 1)
        assert torch.equal(t[0], whole[0][rows])
        assert torch.equal(t[1], whole[1][:, cols])


# ---------------------------------------------------------------- true walls


def _bounded_inputs(h, w, seed=0):
    rng = np.random.default_rng(seed)
    hp, wp = h + 32, w + 128
    vel = np.clip(rng.standard_normal((2, hp, wp)) * 400, -1000, 1000).astype(np.float32)
    s = np.zeros((8, 8), np.float32)
    s[:, 0:2] = rng.random((8, 2))
    s[:, 2:4] = (rng.random((8, 2)) - 0.5) * 1000
    s[:-1, 7] = 1.0
    kw = dict(row0=-16, h_total=4 * h, col0=-64, w_total=2 * w)
    tf = tsplat.splat_factors(torch.from_numpy(s), hp, wp, 0.01, wp / hp, slice(2, 4), **kw)
    jf = jsplat.splat_factors(jnp.asarray(s), hp, wp, 0.01, wp / hp, slice(2, 4), **kw)
    return vel, tf, jf


def _inside(a, window):
    r0, c0, h, w = window
    return a[..., r0:r0 + h, c0:c0 + w]


@pytest.mark.parametrize("bounds", sorted(check.shard_bounds(96, 160, *GHOSTS)), ids=str)
def test_bounded_pre_pressure_matches_jax(bounds):
    """pre_pressure_plain(true_bounds=) against JAX's dispatch.pre_pressure
    (its bounds-aware jnp fallback) inside the walls of every check.py
    case, 1e-6 of the scale in float32; NaN outside."""
    h, w = 96, 160
    b = check.shard_bounds(h, w, *GHOSTS)[bounds]
    vel, tf, jf = _bounded_inputs(h, w)
    gv, gd = kstencil.pre_pressure_plain(torch.from_numpy(vel), 30.0, DT, tf, b)
    jv, jd = jdispatch.pre_pressure(jnp.asarray(vel), 30.0, DT, splat_factors=jf, true_bounds=b)
    window = kstencil.window(*vel.shape[-2:], b)
    scale = float(np.abs(_inside(np.asarray(jv), window)).max())
    assert float(np.abs(_inside(gv.numpy() - np.asarray(jv), window)).max()) < 1e-6 * scale
    assert float(np.abs(_inside(gd.numpy() - np.asarray(jd), window)).max()) < 1e-6 * scale
    inside = np.zeros(vel.shape[-2:], bool)
    inside[window[0]:window[0] + window[2], window[1]:window[1] + window[3]] = True
    assert np.isnan(gv.numpy()[:, ~inside]).all() and np.isnan(gd.numpy()[~inside]).all()


@pytest.mark.parametrize("splats", [False, True], ids=["nosplats", "splats"])
@pytest.mark.parametrize("bounds", ["corner", "corner-bottom-right", "middle", "first-tile"])
def test_bounded_pre_pressure_matches_pallas_interpret(bounds, splats):
    """The same against the Pallas kernel with its SMEM bounds, run in
    interpret mode through its dispatch (as tests/test_sharding.py runs the
    kernels on the CPU), where the kernel's result is defined: inside the
    walls, and 3 texels (the chain's reach) in from an array edge that is
    no wall, whose ghosts the TPU kernel reads wrapped around. 1e-6 of the
    scale without splats; with them 2e-4, the error of the kernel's bump,
    a 3-pass bfloat16 dot (dot_f32_3x), measured at 1e-4."""
    import tpufluid.ops.pallas.stencil as ps

    h, w = 96, 160
    b = check.shard_bounds(h, w, *GHOSTS)[bounds]
    vel, tf, jf = _bounded_inputs(h, w, seed=1)
    calls = {"n": 0}
    orig = ps.pl.pallas_call

    def interp(*a, **k):
        calls["n"] += 1
        return orig(*a, interpret=True, **k)

    with mock.patch.object(jdispatch, "_on_tpu", lambda: True), \
            mock.patch.object(ps.pl, "pallas_call", interp):
        jv, jd = jdispatch.pre_pressure(jnp.asarray(vel), 30.0, DT,
                                        splat_factors=jf if splats else None, true_bounds=b)
        jv, jd = np.asarray(jv), np.asarray(jd)
    assert calls["n"] == 1, "the Pallas kernel did not engage"
    gv, gd = kstencil.pre_pressure_plain(torch.from_numpy(vel), 30.0, DT,
                                         tf if splats else None, b)
    hp, wp = vel.shape[-2:]
    r0, c0, wh, ww = kstencil.window(hp, wp, b)
    reach = kstencil.HALO
    rows = slice(r0 + (0 if b[0] >= 0 else reach), r0 + wh - (0 if b[1] < hp else reach))
    cols = slice(c0 + (0 if b[2] >= 0 else reach), c0 + ww - (0 if b[3] < wp else reach))
    tol = 2e-4 if splats else 1e-6
    scale = float(np.abs(jv[:, rows, cols]).max())
    assert float(np.abs(gv.numpy() - jv)[:, rows, cols].max()) < tol * scale
    assert float(np.abs(gd.numpy() - jd)[rows, cols].max()) < tol * scale


# ---------------------------------------------------------------- the step


@pytest.mark.parametrize("overlap", [False, True], ids=["monolithic", "overlap"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(shape, grid, overlap):
    """The port's make_sharded_step against JAX's on the same mesh shape:
    1e-4 after one step, 1e-3 after three. At these sizes OVERLAP_HALO
    falls back to the monolithic phases (shards under 3 ghosts deep), as
    JAX's does."""
    cfg = _jcfg(OVERLAP_HALO=overlap, **GRIDS[grid])
    for t, (got, want) in enumerate(_run_both(cfg, shape, 3)):
        tol = 1e-4 if t == 0 else 1e-3
        for name, g, w in zip(FIELDS, got, want):
            assert g.shape == w.shape
            if t in (0, 2):
                assert _rel(g, w) < tol, (t, name, _rel(g, w))


@pytest.mark.parametrize("shape,kw", [
    ((2, 4), dict(SIM_RESOLUTION=256, DYE_RESOLUTION=256)),    # every phase split
    ((4, 2), dict(SIM_RESOLUTION=256, DYE_RESOLUTION=512)),    # pre-pressure, projection split
    ((2, 1), dict(SIM_RESOLUTION=256, DYE_RESOLUTION=512)),    # every phase, cross grid
], ids=["2x4-same", "4x2-dye2x", "2x1-dye2x"])
def test_split_phase_step_matches_jax(shape, kw, monkeypatch):
    """OVERLAP_HALO=True where the shards hold an interior band: the
    split-phase phases (interior band plus two strips, assembled in place)
    against JAX's split-phase step, 1e-4 after one step, 1e-3 after three."""
    calls = {"n": 0}
    orig = sharded_step._overlap_rows

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sharded_step, "_overlap_rows", counted)
    cfg = _jcfg(OVERLAP_HALO=True, **kw)
    for t, (got, want) in enumerate(_run_both(cfg, shape, 3, seed=3)):
        tol = 1e-4 if t == 0 else 1e-3
        for name, g, w in zip(FIELDS, got, want):
            if t in (0, 2):
                assert _rel(g, w) < tol, (t, name, _rel(g, w))
    assert calls["n"] > 0, "no phase took the split path"


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_bfloat16_rgb9e5_matches_jax(shape):
    """bfloat16 with the RGB9E5 dye (cross grid, sim 32 / dye 128): within
    0.08 of the scale of JAX's sharded step after one step."""
    cfg = _jcfg(SIM_RESOLUTION=32, DYE_RESOLUTION=128, DTYPE="bfloat16")
    assert cfg.DYE_RGB9E5
    got, want = _run_both(cfg, shape, 1, seed=17)[0]
    for name, g, w in zip(FIELDS, got, want):
        assert _rel(g, w) < 0.08, (name, _rel(g, w))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_single_device(shape):
    """The port's sharded step against its own single-device step, 4 steps:
    within 4e-4 of the scale (tests/test_sharding.py's bound)."""
    cfg = _tcfg(_jcfg(**GRIDS["dye2x"]))
    trace = T.swirl_trace(cfg, 4, seed=11)
    mesh = _tmesh(shape)
    sharded = T.make_sharded_step(cfg, mesh)
    one = T.make_step(cfg, device="cpu")
    s1 = T.init_state(cfg, device="cpu")
    s8 = T.shard_state(T.init_state(cfg, device="cpu"), mesh)
    for t in range(4):
        s1 = one(s1, DT, trace.batches[t])
        s8 = sharded(s8, DT, trace.batches[t])
    g = gather_state(s8)
    for f in FIELDS:
        a, b = getattr(g, f).numpy(), getattr(s1, f).numpy()
        assert _rel(a, b) < 4e-4, (f, _rel(a, b))


@pytest.mark.parametrize("shape", [(4, 2), (2, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_16bit_dye_reads_a_float32_velocity(shape):
    """bfloat16 with the RGB9E5 dye on a cross grid (sim 32 / dye 128): the
    velocity each shard resamples on its dye block stays float32, as JAX's
    does, so after one step the sharded dye is within 2e-3 of the scale of
    the single-device dye. Rounding that velocity to storage puts it 5.3e-3
    away."""
    cfg = _tcfg(_jcfg(SIM_RESOLUTION=32, DYE_RESOLUTION=128, DTYPE="bfloat16"))
    assert cfg.DYE_RGB9E5
    trace = T.swirl_trace(cfg, 1, seed=17)
    mesh = _tmesh(shape)
    one = T.make_step(cfg, device="cpu")(T.init_state(cfg, device="cpu"), DT, trace.batches[0])
    shards = T.make_sharded_step(cfg, mesh)(T.shard_state(T.init_state(cfg, device="cpu"), mesh),
                                            DT, trace.batches[0])
    got, want = gather_state(shards).dye.float().numpy(), one.dye.float().numpy()
    assert _rel(got, want) < 2e-3, _rel(got, want)


def test_sharded_multi_step_equals_stepwise():
    cfg = _tcfg(_jcfg(**GRIDS["dye2x"]))
    trace = T.swirl_trace(cfg, 5, seed=13)
    mesh = _tmesh((4, 2))
    step = T.make_sharded_step(cfg, mesh)
    a = T.shard_state(T.init_state(cfg, device="cpu"), mesh)
    for t in range(5):
        a = step(a, trace.dts[t], trace.batches[t])
    b = T.make_sharded_multi_step(cfg, mesh)(T.shard_state(T.init_state(cfg, device="cpu"),
                                                           mesh), trace.dts, trace.batches)
    for row_a, row_b in zip(a, b):
        for x, y in zip(row_a, row_b):
            for f in FIELDS:
                assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_sharded_rgb9e5_leaves_velocity_bit_equal():
    """DYE_RGB9E5 touches the dye alone: velocity bit-equal to the
    unquantized sharded run, the dye within the quantization's noise."""
    outs = {}
    for q in (False, True):
        cfg = _tcfg(_jcfg(SIM_RESOLUTION=32, DYE_RESOLUTION=128, DTYPE="bfloat16", DYE_RGB9E5=q))
        trace = T.swirl_trace(cfg, 3, seed=17)
        mesh = _tmesh((4, 2))
        step = T.make_sharded_step(cfg, mesh)
        s = T.shard_state(T.init_state(cfg, device="cpu"), mesh)
        for t in range(3):
            s = step(s, DT, trace.batches[t])
        outs[q] = gather_state(s)
    assert torch.equal(outs[True].velocity, outs[False].velocity)
    d = (outs[True].dye.float() - outs[False].dye.float()).abs()
    scale = max(float(outs[False].dye.float().abs().max()), 1e-6)
    assert 0 < float(d.max()) / scale < 0.02


def test_shard_and_gather_round_trip():
    cfg = _tcfg(_jcfg(**GRIDS["dye2x"]))
    state, _ = check.random_state(cfg, 3, "cpu")
    mesh = _tmesh((2, 4))
    shards = T.shard_state(state, mesh)
    assert len(shards) == 2 and len(shards[0]) == 4
    assert tuple(shards[1][3].dye.shape) == (3, 64, 32)
    back = gather_state(shards)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(state, f))


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("kw,shape", [
    (dict(SIM_RESOLUTION=64, DYE_RESOLUTION=128), (4, 2)),
    (dict(SIM_RESOLUTION=64, DYE_RESOLUTION=64, DTYPE="bfloat16"), (8, 1)),
    (dict(SIM_RESOLUTION=16384, DYE_RESOLUTION=16384, CANVAS_WIDTH=16384,
          CANVAS_HEIGHT=16384, DTYPE="bfloat16"), (2, 2)),
    (dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720), (2, 2)),
    (dict(SIM_RESOLUTION=64, DYE_RESOLUTION=128), (1, 1)),
], ids=["64-128-4x2", "64-bf16-8x1", "16384-2x2", "demo-2x2", "1x1"])
def test_overhead_report_equals_jax(kw, shape):
    cfg = _jcfg(**kw)
    assert sharded_step.overhead_report(_tcfg(cfg), shape) == jax_overhead_report(cfg, shape)


def test_overlap_halo_default_follows_the_crossover():
    for res, want in ((4096, False), (8192, True), (16384, True)):
        cfg = _jcfg(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res, CANVAS_HEIGHT=res)
        assert _tcfg(cfg).overlap_halo == cfg.overlap_halo == want
    cfg = _jcfg(SIM_RESOLUTION=64, DYE_RESOLUTION=64, OVERLAP_HALO=True)
    assert _tcfg(cfg).overlap_halo and cfg.overlap_halo


def test_sharded_step_rejects_indivisible_grid():
    cfg = _tcfg(_jcfg(SIM_RESOLUTION=30, DYE_RESOLUTION=30, CANVAS_WIDTH=30, CANVAS_HEIGHT=30))
    with pytest.raises(ValueError, match="must divide mesh"):
        T.make_sharded_step(cfg, _tmesh((8, 1)))
    with pytest.raises(ValueError, match="must divide mesh"):
        T.make_sharded_multi_step(cfg, _tmesh((8, 1)))


def test_mixed_device_mesh_raises():
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        Mesh(((torch.device("cpu"), torch.device("cuda", 0)),))
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        T.make_mesh(devices=["cpu", "cuda:0"], shape=(2, 1))


def test_make_mesh_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no"):
        T.make_mesh()
    mesh = T.make_mesh(devices=["cpu"] * 4, shape=(2, 2))
    assert mesh.shape == (2, 2) and mesh.axis_names == ("y", "x")
    with pytest.raises(ValueError):
        T.make_mesh(devices=["cpu"] * 3, shape=(2, 2))


def test_step_refuses_shards_off_the_mesh():
    cfg = _tcfg(_jcfg(**GRIDS["same"]))
    shards = T.shard_state(T.init_state(cfg, device="cpu"), _tmesh((4, 2)))
    with pytest.raises(ValueError, match="shards on a"):
        T.make_sharded_step(cfg, _tmesh((2, 4)))(shards, DT, np.zeros((4, 8), np.float32))


def test_parallel_imports_neither_jax_nor_tpufluid():
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys, pkgutil, importlib, tpufluid_torch.parallel as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tpufluid_torch.parallel.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpufluid')]\n"
        "assert not bad, bad\n"
        "print(sorted(m for m in sys.modules if m.startswith('tpufluid_torch.parallel.')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("halo", "mesh", "sharded_step"):
        assert f"tpufluid_torch.parallel.{name}" in out.stdout
