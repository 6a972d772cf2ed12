"""The port's fleet programs (tpufluid_torch.serve_batch) against
tpufluid.serve_batch on the CPU, and fleet checkpoints across the two
packages.

Tolerances. The programs run on the port's plain versions and on JAX's jnp
path (USE_PALLAS=False) from the same state: a running fleet (5 ticks of
each sim's swirl_trace from zero, seeded with numpy), carried across with
tpufluid_torch.interop. Each field of the state is held within 2e-5 of its
scale (max |JAX|): the float32 rounding of the two packages' op orders,
about 4e-6 of the scale after one tick here; an element-wise 2e-5 does not
hold for the velocity, whose near-zero texels differ by that rounding. For
K = 3 the bound adds JAX's own gap between its scanned substeps and its
per-sim program iterated, measured in the test (the port's K-substep tick
equals its iterated ticks bit for bit, tests/test_torch_serve_batch.py).
The uint8 frames are within 1 count. The zero tail, the resize and the
checkpoints are exact.
"""

import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid.serve_batch as jsb
from tpufluid import FluidConfig as JaxConfig
from tpufluid.state import FluidState as JaxState
import tpufluid_torch as T
import tpufluid_torch.serve_batch as tsb
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy

KW = dict(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=96, CANVAS_HEIGHT=64,
          MAX_SPLATS=4, USE_PALLAS=False)
# Effects on at tests/test_torch_batch_render.py's bloom and sunrays
# resolutions, which keep JAX's compiles short.
EFFECTS = {"off": dict(BLOOM=False, SUNRAYS=False, SHADING=False),
           "on": dict(BLOOM=True, SUNRAYS=True, SHADING=True, BLOOM_RESOLUTION=32,
                      SUNRAYS_RESOLUTION=24)}
SESSIONS, PB = 3, 4
STATE_TOL = 2e-5
N_SUB = np.array([1, 2, 3, 1])
SUB_DT = np.array([1 / 120, 1 / 60, 1 / 60, 1 / 60], np.float32)
DTS = {"scalar": np.float32(1 / 60),
       "vector": np.array([1 / 60, 1 / 90, 1 / 120, 1 / 60], np.float32),
       3: np.where(np.arange(3)[:, None] < N_SUB[None, :], SUB_DT[None, :], 0.0
                   ).astype(np.float32)}


def _cfgs(**kw):
    jcfg = JaxConfig(**{**KW, **kw}).validate()
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _fleet(cfg):
    """Numpy fields of a running padded fleet (the pad row zero) and the
    next tick's splats: SESSIONS sims, each its own swirl_trace (seed 42 +
    i), 5 ticks from zero through the port's plain versions."""
    seq = np.zeros((6, PB, cfg.MAX_SPLATS, 8), np.float32)
    for b in range(SESSIONS):
        seq[:, b] = T.swirl_trace(cfg, 6, seed=42 + b).batches
    state = T.init_batch(cfg, PB, device="cpu")
    tick = tsb.make_substepped_tick(cfg, device="cpu")
    for t in range(5):
        state, _ = tick(state, np.full((1, PB), 1 / 60, np.float32), seq[t])
    return state_to_numpy(state), seq[5]


def _jax_state(fields, jcfg):
    return JaxState(*(jnp.asarray(a).astype(jcfg.DTYPE) for a in fields))


def _port_state(fields, cfg):
    s = state_from_numpy(*fields, device="cpu")
    return T.FluidState(*(x.to(cfg.dtype) for x in (s.velocity, s.dye, s.pressure)))


def _u8_close(got, want):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_padded_and_constants_equal_jax():
    assert [tsb._padded(n) for n in range(1, 65)] == [jsb._padded(n) for n in range(1, 65)]
    assert (tsb.MAX_DT, tsb.SPEED_MAX, tsb._K_MAX) == (jsb.MAX_DT, jsb.SPEED_MAX, jsb._K_MAX)
    assert tsb.BatchFluidServer.MAX_SESSIONS == jsb.BatchFluidServer.MAX_SESSIONS
    assert tsb.BatchFluidServer._SNAP_MIN_INTERVAL_S == \
        jsb.BatchFluidServer._SNAP_MIN_INTERVAL_S
    assert tsb._DASH.replace("one GPU, one batched tick a frame",
                             "one chip, one dispatch/frame") == jsb._DASH


def _prewarm(server):
    return {p: server._prewarm_keys(p) for p in (1, 4, 64)}


@pytest.mark.parametrize("prewarm", ["off", "neighbors", "all"])
def test_reconciler_order_equals_jax(prewarm):
    """The prewarm keys and the reconciler's next task, through a shrink and
    a grow across padded sizes, equal JAX's (its programs stubbed: nothing
    is compiled)."""
    jcfg, cfg = _cfgs(**EFFECTS["off"])
    js = jsb.BatchFluidServer(jcfg, sessions=3, prewarm=prewarm)
    ts = tsb.BatchFluidServer(cfg, sessions=3, prewarm=prewarm, device="cpu")
    assert _prewarm(js) == _prewarm(ts)
    for n in (None, 1, 6, 2):
        if n is not None:
            js.resize_fleet(n)
            ts.resize_fleet(n)
        for _ in range(40):
            with js.lock:
                jt = js._next_task()
            with ts.lock:
                tt = ts._next_task()
            assert jt == tt, (n, jt, tt)
            if jt is None:
                break
            for s in (js, ts):
                if jt[0] == "compile":
                    s._progs[jt[1]] = object()
                elif jt[0] == "zero_tail":
                    s._tail_clean = True
                elif jt[0] == "swap":
                    s._pb = jt[2]
                    s._live_rows = min(s._live_rows, jt[2])
                else:
                    s._live_rows = min(s.sessions, s._pb)
        assert (js._pb, js._live_rows, js._gen) == (ts._pb, ts._live_rows, ts._gen)


@pytest.mark.parametrize("kind", ["scalar", "vector", 3])
@pytest.mark.parametrize("effects", ["off", "on"])
def test_tick_program_matches_jax(effects, kind):
    """make_tick_program(config, 4, kind) against JAX's, B = 3 in a padded
    4: every field within STATE_TOL of its scale (plus, for K = 3, JAX's gap
    between its scan and its iterated per-sim ticks), the uint8
    frames within 1 count, the pad row exactly zero in both."""
    jcfg, cfg = _cfgs(**EFFECTS[effects])
    fields, splats = _fleet(cfg)
    dt = DTS[kind]
    got_state, got_u8 = tsb.make_tick_program(cfg, PB, kind)(
        state_from_numpy(*fields, device="cpu"), dt, splats)
    want_state, want_u8 = jsb.make_tick_program(jcfg, PB, kind)(
        _jax_state(fields, jcfg), jnp.asarray(dt), jnp.asarray(splats))
    want = [np.asarray(x, np.float32) for x in (want_state.velocity, want_state.dye,
                                                 want_state.pressure)]
    gap = [np.zeros_like(w) for w in want]
    if kind == 3:
        # JAX's own scan noise: its per-sim program iterated, splats on the
        # first tick, each sim read after its own n substeps (rows of a
        # vmap never mix, so the later ticks of a sim already done are
        # simply not read).
        vector = jsb.make_tick_program(jcfg, PB, "vector")
        s = _jax_state(fields, jcfg)
        for i in range(int(N_SUB.max())):
            sp = splats if i == 0 else np.zeros_like(splats)
            s, _ = vector(s, jnp.asarray(SUB_DT), jnp.asarray(sp))
            for g, w, x in zip(gap, want, (s.velocity, s.dye, s.pressure)):
                done = N_SUB == i + 1
                g[done] = np.abs(w[done] - np.asarray(x, np.float32)[done])
    for name, g, w, jg in zip(("velocity", "dye", "pressure"), state_to_numpy(got_state),
                              want, gap):
        assert g.shape == w.shape
        assert (g[SESSIONS:] == 0).all() and (w[SESSIONS:] == 0).all(), name
        err = np.abs(g - w) - jg
        assert err.max() <= STATE_TOL * np.abs(w).max(), (name, float(err.max()),
                                                           float(np.abs(w).max()))
    assert got_u8.shape == (PB, 64, 96, 3)
    _u8_close(got_u8, want_u8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_tail_and_resize_equal_jax(dtype):
    """make_zero_tail and make_state_resize (grow 2 -> 4, shrink 4 -> 2 and
    4 -> 1) equal JAX's exactly."""
    jcfg, cfg = _cfgs(DTYPE=dtype, **EFFECTS["off"])
    rng = np.random.default_rng(3)
    shapes = tsb._batch_shapes(cfg, PB)
    fields = [(rng.standard_normal(shapes[f]) * 10).astype(np.float32)
              for f in ("velocity", "dye", "pressure")]

    def same(got, want):
        for g, w in zip(state_to_numpy(got), (want.velocity, want.dye, want.pressure)):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))

    keep = np.array([True, False, True, False])
    same(tsb.make_zero_tail(cfg, PB)(_port_state(fields, cfg), keep),
         jsb.make_zero_tail(jcfg, PB)(_jax_state(fields, jcfg), jnp.asarray(keep)))
    for pb_from, pb_to in ((2, 4), (4, 2), (4, 1)):
        sub = [a[:pb_from] for a in fields]
        got = tsb.make_state_resize(cfg, pb_from, pb_to)(_port_state(sub, cfg))
        assert got.velocity.shape[0] == pb_to and got.dye.dtype == cfg.dtype
        same(got, jsb.make_state_resize(jcfg, pb_from, pb_to)(_jax_state(sub, jcfg)))


def _load(server_state, rows):
    return [np.asarray(x, np.float32)[:rows] for x in server_state]


def _session_side(server, speeds):
    """Give a server of either package distinct bookkeeping: speeds, a
    pointer down, a burst and a drained step (leaving a spill)."""
    server.speeds[:] = speeds
    server.tracers[0].feed("down", pid=2, x=40.0, y=30.0)
    server.tracers[1].feed("burst", n=9)
    for tr in server.tracers:
        tr.drain_step(1 / 60)


def _carried(a, b):
    """Sessions, speeds, seed policy and every tracer's state_dict equal."""
    assert a.sessions == b.sessions and a._pb == b._pb
    assert (a._seed, a._identical_seeds) == (b._seed, b._identical_seeds)
    np.testing.assert_array_equal(np.asarray(a.speeds), np.asarray(b.speeds))
    assert [json.dumps(t.state_dict()) for t in a.tracers] == \
        [json.dumps(t.state_dict()) for t in b.tracers]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fleet_checkpoints_load_across_packages(dtype, tmp_path):
    """tpufluid's BatchFluidServer.checkpoint_bytes resumes the port's
    BatchFluidServer, and the port's resumes tpufluid's: sessions, speeds,
    seed policy, every tracer's state_dict and the fields bit for bit (the
    pad row zero), for float32 and bfloat16."""
    jcfg, cfg = _cfgs(DTYPE=dtype, **EFFECTS["off"])
    fields, _ = _fleet(dataclasses.replace(cfg, DTYPE="float32").validate())
    speeds = np.array([0.25, 1.0, 3.5], np.float32)

    js = jsb.BatchFluidServer(jcfg, sessions=SESSIONS, seed=7, identical_seeds=True)
    js.state = _jax_state(fields, jcfg)
    _session_side(js, speeds)
    p = tmp_path / "jax_fleet.npz"
    p.write_bytes(js.checkpoint_bytes())
    ts = tsb.BatchFluidServer(cfg, resume=str(p), device="cpu")
    _carried(ts, js)
    assert ts.config == cfg and ts.state.dye.dtype == cfg.dtype
    for g, w in zip(_load(state_to_numpy(ts.state), PB),
                    (js.state.velocity, js.state.dye, js.state.pressure)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))

    ts2 = tsb.BatchFluidServer(cfg, sessions=SESSIONS, seed=9, device="cpu")
    ts2.state = _port_state(fields, cfg)
    _session_side(ts2, speeds[::-1].copy())
    q = tmp_path / "port_fleet.npz"
    q.write_bytes(ts2.checkpoint_bytes())
    js2 = jsb.BatchFluidServer(jcfg, resume=str(q))
    _carried(js2, ts2)
    for g, w in zip(_load((js2.state.velocity, js2.state.dye, js2.state.pressure), PB),
                    state_to_numpy(ts2.state)):
        np.testing.assert_array_equal(g, w)
    with np.load(io.BytesIO(q.read_bytes())) as d:
        assert d["velocity"].shape[0] == SESSIONS
