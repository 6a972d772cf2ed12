"""The port's multi-tenant fleet server (tpufluid_torch.serve_batch) on the
CPU: the contract of tests/test_serve_batch.py, case for case, on the port's
BatchFluidServer with device="cpu" at the same CFG (32/64, 96x64, effects
off, MAX_SPLATS=4); then the port's own contract, bit for bit: each sim of
a K-substep tick equals its iterated make_step_and_render ticks, a masked
zero row is a no-op, a frozen session still gets its splats, pad rows stay
exactly zero; the programs' shape checks; and the soak's correctness fields
over a few seconds. The programs against tpufluid's, and fleet checkpoints
across the two packages, are in tests/test_torch_serve_batch_jax.py.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from unittest import mock

import numpy as np
import pytest
import torch

import tpufluid_torch as T
from tpufluid_torch import FluidConfig, spans
from tpufluid_torch.checkpoint import load_state
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.ops.splat import SPLAT_COLS
from tpufluid_torch.serve_batch import (SPEED_MAX, BatchFluidServer, build_argparser,
                                        make_handler, make_state_resize, make_substepped_tick,
                                        make_tick_program, make_zero_tail)

KW = dict(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=96, CANVAS_HEIGHT=64,
          BLOOM=False, SUNRAYS=False, SHADING=False, MAX_SPLATS=4, USE_PALLAS=False)
CFG = FluidConfig(**KW).validate()
B = 3
FIELDS = ("velocity", "dye", "pressure")

_SRV = {}


@pytest.fixture(scope="module")
def server_url():
    server = BatchFluidServer(CFG, sessions=B, seed=0, quality=70, identical_seeds=True,
                              device="cpu")
    _SRV["s"] = server
    sim = threading.Thread(target=server.run, daemon=True)
    sim.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    for _ in range(600):
        try:
            urllib.request.urlopen(url + "/frame?sid=0", timeout=1).read()
            break
        except Exception:
            time.sleep(0.1)
    yield url
    server.stop()
    httpd.shutdown()
    httpd.server_close()
    sim.join(timeout=10)


def _frame(url, sid):
    r = urllib.request.urlopen(f"{url}/frame?sid={sid}", timeout=5)
    return r.read(), int(r.headers["X-Step"])


def _same_step_frames(url, sids, tries=200):
    """Frames for every sid taken at ONE sim step (retry across ticks)."""
    for _ in range(tries):
        got = [_frame(url, s) for s in sids]
        if len({step for _, step in got}) == 1:
            return [data for data, _ in got]
        time.sleep(0.005)
    raise AssertionError("could not catch all sessions at one step")


def _post(url, sid, events):
    req = urllib.request.Request(f"{url}/events?sid={sid}", data=json.dumps(events).encode(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=5).status


def _stats(url):
    return json.loads(urllib.request.urlopen(url + "/stats", timeout=5).read())


# ------------------------------------------- tests/test_serve_batch.py's cases

def test_dashboard_stats_and_frames(server_url):
    page = urllib.request.urlopen(server_url + "/", timeout=5).read()
    assert b"sessions" in page
    stats = _stats(server_url)
    assert stats["sessions"] == B and stats["steps"] > 0
    for sid in range(B):
        data, step = _frame(server_url, sid)
        assert data[:2] == b"\xff\xd8", f"sid {sid}: not a JPEG"
        assert step > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server_url + f"/frame?sid={B}", timeout=5)
    assert e.value.code == 404


def test_stats_give_the_spans_of_the_ring(server_url):
    """serve_batch --spans: with the recorder on in a ring, /stats adds each
    span's count, p50 and p95 ms over the ring (the server's drain,
    dispatch and copy of a tick, and the program's spans inside); without
    it /stats has no "spans"."""
    assert "spans" not in _stats(server_url)
    assert build_argparser().parse_args(["--spans"]).spans
    assert not build_argparser().parse_args([]).spans
    spans.enable(1 << 12, ring=True)
    try:
        want = {"server.drain", "server.dispatch", "server.frames_copy", "tick", "step",
                "pre_pressure", "frame", "display", "quantize"}
        for _ in range(200):
            got = _stats(server_url).get("spans", {})
            if want <= set(got) and got["server.frames_copy"]["count"] >= 3:
                break
            time.sleep(0.05)
        assert want <= set(got), sorted(got)
        for name, row in got.items():
            assert row["count"] >= 1 and 0 <= row["p50_ms"] <= row["p95_ms"], (name, row)
        assert got["server.dispatch"]["p50_ms"] >= got["tick"]["p50_ms"] * 0.5
    finally:
        spans.disable()
    assert "spans" not in _stats(server_url)


def test_identical_seed_sessions_stay_identical(server_url):
    frames = _same_step_frames(server_url, range(B))
    assert frames[0] == frames[1] == frames[2], "identical-seed untouched sessions diverged"


def test_event_isolation(server_url):
    # A drag on session 1 only: session 1 diverges, 0 and 2 stay identical.
    drag = ([{"k": "down", "x": 0.3, "y": 0.3}]
            + [{"k": "move", "x": 0.3 + 0.04 * i, "y": 0.3 + 0.03 * i} for i in range(1, 8)]
            + [{"k": "up"}])
    assert _post(server_url, 1, drag) == 204
    deadline = time.time() + 90
    while time.time() < deadline:
        f0, f1, f2 = _same_step_frames(server_url, range(B))
        if f1 != f0:
            break
        time.sleep(0.05)
    assert f1 != f0, "session 1 did not react to its events"
    assert f0 == f2, "untouched sessions 0 and 2 diverged (isolation broken)"


def test_per_session_speed(server_url):
    """Setting speed on session 2 switches the loop to the (B,) per-sim dt
    program and diverges session 2 from untouched session 0; /stats reports
    it; out-of-range speeds clamp to SPEED_MAX."""
    assert _post(server_url, 2, [{"k": "speed", "v": 0.5}]) == 204
    deadline = time.time() + 90
    while time.time() < deadline:
        stats = _stats(server_url)
        if stats["speeds"][2] == 0.5:
            break
        time.sleep(0.05)
    assert stats["speeds"] == [1.0, 1.0, 0.5]
    deadline = time.time() + 120
    while time.time() < deadline:
        stats = _stats(server_url)
        assert not stats["program_errors"], stats["program_errors"]
        if f"({stats['padded_batch']}, 'vector')" in stats["programs"]:
            break
        time.sleep(0.2)
    else:
        raise AssertionError(f"vector program never made: {stats['programs']}")
    # Identical event streams to sessions 0 and 2: only the clock differs.
    drag = ([{"k": "down", "x": 0.5, "y": 0.5}]
            + [{"k": "move", "x": 0.5 + 0.05 * i, "y": 0.5} for i in range(1, 5)]
            + [{"k": "up"}, {"k": "burst", "n": 6}])
    for sid in (0, 2):
        assert _post(server_url, sid, drag) == 204
    deadline = time.time() + 90
    while time.time() < deadline:
        f0, _, f2 = _same_step_frames(server_url, range(B))
        if f2 != f0:
            break
        time.sleep(0.05)
    assert f2 != f0, "session 2 at half speed did not diverge from session 0"
    assert _post(server_url, 2, [{"k": "speed", "v": 99.0}]) == 204
    deadline = time.time() + 45
    while time.time() < deadline:
        stats = _stats(server_url)
        if stats["speeds"][2] == SPEED_MAX:
            break
        time.sleep(0.05)
    assert stats["speeds"][2] == SPEED_MAX
    assert _post(server_url, 2, [{"k": "speed", "v": 1.0}]) == 204
    deadline = time.time() + 45
    while time.time() < deadline:
        stats = _stats(server_url)
        if stats["speeds"][2] == 1.0:
            break
        time.sleep(0.05)
    assert stats["speeds"][2] == 1.0


def test_fast_forward_substepping(server_url):
    """speed > 1 is fast-forward: once the K-substep program is in the
    table the loop runs ceil(max speed) masked substeps a frame (/stats
    "substeps" 2), and returns to the single-step program when the speed
    drops back, with no sim-loop error.

    "substeps" is the K of the last PUBLISHED tick, and the tick in flight
    when a speed is posted was dispatched at the speeds before it (the
    previous test leaves a tick at SPEED_MAX, K = 4, that can publish after
    its own last /stats). The sim loop runs one tick at a time, so a tick
    published two or more steps after the POST was dispatched after it: only
    such readings are judged."""

    def after_post(sid, speed):
        assert _post(server_url, sid, [{"k": "speed", "v": speed}]) == 204
        return _stats(server_url)["steps"] + 2

    fresh = after_post(1, 2.0)
    deadline = time.time() + 120
    subs = 1
    while time.time() < deadline:
        st = _stats(server_url)
        assert st["error"] is None, st["error"]
        subs = st["substeps"]
        if st["steps"] >= fresh and subs >= 2:
            break
        time.sleep(0.1)
    assert subs == 2, "fast-forward program never engaged"
    data, step = _frame(server_url, 1)
    assert data[:2] == b"\xff\xd8" and step > 0
    fresh = after_post(1, 1.0)
    deadline = time.time() + 90
    while time.time() < deadline:
        st = _stats(server_url)
        if st["steps"] >= fresh and st["substeps"] == 1 and st["speeds"][1] == 1.0:
            break
        time.sleep(0.05)
    assert st["steps"] >= fresh and st["substeps"] == 1 and st["error"] is None


def test_bad_sid_events_rejected(server_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, B + 5, [{"k": "burst", "n": 3}])
    assert e.value.code == 400


def test_nonfinite_speed_rejected(server_url):
    """NaN and +-Infinity speeds get 400 and the loop keeps ticking."""
    for lit in ("NaN", "Infinity", "-Infinity"):
        req = urllib.request.Request(f"{server_url}/events?sid=0",
                                     data=f'[{{"k": "speed", "v": {lit}}}]'.encode(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 400, lit
    s0 = _stats(server_url)
    deadline = time.time() + 90
    while time.time() < deadline:
        s1 = _stats(server_url)
        if s1["steps"] > s0["steps"]:
            break
        time.sleep(0.05)
    assert s1["steps"] > s0["steps"], "sim loop died after NaN speed POST"
    assert s1["error"] is None
    assert np.isfinite(s1["speeds"]).all()


def test_elastic_fleet_resize(server_url):
    """POST /sessions resizes the fleet live: growth brings fresh tenants
    up at the new high sids, shrink drops the high sids (404), and sizes
    outside [1, MAX_SESSIONS] or not integers get 400."""
    def post_n(n):
        req = urllib.request.Request(f"{server_url}/sessions",
                                     data=json.dumps({"n": n}).encode(), method="POST")
        return urllib.request.urlopen(req, timeout=60).status

    assert post_n(B + 2) == 204
    deadline = time.time() + 60
    got = None
    while time.time() < deadline:
        try:
            got = _frame(server_url, B + 1)
            break
        except urllib.error.HTTPError:
            time.sleep(0.1)
    assert got is not None and got[0][:2] == b"\xff\xd8"
    stats = _stats(server_url)
    assert stats["sessions"] == B + 2 and len(stats["speeds"]) == B + 2
    assert stats["padded_batch"] == 8
    # The two new tenants share the identical seed and joined at one tick.
    fa, fb = _same_step_frames(server_url, [B, B + 1])
    assert fa == fb, "fresh identical-seed tenants diverged after resize"
    assert post_n(B) == 204
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            _frame(server_url, 0)
            break
        except urllib.error.HTTPError:
            time.sleep(0.1)
    with pytest.raises(urllib.error.HTTPError) as e:
        _frame(server_url, B)
    assert e.value.code == 404
    for bad in (0, BatchFluidServer.MAX_SESSIONS + 1, 2.7):
        with pytest.raises(urllib.error.HTTPError) as e2:
            post_n(bad)
        assert e2.value.code == 400, bad


def test_fleet_checkpoint_resume(server_url, tmp_path):
    """/checkpoint.npz mid-run resumes a NEW fleet: batched state, session
    count, per-session speeds and every tracer's state carry over; tampered
    speeds are clamped into [0, SPEED_MAX]."""
    assert _post(server_url, 0, [{"k": "down", "x": 0.4, "y": 0.5},
                                 {"k": "burst", "n": 7}]) == 204
    assert _post(server_url, 2, [{"k": "speed", "v": 0.25}]) == 204
    deadline = time.time() + 45
    while time.time() < deadline:
        if _stats(server_url)["speeds"][2] == 0.25:
            break
        time.sleep(0.05)
    data = urllib.request.urlopen(server_url + "/checkpoint.npz", timeout=30).read()
    p = tmp_path / "fleet.npz"
    p.write_bytes(data)

    src = _SRV["s"]
    resumed = BatchFluidServer(CFG, resume=str(p), device="cpu")
    assert resumed.sessions == B
    assert resumed.steps_done > 0
    assert resumed.config == src.config
    assert resumed.speeds.tolist()[2] == 0.25
    assert 0 in resumed.tracers[0].pointers
    with np.load(p, allow_pickle=False) as d:
        assert d["velocity"].shape[0] == B
    assert resumed.state.velocity.shape[0] == resumed._pb >= B
    for name in FIELDS:
        arr = getattr(resumed.state, name)
        assert arr.dtype == CFG.dtype
        assert bool(torch.isfinite(arr.float()).all())

    with np.load(p, allow_pickle=False) as d:
        arrays = {k: d[k] for k in d.files}
    meta = json.loads(str(arrays.pop("meta")))
    meta["extra"]["speeds"] = [float("nan"), 1e9, -5.0][:B]
    p2 = tmp_path / "tampered.npz"
    np.savez_compressed(p2, meta=json.dumps(meta), **arrays)
    tampered = BatchFluidServer(CFG, resume=str(p2), device="cpu")
    sp = np.asarray(tampered.speeds)
    assert np.isfinite(sp).all()
    assert (sp >= 0.0).all() and (sp <= SPEED_MAX).all(), sp


def test_shrink_bumps_generation():
    """A shrink below _live_rows bumps _gen (an in-flight tick must not
    publish); a grow inside the padded batch does not."""
    srv = BatchFluidServer(CFG, sessions=3, seed=0, device="cpu")
    try:
        gen0 = srv._gen
        srv.resize_fleet(1)
        assert srv._gen == gen0 + 1
        assert srv._live_rows == 1 and not srv._tail_clean
        srv2 = BatchFluidServer(CFG, sessions=2, seed=0, device="cpu")
        try:
            g = srv2._gen
            srv2.resize_fleet(3)
            assert srv2._gen == g
        finally:
            srv2.stop()
    finally:
        srv.stop()


def test_reconciler_skips_terminally_failed_programs():
    """A key in _prog_errors is terminal: the reconciler never returns an
    apply task ('zero_tail' / 'swap') whose program can never exist, and
    stuck_tasks() shows the wedged objective."""
    srv = BatchFluidServer(CFG, sessions=2, seed=0, prewarm="off", device="cpu")
    try:
        with srv.lock:
            pb = srv._pb
            srv._progs[(pb, "scalar")] = object()
            srv._progs[(pb, "vector")] = object()
            srv._tail_clean = False
            srv._prog_errors[("zerotail", pb)] = "boom\nzerotail failed"
            task = srv._next_task()
            assert task != ("zero_tail",), task
            assert task is None or task[0] == "compile", task
            stuck = srv.stuck_tasks()
            assert any(s["task"] == "zero_tail" for s in stuck), stuck
            srv._tail_clean = True
            srv._prog_errors.clear()
            srv.sessions = pb + 1
            target = pb * 2
            srv._progs[(target, "scalar")] = object()
            srv._progs[(target, "vector")] = object()
            srv._prog_errors[("resize", pb, target)] = "boom\nresize failed"
            task = srv._next_task()
            assert task is None or task[0] != "swap", task
            stuck = srv.stuck_tasks()
            assert any(s["task"] == "swap" for s in stuck), stuck
            srv._prog_errors.clear()
            srv._progs[("resize", pb, target)] = object()
            assert srv._next_task() == ("swap", pb, target)
    finally:
        srv.stop()


def test_checkpoint_rolling_snapshot_respects_resize():
    """A checkpoint after an ACKed shrink, taken while a tick is on the
    device (_state_ready patched to False, so the rolling snapshot serves
    the fields), carries the post-ACK bookkeeping and never serializes the
    evicted tenants' stale rows; reused sids serialize as zero rows."""
    srv = BatchFluidServer(CFG, sessions=5, seed=0, device="cpu")
    try:
        st = srv._host_state()
        for name in FIELDS:
            a = getattr(st, name).clone()
            a[3:] = 7.0
            setattr(st, name, a)
        with srv.out_lock:
            srv._snap = (12, st)
            srv._snap_time = time.time()
            srv._snap_floor = 5
        srv.resize_fleet(3)
        srv.speeds[2] = 0.25
        with mock.patch.object(srv, "_state_ready", return_value=False):
            data = srv.checkpoint_bytes()
        state, cfg, step, extra = load_state(io.BytesIO(data), device="cpu")
        assert extra["sessions"] == 3
        assert extra["speeds"][2] == pytest.approx(0.25)
        assert step == 12
        assert state.velocity.shape[0] == 3
        assert not bool((state.velocity == 7.0).any())

        srv.resize_fleet(5)
        with mock.patch.object(srv, "_state_ready", return_value=False):
            data2 = srv.checkpoint_bytes()
        state2, _, _, extra2 = load_state(io.BytesIO(data2), device="cpu")
        assert extra2["sessions"] == 5
        v2 = state2.velocity
        assert v2.shape[0] == 5
        assert not bool((v2 == 7.0).any())
        assert bool((v2[3:] == 0.0).all())
    finally:
        srv.stop()


# ------------------------------------------ the port's own contract, bit for bit

def _splats(batch, seed=0):
    """One distinct splat a sim (tests/test_serve_batch.py's), from numpy."""
    rng = np.random.default_rng(seed)
    s = np.zeros((batch, CFG.MAX_SPLATS, SPLAT_COLS), np.float32)
    for b in range(batch):
        s[b, 0] = [0.25 + 0.2 * (b % 4), 0.5, 80.0 * (b - 1), 40.0,
                   0.4, 0.2 + 0.2 * (b % 4), 0.6, 1.0]
        s[b, 1] = [*rng.random(2), *(rng.standard_normal(2) * 300), *rng.random(3), 1.0]
    return s


def _running(cfg, batch, seed=0):
    """A batch of ``batch`` sims with distinct fields: one warm-up tick."""
    state = T.init_batch(cfg, batch, device="cpu")
    tick = make_substepped_tick(cfg, device="cpu")
    state, _ = tick(state, np.full((1, batch), 1 / 60, np.float32), _splats(batch, seed))
    return state


def _fields_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


@pytest.mark.parametrize("dtype,rgb9e5", [("float32", False), ("bfloat16", True)])
def test_each_sim_of_a_substepped_tick_equals_its_iterated_ticks(dtype, rgb9e5):
    """A sim whose row holds n equal dts equals n make_step_and_render ticks
    at that dt (splats on the first), state and frame, bit for bit: the
    port has no compiler between the two, so it is held to 0, not to JAX's
    scan noise (1e-4)."""
    cfg = FluidConfig(**{**KW, "DTYPE": dtype, "DYE_RGB9E5": rgb9e5}).validate()
    dt, k = 1 / 60, 3
    splats = _splats(B)
    n_sub = np.array([1, 2, 3])
    subs = np.array([0.5 * dt, dt, dt], np.float32)
    dts = np.where(np.arange(k)[:, None] < n_sub[None, :], subs[None, :], 0.0).astype(np.float32)
    keep = _running(cfg, B)
    got, frames = make_substepped_tick(cfg, device="cpu")(keep, dts, splats)
    single = T.make_step_and_render(cfg, device="cpu")
    for b in range(B):
        s = T.unstack_state(keep, b)
        for i in range(int(n_sub[b])):
            s, frame = single(s, subs[b], splats[b] if i == 0 else np.zeros_like(splats[b]))
        assert _fields_equal(T.unstack_state(got, b), s), b
        assert torch.equal(frames[b], frame), b


def test_masked_zero_row_is_a_noop():
    """Two sims with identical state and splats whose dt rows hold the same
    two active dts, the zero row in a different position ([d, d', 0] against
    [d, 0, d']), end bit-identical: a masked substep keeps the state bit for
    bit (a dt = 0 step would not: the projection still runs)."""
    dt = 1 / 60
    keep = _running(CFG, 3)
    pair = T.stack_states([T.unstack_state(keep, 2)] * 2)
    psplat = np.stack([_splats(3)[2]] * 2)
    perm = np.array([[dt, dt], [0.5 * dt, 0.0], [0.0, 0.5 * dt]], np.float32)
    got, frames = make_substepped_tick(CFG, device="cpu")(pair, perm, psplat)
    assert _fields_equal(T.unstack_state(got, 0), T.unstack_state(got, 1))
    assert torch.equal(frames[0], frames[1])
    stepped = T.make_batched_step(CFG, device="cpu")(
        pair, np.float32(0.0), np.zeros_like(psplat))
    assert not _fields_equal(stepped, pair), "a dt = 0 step left the state as it was"


def test_frozen_session_still_gets_its_splats():
    """All-zero dt rows still land the splats (substep 0 is unmasked) and
    advance no time: one make_step_and_render tick at dt = 0, bit for bit."""
    keep = _running(CFG, B)
    splats = _splats(B, seed=1)
    got, frames = make_substepped_tick(CFG, device="cpu")(keep, np.zeros((3, B), np.float32),
                                                          splats)
    single = T.make_step_and_render(CFG, device="cpu")
    for b in range(B):
        s, frame = single(T.unstack_state(keep, b), 0.0, splats[b])
        assert _fields_equal(T.unstack_state(got, b), s), b
        assert torch.equal(frames[b], frame), b
    assert not torch.equal(got.dye, keep.dye), "frozen-session splats did not land"


@pytest.mark.parametrize("kind", ["scalar", "vector", 3])
@pytest.mark.parametrize("dtype,rgb9e5", [("float32", False), ("bfloat16", True),
                                          ("float16", False)])
def test_pad_rows_stay_exactly_zero(dtype, rgb9e5, kind):
    """3 live sims in a padded batch of 4, 10 ticks of each program: the pad
    row, a zero state with zero splats, stays exactly zero (no mask does
    it: the step keeps zero at zero) while the live rows move."""
    cfg = FluidConfig(**{**KW, "DTYPE": dtype, "DYE_RGB9E5": rgb9e5}).validate()
    prog = make_tick_program(cfg, 4, kind)
    state = T.init_batch(cfg, 4, device="cpu")
    speeds = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    for t in range(10):
        splats = np.zeros((4, cfg.MAX_SPLATS, SPLAT_COLS), np.float32)
        splats[:3] = _splats(3, seed=t)
        if kind == "scalar":
            dt = np.float32(1 / 60)
        elif kind == "vector":
            dt = (speeds * np.float32(1 / 120)).astype(np.float32)
        else:
            dt = np.where(np.arange(3)[:, None] < np.array([1, 2, 3, 1])[None, :],
                          np.float32(1 / 60), 0.0).astype(np.float32)
        state, frames = prog(state, dt, splats)
    for f in FIELDS:
        x = getattr(state, f)
        assert bool((x[3] == 0).all()), f
        assert float(x[:3].float().abs().max()) > 0, f
    assert bool(torch.isfinite(state.velocity.float()).all())


def test_programs_check_their_arguments():
    """A program raises ValueError for a state, dt or splats not of its
    (pb, kind), and a substep kind below 2 raises."""
    state = T.init_batch(CFG, 4, device="cpu")
    splats = np.zeros((4, CFG.MAX_SPLATS, SPLAT_COLS), np.float32)
    prog = make_tick_program(CFG, 4, "vector")
    prog(state, np.full(4, 1 / 60, np.float32), splats)
    for bad in [(T.init_batch(CFG, 2, device="cpu"), np.full(2, 1 / 60, np.float32),
                 splats[:2]),
                (state, np.float32(1 / 60), splats),
                (state, np.full(4, 1 / 60, np.float32), splats[:, :2])]:
        with pytest.raises(ValueError):
            prog(*bad)
    with pytest.raises(ValueError):
        make_tick_program(CFG, 4, "scalar")(state, np.full(4, 1 / 60, np.float32), splats)
    with pytest.raises(ValueError):
        make_tick_program(CFG, 4, 3)(state, np.full((2, 4), 1 / 60, np.float32), splats)
    with pytest.raises(ValueError):
        make_tick_program(CFG, 4, 1)
    bf16 = T.init_batch(FluidConfig(**{**KW, "DTYPE": "bfloat16"}).validate(), 4, device="cpu")
    with pytest.raises(ValueError):
        make_zero_tail(CFG, 4)(bf16, np.ones(4, bool))
    with pytest.raises(ValueError):
        make_state_resize(CFG, 2, 4)(state)


def test_zero_tail_is_a_select():
    """Evicted rows become exactly zero even where they hold NaN or inf (a
    mask multiply would leak them), kept rows stay bit for bit."""
    state = _running(CFG, 4)
    state.velocity[2, 0, 0, 0] = float("nan")
    state.dye[3, 1, 2, 2] = float("inf")
    got = make_zero_tail(CFG, 4)(state, np.array([True, True, False, False]))
    for f in FIELDS:
        x, y = getattr(got, f), getattr(state, f)
        assert bool((x[2:] == 0).all()), f
        assert torch.equal(x[:2], y[:2]), f


def test_server_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchFluidServer(CFG, sessions=2)
    from tpufluid_torch import serve_batch

    with mock.patch.dict("os.environ", {"TPUFLUID_DEVICE": ""}):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_batch.main(["--sessions", "2", "--port", "0"])


def test_cli_defaults():
    """The CLI keeps tpufluid.serve_batch's defaults, without its
    --compile-cache (compilecache.py is not ported)."""
    a = build_argparser().parse_args([])
    assert (a.port, a.sessions, a.sim_res, a.dye_res, a.canvas, a.dtype, a.prewarm) == \
        (8001, 4, 128, 256, "256x256", "float32", "neighbors")
    with pytest.raises(SystemExit):
        build_argparser().parse_args(["--compile-cache", "x"])


def test_server_ticks_launch_no_kernel_on_the_cpu():
    """A CPU server's ticks, driven by hand (the reconciler's tasks, then
    _tick), publish frames and steps and launch no CUDA kernel: the CPU runs
    the plain versions, and only because the caller asked for it."""
    srv = BatchFluidServer(CFG, sessions=3, seed=2, prewarm="off", device="cpu")
    while (task := srv._next_task()) is not None:
        srv._run_task(task)
    build.reset_launches()
    for _ in range(3):
        assert srv._tick(1 / 60)
    assert srv.steps_done == 3 and srv.frames.shape == (4, 64, 96, 3)
    assert not any(k.launches for k in build.KERNELS.values())
    assert srv._state_ready()


def test_soak_correctness_over_a_few_seconds():
    """tpufluid_torch.tools.serve_soak.soak for a few seconds on the CPU:
    no loop error, steps advancing, every call completing, a finite and
    consistent fleet. Its latency bars and resize count need the full run
    and are not asserted here."""
    from tpufluid_torch.tools.serve_soak import SLO_MS, soak

    summary = soak(CFG, seconds=4.0, sessions=3, max_resize=5, seed=0, device="cpu")
    assert summary["loop_error"] is None
    assert summary["loop_exited_cleanly"] and summary["lock_acquirable_after_soak"]
    assert summary["steps_during_soak"] > 0
    assert summary["n_failures"] == 0, summary["call_failures"]
    assert summary["fleet_consistent"] and summary["state_finite"]
    assert summary["final_sessions"] >= 1
    assert not summary["program_compile_errors"]
    for k, row in summary["latency_ms"].items():
        assert row["n"] > 0 and row["slo_p99_ms"] == SLO_MS[k], (k, row)
