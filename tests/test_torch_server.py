"""The port's interactive server (tpufluid_torch.server) on the CPU: the
contract of tests/test_server.py, test for test, on the port's FluidServer
with device="cpu" at the same CFG (32/64, 96x64, effects off, MAX_SPLATS=4);
then the server's tick against make_step_and_render, its trace export
replayed by tpufluid.trace, and JAX's /checkpoint.npz resuming a port server
bit for bit."""

import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid.server as jserver
from tpufluid import FluidConfig as JaxConfig
from tpufluid import init_state as jax_init
from tpufluid import make_step as jax_make_step
from tpufluid_torch import FluidConfig, init_state, make_step, make_step_and_render
from tpufluid_torch.config import MAX_DT as CONFIG_MAX_DT
from tpufluid_torch.interop import state_to_numpy
from tpufluid_torch.io import frame_to_uint8
from tpufluid_torch.server import MAX_DT, FluidServer, make_handler

KW = dict(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=96, CANVAS_HEIGHT=64,
          BLOOM=False, SUNRAYS=False, SHADING=False, MAX_SPLATS=4, USE_PALLAS=False)
CFG = FluidConfig(**KW).validate()

_SERVER = {}


def _serve(server):
    """The server's sim thread and an HTTP server on a free port; returns
    (url, httpd, sim thread) once the first frame is out."""
    sim = threading.Thread(target=server.run, daemon=True)
    sim.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    for _ in range(600):
        try:
            urllib.request.urlopen(url + "/frame", timeout=1).read()
            break
        except Exception:
            time.sleep(0.1)
    return url, httpd, sim


def _close(server, httpd, sim):
    server.stop()
    httpd.shutdown()
    httpd.server_close()
    sim.join(timeout=10)
    assert not sim.is_alive()


@pytest.fixture(scope="module")
def server_obj(server_url):
    return _SERVER["s"]


@pytest.fixture(scope="module")
def server_url():
    server = FluidServer(CFG, seed=0, quality=70, device="cpu")
    _SERVER["s"] = server
    url, httpd, sim = _serve(server)
    yield url
    _close(server, httpd, sim)


def _post(url, events):
    req = urllib.request.Request(url + "/events", data=json.dumps(events).encode(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=5).status


def _stats(url):
    return json.loads(urllib.request.urlopen(url + "/stats", timeout=10).read())


def test_page_and_frame(server_url):
    page = urllib.request.urlopen(server_url + "/", timeout=5).read()
    assert b"tpufluid" in page and b"mousedown" in page
    for knob in [b"DENSITY_DISSIPATION", b"VELOCITY_DISSIPATION", b"PRESSURE",
                 b"CURL", b"SPLAT_RADIUS", b"SHADING", b"COLORFUL",
                 b"DYE_RESOLUTION", b"SIM_RESOLUTION", b"BLOOM_INTENSITY",
                 b"BLOOM_THRESHOLD", b"SUNRAYS_WEIGHT", b"BACK_COLOR",
                 b"TRANSPARENT", b"Random splats", b"Take screenshot"]:
        assert knob in page, knob
    jpg = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
    assert jpg[:2] == b"\xff\xd8"  # JPEG magic


def test_config_get(server_url):
    cfg = json.loads(urllib.request.urlopen(server_url + "/config", timeout=5).read())
    assert cfg["SIM_RESOLUTION"] == 32 and "SPLAT_RADIUS" in cfg


def test_screenshot_endpoint(server_url):
    png = urllib.request.urlopen(server_url + "/screenshot", timeout=30).read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    im = Image.open(io.BytesIO(png))
    # the capture renders at CAPTURE_RESOLUTION, aspect-fitted
    assert im.width >= CFG.CANVAS_WIDTH and im.height >= CFG.CANVAS_HEIGHT


def test_drag_splats_dye(server_url):
    before = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
    assert _post(server_url, [{"k": "down", "x": 0.3, "y": 0.5},
                              {"k": "move", "x": 0.5, "y": 0.5},
                              {"k": "up"}]) == 204
    time.sleep(1.0)
    after = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
    assert after != before


def test_pause_toggles(server_url):
    assert _post(server_url, [{"k": "pause"}]) == 204
    time.sleep(0.3)
    assert _stats(server_url)["paused"] is True
    _post(server_url, [{"k": "pause"}])
    time.sleep(0.3)
    assert _stats(server_url)["paused"] is False


def test_bad_json_rejected(server_url):
    req = urllib.request.Request(server_url + "/events", data=b"not json", method="POST")
    try:
        urllib.request.urlopen(req, timeout=5)
        status = 200
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 400


def test_trace_export_is_replayable(server_url):
    """The session exports as a Trace v2 with the per-step wall dt the
    server measured, which the port's step replays."""
    from tpufluid_torch.trace import Trace

    data = urllib.request.urlopen(server_url + "/trace.npz", timeout=5).read()
    npz = np.load(io.BytesIO(data))
    assert npz["batches"].ndim == 3 and npz["batches"].shape[-1] == 8
    assert npz["dts"].shape == (npz["batches"].shape[0],)
    assert (npz["dts"] <= 1 / 60 + 1e-6).all() and (npz["dts"] >= 0).all()
    tr = Trace(npz["batches"][:5], npz["dts"][:5])
    step = make_step(CFG, device="cpu")
    s = init_state(CFG, device="cpu")
    for t in range(tr.num_steps):
        s = step(s, tr.dts[t], tr.batches[t])
    assert bool(torch.isfinite(s.dye).all())


def test_early_endpoints_503_before_first_frame():
    """/screenshot, /frame and /checkpoint.npz before the sim thread made a
    state answer 503."""
    server = FluidServer(CFG, seed=0, device="cpu")  # sim thread NOT started
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        for path in ("/screenshot", "/frame", "/checkpoint.npz"):
            try:
                urllib.request.urlopen(url + path, timeout=5)
                status = 200
            except urllib.error.HTTPError as e:
                status = e.code
            assert status == 503, path
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_page_wires_window_resize(server_url):
    page = urllib.request.urlopen(server_url + "/", timeout=5).read()
    assert b"addEventListener('resize'" in page
    assert b"CANVAS_WIDTH" in page and b"CANVAS_HEIGHT" in page


def test_live_canvas_resize():
    """POST /config with CANVAS_WIDTH/HEIGHT resamples the fields live and
    frames keep flowing at the new geometry."""
    from PIL import Image

    server = FluidServer(CFG, seed=0, device="cpu")
    url, httpd, sim = _serve(server)
    try:
        body = json.dumps({"CANVAS_WIDTH": 128, "CANVAS_HEIGHT": 96}).encode()
        req = urllib.request.Request(url + "/config", data=body, method="POST")
        resp = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert resp["CANVAS_WIDTH"] == 128 and resp["CANVAS_HEIGHT"] == 96
        size = None
        for _ in range(300):
            jpg = urllib.request.urlopen(url + "/frame", timeout=10).read()
            im = Image.open(io.BytesIO(jpg))
            size = (im.width, im.height)
            if size == (128, 96):
                break
            time.sleep(0.1)
        assert size == (128, 96)
    finally:
        _close(server, httpd, sim)


def test_session_checkpoint_resume(tmp_path):
    """/checkpoint.npz mid-session resumes a new server: config, step count
    and tracer session state carry over."""
    server = FluidServer(CFG, seed=0, device="cpu")
    url, httpd, sim = _serve(server)
    try:
        req = urllib.request.Request(
            url + "/events", data=json.dumps(
                [{"k": "down", "x": 0.4, "y": 0.5}, {"k": "burst"}]).encode(),
            method="POST")
        urllib.request.urlopen(req, timeout=5)
        time.sleep(0.3)
        data = urllib.request.urlopen(url + "/checkpoint.npz", timeout=30).read()
    finally:
        _close(server, httpd, sim)
    p = tmp_path / "session.npz"
    p.write_bytes(data)

    resumed = FluidServer(CFG, seed=0, resume=str(p), device="cpu")
    assert resumed.steps_done > 0
    assert resumed.config == server.config
    assert 0 in resumed.tracer.pointers
    sim2 = threading.Thread(target=resumed.run, daemon=True)
    sim2.start()
    for _ in range(100):
        with resumed.lock:
            if resumed.frame_bytes is not None:
                break
        time.sleep(0.1)
    resumed.stop()
    sim2.join(timeout=10)
    assert resumed.frame_bytes is not None  # the resumed loop really runs


def test_frame_and_stats_respond_during_long_tick(server_url, server_obj):
    """/frame and /stats answer while the sim lock is held (they read under
    out_lock)."""
    urllib.request.urlopen(server_url + "/frame", timeout=10).read()
    with server_obj.lock:  # a tick in progress, indefinitely
        t0 = time.time()
        jpg = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
        st = _stats(server_url)
        elapsed = time.time() - t0
    assert jpg[:2] == b"\xff\xd8" and "steps" in st
    assert elapsed < 3.0


def test_mobile_ua_downgrade():
    """A mobile client's page load applies the mobile preset's dye 512:
    once a session, downward only, desktop agents untouched."""
    cfg = FluidConfig(**{**KW, "DYE_RESOLUTION": 1024}).validate()
    s = FluidServer(cfg, seed=0, device="cpu")
    assert not s.maybe_mobile_downgrade(
        "Mozilla/5.0 (X11; Linux x86_64) Gecko/20100101 Firefox/126.0")
    assert s.config.DYE_RESOLUTION == 1024
    assert s.maybe_mobile_downgrade(
        "Mozilla/5.0 (Linux; Android 13; Pixel 7) Mobile Safari/537.36")
    assert s.config.DYE_RESOLUTION == 512
    assert not s.maybe_mobile_downgrade("Android")

    s2 = FluidServer(CFG, seed=0, device="cpu")
    assert s2.maybe_mobile_downgrade("iPhone Mobi")
    assert s2.config.DYE_RESOLUTION == CFG.DYE_RESOLUTION


def test_mobile_ua_http_page(server_url):
    req = urllib.request.Request(server_url + "/", headers={
        "User-Agent": "Mozilla/5.0 (Linux; Android 13) Mobile"})
    page = urllib.request.urlopen(req, timeout=10).read()
    assert b"tpufluid" in page
    cfg = json.loads(urllib.request.urlopen(server_url + "/config", timeout=5).read())
    assert cfg["DYE_RESOLUTION"] == CFG.DYE_RESOLUTION


def test_panel_storage_knobs(server_url):
    page = urllib.request.urlopen(server_url + "/", timeout=10).read()
    assert b"DTYPE" in page and b"DYE_RGB9E5" in page


def test_live_dtype_switch():
    """POST /config {"DTYPE": "bfloat16"} casts the running fields
    (resize_state), rebuilds the tick, and frames keep flowing."""
    server = FluidServer(CFG, seed=0, device="cpu")
    url, httpd, sim = _serve(server)
    try:
        body = json.dumps({"DTYPE": "bfloat16"}).encode()
        req = urllib.request.Request(url + "/config", data=body, method="POST")
        resp = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert resp["DTYPE"] == "bfloat16"
        stats0 = _stats(url)
        deadline = time.time() + 60
        while time.time() < deadline:
            stats1 = _stats(url)
            if stats1["steps"] > stats0["steps"]:
                break
            time.sleep(0.2)
        assert stats1["steps"] > stats0["steps"]
        with server.lock:
            assert server.state.dye.dtype == torch.bfloat16
            assert server.state.velocity.dtype == torch.bfloat16
    finally:
        _close(server, httpd, sim)


def test_live_config_change(server_url):
    """POST /config rebuilds the step and render and resizes the fields; an
    unknown knob answers 400."""
    body = json.dumps({"CURL": 50.0, "DYE_RESOLUTION": 48}).encode()
    req = urllib.request.Request(server_url + "/config", data=body, method="POST")
    resp = json.loads(urllib.request.urlopen(req, timeout=30).read())
    assert resp["CURL"] == 50.0 and resp["DYE_RESOLUTION"] == 48
    stats0 = _stats(server_url)
    deadline = time.time() + 60
    stats1 = stats0
    while time.time() < deadline and stats1["steps"] <= stats0["steps"]:
        time.sleep(0.2)
        stats1 = _stats(server_url)
    assert stats1["steps"] > stats0["steps"]
    jpg = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
    assert jpg[:2] == b"\xff\xd8"
    req = urllib.request.Request(server_url + "/config",
                                 data=json.dumps({"NOPE": 1}).encode(), method="POST")
    try:
        urllib.request.urlopen(req, timeout=10)
        status = 200
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 400


def test_stalled_client_cannot_wedge(server_url, server_obj):
    """Stalled clients (request headers never finished) hold only their
    own connections: the sim loop advances, events and frames flow."""
    import socket

    host, port = server_url.replace("http://", "").split(":")
    stalled = [socket.create_connection((host, int(port)), timeout=30) for _ in range(4)]
    for s in stalled:
        s.sendall(b"GET /frame HTTP/1.1\r\nHost: x")
    try:
        s0 = _stats(server_url)
        deadline = time.time() + 30
        advanced = False
        while time.time() < deadline:
            if _stats(server_url)["steps"] > s0["steps"]:
                advanced = True
                break
            time.sleep(0.1)
        assert advanced, "sim loop stopped while clients were stalled"
        assert _post(server_url, [{"k": "burst", "n": 3}]) == 204
        jpg = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
        assert jpg[:2] == b"\xff\xd8"
    finally:
        for s in stalled:
            s.close()


def test_events_503_when_sim_lock_stalled(server_url, server_obj):
    """A tick holding the sim lock past EVENT_LOCK_TIMEOUT_S turns /events
    and GET /config into bounded 503s while /frame keeps serving; all
    recovers once the lock frees."""
    server_obj.lock.acquire()
    try:
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server_url, [{"k": "burst", "n": 1}])
        assert e.value.code == 503
        assert time.time() - t0 < FluidServer.EVENT_LOCK_TIMEOUT_S + 3.0
        with pytest.raises(urllib.error.HTTPError) as e2:
            urllib.request.urlopen(server_url + "/config", timeout=10)
        assert e2.value.code == 503
        jpg = urllib.request.urlopen(server_url + "/frame", timeout=5).read()
        assert jpg[:2] == b"\xff\xd8"
    finally:
        server_obj.lock.release()
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            assert _post(server_url, [{"k": "burst", "n": 1}]) == 204
            break
        except urllib.error.HTTPError:
            time.sleep(0.2)
    else:
        raise AssertionError("events did not recover after the stall")


# -- beyond tests/test_server.py: the port's own seams -------------------------


def test_constants_and_page_equal_jax():
    """MAX_DT is the reference's literal, equal to the config's and JAX
    server's; the page is JAX's but for one comment's wording; the
    backpressure bounds are JAX's."""
    from tpufluid_torch.server import _PAGE

    assert MAX_DT == CONFIG_MAX_DT == jserver.MAX_DT == 0.016666
    assert _PAGE.replace("// Storage knobs", "// TPU storage knobs") == jserver._PAGE
    assert FluidServer.EVENT_LOCK_TIMEOUT_S == jserver.FluidServer.EVENT_LOCK_TIMEOUT_S
    assert FluidServer.MAX_INFLIGHT_EVENTS == jserver.FluidServer.MAX_INFLIGHT_EVENTS


def test_server_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        FluidServer(CFG, seed=0)


@pytest.mark.parametrize("paused", [False, True])
def test_advance_is_one_tick_of_make_step_and_render(paused):
    """advance(dt) drains the tracer into one recorded batch and returns the
    tick's uint8 frame (make_step_and_render on the same state and batch);
    paused, it renders the state unchanged."""
    server = FluidServer(CFG, seed=3, device="cpu")
    server.state = init_state(CFG, device="cpu")
    server.tracer.feed("burst", n=3)
    server.tracer.feed("down", pid=0, x=30.0, y=20.0)
    server.tracer.feed("move", pid=0, x=50.0, y=25.0)
    server.paused = paused
    before = server.state
    frame = server.advance(0.01)
    assert frame.dtype == np.uint8 and frame.shape == (64, 96, 3)
    batch = server.recorded[-1]
    assert batch.shape == (4, 8) and batch[:, 7].sum() == 4.0
    assert server.recorded_dts == [0.01]
    if paused:
        assert server.state is before
        want = frame_to_uint8(server.render(before))[..., :3]
    else:
        want_state, want = make_step_and_render(CFG, device="cpu")(before, 0.01, batch)
        want = want.numpy()
        for g, w in zip(state_to_numpy(server.state), state_to_numpy(want_state)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(frame, want)


def test_exported_trace_replays_in_jax(server_url):
    """A port session's /trace.npz loads with tpufluid.trace.Trace.load and
    replays through JAX's step."""
    from tpufluid.trace import Trace

    data = urllib.request.urlopen(server_url + "/trace.npz", timeout=5).read()
    tr = Trace.load(io.BytesIO(data))
    assert tr.num_steps > 0 and tr.batches.shape[1:] == (4, 8)
    jcfg = JaxConfig(**KW).validate()
    step = jax_make_step(jcfg)
    s = jax_init(jcfg)
    n = min(tr.num_steps, 4)
    for t in range(n):
        s = step(s, jnp.float32(tr.dts[t]), jnp.asarray(tr.batches[t]))
    assert bool(jnp.isfinite(s.dye).all())


def test_jax_checkpoint_resumes_a_port_server(tmp_path):
    """JAX's FluidServer.checkpoint_bytes (its /checkpoint.npz) after a few
    JAX steps and pending tracer state resumes a port server: the fields bit
    for bit, the config, the step count and the tracer state; the resumed
    port server's ticks then run."""
    jcfg = JaxConfig(**KW).validate()
    js = jserver.FluidServer(jcfg, seed=4)
    trace_steps = jax_make_step(jcfg)
    s = jax_init(jcfg)
    batch = np.zeros((4, 8), np.float32)
    batch[0] = [0.4, 0.5, 300.0, -200.0, 1.0, 0.5, 0.2, 1.0]
    for _ in range(3):
        s = trace_steps(s, jnp.float32(1 / 60), jnp.asarray(batch))
    js.state = s
    js.steps_done = 3
    js.tracer.feed("down", pid=2, x=40.0, y=30.0)
    js.tracer.feed("burst", n=9)
    js.tracer.drain_step(1 / 60)   # leaves a spill behind
    p = tmp_path / "jax_session.npz"
    p.write_bytes(js.checkpoint_bytes())

    resumed = FluidServer(CFG, seed=0, resume=str(p), device="cpu")
    assert resumed.steps_done == 3
    assert dataclasses.asdict(resumed.config) == dataclasses.asdict(jcfg)
    assert json.dumps(resumed.tracer.state_dict()) == json.dumps(js.tracer.state_dict())
    for g, w in zip(state_to_numpy(resumed._resume_state), (s.velocity, s.dye, s.pressure)):
        np.testing.assert_array_equal(g, np.asarray(w))
    resumed.state, resumed._resume_state = resumed._resume_state, None
    frame = resumed.advance(1 / 60)
    assert frame.shape == (64, 96, 3) and resumed.recorded[-1][:, 7].sum() > 0
