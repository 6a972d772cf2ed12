"""Interactive browser demo, counterpart of ``tpufluid.server``: the
reference's index.html experience, served by the simulator on the GPU.

The reference is a browser app: mouse/touch drags splat dye, space queues a
random burst, P pauses, and a control panel tunes the config. This module
reproduces that loop headlessly: a background thread runs one tick a frame
(``FluidServer.advance``: the pending pointer events drained into a splat
batch, then make_step_and_render's step and uint8 frame, 8 kernel launches
at the defaults) and JPEG-encodes the frame; a small HTTP server streams
frames to a canvas page that posts pointer, keyboard and panel events back
into the pointer state machine of trace replay (``PointerTracer``), so an
interactive session can be recorded and replayed deterministically, with
the per-frame wall-clock dt.

The page carries the reference's control panel: quality and sim resolution,
dissipation, pressure, vorticity and splat radius, shading and colorful,
Bloom and Sunrays, background color and transparency, the storage dtype,
"Random splats", pause, and "Take screenshot" (a server-side capture ->
fluid.png). /checkpoint.npz downloads the session (fields, config, step,
tracer state) in the format of ``tpufluid.checkpoint``, which --resume (or
either package's server) resumes; /trace.npz exports it as a Trace v2.

Run (on the GPU; TPUFLUID_DEVICE=cpu runs the plain versions on the CPU):
  python -m tpufluid_torch.server --port 8000 --sim-res 128 --dye-res 512
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tpufluid_torch.checkpoint import load_state, save_state
from tpufluid_torch.config import FluidConfig
from tpufluid_torch.io import frame_to_uint8
from tpufluid_torch.ops.splat import SPLAT_COLS
from tpufluid_torch.render import capture_frame, load_dither_tensor, make_render, \
    make_step_and_render
from tpufluid_torch.state import FluidState, device_from_env, init_state, resize_state, \
    resolve_device
from tpufluid_torch.trace import PointerTracer

_PAGE = """<!DOCTYPE html>
<html><head><title>tpufluid</title><style>
html,body{margin:0;background:#000;height:100%;overflow:hidden;font:12px monospace}
img{width:100vw;height:100vh;object-fit:fill;cursor:crosshair;-webkit-user-drag:none;user-select:none}
#hud{position:fixed;top:8px;left:8px;color:#8f8;background:rgba(0,0,0,.5);padding:4px 8px}
#panel{position:fixed;top:8px;right:8px;width:240px;background:rgba(16,16,16,.88);color:#eee;
 padding:8px;border-radius:4px;max-height:95vh;overflow-y:auto}
#panel h4{margin:6px 0 2px;color:#7cf;border-bottom:1px solid #333;cursor:pointer}
#panel label{display:flex;justify-content:space-between;align-items:center;margin:3px 0}
#panel input[type=range]{width:120px}
#panel select{width:126px;background:#222;color:#eee;border:1px solid #444}
#panel button{width:100%;margin:3px 0;background:#234;color:#eee;border:1px solid #456;
 padding:4px;cursor:pointer;border-radius:3px}
#panel .val{color:#8f8;min-width:34px;text-align:right}
</style></head><body>
<img id="view" draggable="false"><div id="hud">tpufluid</div>
<div id="panel"></div>
<script>
const img = document.getElementById('view');
const hud = document.getElementById('hud');
let events = [];
function post() {
  if (events.length) {
    fetch('/events', {method: 'POST', body: JSON.stringify(events)});
    events = [];
  }
}
function setCfg(k, v) {
  const body = {}; body[k] = v;
  return fetch('/config', {method: 'POST', body: JSON.stringify(body)});
}
function xy(e) {
  const r = img.getBoundingClientRect();
  return [(e.clientX - r.left) / r.width, (e.clientY - r.top) / r.height];
}
let down = false;
img.addEventListener('mousedown', e => { down = true; const [x,y]=xy(e); events.push({k:'down',x,y}); post(); });
img.addEventListener('mousemove', e => { if(!down) return; const [x,y]=xy(e); events.push({k:'move',x,y}); });
window.addEventListener('mouseup', () => { down = false; events.push({k:'up'}); post(); });
img.addEventListener('touchstart', e => { e.preventDefault();
  for (const t of e.changedTouches) { const r = img.getBoundingClientRect();
    events.push({k:'down', id:t.identifier, x:(t.clientX-r.left)/r.width, y:(t.clientY-r.top)/r.height}); } post(); }, {passive:false});
img.addEventListener('touchmove', e => { e.preventDefault();
  for (const t of e.changedTouches) { const r = img.getBoundingClientRect();
    events.push({k:'move', id:t.identifier, x:(t.clientX-r.left)/r.width, y:(t.clientY-r.top)/r.height}); } }, {passive:false});
window.addEventListener('touchend', e => {
  for (const t of e.changedTouches) events.push({k:'up', id:t.identifier}); post(); });
window.addEventListener('keydown', e => {
  if (e.code === 'KeyP') events.push({k:'pause'});
  if (e.key === ' ') events.push({k:'burst'});
  post();
});
setInterval(post, 33);

// ---- control panel (the dat.GUI analog, script.js:208-281) ----
const panel = document.getElementById('panel');
function folder(name, open=true) {
  const h = document.createElement('h4'); h.textContent = name;
  const box = document.createElement('div');
  if (!open) box.style.display = 'none';
  h.onclick = () => box.style.display = box.style.display === 'none' ? '' : 'none';
  panel.appendChild(h); panel.appendChild(box);
  return box;
}
function slider(box, label, key, min, max, step, value) {
  const l = document.createElement('label');
  l.innerHTML = label + ' <input type="range" min="'+min+'" max="'+max+'" step="'+step+
    '" value="'+value+'"><span class="val">'+value+'</span>';
  const inp = l.querySelector('input'), val = l.querySelector('.val');
  inp.oninput = () => val.textContent = inp.value;
  inp.onchange = () => setCfg(key, parseFloat(inp.value));
  box.appendChild(l);
}
function toggle(box, label, key, value, fn) {
  const l = document.createElement('label');
  l.innerHTML = label + ' <input type="checkbox"' + (value ? ' checked' : '') + '>';
  const inp = l.querySelector('input');
  inp.onchange = () => fn ? fn(inp.checked) : setCfg(key, inp.checked);
  box.appendChild(l);
}
function dropdown(box, label, key, options, value, str) {
  const l = document.createElement('label');
  l.innerHTML = label + ' <select>' + options.map(o =>
    '<option value="'+o[1]+'"'+(o[1]===value?' selected':'')+'>'+o[0]+'</option>').join('') + '</select>';
  l.querySelector('select').onchange = e => setCfg(key, str ? e.target.value : parseInt(e.target.value));
  box.appendChild(l);
}
function button(box, label, fn) {
  const b = document.createElement('button'); b.textContent = label; b.onclick = fn;
  box.appendChild(b);
}
fetch('/config').then(r => r.json()).then(cfg => {
  const main = folder('tpufluid');
  dropdown(main, 'quality', 'DYE_RESOLUTION',
    [['high',1024],['medium',512],['low',256],['very low',128]], cfg.DYE_RESOLUTION);
  dropdown(main, 'sim resolution', 'SIM_RESOLUTION',
    [['32',32],['64',64],['128',128],['256',256]], cfg.SIM_RESOLUTION);
  slider(main, 'density diffusion', 'DENSITY_DISSIPATION', 0, 4, 0.01, cfg.DENSITY_DISSIPATION);
  slider(main, 'velocity diffusion', 'VELOCITY_DISSIPATION', 0, 4, 0.01, cfg.VELOCITY_DISSIPATION);
  slider(main, 'pressure', 'PRESSURE', 0, 1, 0.01, cfg.PRESSURE);
  slider(main, 'vorticity', 'CURL', 0, 50, 1, cfg.CURL);
  slider(main, 'splat radius', 'SPLAT_RADIUS', 0.01, 1, 0.01, cfg.SPLAT_RADIUS);
  toggle(main, 'shading', 'SHADING', cfg.SHADING);
  toggle(main, 'colorful', 'COLORFUL', cfg.COLORFUL);
  toggle(main, 'paused', null, false, v => { events.push({k:'pause', v:v}); post(); });
  button(main, 'Random splats', () => { events.push({k:'burst'}); post(); });
  const bloom = folder('Bloom');
  toggle(bloom, 'enabled', 'BLOOM', cfg.BLOOM);
  slider(bloom, 'intensity', 'BLOOM_INTENSITY', 0.1, 2, 0.01, cfg.BLOOM_INTENSITY);
  slider(bloom, 'threshold', 'BLOOM_THRESHOLD', 0, 1, 0.01, cfg.BLOOM_THRESHOLD);
  const rays = folder('Sunrays');
  toggle(rays, 'enabled', 'SUNRAYS', cfg.SUNRAYS);
  slider(rays, 'weight', 'SUNRAYS_WEIGHT', 0.3, 1, 0.01, cfg.SUNRAYS_WEIGHT);
  // Storage knobs (no dat.GUI counterpart: the reference's half-float
  // format is fixed at startup; here dtype + packed-dye are live-switchable).
  const st = folder('Storage', false);
  dropdown(st, 'dtype', 'DTYPE',
    [['float32','float32'],['bfloat16','bfloat16'],['float16','float16']], cfg.DTYPE, true);
  toggle(st, 'rgb9e5 dye (bf16)', 'DYE_RGB9E5', cfg.DYE_RGB9E5);
  const cap = folder('Capture');
  const l = document.createElement('label');
  l.innerHTML = 'background <input type="color" value="#000000">';
  l.querySelector('input').onchange = e => {
    const v = e.target.value;
    setCfg('BACK_COLOR', [parseInt(v.slice(1,3),16), parseInt(v.slice(3,5),16), parseInt(v.slice(5,7),16)]);
  };
  cap.appendChild(l);
  toggle(cap, 'transparent', 'TRANSPARENT', cfg.TRANSPARENT);
  button(cap, 'Take screenshot', () => {
    const a = document.createElement('a');
    a.href = '/screenshot?' + Date.now(); a.download = 'fluid.png'; a.click();
  });
});

// ---- live canvas resize (reference resizeCanvas, script.js:1178-1179,
// 1196-1205: on size change, FBOs re-init with the fields GPU-resampled).
// The sim canvas tracks the window proportionally (the streaming-bandwidth
// analog of devicePixelRatio scaling); debounced so a drag-resize lands as
// one reconfigure, which runs resize_state live on the server.
let baseW = window.innerWidth, baseH = window.innerHeight, rsTimer = null;
window.addEventListener('resize', () => {
  clearTimeout(rsTimer);
  rsTimer = setTimeout(() => {
    const sw = window.innerWidth / baseW, sh = window.innerHeight / baseH;
    if (Math.abs(sw - 1) < 0.02 && Math.abs(sh - 1) < 0.02) return;
    fetch('/config').then(r => r.json()).then(cfg => {
      const w = Math.max(64, Math.round(cfg.CANVAS_WIDTH * sw));
      const h = Math.max(64, Math.round(cfg.CANVAS_HEIGHT * sh));
      baseW = window.innerWidth; baseH = window.innerHeight;
      fetch('/config', {method: 'POST',
        body: JSON.stringify({CANVAS_WIDTH: w, CANVAS_HEIGHT: h})});
    });
  }, 250);
});

let frames = 0, t0 = performance.now();
function tick() {
  const next = new Image();
  next.onload = () => {
    img.src = next.src; frames++;
    const dt = performance.now() - t0;
    if (dt > 1000) { hud.textContent = 'tpufluid  ' + (frames*1000/dt).toFixed(0) + ' fps'; frames = 0; t0 = performance.now(); }
    requestAnimationFrame(tick);
  };
  next.onerror = () => setTimeout(tick, 200);
  next.src = '/frame?' + Date.now();
}
tick();
</script></body></html>"""

# The dt clamp of the reference's calcDeltaTime: its literal 0.016666, not
# 1/60; equal to config.MAX_DT, as tpufluid.server's. Also the sim loop's
# pacing, about 60 frames a second.
MAX_DT = 0.016666


class FluidServer:
    """Owns the sim loop; a thread-safe event queue and the latest JPEG frame.

    Backpressure: clients can never stop the sim loop. Handlers that need
    the sim lock wait for it at most EVENT_LOCK_TIMEOUT_S and fail fast
    (503) if a slow tick, such as a live reconfigure, holds it; at most
    MAX_INFLIGHT_EVENTS event posts may wait on the lock at once (more
    503 at once instead of stacking handler threads); and every connection
    carries a socket timeout (make_handler), so a stalled client wedges only
    its own connection. /frame and /stats read under ``out_lock``, which
    guards only attribute swaps, never a tick.

    On a CUDA device the constructor builds the kernels (ops/cuda/build.py)
    before any tick, so the first tick does not hold the sim lock for the
    minutes of an nvcc build; a build that fails raises here."""

    # Bounded wait for the sim lock in client-facing paths: longer than
    # any healthy tick's hold (ms), far shorter than a kernel build.
    EVENT_LOCK_TIMEOUT_S = 2.0
    # Concurrent /events posts allowed to wait on the lock; beyond this
    # the handler answers 503 instead of growing a thread pile.
    MAX_INFLIGHT_EVENTS = 32

    def __init__(self, config: FluidConfig, seed: int = 0, quality: int = 80,
                 resume: Optional[str] = None, dither_path: Optional[str] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from tpufluid_torch.ops.cuda import build

            build.build()
        self.state: Optional[FluidState] = None
        self._resume_state = None
        self.steps_done = 0
        extra = {}
        if resume:
            # Deterministic resume: the checkpoint carries the fields and
            # the tracer's session state (RNG cursors, pointers, bursts).
            self._resume_state, config, self.steps_done, extra = load_state(
                resume, device=self.device)
        self.config = config
        self.tracer = PointerTracer(config, seed=seed)
        if "tracer" in extra:
            self.tracer.load_state_dict(extra["tracer"])
        # An external dither texture (the reference's LDR_LLL1_0.png analog),
        # read once: the tick reads its own copy, the screenshot this one.
        self.dither_path = dither_path
        self._dither = load_dither_tensor(dither_path, self.device)
        self.tick = make_step_and_render(config, dither_path=dither_path, device=self.device)
        self.render = make_render(config, device=self.device)
        self.quality = quality
        self.paused = False
        self.lock = threading.Lock()
        # The sim thread holds self.lock for the whole tick; /frame and
        # /stats read under this one, which guards only attribute swaps.
        self.out_lock = threading.Lock()
        self.frame_bytes: Optional[bytes] = None
        # Per-step splat batches and wall dts for the Trace v2 export,
        # capped at about 10 minutes of session.
        self.recorded = []
        self.recorded_dts = []
        self.max_recorded = 36000
        self._mobile_applied = False
        self._stop = threading.Event()
        self._event_slots = threading.BoundedSemaphore(self.MAX_INFLIGHT_EVENTS)

    def _acquire_or_503(self):
        """Bounded sim-lock acquire for client-facing paths; raises
        TimeoutError (a 503 in the handlers) when a slow tick holds the
        lock past the bound."""
        if not self.lock.acquire(timeout=self.EVENT_LOCK_TIMEOUT_S):
            raise TimeoutError(
                f"sim lock not acquired within {self.EVENT_LOCK_TIMEOUT_S}s "
                f"(tick or reconfigure in progress)")

    def maybe_mobile_downgrade(self, user_agent: Optional[str]) -> bool:
        """Apply the mobile preset when a mobile client loads the page, as
        the reference drops DYE_RESOLUTION to 512 on a mobile browser
        (/Mobi|Android/i): at most once a session, and only downward."""
        if self._mobile_applied or not re.search(r"Mobi|Android", user_agent or "", re.I):
            return False
        if self.config.DYE_RESOLUTION > 512:
            try:
                self.reconfigure({"DYE_RESOLUTION": 512})
            except TimeoutError:
                # Sim lock busy past the bound: serve the page anyway and
                # leave the downgrade armed for the next mobile page load.
                return False
        self._mobile_applied = True
        return True

    def reconfigure(self, updates: dict) -> dict:
        """Live config change, the reference's panel behaviour: resolution
        changes resample the fields (resize_state: velocity and dye
        resampled, pressure restarted; a dtype change casts), toggles
        rebuild the step and render. Returns the new config as a dict."""
        self._acquire_or_503()
        try:
            cfg = dataclasses.replace(self.config, **updates).validate()
            new_tick = make_step_and_render(cfg, dither_path=self.dither_path,
                                            device=self.device)
            new_render = make_render(cfg, device=self.device)
            if self.state is not None:
                self.state = resize_state(self.state, cfg)
            if cfg.MAX_SPLATS != self.config.MAX_SPLATS:
                self.recorded = []  # trace batches are shape-homogeneous
                self.recorded_dts = []
            self.config = cfg
            self.tracer.config = cfg
            self.tick = new_tick
            self.render = new_render
            return dataclasses.asdict(cfg)
        finally:
            self.lock.release()

    def handle_events(self, events) -> None:
        """Feed the page's events to the tracer; raises TimeoutError (a 503)
        when the event queue is full or the lock wait runs out."""
        if not self._event_slots.acquire(blocking=False):
            raise TimeoutError(f"more than {self.MAX_INFLIGHT_EVENTS} event posts queued")
        try:
            self._acquire_or_503()
            try:
                w, h = self.config.CANVAS_WIDTH, self.config.CANVAS_HEIGHT
                for e in events:
                    k = e.get("k")
                    pid = int(e.get("id", 0))  # multitouch: one pointer per id
                    if k == "down":
                        self.tracer.feed("down", pid=pid, x=e["x"] * w, y=e["y"] * h)
                    elif k == "move":
                        self.tracer.feed("move", pid=pid, x=e["x"] * w, y=e["y"] * h)
                    elif k == "up":
                        self.tracer.feed("up", pid=pid)
                    elif k == "burst":
                        self.tracer.feed("burst",
                                         n=int(np.random.default_rng().integers(5, 25)))
                    elif k == "pause":
                        # absolute from the panel's checkbox, a toggle from 'P'
                        self.paused = bool(e["v"]) if "v" in e else not self.paused
            finally:
                self.lock.release()
        finally:
            self._event_slots.release()

    def screenshot_png(self) -> Optional[bytes]:
        """Server-side captureScreenshot -> PNG bytes, or None before the
        sim thread made its first state. The capture renders and reaches
        the host under the lock; the PNG encodes outside it."""
        from PIL import Image

        self._acquire_or_503()
        try:
            if self.state is None:
                return None
            frame = capture_frame(self.state, self.config, dither=self._dither).cpu().numpy()
        finally:
            self.lock.release()
        arr = frame_to_uint8(frame)
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(arr),
                        "RGBA" if arr.shape[-1] == 4 else "RGB").save(buf, "PNG")
        return buf.getvalue()

    def checkpoint_bytes(self) -> Optional[bytes]:
        """The whole session as .npz: fields, config, step count and tracer
        state, resumable with FluidServer(resume=path)."""
        self._acquire_or_503()
        try:
            if self.state is None:
                return None
            step = self.steps_done
            tracer_state = self.tracer.state_dict()
            config = self.config
            # Only a device copy under the lock, so no later tick can touch
            # the snapshot; the copy to the host and the deflate run outside.
            s = self.state
            state = FluidState(s.velocity.clone(), s.dye.clone(), s.pressure.clone())
        finally:
            self.lock.release()
        buf = io.BytesIO()
        save_state(buf, state, config, step=step, extra={"tracer": tracer_state})
        return buf.getvalue()

    def advance(self, dt_wall: float) -> np.ndarray:
        """One tick of the sim loop, under the sim lock: the tracer's events
        for ``dt_wall`` into a splat batch (recorded for /trace.npz), then a
        step and its frame, or only the frame while paused. Returns the
        (h, w, 3) uint8 frame on the host: its copy there, under the lock,
        is where the tick waits for the device."""
        with self.lock:
            events = self.tracer.drain_step(dt_wall)
            max_s = self.config.MAX_SPLATS
            batch = np.zeros((max_s, SPLAT_COLS), np.float32)
            for i, (x, y, dx, dy, color) in enumerate(events[:max_s]):
                batch[i] = [x, y, dx, dy, color[0], color[1], color[2], 1.0]
            if len(self.recorded) < self.max_recorded:
                self.recorded.append(batch)
                self.recorded_dts.append(dt_wall)
            if self.paused:
                return frame_to_uint8(self.render(self.state, self._dither))[..., :3]
            self.state, rgb = self.tick(self.state, dt_wall, batch)
            return rgb.cpu().numpy()

    def encode(self, frame: np.ndarray) -> bytes:
        """The frame as JPEG bytes at the server's quality."""
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(frame), "RGB").save(buf, "JPEG",
                                                                 quality=self.quality)
        return buf.getvalue()

    def run(self):
        """The sim loop: a tick, its JPEG (encoded outside the sim lock),
        published under out_lock, paced at the reference's 60 Hz."""
        if self._resume_state is not None:
            self.state = self._resume_state
            self._resume_state = None
        else:
            self.state = init_state(self.config, device=self.device)
            # an initial random burst, like the reference's startup
            with self.lock:
                self.tracer.splat_stack.append(int(np.random.default_rng().integers(5, 25)))

        last = time.time()
        while not self._stop.is_set():
            t_frame = time.time()
            # dt from wall time each frame, clamped (the reference's calcDeltaTime)
            dt_wall = min(t_frame - last, MAX_DT)
            last = t_frame
            data = self.encode(self.advance(dt_wall))
            with self.out_lock:
                self.frame_bytes = data
                self.steps_done += 1
            left = MAX_DT - (time.time() - t_frame)
            if left > 0:
                time.sleep(left)

    def stop(self):
        self._stop.set()


def make_handler(server: FluidServer):
    class Handler(BaseHTTPRequestHandler):
        # A socket timeout on every connection, for reads and writes: a
        # stalled client (a half-sent request, a receiver that never
        # drains) times out and frees its handler thread.
        timeout = 15

        def log_message(self, *a):  # quiet
            pass

        def handle_one_request(self):
            # A frame client that navigates away mid-write is routine.
            try:
                super().handle_one_request()
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _send(self, data: bytes, ctype: str, extra=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_or_503(self, data, ctype: str, extra=()):
            """503 for a resource not ready (before the first tick) or a
            lock wait that ran out."""
            if data is None:
                self.send_response(503)
                self.end_headers()
                return
            self._send(data, ctype, extra)

        def do_GET(self):
            if self.path in ("/", "") or self.path.startswith("/?"):
                # Page load: the mobile downgrade before the panel fetches /config.
                server.maybe_mobile_downgrade(self.headers.get("User-Agent"))
                self._send(_PAGE.encode(), "text/html")
            elif self.path.startswith("/frame"):
                with server.out_lock:
                    data = server.frame_bytes
                self._send_or_503(data, "image/jpeg")
            elif self.path.startswith("/screenshot"):
                try:
                    data = server.screenshot_png()
                except TimeoutError:
                    data = None
                self._send_or_503(data, "image/png",
                                  [("Content-Disposition", "attachment; filename=fluid.png")])
            elif self.path.startswith("/checkpoint.npz"):
                try:
                    data = server.checkpoint_bytes()
                except TimeoutError:
                    data = None
                self._send_or_503(data, "application/octet-stream",
                                  [("Content-Disposition",
                                    "attachment; filename=fluid_session.npz")])
            elif self.path.startswith("/trace.npz"):
                # The session as a deterministic replay trace (Trace v2:
                # per-step wall dt).
                try:
                    server._acquire_or_503()
                except TimeoutError:
                    self._send_or_503(None, "application/octet-stream")
                    return
                try:
                    batches = np.stack(server.recorded) if server.recorded else \
                        np.zeros((0, server.config.MAX_SPLATS, SPLAT_COLS), np.float32)
                    dts = np.asarray(server.recorded_dts, np.float32)
                finally:
                    server.lock.release()
                buf = io.BytesIO()
                np.savez_compressed(buf, batches=batches, dts=dts, version=np.int32(2))
                self._send(buf.getvalue(), "application/octet-stream")
            elif self.path.startswith("/config"):
                try:
                    server._acquire_or_503()
                except TimeoutError:
                    self._send_or_503(None, "application/json")
                    return
                try:
                    body = json.dumps(dataclasses.asdict(server.config)).encode()
                finally:
                    server.lock.release()
                self._send(body, "application/json")
            elif self.path.startswith("/stats"):
                with server.out_lock:
                    out = {"steps": server.steps_done, "paused": server.paused}
                self._send(json.dumps(out).encode(), "application/json")
            else:
                self._send(_PAGE.encode(), "text/html")

        def do_POST(self):
            if self.path.startswith("/events"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    events = json.loads(self.rfile.read(n) or b"[]")
                    server.handle_events(events)
                    self.send_response(204)
                except TimeoutError:
                    # Backpressure, not a client error.
                    self.send_response(503)
                except Exception:
                    self.send_response(400)
                self.end_headers()
            elif self.path.startswith("/config"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    updates = json.loads(self.rfile.read(n) or b"{}")
                    if "BACK_COLOR" in updates:  # JSON gives a list
                        updates["BACK_COLOR"] = tuple(updates["BACK_COLOR"])
                    body = json.dumps(server.reconfigure(updates)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                except TimeoutError:
                    self.send_response(503)
                    self.end_headers()
                except (TypeError, ValueError) as e:
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpufluid_torch.server", description=__doc__)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--sim-res", type=int, default=128)
    p.add_argument("--dye-res", type=int, default=512)
    p.add_argument("--canvas", type=str, default="640x360")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-bloom", action="store_true")
    p.add_argument("--no-sunrays", action="store_true")
    p.add_argument("--resume", type=str, default=None,
                   help="resume an interactive session from a /checkpoint.npz "
                        "download (fields + config + tracer RNG cursors)")
    p.add_argument("--dither", type=str, default=None,
                   help="external dither texture PNG (R channel, tiled at the "
                        "reference's ditherScale like its LDR_LLL1_0.png)")
    return p


def config_from_args(args: argparse.Namespace) -> FluidConfig:
    """The session's config from build_argparser's options."""
    cw, ch = (int(x) for x in args.canvas.split("x"))
    return FluidConfig(SIM_RESOLUTION=args.sim_res, DYE_RESOLUTION=args.dye_res,
                       CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch,
                       BLOOM=not args.no_bloom, SUNRAYS=not args.no_sunrays).validate()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = device_from_env()
    config = config_from_args(args)
    server = FluidServer(config, seed=args.seed, resume=args.resume,
                         dither_path=args.dither, device=device)
    sim_thread = threading.Thread(target=server.run, daemon=True)
    sim_thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(server))
    print(f"tpufluid_torch interactive demo on {device} at http://127.0.0.1:{args.port}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        sim_thread.join(timeout=10)
        httpd.server_close()


if __name__ == "__main__":
    main()
