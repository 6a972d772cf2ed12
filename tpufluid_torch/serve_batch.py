"""Multi-tenant interactive serving: N sessions on one GPU, one batched tick
a frame.

Counterpart of tpufluid/serve_batch.py. The single-session server
(tpufluid_torch/server.py) runs one sim and one canvas. This module
multiplexes many interactive users onto one card, on top of
tpufluid_torch/batch.py: every frame, all sessions' pointer events drain
into one (B, MAX_SPLATS, 8) splat tensor, and one batched step and one
batched frame advance and render every session (each sim equal to the
single-sim make_step_and_render on it alone, bit for bit). A tick is the
step's 5 launches (at 20 Jacobi sweeps) and the frame's 2, whatever B is.

Each session has its own clock RATE: a per-session ``speed`` multiplier
scales the shared wall dt. Below 1 it is slow motion. Above 1 it is
FAST-FORWARD by masked substepping: every individual step's dt stays at
the reference's 1/60 ceiling (script.js:1191, also the kernels'
displacement contract), and the batched tick takes the resulting (B,) or
(K, B) per-sim dts as one dt table copied to the card a tick. With every
speed at 1.0 the server passes a scalar dt instead: lock-step, ONE shared
clock like the reference's single requestAnimationFrame (script.js:
1182-1194), with no dt copy at all.

Latency design (the reference's bar is that every input is served within
one 16.7 ms frame, script.js:1185,1219-1229):

- **Programs per (padded batch, kind).** JAX compiles one executable per
  shape in a background thread, so that no compile runs under a lock. The
  port has nothing to compile per shape: a program (make_tick_program) is
  a callable that checks the shapes of its arguments and runs the batched
  body. The reconciler thread, its program table keyed by (pb, kind), its
  terminal failures and /stats keep JAX's structure, so the serving logic
  and its tests carry over unchanged. The CUDA kernels are built once, in
  the server's constructor, before any lock exists.
- **Batch shapes are padded to powers of two** (``_padded``): pad rows are
  exactly inert (a zero state with zero splats stays zero through the
  step's kernels in float32, bfloat16 with RGB9E5 and float16), and most
  fleet resizes change no shape at all.
- **Resize is two-phase and non-blocking**: POST /sessions applies the
  bookkeeping (sessions, tracers, speeds) in milliseconds and returns; the
  reconciler zeroes evicted rows (privacy: a shrink's tenants must not
  leak into later grows), swaps the state tensor to a new padded size at a
  tick boundary, on the device, and only then activates the new rows.
  Until activation the new sids' frames 503; events to them queue in their
  tracers and land on the first activated tick.
- **The host sets the pace.** A tick is ~400 PyTorch launches from Python
  under ``state_lock``; its frames are copied to the host (the sync point)
  outside every lock.

Session isolation is structural: the kernels run each sim of a batch on its
own, and the plain versions run a CPU batch sim by sim. JPEG encoding is
lazy (per session, cached per step), so B sessions cost one batched tick
plus encodes only for the frames actually polled.

Endpoints (sid = session id, 0..B-1):
  GET  /            dashboard page: a grid of all sessions' live frames
  GET  /frame?sid=N latest JPEG for session N (X-Step header = sim step);
                    404 for a retired sid, 503 for a pending one
  GET  /stats       {"steps", "sessions", "paused", "speeds", "substeps",
                    "live_rows", "padded_batch", "programs", "stuck", ...}
  GET  /checkpoint.npz  whole-fleet checkpoint (batched state + config +
                        per-session speeds and tracers), in the format of
                        either package's checkpoint; resume with --resume
  POST /sessions     {"n": N}: elastic fleet resize (204; 400 for a size
                     outside [1, MAX_SESSIONS] or not an integer). Growth
                     appends fresh zeroed tenants at the new high sids,
                     each with a startup burst; shrink drops the high sids
  POST /events?sid=N  the single-session server's JSON events
                      (down/move/up/burst/pause; pause is global), plus
                      {"k": "speed", "v": S}: session N's clock rate, S
                      clamped to [0, SPEED_MAX]; 204, or 400 for a bad sid
                      or a non-finite speed. S = 0 freezes the session's
                      time while its splats still land; S > 1 splits its
                      time advance into ceil(S) substeps of <= 1/60 each,
                      run as masked rows of one K-substep tick
                      (make_substepped_tick; /stats "substeps")

Geometry and config are uniform across sessions by construction (one batch);
per-tenant quality knobs belong on separate server processes.

Run (on the GPU; TPUFLUID_DEVICE=cpu runs the plain versions on the CPU):
  python -m tpufluid_torch.serve_batch --port 8001 --sessions 4
"""

from __future__ import annotations

import io
import json
import math
import threading
import time
import traceback
from functools import lru_cache
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tpufluid_torch.batch import (_host, _require_batch, _split, _table, check_batch_shards,
                                  init_batch, step_dt)
from tpufluid_torch.checkpoint import load_state, save_state
from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.ops.splat import SPLAT_COLS
from tpufluid_torch import spans
from tpufluid_torch.render import _quantize, frame_u8, plain_render
from tpufluid_torch.state import FluidState, device_from_env, resolve_device, state_bytes
from tpufluid_torch.step import _step
from tpufluid_torch.spans import span
from tpufluid_torch.trace import PointerTracer

# The reference's calcDeltaTime clamp, its literal 0.016666 (script.js:1191);
# equal to config.MAX_DT. Also the sim loop's pacing.
MAX_DT = 0.016666

# Per-session clock-rate ceiling. Speeds in (1, SPEED_MAX] are fast-forward:
# ceil(speed) masked substeps a frame, each substep's dt still <= MAX_DT. The
# cap bounds the per-frame compute an unauthenticated knob can demand and
# the program table (at most ceil(SPEED_MAX) - 1 substep programs a padded
# batch size).
SPEED_MAX = 4.0
_K_MAX = math.ceil(SPEED_MAX)

_FIELDS = ("velocity", "dye", "pressure")


# Spans serve_batch --spans keeps: ~25 a tick, so the last ~650 ticks.
SPAN_RING = 1 << 14


def _padded(n: int) -> int:
    """Smallest power of two >= n: the only batch sizes a server runs.

    Pad rows are exactly inert: a zero state with zero splats stays zero
    through the step at any dt (advection, projection and dissipation of
    the zero field are zero; the vorticity normalizer is eps-guarded; RGB9E5
    of 0 is 0; the warm start of 0 is 0), so a fleet of S sessions runs
    correctly inside any padded B >= S."""
    return 1 << max(0, (n - 1)).bit_length()


def _frame(state: FluidState, config: FluidConfig, plain: bool) -> torch.Tensor:
    if plain:
        return _quantize(plain_render(state, config))
    return frame_u8(state, config)


def _batched_tick_body(config: FluidConfig, plain: bool = False):
    """tick(batched_state, dt, splats) -> (batched_state, (B, h, w, 3)
    uint8): a batched step, ``dt`` a scalar (the server's one clock) or (B,)
    per sim, then the batched frame quantized and flipped on the state's
    device, as tick_body for one sim. ``plain`` runs the kernels' plain
    versions on any device (the reference the kernels are held to)."""
    passes = dispatch.PLAIN if plain else dispatch.ROUTED

    def tick(state: FluidState, dt, splats):
        b = state.velocity.shape[0]
        state = _step(state, step_dt(dt, b, config, state.velocity.device), splats, config,
                      passes)
        return state, _frame(state, config, plain)

    return tick


def make_batched_tick(config: FluidConfig, device="cuda"):
    """tick(batched_state, dt, splats) -> (batched_state, (B, h, w, 3)
    uint8 frames) on ``device`` (default the GPU): the kernels on the card,
    their plain versions on the CPU. ``splats`` is (B, MAX_SPLATS, 8)."""
    device = resolve_device(device)
    body = _batched_tick_body(config)

    def tick(state: FluidState, dt, splats):
        _require_batch(state, device)
        return body(state, dt, splats)

    return tick


def _select(active: torch.Tensor, new: FluidState, old: FluidState) -> FluidState:
    """Each sim's fields from ``new`` where its ``active`` entry is set, else
    from ``old``, bit for bit: a select, never a multiplication."""
    def sel(n, o):
        return torch.where(active.view((-1,) + (1,) * (n.ndim - 1)), n, o)

    with span("select"):
        return FluidState(*(sel(getattr(new, f), getattr(old, f)) for f in _FIELDS))


def _substepped_body(config: FluidConfig, plain: bool = False):
    """The K-substep body (make_substepped_tick's contract), shared by
    make_substepped_tick and the K-substep programs of make_tick_program.

    Substep 0 always runs, with the splats; substeps 1..K-1 run with zero
    splats and keep a sim's old fields wherever its dt entry is 0. A dt = 0
    step is not the identity (the projection still runs), so a zero row is
    a select after the step, never a step. The (K, B) dts go to the card as
    one dt table a tick, indexed per substep."""
    passes = dispatch.PLAIN if plain else dispatch.ROUTED

    def tick(state: FluidState, dts, splats):
        device = state.velocity.device
        a = _host(dts)
        b = state.velocity.shape[0]
        if a.ndim != 2 or a.shape[1] != b or a.shape[0] < 1:
            raise ValueError(f"substep dts of shape {a.shape}, expected (K, {b})")
        table = _table(a, config, device)        # (K, 2, B, 2): one copy a tick
        with span("upload"):
            splats = torch.as_tensor(splats, dtype=torch.float32, device=device)
        state = _step(state, table[0], splats, config, passes)
        if a.shape[0] > 1:
            zero_splats = torch.zeros_like(splats)
            for k in range(1, a.shape[0]):
                stepped = _step(state, table[k], zero_splats, config, passes)
                # table[k, 0, :, 0] is min(dt, MAX_DT): > 0 exactly where dt > 0
                state = _select(table[k, 0, :, 0] > 0.0, stepped, state)
        return state, _frame(state, config, plain)

    return tick


def make_substepped_tick(config: FluidConfig, device="cuda"):
    """Fast-forward tick: K masked substeps and ONE frame, on ``device``
    (default the GPU).

    tick(batched_state, dts, splats) -> (batched_state, (B, h, w, 3) uint8).
    ``dts`` is (K, B): sim b advances ``sum(dts[:, b])`` this frame, split by
    the serving loop into equal substeps each <= 1/60, so the reference's dt
    ceiling (script.js:1191) holds per SUBSTEP. Substep 0 always runs
    (splats land even at dt = 0: the frozen-fluid speed-0 semantics);
    substeps 1..K-1 are exact no-ops for sims whose dt entry is 0. Each sim
    with n equal substeps equals n calls of make_step_and_render at that
    dt, state and frame, bit for bit. A K-substep tick makes the step's 5
    launches K times and the frame's 2 once."""
    device = resolve_device(device)
    body = _substepped_body(config)

    def tick(state: FluidState, dts, splats):
        _require_batch(state, device)
        return body(state, dts, splats)

    return tick


def make_batch_sharded_substepped_tick(config: FluidConfig, mesh):
    """Fast-forward serving over a mesh: make_substepped_tick with the batch
    axis sharded over ``mesh`` (batch.shard_batch's layout).

    tick(batch_shards, dts, splats) -> (batch_shards, (B, h, w, 3) uint8).
    Each device runs _substepped_body on its own B / n sims: its columns of
    the (K, B) ``dts`` (one dt table a device a tick) and its rows of the
    (B, MAX_SPLATS, 8) ``splats``. No byte of the state moves between
    devices; the frames of all B sims, in order, are copied to the mesh's
    first device, as JAX's out_specs gather them when they are read. Each
    sim's state and frame equal the unsharded tick's bit for bit, and each
    device makes the K-substep tick's 5K + 4 launches. Raises ValueError
    where mesh.size does not divide B."""
    body = _substepped_body(config)

    def tick(shards, dts, splats):
        a = _host(dts)
        splats = torch.as_tensor(splats, dtype=torch.float32)
        b = splats.shape[0]
        m = _split(b, mesh.size, "mesh size")
        if a.ndim != 2 or a.shape[1] != b or a.shape[0] < 1:
            raise ValueError(f"substep dts of shape {a.shape}, expected (K, {b})")
        check_batch_shards(shards, mesh, m)
        out, frames = [], []
        for k, shard in enumerate(shards):
            state, frame = body(shard, a[:, k * m:(k + 1) * m], splats[k * m:(k + 1) * m])
            out.append(state)
            frames.append(frame)
        first = mesh.flat[0]
        return tuple(out), torch.cat([f.to(first) for f in frames])

    return tick


def _batch_shapes(config: FluidConfig, pb: int) -> dict:
    """Each field's shape in a padded batch of ``pb`` sims. The counterpart
    of JAX's AOT lowering avals: nothing is lowered here; a program checks
    its arguments against these shapes."""
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    return {"velocity": (pb, 2, sh, sw), "dye": (pb, 3, dh, dw), "pressure": (pb, sh, sw)}


def _check_state(state: FluidState, shapes: dict, config: FluidConfig) -> None:
    for f, want in shapes.items():
        x = getattr(state, f)
        if tuple(x.shape) != want or x.dtype != config.dtype:
            raise ValueError(f"{f} {tuple(x.shape)} {x.dtype}, the program takes {want} "
                             f"{config.dtype}")


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


@lru_cache(maxsize=None)
def make_tick_program(config: FluidConfig, pb: int, kind, plain: bool = False):
    """The serving program for padded batch ``pb``:
    program(state, dt, splats) -> (state, (pb, h, w, 3) uint8 frames).

    kind: 'scalar' (lock-step shared clock, dt ()), 'vector' ((pb,) per-sim
    dts) or an int K >= 2 (the K-substep fast-forward tick, dts (K, pb)).
    ``splats`` is (pb, MAX_SPLATS, 8). JAX lowers and compiles one
    executable per (pb, kind) (``_batch_shapes``' avals, ``jit.lower(...)
    .compile()``); the port has nothing to compile per shape, so a program
    is a callable that checks the shapes of its arguments, raising
    ValueError, and then runs the batched body on the state's device: the
    kernels on a CUDA state, their plain versions on a CPU one. ``plain``
    runs the plain versions on any device (the reference on the card)."""
    if kind == "scalar":
        body, dt_shape = _batched_tick_body(config, plain), ()
    elif kind == "vector":
        body, dt_shape = _batched_tick_body(config, plain), (pb,)
    else:
        k = int(kind)
        if k < 2:
            raise ValueError(f"substep kind must be >= 2, got {kind!r}")
        body, dt_shape = _substepped_body(config, plain), (k, pb)
    shapes = _batch_shapes(config, pb)
    splat_shape = (pb, config.MAX_SPLATS, SPLAT_COLS)

    def program(state: FluidState, dt, splats):
        _check_state(state, shapes, config)
        if _shape(dt) != dt_shape or _shape(splats) != splat_shape:
            raise ValueError(f"dt {_shape(dt)} and splats {_shape(splats)}: the ({pb}, "
                             f"{kind!r}) program takes {dt_shape} and {splat_shape}")
        with span("tick"):
            return body(state, dt, splats)

    return program


@lru_cache(maxsize=None)
def make_zero_tail(config: FluidConfig, pb: int):
    """zero_tail(state, keep (pb,) bool) -> the padded-``pb`` state with the
    rows not kept exactly zero, on the state's device. torch.where, not a
    multiplication by a mask: 0 * NaN would leak a broken evicted tenant's
    non-finite values into the pad rows' inertness invariant."""
    shapes = _batch_shapes(config, pb)

    def zero_tail(state: FluidState, keep) -> FluidState:
        _check_state(state, shapes, config)
        keep = torch.as_tensor(keep, dtype=torch.bool, device=state.velocity.device)
        if tuple(keep.shape) != (pb,):
            raise ValueError(f"keep {tuple(keep.shape)}, expected ({pb},)")

        def f(x):
            return torch.where(keep.view((-1,) + (1,) * (x.ndim - 1)), x, x.new_zeros(()))

        return FluidState(*(f(getattr(state, n)) for n in _FIELDS))

    return zero_tail


@lru_cache(maxsize=None)
def make_state_resize(config: FluidConfig, pb_from: int, pb_to: int):
    """resize(state) -> the state's padded batch axis from ``pb_from`` to
    ``pb_to`` rows on its own device, with no round trip through the host
    (a fleet's state can be hundreds of MB): grow concatenates zero rows,
    shrink slices."""
    shapes = _batch_shapes(config, pb_from)

    def resize(state: FluidState) -> FluidState:
        _check_state(state, shapes, config)

        def f(x):
            if pb_to > pb_from:
                return torch.cat([x, x.new_zeros((pb_to - pb_from,) + tuple(x.shape[1:]))])
            return x[:pb_to]

        return FluidState(*(f(getattr(state, n)) for n in _FIELDS))

    return resize


class BatchFluidServer:
    """Owns the batched sim loop; per-session tracers + lazy JPEG frames.

    Concurrency (the latency invariants, JAX's):
      - lock       guards fleet bookkeeping (sessions, tracers, speeds,
                   program table, pending flags). Held only for O(ms)
                   bookkeeping, and by the reconciler's resize steps across
                   one zero-tail or resize of the state.
      - state_lock owns the state tensors. Acquired only while holding (or
                   having just held) lock: the global order is
                   lock -> state_lock.
      - out_lock   guards the published frames, steps and caches.
    Every launch runs on the device's default stream, so the reconciler's
    zero tail and resize are ordered after the tick in flight.

    On a CUDA device the constructor builds the kernels (ops/cuda/build.py)
    before any lock exists, so a first build (minutes of nvcc) never runs
    inside the sim loop's state_lock; a build that fails raises here. The
    server runs on ``device`` (default the GPU) and raises without one; the
    CPU only when the caller passes device="cpu"."""

    MAX_SESSIONS = 64  # resize ceiling: caps state allocation and the program table

    # Rolling-snapshot refresh cadence: at least this often, further
    # throttled so the host copy costs <= ~2% of a 200 MB/s copy at any
    # fleet size (interval >= fleet_bytes / 200 MB/s * 50).
    _SNAP_MIN_INTERVAL_S = 0.25

    def __init__(self, config: FluidConfig, sessions: int = 4, seed: int = 0,
                 quality: int = 80, identical_seeds: bool = False,
                 resume: Optional[str] = None, prewarm: str = "neighbors", device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from tpufluid_torch.ops.cuda import build

            build.build()
        self.steps_done = 0
        self._seed = int(seed)
        self._identical_seeds = bool(identical_seeds)
        if resume:
            # Whole-fleet deterministic resume: the checkpoint carries the
            # batched fields, config, step count, per-session speeds, the
            # seeding policy and every session's tracer state, with the
            # per-session parts in ``extra``.
            state, config, self.steps_done, extra = load_state(resume, device="cpu")
            self.config = config
            self.sessions = int(extra["sessions"])
            # The seeding policy comes from the checkpoint, so tenants added
            # to a resumed fleet seed as they would have on the original.
            self._seed = int(extra.get("seed", seed))
            self._identical_seeds = bool(extra.get("identical_seeds", identical_seeds))
            self.tracers = []
            for d in extra["tracers"]:
                tr = PointerTracer(config, seed=self._seed)
                tr.load_state_dict(d)
                self.tracers.append(tr)
            # Clamp on load: an edited checkpoint must not bypass the
            # SPEED_MAX bound. NaN maps to 0, +inf to SPEED_MAX.
            speeds = np.asarray(extra["speeds"], np.float32)
            self.speeds = np.clip(np.nan_to_num(speeds, nan=0.0, posinf=SPEED_MAX,
                                                neginf=0.0), 0.0, SPEED_MAX)
            # Pad the checkpointed rows to the padded batch on the host, then
            # move each field to the device once.
            self._pb = _padded(self.sessions)

            def pad(x):
                if x.shape[0] < self._pb:
                    x = torch.cat([x, x.new_zeros((self._pb - x.shape[0],) + tuple(x.shape[1:]))])
                return x.to(self.device)

            self.state = FluidState(*(pad(getattr(state, f)) for f in _FIELDS))
        else:
            self.config = config
            self.sessions = int(sessions)
            # identical_seeds starts every session bit-identical (the
            # isolation test shape); the default gives each tenant its own
            # seeded startup burst, like the reference's
            # multipleSplats(random) (script.js:1170).
            self.tracers = [self._new_tracer(i) for i in range(self.sessions)]
            self._pb = _padded(self.sessions)
            self.state = init_batch(config, self._pb, device=self.device)
            self.speeds = np.ones(self.sessions, np.float32)
        self.quality = quality
        self.prewarm = prewarm  # "off" | "neighbors" | "all"
        # Rows [0, _live_rows) are ticked, drained and published. Invariant
        # (_tail_clean): rows >= _live_rows of self.state are exactly zero,
        # so activating them starts fresh tenants from the zero field and no
        # evicted tenant's pixels can leak into a reused row.
        self._live_rows = min(self.sessions, self._pb)
        self._tail_clean = True
        # Program table: (pb, kind) -> program, made only by the reconciler
        # thread; a failure lands in _prog_errors and is never retried.
        self._progs: dict = {}
        self._prog_errors: dict = {}
        self._want: set = set()  # loop-requested (pb, K) fast-forward keys
        self._last_substeps = 1
        self.paused = False
        self.lock = threading.Lock()
        self.state_lock = threading.Lock()
        self.out_lock = threading.Lock()
        self.frames: Optional[np.ndarray] = None  # (pb, H, W, 3) uint8
        self._frames_live = 0  # rows of self.frames that are live tenants
        self._jpeg_cache: dict = {}
        self._stop = threading.Event()
        self.error: Optional[str] = None  # sim-loop crash, shown in /stats
        # Fleet generation, bumped by state swaps and by shrinks below
        # _live_rows: a tick that started before one must not publish.
        self._gen = 0
        self._reconcile = threading.Event()
        self._reconciler_thread: Optional[threading.Thread] = None
        # Set after the launches that made self.state (a CUDA event; None on
        # the CPU, where a state is ready when it exists): _state_ready().
        self._ready: Optional[torch.cuda.Event] = None
        # Rolling post-tick host snapshot (step, host FluidState), refreshed
        # by the sim loop at tick boundaries: a checkpoint serves its FIELDS
        # while the live state's tick is still on the device. Bookkeeping
        # always comes from the live server. _snap_floor is the least live
        # row count since the capture: snapshot rows at or above it are
        # evicted tenants' stale fields (or pending zeros) and serialize as
        # zeros. All three guarded by out_lock.
        self._snap = None
        self._snap_time = 0.0
        self._snap_floor = self._live_rows
        # Set by _fleet_and_state spinners; the sim loop parks (holding
        # neither lock) while it is up, so a checkpoint or swap waiter gets
        # its both-locks window within one tick instead of starving.
        self._yield_loop = threading.Event()

    def _new_tracer(self, i: int) -> PointerTracer:
        """Tracer for global session index ``i`` under the fleet's seeding
        policy, with the reference's load-time startup burst
        (multipleSplats(random), script.js:1170) pre-queued."""
        tr = PointerTracer(self.config,
                           seed=self._seed if self._identical_seeds else self._seed + i)
        tr.splat_stack.append(int(tr.rng.integers(5, 25)))
        return tr

    def handle_events(self, events, sid: int) -> None:
        w, h = self.config.CANVAS_WIDTH, self.config.CANVAS_HEIGHT
        with self.lock:
            # Range check under the lock: a concurrent shrink can retire the
            # sid between an unlocked check and the tracer access.
            if not 0 <= sid < self.sessions:
                raise ValueError(f"sid {sid} out of range 0..{self.sessions - 1}")
            tr = self.tracers[sid]
            for e in events:
                k = e.get("k")
                pid = int(e.get("id", 0))
                if k == "down":
                    tr.feed("down", pid=pid, x=e["x"] * w, y=e["y"] * h)
                elif k == "move":
                    tr.feed("move", pid=pid, x=e["x"] * w, y=e["y"] * h)
                elif k == "up":
                    tr.feed("up", pid=pid)
                elif k == "burst":
                    tr.feed("burst", n=int(e.get("n", 12)))
                elif k == "pause":
                    self.paused = bool(e["v"]) if "v" in e else not self.paused
                elif k == "speed":
                    v = float(e["v"])
                    # json.loads accepts NaN and Infinity; a NaN surviving
                    # np.clip would make the loop's substep count INT64_MIN
                    # and kill it. Reject at the edge (a 400).
                    if not math.isfinite(v):
                        raise ValueError(f"speed must be finite, got {v!r}")
                    self.speeds[sid] = float(np.clip(v, 0.0, SPEED_MAX))

    # ----- reconciler: the only thread that makes programs -----

    def _ensure_reconciler(self):
        if self._reconciler_thread is None:
            self._reconciler_thread = threading.Thread(target=self._reconcile_loop, daemon=True)
            self._reconciler_thread.start()

    def _prewarm_keys(self, pb: int) -> list:
        """Speculative program keys, lowest reconciler priority.

        'neighbors' (default): everything the CURRENT padded size can ask
        for at run time (per-sim dts and every fast-forward K) plus the
        adjacent padded sizes' lock-step and per-sim programs. 'all' covers
        the whole power-of-two table up to MAX_SESSIONS (the soak uses it).
        'off' makes programs strictly on demand."""
        if self.prewarm == "off":
            return []
        keys = [(pb, k) for k in range(2, _K_MAX + 1)]
        if self.prewarm == "all":
            sizes = []
            s = 1
            while s <= _padded(self.MAX_SESSIONS):
                sizes.append(s)
                s *= 2
        else:
            sizes = [p for p in (pb * 2, pb // 2) if 1 <= p <= _padded(self.MAX_SESSIONS)]
        for p in sizes:
            keys.append((p, "scalar"))
            keys.append((p, "vector"))
        if self.prewarm == "all":
            for p in sizes:
                keys.extend((p, k) for k in range(2, _K_MAX + 1))
        return keys

    def _next_task(self):
        """The reconciler's next unit of work. Call under self.lock.

        Priority: programs the loop needs NOW (the current padded size's
        lock-step, then per-sim dt, then requested fast-forward Ks) >
        privacy zeroing of evicted rows > a pending padded-size swap >
        activating pending grown tenants > speculative prewarm."""
        pb = self._pb
        target = _padded(self.sessions)

        def missing(key):
            return key not in self._progs and key not in self._prog_errors

        for key in [(pb, "scalar"), (pb, "vector")]:
            if missing(key):
                return ("compile", key)
        for key in sorted(self._want):
            if missing(key):
                return ("compile", key)
        if not self._tail_clean:
            zt = ("zerotail", pb)
            if missing(zt):
                return ("compile", zt)
            if zt in self._progs:
                return ("zero_tail",)
            # Terminal: the zero tail's program failed (never retried).
            # Returning ("zero_tail",) anyway would spin the reconciler on a
            # no-op apply, grabbing both locks each cycle. Privacy zeroing,
            # and with it swaps and activation, is wedged: stuck_tasks()
            # shows it and the live rows keep serving.
        elif target != pb:
            dep_error = False
            for key in [(target, "scalar"), (target, "vector"), ("resize", pb, target)]:
                if key in self._prog_errors:
                    dep_error = True  # terminal, see stuck_tasks()
                elif key not in self._progs:
                    return ("compile", key)
            if not dep_error:
                return ("swap", pb, target)
            # A swap dependency failed terminally: fall through so that
            # tenants that fit the CURRENT padded size still activate.
        if self._tail_clean and self._live_rows < min(self.sessions, pb):
            return ("activate",)
        for key in self._prewarm_keys(pb):
            if missing(key):
                return ("compile", key)
        return None

    def stuck_tasks(self) -> list:
        """Terminally wedged reconciler objectives (a required program
        failed; failures are never retried). Call under self.lock. Shown in
        /stats, so an operator sees why a resize never completes."""
        stuck = []
        pb = self._pb
        target = _padded(self.sessions)
        if not self._tail_clean and ("zerotail", pb) in self._prog_errors:
            stuck.append({"task": "zero_tail", "padded_batch": pb,
                          "blocked": "privacy zeroing, swaps, activation"})
        if target != pb:
            deps = [k for k in [(target, "scalar"), (target, "vector"), ("resize", pb, target)]
                    if k in self._prog_errors]
            if deps:
                stuck.append({"task": "swap", "from": pb, "to": target,
                              "failed_deps": [str(k) for k in deps],
                              "blocked": "padded-size resize"})
        return stuck

    def _compile(self, key) -> None:
        """Make ONE program outside every lock, then publish it into the
        program table. A failure is recorded once and never retried."""
        try:
            if key[0] == "zerotail":
                prog = make_zero_tail(self.config, key[1])
            elif key[0] == "resize":
                prog = make_state_resize(self.config, key[1], key[2])
            else:
                prog = make_tick_program(self.config, key[0], key[1])
        except Exception:
            with self.lock:
                self._prog_errors[key] = traceback.format_exc()
            return
        with self.lock:
            self._progs[key] = prog

    def _run_task(self, task) -> None:
        """Carry out one task of _next_task."""
        if task[0] == "compile":
            self._compile(task[1])
        elif task[0] == "zero_tail":
            self._apply_zero_tail()
        elif task[0] == "swap":
            self._apply_swap(task[1], task[2])
        else:  # activate
            with self.lock:
                if self._tail_clean:
                    self._live_rows = min(self.sessions, self._pb)

    def _reconcile_loop(self):
        while not self._stop.is_set():
            with self.lock:
                task = self._next_task()
            if task is None:
                self._reconcile.wait(timeout=0.25)
                self._reconcile.clear()
                continue
            self._run_task(task)

    def _fleet_and_state(self) -> bool:
        """Acquire lock AND state_lock together without holding the event
        lock while waiting for a tick's dispatch: spins on a non-blocking
        state_lock attempt, releasing the event lock between tries, in the
        global lock -> state_lock order. Returns True with BOTH locks held,
        or False if the server is stopping.

        ``_yield_loop`` closes the spin's starvation hole: on a busy host the
        loop cycles drain (lock) -> tick (state_lock) almost back to back,
        so the window with both free is microseconds a frame. While the flag
        is set the sim loop parks before its next drain, holding neither
        lock, so the spinner wins within one tick."""
        while not self._stop.is_set():
            # Re-set each try: a concurrent spinner's _release_both may have
            # cleared the flag while this one is still waiting.
            self._yield_loop.set()
            self.lock.acquire()
            if self.state_lock.acquire(blocking=False):
                return True  # _release_both clears the flag
            self.lock.release()
            time.sleep(0.001)
        self._yield_loop.clear()
        return False

    def _release_both(self):
        self._yield_loop.clear()
        self.state_lock.release()
        self.lock.release()

    def _mark_ready(self) -> None:
        """Record, on a CUDA device, an event after the launches that just
        made self.state. Call with state_lock held."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._ready = ev

    def _state_ready(self) -> bool:
        """Whether the launches that made self.state have finished on the
        device (JAX asks is_ready() of its futures): the event of
        _mark_ready, always True on the CPU. Call with state_lock held."""
        return self._ready is None or self._ready.query()

    def _apply_zero_tail(self):
        """Zero rows >= _live_rows on the device (privacy after a shrink,
        and the pad rows' inertness invariant)."""
        if not self._fleet_and_state():
            return
        try:
            pb = self._pb
            prog = self._progs.get(("zerotail", pb))
            if prog is None or self._tail_clean:
                return
            keep = np.arange(pb) < self._live_rows
            self.state = prog(self.state, keep)
            self._mark_ready()
            self._tail_clean = True
        finally:
            self._release_both()

    def _apply_swap(self, pb_from: int, pb_to: int):
        """Swap the state to a new padded batch size on the device.
        Preconditions (kept by _next_task's order): the tail is clean, the
        target's programs and the resize exist. Re-validated under the lock:
        a concurrent resize may have moved the target."""
        if not self._fleet_and_state():
            return
        try:
            if (self._pb != pb_from or _padded(self.sessions) != pb_to
                    or not self._tail_clean):
                return  # stale plan; _next_task will re-derive
            prog = self._progs.get(("resize", pb_from, pb_to))
            if prog is None:
                return
            self.state = prog(self.state)
            self._mark_ready()
            self._pb = pb_to
            self._live_rows = min(self._live_rows, pb_to)
            # The tail stays clean: grow appended zeros; shrink sliced away
            # rows the clean invariant already had zero.
            self._gen += 1  # in-flight pre-swap ticks must not publish
        finally:
            self._release_both()

    def resize_fleet(self, n: int) -> None:
        """Elastic multi-tenancy: grow or shrink the fleet LIVE, in O(ms).

        Two-phase: this call applies only bookkeeping (tracers, speeds, the
        session count; growth appends fresh seeded tracers with startup
        bursts at sids B..n-1, shrink drops the HIGHEST sids, so sids
        0..n-1 stay themselves) and returns. The reconciler then (a) zeroes
        evicted rows on the device (privacy), (b) swaps the padded state
        shape if the power-of-two bucket changed, and (c) activates pending
        grown rows. Until activation the new sids' frames 503 while their
        events queue in their tracers. Untouched sessions' fields are
        untouched throughout: concatenating or slicing the batch axis
        cannot mix rows."""
        if not isinstance(n, int) or isinstance(n, bool):
            raise ValueError(f"fleet size must be an integer, got {n!r}")
        if not 1 <= n <= self.MAX_SESSIONS:
            raise ValueError(f"fleet size must be in [1, {self.MAX_SESSIONS}], got {n} (the "
                             "cap bounds state allocation and program-table growth from "
                             "unauthenticated POST /sessions)")
        with self.lock:
            b = self.sessions
            if n == b:
                return
            if n < b:
                self.tracers = self.tracers[:n]
                self.speeds = self.speeds[:n].copy()
                self.sessions = n
                if n < self._live_rows:
                    # Evicted rows hold real tenant data until the reconciler
                    # zeroes them; nothing may publish or reactivate them
                    # before that. Fence in-flight ticks too: a tick that
                    # captured the pre-shrink live count must not publish.
                    self._live_rows = n
                    self._tail_clean = False
                    self._gen += 1
            else:
                self.tracers += [self._new_tracer(i) for i in range(b, n)]
                self.speeds = np.concatenate([self.speeds, np.ones(n - b, np.float32)])
                self.sessions = n
                if self._tail_clean and n <= self._pb:
                    # The new tenants fit inside the current padded batch and
                    # their rows are known zero: activate at once.
                    self._live_rows = n
        self._reconcile.set()
        with self.out_lock:
            # Cached encodes may belong to retired sids; drop them.
            self._jpeg_cache.clear()
            # A shrink evicts rows >= n: the rolling snapshot's copies of
            # them are a departed tenant's fields until the next refresh.
            if n < b:
                self._snap_floor = min(self._snap_floor, n)

    def _snapshot_meta(self) -> dict:
        """Bookkeeping half of a checkpoint cut. Call under self.lock."""
        return {"sessions": self.sessions,
                "speeds": [float(s) for s in self.speeds],
                # Seeding policy, so tenants added to a resumed fleet seed
                # as the original fleet's would have.
                "seed": self._seed,
                "identical_seeds": self._identical_seeds,
                "tracers": [tr.state_dict() for tr in self.tracers]}

    def _host_state(self) -> FluidState:
        """A host copy of self.state. Call with state_lock held; on the card
        the copy waits for the launches that made the state."""
        return FluidState(*(getattr(self.state, f).detach().to("cpu", copy=True)
                            for f in _FIELDS))

    def _maybe_refresh_snapshot(self) -> None:
        """Refresh the rolling post-tick snapshot. Called by the sim loop
        right after publishing a tick (its frames reached the host, so the
        state is ready). Throttled by wall time and fleet bytes."""
        now = time.time()
        nbytes = state_bytes(self.state)
        if nbytes > 64 * 1024 * 1024:
            # Huge fleets: the copy itself would hold the locks long enough
            # to hurt the event latency. Checkpoints take the fresh path.
            return
        interval = max(self._SNAP_MIN_INTERVAL_S, nbytes / 200e6 * 50.0)
        if now - self._snap_time < interval:
            return
        self.lock.acquire()
        try:
            floor0 = min(self.sessions, self._live_rows)  # valid rows of this capture
            self.state_lock.acquire()
            try:
                st = self._host_state()
            finally:
                self.state_lock.release()
        finally:
            self.lock.release()
        with self.out_lock:
            self._snap = (self.steps_done, st)
            self._snap_time = now
            # Reset the since-capture floor, folding in the current
            # bookkeeping so a shrink in the capture-to-publish gap can
            # never raise it back up.
            self._snap_floor = min(floor0, self.sessions, self._live_rows)

    def checkpoint_bytes(self) -> bytes:
        """Whole-fleet checkpoint (.npz): batched fields + config + step
        count + per-session speeds and tracer states, resumable with
        BatchFluidServer(config, resume=path) of either package. Saves
        exactly ``sessions`` rows, uncompressed; a pending grown tenant is
        saved as its zero field, which is precisely its state.

        BOOKKEEPING is always the live, post-ACK truth. FIELDS come from one
        of two cuts: fresh (the state's launches have finished,
        _state_ready(): a host copy now) or rolling (a tick is still on the
        device: the loop's post-tick snapshot, at most one tick and the
        refresh throttle stale). Rows at or above the row floor (evicted
        tenants' stale copies, un-zeroed or pending rows) serialize as
        ZEROS, never as field data."""
        if not self._fleet_and_state():
            raise RuntimeError("server is stopping")
        try:
            ready = self._state_ready()
            with self.out_lock:
                snap = self._snap
                snap_floor = self._snap_floor
                step = self.steps_done
            sessions = self.sessions
            extra = self._snapshot_meta()
            if ready or snap is None:
                floor = min(sessions, self._live_rows)
                state = self._host_state()
            else:
                step, state = snap
                floor = snap_floor
        finally:
            self._release_both()
        rows = min(sessions, floor, state.velocity.shape[0])

        def take(x):
            a = x[:rows]
            if rows < sessions:  # pending grown tenants: zero by contract
                a = torch.cat([a, a.new_zeros((sessions - rows,) + tuple(a.shape[1:]))])
            return a

        state = FluidState(*(take(getattr(state, f)) for f in _FIELDS))
        buf = io.BytesIO()
        # Uncompressed: DEFLATE's single-core tail grows with the fleet.
        save_state(buf, state, self.config, step=step, extra=extra, compress=False)
        return buf.getvalue()

    def _encode(self, arr: np.ndarray) -> bytes:
        """One session's (h, w, 3) uint8 frame as JPEG bytes."""
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=self.quality)
        return buf.getvalue()

    def frame_jpeg(self, sid: int) -> Optional[tuple]:
        """(JPEG bytes, sim step) for one session, or None while its row is
        not published yet; encoded lazily, cached per step. Raises
        ValueError for a sid out of range."""
        if not 0 <= sid < self.sessions:
            raise ValueError(f"sid {sid} out of range")
        with self.out_lock:
            # _frames_live is the row count that was LIVE when self.frames
            # was published: around a resize a sid can be missing (503).
            if self.frames is None or sid >= self._frames_live:
                return None
            step = self.steps_done
            hit = self._jpeg_cache.get(sid)
            if hit and hit[0] == step:
                return hit[1], step
            arr = np.array(self.frames[sid])
        data = self._encode(arr)
        with self.out_lock:
            if self.steps_done == step:
                self._jpeg_cache[sid] = (step, data)
        return data, step

    def run(self):
        """Sim-loop thread entry; a crash is recorded for /stats instead of
        silently 503-ing every frame request."""
        try:
            self._run()
        except Exception:
            with self.out_lock:
                self.error = traceback.format_exc()
            traceback.print_exc()

    def _tick(self, dt_wall: float) -> bool:
        """One frame of the sim loop: drain the live sessions' events,
        dispatch the program under state_lock, copy the frames to the host
        outside both locks and publish them unless a swap or shrink fenced
        the tick. Returns False, dispatching nothing, while the current
        padded size has no lock-step program yet."""
        with self.lock:
            with span("server.drain"):
                pb = self._pb
                if (pb, "scalar") in self._prog_errors:
                    raise RuntimeError("lock-step program failed:\n"
                                       + self._prog_errors[(pb, "scalar")])
                if (pb, "scalar") not in self._progs:
                    return False
                live = self._live_rows
                max_s = self.config.MAX_SPLATS
                batch = np.zeros((pb, max_s, SPLAT_COLS), np.float32)
                # Per-session clocks over the PADDED batch: live rows use their
                # session's speed, pad and pending rows read 1.0 (their zero
                # state is inert at any dt). Speeds above 1 advance more than
                # 1/60 of sim time a frame, split into n = ceil(t / MAX_DT) equal
                # substeps so the ceiling holds per substep.
                speeds_p = np.ones(pb, np.float32)
                speeds_p[:live] = self.speeds[:live]
                t_total = dt_wall * speeds_p
                n_sub = np.maximum(np.ceil(t_total / MAX_DT - 1e-9), 1.0).astype(np.int64)
                k = int(n_sub.max())
                if k > 1 and (pb, k) not in self._progs:
                    # No fast-forward program yet: request it and serve this frame
                    # at the capped single-step rate.
                    if (pb, k) not in self._prog_errors:
                        self._want.add((pb, k))
                        self._reconcile.set()
                    k = 1
                if k == 1:
                    t_total = np.minimum(t_total, MAX_DT)
                # Pick the program AND the dt it applies BEFORE draining the
                # tracers: a degrade replaces the per-session clocks with the
                # shared one, and splat pacing and color cycling must advance at
                # the dt the sim actually steps.
                if k == 1:
                    lockstep = bool(np.all(speeds_p == 1.0))
                    if not lockstep and (pb, "vector") not in self._progs:
                        # Per-sim program not made yet: degrade to the shared
                        # clock rather than stall the loop.
                        lockstep = True
                        self._reconcile.set()
                    if lockstep:
                        prog = self._progs[(pb, "scalar")]
                        dt_arg = np.float32(dt_wall)
                        t_total = np.full(pb, dt_wall, np.float32)
                    else:
                        prog = self._progs[(pb, "vector")]
                        dt_arg = t_total.astype(np.float32)
                else:
                    # (K, B) substep dts: session b runs n_sub[b] equal substeps
                    # of t_total[b] / n_sub[b] (each <= MAX_DT), zero-padded to
                    # K; zero rows are exact no-ops in the substepped body.
                    prog = self._progs[(pb, k)]
                    sub = (t_total / n_sub).astype(np.float32)
                    dt_arg = np.where(np.arange(k)[:, None] < n_sub[None, :],
                                      sub[None, :], 0.0).astype(np.float32)
                # Each tracer drains at ITS OWN applied time. Pending (not yet
                # activated) tenants are not drained: their events queue until
                # their zeroed row is live.
                for b in range(live):
                    for i, (x, y, dx, dy, color) in enumerate(
                            self.tracers[b].drain_step(float(t_total[b]))[:max_s]):
                        batch[b, i] = [x, y, dx, dy, color[0], color[1], color[2], 1.0]
                gen = self._gen
            # Take the state BEFORE releasing the event lock (lock ->
            # state_lock): a swap cannot replace the fleet between this
            # frame's drain and its tick, yet the tick runs with the event
            # lock free. The dispatch span runs from this wait through the
            # program.
            dispatch = span("server.dispatch")
            dispatch.__enter__()
            self.state_lock.acquire()
        try:
            self.state, frames = prog(self.state, dt_arg, batch)
            self._mark_ready()
        finally:
            self.state_lock.release()
            dispatch.__exit__(None, None, None)
        # The copy to the host (the sync point) runs outside both locks:
        # checkpoint and swap waiters queue behind the tick on the device
        # instead of waiting for it on the host.
        with span("server.frames_copy"):
            frames = frames.cpu().numpy()
        with self.out_lock:
            # Publish ONLY if no swap or shrink happened since this tick was
            # dispatched (both bump _gen): after a shrink-then-regrow to the
            # same padded size, stale frames would pass shape checks and
            # leak evicted tenants' pixels to new tenants at reused sids.
            if gen == self._gen:
                self.frames = frames
                self._frames_live = live
                self.steps_done += 1
                self._last_substeps = k
        return True

    def _run(self):
        self._ensure_reconciler()
        last = time.time()
        while not self._stop.is_set():
            t_frame = time.time()
            dt_wall = min(t_frame - last, MAX_DT)
            last = t_frame
            with self.lock:
                paused = self.paused
            if paused:
                # Sleep OUTSIDE the lock: holding it would starve POST
                # /events, the unpause event included.
                time.sleep(MAX_DT)
                continue
            if self._yield_loop.is_set():
                # A checkpoint or swap spinner needs both locks: park,
                # holding neither, so it wins within one frame.
                time.sleep(0.002)
                continue
            if not self._tick(dt_wall):
                # The reconciler has not made this padded size's first
                # program yet: events flow, frames wait.
                self._reconcile.set()
                time.sleep(0.05)
                continue
            # Post-tick boundary: the frames reached the host, so the state
            # is ready; refresh the rolling snapshot (throttled inside).
            self._maybe_refresh_snapshot()
            left = MAX_DT - (time.time() - t_frame)
            if left > 0:
                time.sleep(left)

    def stop(self, join_timeout: float = 60.0):
        """Stop the loops; joins the reconciler (bounded)."""
        self._stop.set()
        self._reconcile.set()
        t = self._reconciler_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=join_timeout)


_DASH = """<!doctype html><meta charset=utf-8><title>tpufluid sessions</title>
<style>body{background:#000;color:#9ab;font:13px monospace;margin:12px}
.g{display:flex;flex-wrap:wrap;gap:10px}.c{text-align:center}
img{display:block;border:1px solid #345;cursor:crosshair}</style>
<h3>tpufluid — %B% sessions, one GPU, one batched tick a frame</h3>
<div class=g id=g></div>
<script>
const B=%B%;const g=document.getElementById('g');
for(let s=0;s<B;s++){const d=document.createElement('div');d.className='c';
 d.innerHTML=`<img id=f${s} width=256><br>session ${s} · speed
  <input id=v${s} type=range min=0 max=4 step=0.125 value=1
   style="width:90px;vertical-align:middle">
  <span id=l${s}>1</span>x`;g.appendChild(d);
 const sl=d.querySelector(`#v${s}`);
 sl.oninput=()=>{document.getElementById('l'+s).textContent=sl.value;
  fetch(`/events?sid=${s}`,{method:'POST',
   body:JSON.stringify([{k:'speed',v:+sl.value}])})};
 const img=d.querySelector('img');let down=false;
 // Send the RAW top-down pixel fraction: Pointer.on_down/on_move apply
 // the reference's texcoord flip (1 - y/H) themselves — pre-flipping
 // here would double-flip (the single-session page does the same).
 const send=(k,e)=>{const r=img.getBoundingClientRect();
  fetch(`/events?sid=${s}`,{method:'POST',body:JSON.stringify([{k,
   x:(e.clientX-r.left)/r.width,y:(e.clientY-r.top)/r.height}])})};
 img.onmousedown=e=>{down=true;send('down',e)};
 img.onmousemove=e=>{if(down)send('move',e)};
 img.onmouseup=e=>{down=false;fetch(`/events?sid=${s}`,{method:'POST',
  body:JSON.stringify([{k:'up'}])})};}
setInterval(()=>{for(let s=0;s<B;s++){const i=document.getElementById('f'+s);
 i.src=`/frame?sid=${s}&t=${Date.now()}`;}},100);
</script>"""


def make_handler(server: BatchFluidServer):
    class Handler(BaseHTTPRequestHandler):
        # A socket timeout on every connection (reads and writes): a stalled
        # client frees its handler thread.
        timeout = 15

        def log_message(self, *a):
            pass

        def handle_one_request(self):
            try:
                super().handle_one_request()
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _sid(self) -> int:
            q = parse_qs(urlparse(self.path).query)
            return int(q.get("sid", ["0"])[0])

        def _send(self, body: bytes, ctype: str, extra=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame"):
                try:
                    got = server.frame_jpeg(self._sid())
                except ValueError:
                    self.send_response(404)
                    self.end_headers()
                    return
                if got is None:
                    self.send_response(503)
                    self.end_headers()
                    return
                data, step = got
                self._send(data, "image/jpeg", [("Cache-Control", "no-store"),
                                                ("X-Step", str(step))])
            elif self.path.startswith("/checkpoint.npz"):
                self._send(server.checkpoint_bytes(), "application/octet-stream")
            elif self.path.startswith("/stats"):
                # sessions, speeds and paused mutate under server.lock (a
                # resize replaces both arrays); steps and error publish under
                # out_lock: read each group under ITS lock, so a resize never
                # shows a torn view (sessions != len(speeds)).
                with server.lock:
                    sessions = server.sessions
                    paused = server.paused
                    speeds = [float(s) for s in server.speeds]
                    live = server._live_rows
                    padded = server._pb
                    warm = len(server._progs)
                    failed = len(server._prog_errors)
                    progs = sorted(str(k) for k in server._progs)
                    prog_errors = {str(k): v.splitlines()[-1]
                                   for k, v in server._prog_errors.items()}
                    stuck = server.stuck_tasks()
                with server.out_lock:
                    out = {"steps": server.steps_done,
                           "sessions": sessions,
                           "paused": paused,
                           "speeds": speeds,
                           # substeps of the LAST published tick: 1 on the
                           # single-step programs, ceil(max speed) once a
                           # fast-forward program is engaged.
                           "substeps": server._last_substeps,
                           # rows ticked and published against the padded
                           # batch, and the program table's health
                           "live_rows": live,
                           "padded_batch": padded,
                           "programs_warm": warm,
                           "programs_failed": failed,
                           # the table's keys, so a client can wait for a
                           # specific program instead of racing the
                           # reconciler
                           "programs": progs,
                           "program_errors": prog_errors,
                           "stuck": stuck,
                           "error": server.error}
                rec = spans.recorder()
                if rec is not None and rec.ring:
                    # serve_batch --spans: each span's count, p50 and p95
                    # ms over the ring's newest spans.
                    out["spans"] = spans.summary(rec.snapshot())
                self._send(json.dumps(out).encode(), "application/json")
            else:
                self._send(_DASH.replace("%B%", str(server.sessions)).encode(), "text/html")

        def do_POST(self):
            if self.path.startswith("/events"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    events = json.loads(self.rfile.read(n) or b"[]")
                    server.handle_events(events, self._sid())
                    self.send_response(204)
                except Exception:
                    self.send_response(400)
                self.end_headers()
            elif self.path.startswith("/sessions"):
                # {"n": N} sets the fleet size live; returns in O(ms), the
                # reconciler applies any state reshape off the request path.
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    server.resize_fleet(body["n"])
                    self.send_response(204)
                except Exception:
                    self.send_response(400)
                self.end_headers()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def build_argparser():
    import argparse

    p = argparse.ArgumentParser(prog="tpufluid_torch.serve_batch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--sessions", type=int, default=4)
    p.add_argument("--sim-res", type=int, default=128)
    p.add_argument("--dye-res", type=int, default=256)
    p.add_argument("--canvas", default="256x256")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--identical-seeds", action="store_true",
                   help="start every session bit-identical (same seed + same startup burst)")
    p.add_argument("--quality", type=int, default=80)
    p.add_argument("--prewarm", default="neighbors", choices=["off", "neighbors", "all"],
                   help="speculative program policy (see BatchFluidServer._prewarm_keys)")
    p.add_argument("--resume", type=str, default=None,
                   help="resume a whole fleet from a /checkpoint.npz download of either "
                        "package (config, sessions, speeds and tracer states come from the "
                        "checkpoint)")
    p.add_argument("--spans", action="store_true",
                   help="record the port's spans in a ring of the newest %d; /stats then "
                        "gives each span's count, p50 and p95 ms" % SPAN_RING)
    return p


def config_from_args(args) -> FluidConfig:
    """The fleet's config from build_argparser's options."""
    w, h = (int(v) for v in args.canvas.split("x"))
    return FluidConfig(SIM_RESOLUTION=args.sim_res, DYE_RESOLUTION=args.dye_res,
                       CANVAS_WIDTH=w, CANVAS_HEIGHT=h, DTYPE=args.dtype).validate()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = device_from_env()
    if args.spans:
        spans.enable(SPAN_RING, ring=True)
    server = BatchFluidServer(config_from_args(args), sessions=args.sessions, seed=args.seed,
                              quality=args.quality, resume=args.resume,
                              identical_seeds=args.identical_seeds, prewarm=args.prewarm,
                              device=device)
    sim = threading.Thread(target=server.run, daemon=True)
    sim.start()
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(server))
    print(f"serving {server.sessions} sessions on {device} at http://localhost:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        sim.join(timeout=10)
        httpd.server_close()


if __name__ == "__main__":
    main()
