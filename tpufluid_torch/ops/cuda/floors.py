"""The profiling path: the three microbenchmark kernels (csrc/floors.cu), the
reference rates they give, torch.profiler breakdowns of the real step and
frame by kernel, and the floor report that puts the step's beside the rates.

Counterpart of tpufluid/ops/pallas/floors.py. The report holds each of the
step's kernels, timed inside a profiled run of the step, against a bare
reimplementation of its own inner loop (``advantage`` = achieved rate /
reference rate) and the streaming stencil against its HBM time. The work
models count what the port's kernels do, not the TPU kernels' tiles and
halos. Not ported: ``north_star_projection`` and ``measure_bf16_tflops``,
which project onto TPU v5e/v5p from TPU constants.

Everything that measures needs a CUDA GPU and raises without one; the
arithmetic of the report (``floor_table``) and the attribution of profiler
events (``attribute_device_events``) are pure functions.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from tpufluid_torch.ops import floors as plain
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.ops.cuda import jacobi as _jacobi
from tpufluid_torch.ops.cuda.build import I, P, Kernel, ptr, stream
from tpufluid_torch.step import make_step
from tpufluid_torch.trace import swirl_trace

FLOOR_TAA = Kernel("floor_taa", "floors", "floor_taa",
                   [P, P, P, P, I, I, I, I, I, I, I, I, I, P],
                   replaces="tpufluid/ops/pallas/floors.py:92")
FLOOR_ROLL = Kernel("floor_roll", "floors", "floor_roll", [P, P, P, I, I, I, I, I, I, I, I, P],
                    replaces="tpufluid/ops/pallas/floors.py:133")
FLOOR_SWEEP = Kernel("floor_sweep", "floors", "floor_sweep",
                     [P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
                     replaces="tpufluid/ops/pallas/floors.py:163")


def _check(dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"kernel input on {t.device}, expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"kernel takes {dtype}, got {t.dtype}")


# ---- plans of the redesigned kernels (csrc/floors.cu) --------------------

TAA_THREADS = 512        # threads of a floor_taa block: words_b = this // splits
TAA_SPLITS = (1, 2, 4, 8, 16)   # threads a word: words_b stays a multiple of 32
TAA_MAX_SMEM = 232448    # shared memory a block can use on the H100


def _split(n: int, parts: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of part i of range(n) cut into ``parts`` (csrc/floors.cu's
    i * n / parts)."""
    return i * n // parts, (i + 1) * n // parts


@dataclasses.dataclass(frozen=True)
class TaaPlan:
    """floor_taa's blocks: ``words_b`` consecutive words of the flattened
    (rows, lanes) tile a block, each summed by ``splits`` threads, which
    cut its trips * reps terms (flattened trip-major) into ``splits``
    ranges; ``smem``: the bytes the largest block stages (its operand rows,
    its words' indices and the splits' partials)."""

    rows: int
    lanes: int
    reps: int
    trips: int
    words_b: int
    splits: int
    smem: int

    @property
    def blocks(self) -> int:
        return -(-self.rows * self.lanes // self.words_b)

    @property
    def threads(self) -> int:
        return self.words_b * self.splits

    def words(self):
        """Each block's [lo, hi) of the flattened tile, in launch order."""
        n = self.rows * self.lanes
        for b in range(self.blocks):
            yield b * self.words_b, min((b + 1) * self.words_b, n)

    def parts(self):
        """Each split's [lo, hi) of the flattened (trip, rep) terms, q =
        trip * reps + rep."""
        for s in range(self.splits):
            yield _split(self.trips * self.reps, self.splits, s)


@functools.lru_cache(maxsize=64)
def taa_plan(planes: int, n_idx: int, reps: int, trips: int, rows: int, lanes: int,
             sms: int, splits: Optional[int] = None) -> TaaPlan:
    """floor_taa's blocks on a GPU of ``sms`` SMs: the (trip, rep) terms of
    every word cut over ``splits`` threads (1, 2, 4, 8 or 16, so that a
    warp's threads share a split), TAA_THREADS // splits words a block. By
    default the split that leaves the fewest words on the busiest SM
    (ceil(blocks / sms) * words a block), the fewest splits of equals (less
    staging). Raises for a split past the terms, and for a block's staging
    beyond shared memory."""
    if min(planes, n_idx, reps, trips, rows, lanes) < 1:
        raise ValueError(f"floor_taa needs every size >= 1: planes {planes}, n_idx {n_idx}, "
                         f"reps {reps}, trips {trips}, tile {rows}x{lanes}")
    terms, n = trips * reps, rows * lanes
    choices = [s for s in TAA_SPLITS if s <= terms]

    def busiest(s: int) -> int:   # words on the busiest SM
        words_b = TAA_THREADS // s
        blocks = -(-n // words_b)
        return -(-blocks // sms) * words_b

    if splits is None:
        splits = min(choices, key=lambda s: (busiest(s), s))
    if splits not in choices:
        raise ValueError(f"floor_taa cuts a word's {terms} terms over one of {choices} "
                         f"threads, not {splits}")
    words_b = TAA_THREADS // splits
    spanned = max((hi - 1) // lanes - lo // lanes + 1
                  for lo, hi in ((b, min(b + words_b, n)) for b in range(0, n, words_b)))
    smem = 4 * (planes * (spanned + reps - 1) * lanes + (n_idx + splits) * words_b)
    if smem > TAA_MAX_SMEM:
        raise ValueError(f"floor_taa stages {smem} bytes a block, over {TAA_MAX_SMEM}")
    return TaaPlan(rows, lanes, reps, trips, words_b, splits, smem)


ROLL_STRIP = 32          # columns a floor_roll block stages (csrc/floors.cu kRollStrip)
ROLL_ROWS = (4, 8)       # rows a floor_roll thread keeps in its register window
ROLL_SPLITS = (1, 2, 4, 8, 16)   # threads a word's trips are cut over
ROLL_MAX_THREADS = 1024
ROLL_WARPS_PER_SM = 8    # warps an SM that the default split aims at, to hide latency
ROLL_DEFAULT_ROWS = 8    # the fastest on the H100 with 4 splits at the default (PERF.md)


@dataclasses.dataclass(frozen=True)
class RollPlan:
    """floor_roll's blocks: each stages one plane's strip of ROLL_STRIP
    columns (all nrk rows) and takes ``groups_b`` groups of ``r``
    consecutive rows of it, every (row group, column) summed by ``splits``
    threads that cut the trips into ranges; ``smem``: the strip and the
    splits' partials, in bytes."""

    planes: int
    nrk: int
    cbw: int
    trips: int
    r: int
    groups_b: int
    splits: int
    smem: int

    @property
    def strips(self) -> int:
        return -(-self.cbw // ROLL_STRIP)

    @property
    def chunks(self) -> int:
        """Blocks a strip: its row groups, groups_b a block."""
        return -(-(-(-self.nrk // self.r)) // self.groups_b)

    @property
    def blocks(self) -> int:
        return self.planes * self.strips * self.chunks

    @property
    def threads(self) -> int:
        return ROLL_STRIP * self.groups_b * self.splits

    def words(self):
        """Each block's (plane, [row lo, row hi), [column lo, column hi)),
        in launch order (csrc/floors.cu's block index)."""
        for b in range(self.blocks):
            chunk = b % self.chunks
            strip = (b // self.chunks) % self.strips
            plane = b // (self.chunks * self.strips)
            r0 = chunk * self.groups_b * self.r
            c0 = strip * ROLL_STRIP
            yield (plane, (r0, min(r0 + self.groups_b * self.r, self.nrk)),
                   (c0, min(c0 + ROLL_STRIP, self.cbw)))

    def parts(self):
        """Each split's [lo, hi) of the trips."""
        for s in range(self.splits):
            yield _split(self.trips, self.splits, s)


@functools.lru_cache(maxsize=64)
def roll_plan(planes: int, nrk: int, cbw: int, trips: int, sms: int,
              rows: Optional[int] = None, splits: Optional[int] = None) -> RollPlan:
    """floor_roll's blocks on a GPU of ``sms`` SMs: ``rows`` rows a thread
    (ROLL_ROWS, default ROLL_DEFAULT_ROWS); by default the fewest splits
    (ROLL_SPLITS, at most the trips) that give ROLL_WARPS_PER_SM warps an
    SM, or the most there are; then the row groups a block that leave the
    least work on the busiest SM (ceil(blocks / sms) * groups a block), the
    most of equals (fewer stagings). Raises for a size below 1, a row count
    or split off the lists or past the trips, and a strip past shared
    memory."""
    if min(planes, nrk, cbw, trips, sms) < 1:
        raise ValueError(f"floor_roll needs every size >= 1: planes {planes}, nrk {nrk}, "
                         f"cbw {cbw}, trips {trips}, sms {sms}")
    rows = ROLL_DEFAULT_ROWS if rows is None else rows
    if rows not in ROLL_ROWS:
        raise ValueError(f"floor_roll keeps one of {ROLL_ROWS} rows a thread, not {rows}")
    choices = [s for s in ROLL_SPLITS if s <= trips]
    ngroups = -(-nrk // rows)
    pairs = planes * -(-cbw // ROLL_STRIP) * ngroups          # (row group, strip) pairs
    if splits is None:
        splits = next((s for s in choices if pairs * s >= ROLL_WARPS_PER_SM * sms), choices[-1])
    if splits not in choices:
        raise ValueError(f"floor_roll cuts a word's {trips} trips over one of {choices} "
                         f"threads, not {splits}")

    def busiest(g: int) -> int:   # row groups on the busiest SM
        blocks = planes * -(-cbw // ROLL_STRIP) * -(-ngroups // g)
        return -(-blocks // sms) * g

    fits = range(1, min(ngroups, ROLL_MAX_THREADS // (ROLL_STRIP * splits)) + 1)
    groups_b = min(fits, key=lambda g: (busiest(g), -g))
    smem = 4 * ROLL_STRIP * (nrk + (splits - 1) * groups_b * rows)
    if smem > TAA_MAX_SMEM:
        raise ValueError(f"floor_roll stages {smem} bytes a block, over {TAA_MAX_SMEM}")
    return RollPlan(planes, nrk, cbw, trips, rows, groups_b, splits, smem)


SWEEP_ROWS = (4, 8)      # rows a floor_sweep thread can keep in registers (csrc/floors.cu)
SWEEP_K = 5              # sweeps a phase: the fastest on the H100 (PERF.md)
SWEEP_MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """floor_sweep's geometry: blocks of ``rw`` x ``ny`` threads, each
    thread ``r`` rows, holding a region of ny * r rows by rw columns, a tile
    less a halo ``k`` deep on every side; ``tiles_y`` x ``tiles_x`` tiles
    cover the field, one block each and an SM; ``phases``: the sweeps
    between grid barriers."""

    h: int
    w: int
    k: int
    r: int
    rw: int
    ny: int
    tiles_y: int
    tiles_x: int
    phases: Tuple[int, ...]

    @property
    def rh(self) -> int:
        return self.ny * self.r

    @property
    def tile(self) -> Tuple[int, int]:
        return self.rh - 2 * self.k, self.rw - 2 * self.k

    @property
    def blocks(self) -> int:
        return self.tiles_y * self.tiles_x

    @property
    def barriers(self) -> int:
        return len(self.phases) - 1

    def design_cell_sweeps(self) -> int:
        """Cells x sweeps the blocks compute, halos and the last tiles'
        padding included (the function's: h * w * sum(phases))."""
        return self.blocks * self.rh * self.rw * sum(self.phases)


@functools.lru_cache(maxsize=64)
def sweep_plan(h: int, w: int, total: int, sms: int, k: int = SWEEP_K) -> SweepPlan:
    """floor_sweep's geometry for ``total`` sweeps of an (h, w) field on a
    GPU of ``sms`` SMs, ``k`` sweeps a phase (fewer if the run is shorter):
    of the regions (columns a multiple of 32, up to SWEEP_MAX_THREADS
    threads, SWEEP_ROWS rows a thread) whose tiles cover the field in at
    most ``sms`` blocks, one an SM, the smallest (the least work on the
    busiest SM); of equals the one with fewer rows a thread (more warps),
    then the widest. Raises where none does: the field outgrows what the
    grid holds on chip."""
    if total < 1 or k < 1:
        raise ValueError(f"floor_sweep needs total >= 1 and k >= 1, got {total}, {k}")
    k = min(k, total)
    best = None
    for r in SWEEP_ROWS:
        for rw in range(32, SWEEP_MAX_THREADS + 1, 32):
            for ny in range(1, SWEEP_MAX_THREADS // rw + 1):
                th, tw = ny * r - 2 * k, rw - 2 * k
                if th < 1 or tw < 1:
                    continue
                ty, tx = -(-h // th), -(-w // tw)
                if ty * tx > sms:
                    continue
                key = (rw * ny * r, r, -rw)
                if best is None or key < best[0]:
                    best = (key, r, rw, ny, ty, tx)
    if best is None:
        raise ValueError(f"a {h}x{w} field with {k}-deep halos does not fit {sms} blocks of "
                         f"{SWEEP_MAX_THREADS} threads x {max(SWEEP_ROWS)} rows on chip")
    _, r, rw, ny, ty, tx = best
    return SweepPlan(h, w, k, r, rw, ny, ty, tx, tuple(_jacobi.chunks(total, k)))


def run_taa(seed: torch.Tensor, idx: torch.Tensor, op: torch.Tensor, trips: int,
            plan: TaaPlan) -> torch.Tensor:
    """One floor_taa launch on ``plan``'s blocks (checked inputs)."""
    out = torch.empty_like(seed)
    FLOOR_TAA(ptr(seed), ptr(idx), ptr(op), ptr(out), trips, op.shape[0], idx.shape[0],
              plan.reps, plan.rows, plan.lanes, plan.words_b, plan.splits, plan.smem,
              stream(seed))
    return out


def taa(seed: torch.Tensor, idx: torch.Tensor, op: torch.Tensor, trips: int,
        reps: int) -> torch.Tensor:
    """plain.taa_plain on the card: seed (rows, lanes), idx (n_idx, rows,
    lanes), op (planes, rows + reps, lanes), all int32 words; one launch on
    taa_plan's blocks. No work (a size 0) is the seed, without a launch."""
    _check(torch.int32, seed, idx, op)
    rows, lanes = seed.shape
    if idx.shape[1:] != seed.shape or op.shape[1:] != (rows + reps, lanes):
        raise ValueError(f"seed {tuple(seed.shape)}, idx {tuple(idx.shape)}, op "
                         f"{tuple(op.shape)} with reps={reps}")
    if min(trips, reps, idx.shape[0], op.shape[0], rows, lanes) < 1:
        return seed.clone()
    plan = taa_plan(op.shape[0], idx.shape[0], reps, trips, rows, lanes,
                    build.sm_count(seed.device))
    return run_taa(seed, idx, op, trips, plan)


def run_roll(seed: torch.Tensor, op: torch.Tensor, plan: RollPlan) -> torch.Tensor:
    """One floor_roll launch on ``plan``'s blocks (checked inputs)."""
    out = torch.empty_like(seed)
    FLOOR_ROLL(ptr(seed), ptr(op), ptr(out), plan.planes, plan.nrk, plan.cbw, plan.trips,
               plan.r, plan.groups_b, plan.splits, plan.smem, stream(seed))
    return out


def roll(seed: torch.Tensor, op: torch.Tensor, trips: int) -> torch.Tensor:
    """plain.roll_plain on the card: seed, op (planes, nrk, cbw) int32
    words; one launch on roll_plan's blocks. No trips is the seed, without
    a launch."""
    _check(torch.int32, seed, op)
    if seed.shape != op.shape or op.ndim != 3:
        raise ValueError(f"seed {tuple(seed.shape)} / op {tuple(op.shape)}")
    if trips < 0:
        raise ValueError(f"roll needs trips >= 0, got {trips}")
    if trips == 0 or op.numel() == 0:
        return seed.clone()
    plan = roll_plan(*op.shape, trips, build.sm_count(seed.device))
    return run_roll(seed, op, plan)


def run_sweep(seed: torch.Tensor, x: torch.Tensor, plan: SweepPlan) -> torch.Tensor:
    """One floor_sweep launch of ``sum(plan.phases)`` sweeps on ``plan``'s
    geometry (checked inputs), the bands through two float32 buffers."""
    out = torch.empty_like(seed)
    band0, band1 = torch.empty_like(seed), torch.empty_like(seed)
    FLOOR_SWEEP(ptr(seed), ptr(x), ptr(band0), ptr(band1), ptr(out), plan.h, plan.w,
                sum(plan.phases), plan.k, plan.r, plan.rw, plan.ny, plan.tiles_y,
                plan.tiles_x, stream(seed))
    return out


def sweep(seed: torch.Tensor, x: torch.Tensor, chunks: int, sweeps: int) -> torch.Tensor:
    """plain.sweep_plain on the card, all chunks * sweeps sweeps in one
    cooperative launch on sweep_plan's geometry: seed, x (H, W) float32.
    Raises where the field does not fit on chip."""
    _check(torch.float32, seed, x)
    if seed.shape != x.shape or x.ndim != 2:
        raise ValueError(f"seed {tuple(seed.shape)} / x {tuple(x.shape)}")
    if chunks * sweeps < 1:
        raise ValueError("sweep needs chunks * sweeps >= 1")
    plan = sweep_plan(*x.shape, chunks * sweeps, build.sm_count(x.device))
    return run_sweep(seed, x, plan)


# ---- reference rates ---------------------------------------------------


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the profiling path measures a CUDA GPU and none is "
                           "available; it has no CPU mode")
    return torch.device("cuda")


def _event_rate(call, seed, scan_len: int = 10, reps: int = 3) -> float:
    """Seconds per ``call`` on the card: reps x scan_len calls queued behind
    a spin kernel (queued_ms), so that the host's launch cost is hidden, as
    in floors.py's lax.scan chain (_scan_rate, :72), which runs on the
    device. ``call`` maps carry -> carry: each call's output is the next
    call's seed."""
    box = [seed]

    def one():
        box[0] = call(box[0])

    return queued_ms(one, reps * scan_len, spin_rate()) / 1e3


def spin_rate() -> float:
    """GPU spin-kernel (torch.cuda._sleep) cycles per millisecond."""
    _require_cuda()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def queued_ms(fn, reps: int, cycles_per_ms: float) -> float:
    """Device ms of one fn() call: ``reps`` calls queued behind a spin
    kernel long enough to cover their enqueue, between CUDA events, so the
    host's launch cost is hidden. ``cycles_per_ms`` from spin_rate()."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(cycles_per_ms * (2 * enqueue_ms + 5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure_taa_row_rate(planes: int = 2, n_idx: int = 8, reps: int = 32,
                         trips: int = 8) -> float:
    """Reduced-structure gather reference: gathered (64, 128)-word rows/s of
    back-to-back gathers + accumulate, precomputed indices."""
    seed, idx, op = plain.taa_inputs(planes, n_idx, reps, device=_require_cuda())
    sec = _event_rate(lambda c: taa(c, idx, op, trips, reps), seed)
    return trips * reps * n_idx * planes * plain.ROWS / sec


def measure_roll_rate(planes: int, nrk: int, cbw: int, trips: int = 256) -> float:
    """Reduced-structure trip-staging reference: rolls/s of the
    (planes, nrk, cbw) operand by a varying amount, plus one accumulate."""
    seed, op = plain.roll_inputs(planes, nrk, cbw, device=_require_cuda())
    return trips / _event_rate(lambda c: roll(c, op, trips), seed)


def measure_sweep_rate(chunks: int = 16, sweeps: int = 20) -> float:
    """Reduced-structure sweep reference (cell-sweeps/s): the bare
    clamped-edge sweep chain on a (256, 1024) float32 field."""
    seed, x = plain.sweep_inputs(device=_require_cuda())
    h, w = x.shape
    return chunks * sweeps * h * w / _event_rate(lambda c: sweep(c, x, chunks, sweeps), seed)


def measure_hbm_bandwidth_gbps() -> float:
    """Achieved device-memory bandwidth (GB/s), the roofline denominator of
    bench.py:157: 20 in-place adds over a 256 MB float32 tensor, each reading
    and writing all of it, between CUDA events."""
    x = torch.ones((64, 1024, 1024), dtype=torch.float32, device=_require_cuda())
    nbytes = x.numel() * x.element_size()
    x.add_(1.0)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        x.add_(1.0)
    end.record()
    end.synchronize()
    return 2 * nbytes * 20 / (start.elapsed_time(end) / 1e3) / 1e9


# ---- work models of the port's kernels ---------------------------------


def gather_rows_per_step(config, velocity, dt) -> List[Tuple[float, int, int]]:
    """(taa_rows, channels, texels) of the velocity and the dye advection.

    The function's gather, whatever implements it: the 4 bilinear corners
    of every source channel for every target texel, and where the velocity
    lies on a coarser grid than the target (the demo's dye) the 4 corners of
    its 2 channels as well; words / 128 = rows. (csrc/advect.cu's dye
    kernel reads its corners from a window in shared memory where the
    window fits.) Every texel gathers the same, so unlike
    the TPU model (tile-picked trips over a displacement window,
    floors.py:232) the count depends on neither ``velocity`` nor ``dt``:
    they are taken for the signature's sake."""
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    out = []
    for h, w, c in ((sh, sw, 2), (dh, dw, 3)):
        words = 4 * c * h * w
        if (h, w) != (sh, sw):
            words += 4 * 2 * h * w
        out.append((words / plain.LANE, c, h * w))
    return out


def jacobi_cell_sweeps(config) -> int:
    """Cells x sweeps of the Jacobi solve per step as a function: H x W x
    iterations, no halo. The chunk kernels' halos and padding are reported
    apart (floor_report's "design", jacobi.design_cell_sweeps)."""
    sw, sh = config.sim_size
    return sw * sh * config.PRESSURE_ITERATIONS


def design_overhead(config, sms: int) -> dict:
    """What the port's kernels compute and move beyond the function's work
    per step on a GPU of ``sms`` SMs: the step's solve (its chunks and the
    fused jacobi_project, whose halo is one cell deeper) in cell-sweeps,
    halos and the last tiles' padding included, over the function's, and
    its launches; its bytes (every block's region of the pressure and the
    divergence, the float32 scratch between launches, the velocity once)
    beside the solve and gradient subtract's as a function. (The dye's
    windows are staged in shared memory: they add no bytes of device memory
    beyond the halos' second reads, which depend on the velocity:
    advect.dye_window_plan.)"""
    sw, sh = config.sim_size
    iters = config.PRESSURE_ITERATIONS
    item = torch.empty((), dtype=config.dtype).element_size()
    design = _jacobi.design_cell_sweeps(sh, sw, iters, sms, project=True)
    return {"jacobi_launches": len(_jacobi.plan(sh, sw, iters, sms, project=True)[1]),
            "jacobi_design_cell_sweeps": design,
            "jacobi_overcompute": round(design / (sw * sh * iters), 3) if iters else None,
            "jacobi_design_bytes": _jacobi.design_bytes(sh, sw, iters, sms, item),
            "jacobi_function_bytes": _jacobi.function_bytes(sh, sw, item)}


# ---- profiled step -----------------------------------------------------


def port_kernel(event_name: str) -> Optional[str]:
    """The build.KERNELS name of a profiler kernel event, or None for a
    kernel that is not the port's. Names come demangled with their template
    and parameter lists ("void advect_kernel<float>(float const*, ...)"):
    the stem before them is ``<name>_kernel`` (build.Kernel)."""
    name = event_name.strip()
    if name.startswith("void "):
        name = name[5:]
    stem = re.split(r"[<(\s]", name, maxsplit=1)[0]
    if stem.endswith("_kernel") and stem[:-len("_kernel")] in build.KERNELS:
        return stem[:-len("_kernel")]
    return None


def attribute_device_events(events: Iterable[Tuple[str, bool, float, float]],
                            launched: Dict[str, int], steps: int,
                            top_other: int = 6) -> Tuple[dict, dict]:
    """(kernel_times, other) in microseconds per step from profiler events
    ``(name, on_device, start_us, duration_us)`` of ``steps`` steps.

    kernel_times: velocity_gather (the advect launches) and dye_gather
    (advect_dye), jacobi (the chunks and the fused jacobi_project, which
    subtracts the gradient on the step's main path), stencil (pre_pressure)
    and gradient_subtract (the sharded step's standalone one). other: the
    device time of every other device event
    (PyTorch's own kernels, copies, fills), its ``top_other`` largest names,
    ``cuda_runtime_host_us``: the host time of the CUDA runtime calls the
    profiler recorded, synchronizations left out (the profiler inflates it;
    JAX's framework_events_us, device time in jit_/Module events, has no
    counterpart here), and each port kernel's
    event count and time. Raises if no kernel ran on the device, and if a
    kernel's event count differs from its launch count ``launched``."""
    events = list(events)
    device = sorted((e for e in events if e[1]), key=lambda e: e[2])
    if all(name.startswith(("Memcpy", "Memset")) for name, *_ in device):
        raise RuntimeError("the profiler recorded no CUDA kernel event")
    ours: Dict[str, List[float]] = {}
    other: Dict[str, float] = {}
    for name, _, _, dur in device:
        k = port_kernel(name)
        if k is None:
            other[name] = other.get(name, 0.0) + dur
            continue
        ours.setdefault(k, []).append(dur)
    counts = {k: len(v) for k, v in ours.items()}
    wrong = {k: (counts.get(k, 0), n) for k, n in launched.items() if counts.get(k, 0) != n}
    if wrong:
        raise AssertionError(f"profiler events != launches (events, launches): {wrong}")
    runtime = sum(dur for name, on_dev, _, dur in events
                  if not on_dev and name.startswith("cuda") and "Synchronize" not in name)

    def per_step(*names) -> float:
        return sum(sum(ours.get(n, [])) for n in names) / steps

    kernel_times = {
        "velocity_gather": per_step("advect"),
        "dye_gather": per_step("advect_dye"),
        "jacobi": per_step("jacobi_chunk", "jacobi_project"),
        "stencil": per_step("pre_pressure"),
        "gradient_subtract": per_step("gradient_subtract"),
    }
    top = sorted(other.items(), key=lambda kv: -kv[1])[:top_other]
    other_info = {
        "other_device_us": round(sum(other.values()) / steps, 1),
        "cuda_runtime_host_us": round(runtime / steps, 1),
        "top_other_ops": [{"op": n[:120], "us": round(v / steps, 1)} for n, v in top],
        "kernel_events": {k: {"events": len(v), "us": sum(v) / steps}
                          for k, v in sorted(ours.items())},
    }
    return kernel_times, other_info


# The profiled window's edges: torch.cuda._sleep's kernel, launched on the
# step's stream just before the first profiled step and just after the last.
MARKER = "spin_kernel"
EDGE_STEPS = 3      # steps traced before and after the window, not counted


def window_events(events: Iterable[Tuple[str, bool, float, float]]) -> list:
    """The events ``(name, on_device, start_us, duration_us)`` of a profiled
    window: the device events that ran between the two MARKER kernels (one
    stream runs in launch order, so these are the window's launches and no
    other), and the host events that started between the markers' launches
    (``profiled window`` record_function range). The profiler can miss
    device activity near the edges of its trace (once on the H100 at 4096^2:
    9 of 210 kernel events of a step profile traced from its first launch);
    the traced steps around the markers keep the window clear of the edges.
    Raises unless both markers and the range were recorded."""
    events = list(events)
    marks = sorted(e[2] for e in events if e[1] and MARKER in e[0])
    span = [e for e in events if not e[1] and e[0] == "profiled window"]
    if len(marks) != 2 or len(span) != 1:
        raise RuntimeError(f"profiled window not found: {len(marks)} marker kernels, "
                           f"{len(span)} window ranges")
    lo, hi = span[0][2], span[0][2] + span[0][3]
    return [e for e in events
            if (e[1] and marks[0] < e[2] < marks[1] and MARKER not in e[0])
            or (not e[1] and lo <= e[2] <= hi and e[0] != "profiled window")]


def profile_calls(call, calls: int, top_other: int = 6) -> tuple:
    """attribute_device_events of ``calls`` calls of ``call(t)`` on the card
    under torch.profiler (CPU and CUDA activities), over the window between
    two marker kernels with EDGE_STEPS traced calls on either side
    (window_events); the times are a call's. Raises if the profiler records
    no kernel, and if a kernel's events differ from its launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(EDGE_STEPS):
            call(t % calls)
        with record_function("profiled window"):
            torch.cuda._sleep(1)
            before = {k: v.launches for k, v in build.KERNELS.items()}
            for t in range(calls):
                call(t)
            launched = {k: v.launches - before[k] for k, v in build.KERNELS.items()}
            torch.cuda._sleep(1)
        for t in range(EDGE_STEPS):
            call(t % calls)
        torch.cuda.synchronize()
    events = [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
               e.time_range.elapsed_us()) for e in prof.events()]
    return attribute_device_events(window_events(events), launched, calls, top_other)


def profile_step_kernels(config, state, dt, steps: int = 30, top_other: int = 6) -> tuple:
    """(kernel_times, other) of ``steps`` calls of the real make_step on the
    card from ``state``, after one warm-up step, under torch.profiler
    (profile_calls): each kernel's own device time from its events'
    durations (see attribute_device_events). A batched state (fields with
    a leading B) runs make_batched_step, each sim its own trace, ``dt`` a
    number or (B,) per sim; the times are then a batched step's. A packed
    fleet's state (fields (C, H, B*W), W the config's sim width, B > 1)
    runs make_packed_step the same way, ``dt`` a number. The caller's state
    is not modified. Raises without a CUDA GPU or a CUDA state, and if the
    profiler records no kernel."""
    from tpufluid_torch.batch import make_batched_step
    from tpufluid_torch.batch_packed import make_packed_step

    device = _require_cuda()
    if not state.velocity.is_cuda:
        raise ValueError(f"state on {state.velocity.device}, the profile runs on the GPU")
    sim_w = config.sim_size[0]
    packed = state.velocity.ndim == 3 and state.velocity.shape[-1] != sim_w
    if state.velocity.ndim == 4 or packed:
        n = state.velocity.shape[-1] // sim_w if packed else state.velocity.shape[0]
        step = (make_packed_step(config, n, device=device) if packed
                else make_batched_step(config, device=device))
        batches = np.stack([swirl_trace(config, steps, seed=1 + i).batches
                            for i in range(n)], axis=1)
    else:
        step = make_step(config, device=device)
        batches = swirl_trace(config, steps, seed=1).batches
    batches = torch.as_tensor(batches, dtype=torch.float32, device=device)
    box = [step(state, dt, batches[0])]
    torch.cuda.synchronize()

    def one(t):
        box[0] = step(box[0], dt, batches[t])

    return profile_calls(one, steps, top_other)


def frame_breakdown(events: Iterable[Tuple[str, bool, float, float]],
                    ops: Iterable[Tuple[str, float]], launched: Dict[str, int], frames: int,
                    top_other: int = 8) -> dict:
    """Microseconds a frame from profiler events ``(name, on_device,
    start_us, duration_us)`` of ``frames`` frames and ``ops``, (PyTorch op,
    its own device microseconds) over the same frames: the whole device
    time, each port kernel's events and time, the rest of the device time
    and its ``top_other`` largest ops. Raises if no kernel ran on the
    device, and if a kernel's event count differs from its launch count
    ``launched``."""
    device = [e for e in events if e[1]]
    if all(name.startswith(("Memcpy", "Memset")) for name, *_ in device):
        raise RuntimeError("the profiler recorded no CUDA kernel event")
    ours: Dict[str, List[float]] = {}
    for name, _, _, dur in device:
        k = port_kernel(name)
        if k is not None:
            ours.setdefault(k, []).append(dur)
    wrong = {k: (len(ours.get(k, [])), n) for k, n in launched.items()
             if len(ours.get(k, [])) != n}
    if wrong:
        raise AssertionError(f"profiler events != launches (events, launches): {wrong}")
    total = sum(e[3] for e in device)
    mine = sum(sum(v) for v in ours.values())
    top = sorted(((n, us) for n, us in ops if us > 0), key=lambda kv: -kv[1])[:top_other]
    return {
        "frame_device_us": round(total / frames, 1),
        "kernel_events": {k: {"events": len(v), "us": sum(v) / frames}
                          for k, v in sorted(ours.items())},
        "other_device_us": round((total - mine) / frames, 1),
        "top_other_ops": [{"op": n[:120], "us": round(us / frames, 1)} for n, us in top],
    }


def profile_frame_kernels(config, state, frames: int = 30, top_other: int = 8) -> dict:
    """frame_breakdown of ``frames`` calls of the real make_render on the
    card from ``state`` (a batched state renders as a batch: a frame is then
    one of all B sims), after one warm-up frame, under torch.profiler (CPU
    and CUDA activities): the render kernels' own device
    time a frame from their events over the window between two marker
    kernels with EDGE_STEPS traced frames on either side (window_events; the
    profiler lost one of 30 pyramid events of a batched frame profile traced
    from its first launch on the H100), and the rest of the frame's device
    time by the PyTorch op that launched it (its self device time, averaged
    over every traced frame). Raises without a CUDA GPU or a CUDA state, and
    if the profiler records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpufluid_torch.render import make_render

    device = _require_cuda()
    if not state.dye.is_cuda:
        raise ValueError(f"state on {state.dye.device}, the profile runs on the GPU")
    render = make_render(config, device=device)
    render(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(EDGE_STEPS):
            render(state)
        with record_function("profiled window"):
            torch.cuda._sleep(1)
            before = {k: v.launches for k, v in build.KERNELS.items()}
            for _ in range(frames):
                render(state)
            launched = {k: v.launches - before[k] for k, v in build.KERNELS.items()}
            torch.cuda._sleep(1)
        for _ in range(EDGE_STEPS):
            render(state)
        torch.cuda.synchronize()
    events = [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
               e.time_range.elapsed_us()) for e in prof.events()]
    traced = frames + 2 * EDGE_STEPS
    ops = [(row.key, float(getattr(row, "self_device_time_total", 0.0)) * frames / traced)
           for row in prof.key_averages() if row.device_type == DeviceType.CPU]
    return frame_breakdown(window_events(events), ops, launched, frames, top_other)


# ---- the report --------------------------------------------------------


def floor_table(measured: dict, other_info: dict, gathers, cell_sweeps: int,
                stencil_bytes: int, taa_rate: float, sweep_rate: float,
                device_bw_gbps: float, measured_steps_per_s: float,
                design: Optional[dict] = None) -> dict:
    """The floor report's arithmetic (floors.py:506-569 without the TPU
    projection), from measured per-step kernel microseconds, the work
    models, the reference rates (rows/s, cell-sweeps/s), the device's
    bandwidth and the measured step rate. ``design``, where given, is the
    kernels' own work beyond the function's (design_overhead), carried
    into the report as it is."""
    out = {} if design is None else {"design": design}
    for name, geo in zip(("velocity_gather", "dye_gather"), gathers):
        rows = geo[0]
        m = measured.get(name, 0.0)
        achieved = rows / m if m else None
        out[name] = {
            "measured_us": round(m, 1),
            "taa_rows": rows,
            "achieved_rows_per_us": round(achieved, 1) if achieved else None,
            "reference_rows_per_us": round(taa_rate / 1e6, 1),
            "advantage": round(achieved * 1e6 / taa_rate, 2) if achieved else None,
        }
    m = measured.get("jacobi", 0.0)
    achieved = cell_sweeps / m / 1e3 if m else None  # Gcell-sweeps/s
    out["jacobi"] = {
        "measured_us": round(m, 1),
        "cell_sweeps": cell_sweeps,
        "achieved_gcells_per_s": round(achieved, 1) if achieved else None,
        "reference_gcells_per_s": round(sweep_rate / 1e9, 1),
        "advantage": round(achieved * 1e9 / sweep_rate, 2) if achieved else None,
    }
    # The fused pre-pressure stencil as a function streams 5 planes (read
    # velocity, write velocity and divergence): its HBM time is a companion
    # to its measured time, one launch a step.
    out["stencil"] = {"occupancy_us": round(measured.get("stencil", 0.0), 1),
                      "hbm_stream_us": round(stencil_bytes / (device_bw_gbps * 1e3), 1)}
    step_us = 1e6 / measured_steps_per_s
    tot_m = sum(measured.values())
    # Device time that is neither the port's kernels nor other device ops
    # is glue and idle: the host's share of the step.
    other_dev = other_info["other_device_us"]
    out["other"] = dict(
        other_info,
        glue_idle_us=round(max(step_us - tot_m - other_dev, 0.0), 1),
        attributed_coverage=round(min((tot_m + other_dev) / step_us, 1.0), 3),
    )
    out.update({
        "kernel_total_us": round(tot_m, 1),
        "step_us": round(step_us, 1),
        "step_coverage": round(tot_m / step_us, 3),
    })
    return out


def floor_report(config, state, dt, device_bw_gbps: float,
                 measured_steps_per_s: float) -> dict:
    """Per-kernel evidence table for one step at ``state`` (a CUDA state):
    profiled in-step microseconds, achieved rates against the reference
    rates, the HBM time of the streaming stencil, and the step's coverage
    at ``measured_steps_per_s``."""
    measured, other_info = profile_step_kernels(config, state, dt)
    sw, sh = config.sim_size
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    return floor_table(measured, other_info,
                       gather_rows_per_step(config, state.velocity, float(dt)),
                       jacobi_cell_sweeps(config), 5 * sw * sh * itemsize,
                       measure_taa_row_rate(), measure_sweep_rate(),
                       device_bw_gbps, measured_steps_per_s,
                       design_overhead(config, build.sm_count(state.velocity.device)))
