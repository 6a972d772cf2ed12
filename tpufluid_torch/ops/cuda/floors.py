"""The profiling path: the three microbenchmark kernels (csrc/floors.cu), the
reference rates they give, a torch.profiler breakdown of the real step by
kernel, and the floor report that puts the two side by side.

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

import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from tpufluid_torch.ops import floors as plain
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.ops.cuda.build import I, P, Kernel, ptr, stream
from tpufluid_torch.step import make_step
from tpufluid_torch.trace import swirl_trace

FLOOR_TAA = Kernel("floor_taa", "floors", "floor_taa", [P, P, P, P, I, I, I, I, I, I, P],
                   replaces="tpufluid/ops/pallas/floors.py:92")
FLOOR_ROLL = Kernel("floor_roll", "floors", "floor_roll", [P, P, P, I, I, I, I, P],
                    replaces="tpufluid/ops/pallas/floors.py:133")
FLOOR_SWEEP = Kernel("floor_sweep", "floors", "floor_sweep", [P, P, P, P, P, I, I, I, P],
                     replaces="tpufluid/ops/pallas/floors.py:163")


def _check(dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"kernel input on {t.device}, expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"kernel takes {dtype}, got {t.dtype}")


def taa(seed: torch.Tensor, idx: torch.Tensor, op: torch.Tensor, trips: int,
        reps: int) -> torch.Tensor:
    """plain.taa_plain on the card: seed (rows, lanes), idx (n_idx, rows,
    lanes), op (planes, rows + reps, lanes), all int32 words."""
    _check(torch.int32, seed, idx, op)
    rows, lanes = seed.shape
    if idx.shape[1:] != seed.shape or op.shape[1:] != (rows + reps, lanes):
        raise ValueError(f"seed {tuple(seed.shape)}, idx {tuple(idx.shape)}, op "
                         f"{tuple(op.shape)} with reps={reps}")
    out = torch.empty_like(seed)
    FLOOR_TAA(ptr(seed), ptr(idx), ptr(op), ptr(out), trips, op.shape[0], idx.shape[0],
              reps, rows, lanes, stream())
    return out


def roll(seed: torch.Tensor, op: torch.Tensor, trips: int) -> torch.Tensor:
    """plain.roll_plain on the card: seed, op (planes, nrk, cbw) int32 words."""
    _check(torch.int32, seed, op)
    if seed.shape != op.shape or op.ndim != 3:
        raise ValueError(f"seed {tuple(seed.shape)} / op {tuple(op.shape)}")
    out = torch.empty_like(seed)
    FLOOR_ROLL(ptr(seed), ptr(op), ptr(out), *op.shape, trips, stream())
    return out


def sweep(seed: torch.Tensor, x: torch.Tensor, chunks: int, sweeps: int) -> torch.Tensor:
    """plain.sweep_plain on the card, all chunks * sweeps sweeps in one
    cooperative launch: seed, x (H, W) float32."""
    _check(torch.float32, seed, x)
    if seed.shape != x.shape or x.ndim != 2:
        raise ValueError(f"seed {tuple(seed.shape)} / x {tuple(x.shape)}")
    if chunks * sweeps < 1:
        raise ValueError("sweep needs chunks * sweeps >= 1")
    out = torch.empty_like(seed)
    buf0, buf1 = torch.empty_like(seed), torch.empty_like(seed)
    FLOOR_SWEEP(ptr(seed), ptr(x), ptr(buf0), ptr(buf1), ptr(out), *x.shape,
                chunks * sweeps, stream())
    return out


# ---- reference rates ---------------------------------------------------


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the profiling path measures a CUDA GPU and none is "
                           "available; it has no CPU mode")
    return torch.device("cuda")


def _event_rate(call, seed, scan_len: int = 10, reps: int = 3) -> float:
    """Seconds per ``call`` on the card, from CUDA events around reps x
    scan_len calls after scan_len warm-up calls. ``call`` maps carry ->
    carry: each call's output is the next call's seed, as in floors.py's
    lax.scan chain (_scan_rate, :72)."""
    out = seed
    for _ in range(scan_len):
        out = call(out)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps * scan_len):
        out = call(out)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / (reps * scan_len)


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

    The port's advect kernel (csrc/advect.cu) reads the 4 bilinear corners
    of every source channel for every target texel, and where the velocity
    lies on a coarser grid than the target (the demo's dye) the 4 corners of
    its 2 channels as well; words / 128 = rows. Every texel gathers the
    same, so unlike the TPU model (tile-picked trips over a displacement
    window, floors.py:232) the count depends on neither ``velocity`` nor
    ``dt``: they are taken for the signature's sake."""
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
    """Cells x sweeps the Jacobi kernel computes per step: one launch per
    sweep over the H x W grid, no halo and no overcompute."""
    sw, sh = config.sim_size
    return sw * sh * config.PRESSURE_ITERATIONS


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

    kernel_times: velocity_gather and dye_gather (the step's first and
    second advect launch, told apart by their order on the device),
    jacobi (the sweeps), stencil (splat_curl + confine_divergence) and
    gradient_subtract. other: the device time of every other device event
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
        else:
            ours.setdefault(k, []).append(dur)
    counts = {k: len(v) for k, v in ours.items()}
    wrong = {k: (counts.get(k, 0), n) for k, n in launched.items() if counts.get(k, 0) != n}
    if wrong:
        raise AssertionError(f"profiler events != launches (events, launches): {wrong}")
    runtime = sum(dur for name, on_dev, _, dur in events
                  if not on_dev and name.startswith("cuda") and "Synchronize" not in name)

    def per_step(*names, part=slice(None)) -> float:
        return sum(sum(ours.get(n, [])[part]) for n in names) / steps

    kernel_times = {
        "velocity_gather": per_step("advect", part=slice(0, None, 2)),
        "dye_gather": per_step("advect", part=slice(1, None, 2)),
        "jacobi": per_step("jacobi_sweep"),
        "stencil": per_step("splat_curl", "confine_divergence"),
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


def profile_step_kernels(config, state, dt, steps: int = 30, top_other: int = 6) -> tuple:
    """(kernel_times, other) of ``steps`` calls of the real make_step on the
    card from ``state``, after one warm-up step, under torch.profiler (CPU
    and CUDA activities): each kernel's own device time from its events'
    durations (see attribute_device_events). The caller's state is not
    modified. Raises without a CUDA GPU or a CUDA state, and if the
    profiler records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = _require_cuda()
    if not state.velocity.is_cuda:
        raise ValueError(f"state on {state.velocity.device}, the profile runs on the GPU")
    step = make_step(config, device=device)
    trace = swirl_trace(config, steps, seed=1)
    batches = torch.as_tensor(trace.batches, dtype=torch.float32, device=device)
    s = step(state, dt, batches[0])
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in build.KERNELS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            s = step(s, dt, batches[t])
        torch.cuda.synchronize()
    launched = {k: v.launches - before[k] for k, v in build.KERNELS.items()}
    events = [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
               e.time_range.elapsed_us()) for e in prof.events()]
    return attribute_device_events(events, launched, steps, top_other)


# ---- the report --------------------------------------------------------


def floor_table(measured: dict, other_info: dict, gathers, cell_sweeps: int,
                stencil_bytes: int, taa_rate: float, sweep_rate: float,
                device_bw_gbps: float, measured_steps_per_s: float) -> dict:
    """The floor report's arithmetic (floors.py:506-569 without the TPU
    projection), from measured per-step kernel microseconds, the work
    models, the reference rates (rows/s, cell-sweeps/s), the device's
    bandwidth and the measured step rate."""
    out = {}
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
    # to its measured time, which the port spends in two launches.
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
                       device_bw_gbps, measured_steps_per_s)
