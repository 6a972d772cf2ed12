"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

Everything a cell is comes from files found by name: the cell's entry in
BENCHMARK.json, its configuration (``configs/<config>.json``), its traffic
mix (``traffic/<traffic>.json``), the limits of its comparison
(``limits/<cell>.json``), the per-layer readers (``metrics/``) and the
passes' work models (``work/``).

The window. Set-up makes the state (zeros) and the traffic from the seed,
runs the cell's first call from the zero state (kept as the comparison's
start) and warm-up calls of the same shapes, and ends at a device sync.
The window then issues calls back to back, each as soon as the last
returned, until ``seconds`` have passed, and closes at a sync after the
last call. A call's time runs from the call to its result: a chunk's
return, a tick's frames complete on the card. The calls at three times
drawn from the seed copy their input and output states (and frames) into
buffers that set-up allocated, so that keeping them allocates nothing in
the window; the last call keeps its own by reference.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufluid")
SAMPLES = 3


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    cfg: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    run_seconds: int

    @property
    def unit(self) -> str:
        return "tick" if self.mix["entry"] == "tick" else "step"


def _applies(metric: Dict, cell: str, bench: Dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(m["name"] == moves and _applies(m, cell, bench) for m in bench["end_to_end"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(name, w, load_json(root / conf["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if _applies(m, name, bench)],
                [m for m in bench["per_layer"] if _applies(m, name, bench)],
                bench["run_seconds"])


@dataclasses.dataclass
class Sample:
    label: str
    t: int
    before: object
    after: object
    frames: Optional[object]


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float
    call_s: List[float]
    host_s: float


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def like(x):
    """Uninitialised buffers shaped as ``x``: a tensor, a state or None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x)
    if isinstance(x, dict):
        return {k: like(v) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: like(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def copy_into(dst, src):
    """``src`` copied into the buffers ``dst`` (like's), on the stream."""
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
    elif isinstance(src, dict):
        for k in src:
            copy_into(dst[k], src[k])
    elif src is not None:
        for f in dataclasses.fields(src):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
    return dst


def measure(prog, state, t: int, seconds: float, sample_at: List[float], keep: List[Sample],
            buffers: List[Sample]):
    """The measured window from traffic row ``t``: (state, next row, Window).
    The k-th drawn call is copied into ``buffers[k]``."""
    stride, length = prog.steps, prog.traffic.splats.shape[0]
    pending = sorted(sample_at)
    call_s: List[float] = []
    host_s, last = 0.0, None
    _sync(prog.device)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        new, frames = prog.call(state, t)
        call_s.append(time.perf_counter() - a)
        host_s += prog.host_s
        last = Sample("window", t, state, new, frames)
        if pending and a - t0 >= pending[0]:
            while pending and a - t0 >= pending[0]:
                pending.pop(0)
            b = buffers.pop(0)
            keep.append(Sample("window", t, copy_into(b.before, state), copy_into(b.after, new),
                               copy_into(b.frames, frames)))
        state, t = new, (t + stride) % length
    _sync(prog.device)
    elapsed = time.perf_counter() - t0
    if last is not None:
        last.label = "last"
        keep.append(last)
    return state, t, Window(len(call_s), elapsed, call_s, host_s)


def end_to_end(cell: Cell, w: Window, setup_s: float) -> Dict[str, Dict]:
    """The cell's end-to-end metrics from the host clock."""
    sims, steps = cell.mix["sims"], cell.mix.get("chunk", 1)
    values = {"setup_s": setup_s,
              "sim_steps_per_s": w.calls * steps * sims / w.seconds,
              "sim_frames_per_s": w.calls * sims / w.seconds,
              "tick_ms_p95": 1e3 * float(np.percentile(w.call_s, 95)) if w.call_s else math.nan}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def unit_shape(cell: Cell, rows: List[int], traffic, item: int):
    """work.Shape of one unit of the calls at traffic ``rows``."""
    from fluidbench.work import Shape

    steps = cell.mix.get("chunk", 1)
    active = [int((traffic.splats[r:r + steps, ..., 7] != 0).sum()) for r in rows]
    if cell.unit == "step":
        return Shape(cell.cfg, cell.mix["sims"], item, 1, sum(active) / (len(rows) * steps), 0)
    return Shape(cell.cfg, cell.mix["sims"], item, int(traffic.substeps.max()),
                 sum(active) / len(rows), 1)


def _device_mallocs(device) -> int:
    """The caching allocator's calls to cudaMalloc so far."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("num_device_alloc", 0))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_program: Optional[Callable] = None, log=sys.stderr) -> Dict:
    """One run; returns the result line's object. ``make_program`` replaces
    the program (the control, or a broken program in the tests)."""
    from fluidbench import check, devtrace, metrics, program
    from fluidbench.traffic.generator import generate

    seed = int(seed) % (1 << 63)
    traffic = generate(cell.mix, cell.cfg, seed)
    prog = (make_program or program.Program)(cell.cfg, cell.mix, traffic, device)
    stride, length = prog.steps, traffic.splats.shape[0]
    draw = np.random.default_rng([seed, 3])
    sample_at = sorted((draw.random(SAMPLES) * seconds).tolist())

    state = prog.init()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    new, frames = prog.call(state, 0)
    keep = [Sample("start", 0, state, new, frames)]
    state, t = new, stride % length
    buffers = [Sample("buffer", 0, like(state), like(new), like(frames))
               for _ in range(SAMPLES)]
    for _ in range(cell.mix["warm_calls"]):
        new, frames = prog.call(state, t)
        # Held as the window holds its last call, so that the allocator's
        # pool has the window's blocks before the window.
        held = (state, new, frames)
        state, t = new, (t + stride) % length
    del held
    _sync(device)
    setup_s = time.perf_counter() - t_start

    mallocs = _device_mallocs(device)
    state, t, window = measure(prog, state, t, seconds, sample_at, keep, buffers)
    q = np.percentile(window.call_s, [5, 50, 95, 100]) * 1e3 if window.call_s else [math.nan] * 4
    print(f"window {window.calls} calls in {window.seconds!r} s; call ms p5 {q[0]:.3f} median "
          f"{q[1]:.3f} p95 {q[2]:.3f} max {q[3]:.3f}; device allocations in it "
          f"{_device_mallocs(device) - mallocs}; setup {setup_s!r} s", file=log)
    out = {"metrics": end_to_end(cell, window, setup_s)}
    units_per_call = stride if cell.unit == "step" else 1
    spans = {"host_s": window.host_s, "units": window.calls * units_per_call,
             "window_s": window.seconds}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": program.device_name(device), "count": 1}
    breakdown = None
    if trace:
        n = cell.mix["trace_calls"]
        rows: List[int] = []
        box = [state, t]

        def call():
            rows.append(box[1])
            box[0], _ = prog.call(box[0], box[1])
            box[1] = (box[1] + stride) % length

        events = (devtrace.profile if device.type == "cuda" else devtrace.profile_cpu)(call, n)
        rows = rows[devtrace.EDGE:devtrace.EDGE + n]
        state = box[0]
        d = devtrace.digest(events, n * units_per_call, cell.unit)
        if spans["units"]:
            # The profiler's own host cost slows the traced window; the
            # readers of idle time and of the peak's share use the measured
            # window's time a unit instead.
            print(f"traced window {d.window_us * 1e-3 / d.units!r} ms a {cell.unit}; measured "
                  f"window {1e3 * window.seconds / spans['units']!r}", file=log)
        item = torch.empty((), dtype=prog.config.dtype).element_size()
        ctx = {"digest": d, "shape": unit_shape(cell, rows, traffic, item),
               "peaks": load_json(HERE / "peaks.json"), "spans": spans}
        out["metrics"] = {}
        for m in cell.per_layer:
            v = metrics.read(m["name"], ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = d.busy_us() * 1e-6
        dev["window_s"] = d.window_us * 1e-6
        breakdown = devtrace.breakdown(d)
    if device.type == "cuda":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    del state, new, prog
    program.release()

    readings, failed = check.compare(cell, traffic, keep, device, log=log)
    limits = {k: cell.limits[k] for k in readings}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in readings.items())
    result = {"correct": correct, "attempted": window.calls, "failed": failed,
              "metrics": out["metrics"], "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    return result


def report(result: Dict, log=sys.stderr) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    log.flush()
    print(json.dumps(result), flush=True)
