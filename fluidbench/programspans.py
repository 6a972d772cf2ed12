"""The program's own spans beside the device trace.

The program records spans at its pass boundaries (``tpufluid_torch.spans``:
each span's name, start and end in ``time.perf_counter_ns``, its parent and
its root, and the program's kernel launches inside it but not inside a
child). This module takes them as plain records and does what a cell's
traced run needs of them:

- ``profile`` / ``profile_cpu``: devtrace's traced window, with the host
  clock stamped just before and just after the two marker launches and a
  few runtime calls on either side of the window, and each device event
  tied to the runtime call that launched it (by the profiler's correlation
  id, else by launch order on the one stream);
- ``Clock``: the spans put on the profiler's clock from the stamps;
- ``Timeline``: the innermost span at each moment of the host's clock;
- ``attribute``: each kernel, copy and fill put down to the span its launch
  fell in, and each idle gap to the span its middle fell in; time in no
  span is ``outside`` (the harness between calls, its sync after a tick);
- ``breakdown``: devtrace.breakdown with each idle gap named by its span;
- ``context``: what the readers ``metrics/span_*.py`` read, under the
  readers' context key ``program_spans``.

Nothing here imports the program: the recorder is passed in (an object
with ``enable(capacity)``, ``disable()``, ``take()`` and ``dropped()``).
The ``run`` function drives one cell with the recorder on through a traced
window and a span window (the recorder on and off in turns);
``tpufluid_torch/tools/span_window.py`` runs it
on the card.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fluidbench import devtrace
from fluidbench.devtrace import EDGE, MARKER, OUTSIDE, Digest, Event

HERE = Path(__file__).resolve().parent
OUTSIDE_SPAN = "outside"
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
CAPACITY = 1 << 18
TURNS = 4               # the span window's turns with the recorder on (and off)


QUERIES = 8


@dataclasses.dataclass
class Traced:
    """A traced window's events, each device event's launch, and the host
    clock's brackets.

    ``launch`` maps a device event's start (µs, the profiler's clock) to the
    middle of the runtime call that launched it. ``brackets`` holds two
    groups, one before the window and one after it, of (host clock ns just
    before a runtime call, just after it, the call's start and end on the
    profiler's clock in µs). ``window`` is the two markers' launches (µs)."""

    events: List[Event]
    launch: Dict[float, float]
    brackets: List[List[Tuple[int, int, float, float]]]
    window: Tuple[float, float]
    unmatched: int = 0


def _launches(prof_events, device_type_cuda) -> Tuple[List[Event], Dict[float, Event], int]:
    """devtrace.profile's events from the profiler's, and each device
    event's launching runtime call: by correlation id, else by order."""
    events, calls, device = [], {}, []
    for e in prof_events:
        ev = Event(e.name, e.device_type == device_type_cuda, float(e.time_range.start),
                   float(e.time_range.elapsed_us()))
        events.append(ev)
        if ev.device:
            device.append((ev, e.id))
        elif e.name.startswith(LAUNCH_CALLS):
            calls.setdefault(e.id, ev)
    launch, left = {}, []
    for ev, cid in device:
        if cid in calls:
            launch[ev.start] = calls.pop(cid)
        else:
            left.append(ev)
    # Launch order on the one stream for what the ids did not tie.
    rest = sorted(calls.values(), key=lambda e: e.start)
    for ev, call in zip(sorted(left, key=lambda e: e.start), rest):
        launch[ev.start] = call
    return events, launch, max(0, len(left) - len(rest))


def profile(call: Callable[[], None], calls: int,
            clock: Callable[[], int] = time.perf_counter_ns) -> Traced:
    """devtrace.profile's window (the device and the CUDA runtime), the
    host clock stamped around each marker's launch and around QUERIES
    stream queries (cudaStreamQuery, which waits for nothing) on either
    side of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    def stamped(fn):
        a = clock()
        fn()
        return a, clock()

    def marker():
        torch.cuda._sleep(1000)

    query = torch.cuda.current_stream().query
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(EDGE):
            call()
        before = [stamped(query) for _ in range(QUERIES)] + [stamped(marker)]
        for _ in range(calls):
            call()
        after = [stamped(marker)] + [stamped(query) for _ in range(QUERIES)]
        for _ in range(EDGE):
            call()
        torch.cuda.synchronize()
    events, launch, unmatched = _launches(prof.events(), DeviceType.CUDA)
    marks = sorted((e for e in events if e.device and MARKER in e.name), key=lambda e: e.start)
    if len(marks) != 2 or any(m.start not in launch for m in marks):
        raise RuntimeError("the markers' launches were not found in the trace")
    m1, m2 = (launch[m.start] for m in marks)
    queries = sorted((e for e in events if not e.device and e.name == "cudaStreamQuery"),
                     key=lambda e: e.start)
    if len(queries) != 2 * QUERIES:     # the program queried too: the markers alone
        before, after, queries = before[-1:], after[:1], []
    groups = [list(zip(before, queries[:len(before) - 1] + [m1])),
              list(zip(after, [m2] + queries[len(before) - 1:]))]
    return Traced(events, {k: v.start + 0.5 * v.dur for k, v in launch.items()},
                  [[(a, b, e.start, e.start + e.dur) for (a, b), e in g] for g in groups],
                  (m1.start, m2.start), unmatched)


def profile_cpu(call: Callable[[], None], calls: int,
                clock: Callable[[], int] = time.perf_counter_ns) -> Traced:
    """devtrace.profile_cpu's window for rehearsals: each outermost PyTorch
    operator stands in for a device event launched where it starts; the
    markers are host ranges, each begun between two stamps."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    stamps = []
    with _profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(EDGE):
            call()
        for k in range(2):
            a = clock()
            with record_function(MARKER):
                stamps.append((a, clock()))
            for _ in range(calls if k == 0 else EDGE):
                call()
    events = []
    for e in prof.events():
        parent = e.cpu_parent
        outer = e.name.startswith("aten::") and (parent is None
                                                 or not parent.name.startswith("aten::"))
        events.append(Event(e.name, outer or e.name == MARKER, float(e.time_range.start),
                            float(e.time_range.elapsed_us())))
    marks = sorted((e for e in events if e.name == MARKER), key=lambda e: e.start)
    return Traced(events, {e.start: e.start for e in events if e.device},
                  [[(a, b, m.start, m.start)] for (a, b), m in zip(stamps, marks)],
                  (marks[0].start, marks[1].start))


class Clock:
    """The host clock (ns) on the profiler's clock (µs). Each bracketed
    runtime call began after its first stamp and ended before its second,
    so at each end of the window the offset lies in the range every
    bracket there allows; the clock takes the middle of each end's range
    and draws a line between the two. ``err_us`` is half the wider range
    (where a range is empty, half its shortfall); ``drift_us`` how far the
    two ends' offsets differ."""

    def __init__(self, groups: Sequence[Sequence[Tuple[int, int, float, float]]]):
        self.t, self.off, widths = [], [], []
        for g in groups:
            lo = max(e - b * 1e-3 for a, b, s, e in g)
            hi = min(s - a * 1e-3 for a, b, s, e in g)
            self.t.append(sum(a for a, b, s, e in g) * 1e-3 / len(g))
            self.off.append(0.5 * (lo + hi))
            widths.append(abs(hi - lo))
        self.err_us = 0.5 * max(widths)
        self.drift_us = self.off[-1] - self.off[0]

    def __call__(self, ns: int) -> float:
        t = ns * 1e-3
        (t1, t2), (o1, o2) = (self.t[0], self.t[-1]), (self.off[0], self.off[-1])
        return t + o1 + ((o2 - o1) * (t - t1) / (t2 - t1) if t2 > t1 else 0.0)


@dataclasses.dataclass
class OnClock:
    """A program span on the profiler's clock (µs)."""

    name: str
    start: float
    end: float
    id: int
    parent: int
    root: int
    thread: int
    launches: int


def on_clock(spans, clock: Callable[[int], float]) -> List[OnClock]:
    return [OnClock(s.name, clock(s.start_ns), clock(s.end_ns), s.id, s.parent, s.root,
                    s.thread, s.launches) for s in spans]


class Timeline:
    """The innermost open span at each moment, of spans that nest (one
    thread's): a list of segments, each a start and the span's name."""

    def __init__(self, spans: Sequence[OnClock]):
        edges = []
        for s in spans:
            edges.append((s.start, 1, -s.end, s.name))
            edges.append((s.end, 0, 0.0, s.name))
        edges.sort()
        self.starts: List[float] = []
        self.names: List[str] = []
        stack: List[str] = []
        for t, opens, _, name in edges:
            if opens:
                stack.append(name)
            else:
                stack.pop()
            self.starts.append(t)
            self.names.append(stack[-1] if stack else OUTSIDE_SPAN)

    def at(self, t: float) -> str:
        """The innermost span open at ``t``, or ``outside``."""
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 else OUTSIDE_SPAN

    def margin(self, t: float) -> float:
        """How far ``t`` lies from the nearest change of the innermost span."""
        i = bisect.bisect_right(self.starts, t)
        near = self.starts[max(0, i - 1):i + 1]
        return min(abs(t - x) for x in near) if near else float("inf")


def attribute(d: Digest, line: Timeline, launch: Dict[float, float],
              port: Callable[[str], bool]) -> Dict[str, Dict[str, float]]:
    """Per span name (and ``outside``): the kernels whose launch fell while
    it was innermost (``launches``, of them the program's own, ``port``),
    the device µs of the kernels, copies and fills issued there
    (``device_us``), and the idle µs whose middle fell there (``idle_us``)."""
    out: Dict[str, Dict[str, float]] = {}

    def row(name):
        return out.setdefault(name, {"launches": 0, "port": 0, "device_us": 0.0, "idle_us": 0.0})

    for e in d.device:
        r = row(line.at(launch.get(e.start, e.start)))
        r["device_us"] += e.dur
        if devtrace.kind(e.name) == "kernel":
            r["launches"] += 1
            r["port"] += bool(port(e.name))
    for a, b in d.gaps():
        row(line.at(0.5 * (a + b)))["idle_us"] += b - a
    row(OUTSIDE_SPAN)
    return out


def counted(spans: Sequence[OnClock], lo: float, hi: float) -> Dict[str, int]:
    """The program's own count of its launches by span name, over the spans
    whose root began in [lo, hi): the calls of the traced window."""
    roots = {s.id for s in spans if s.parent == 0 and lo <= s.start < hi}
    out: Dict[str, int] = {}
    for s in spans:
        if s.root in roots:
            out[s.name] = out.get(s.name, 0) + s.launches
    return out


def breakdown(d: Digest, line: Optional[Timeline], top: int = 10) -> Dict:
    """devtrace.breakdown, each idle gap inside a program span named
    ``<span> / <runtime call>`` or ``<span> / (host outside the CUDA
    runtime)`` by the innermost span at its middle. Without spans it is
    devtrace.breakdown's."""
    if line is None:
        return devtrace.breakdown(d, top)
    ops: Dict[str, float] = {}
    for e in d.device:
        ops[e.name] = ops.get(e.name, 0.0) + e.dur
    host = sorted(d.host, key=lambda e: e.start)
    starts = [e.start for e in host]
    idle: Dict[str, float] = {}
    for a, b in d.gaps():
        t = 0.5 * (a + b)
        j = k = bisect.bisect_right(starts, t) - 1
        while j >= 0 and k - j < devtrace.SCAN and host[j].start + host[j].dur < t:
            j -= 1
        call = host[j].name if j >= 0 and host[j].start + host[j].dur >= t else OUTSIDE
        where = line.at(t)
        name = call if where == OUTSIDE_SPAN else f"{where} / {call}"
        idle[name] = idle.get(name, 0.0) + (b - a)

    def ranked(x):
        return [[k[:120], v * 1e-6] for k, v in sorted(x.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def host_ms(spans, units: int) -> Dict[str, float]:
    """Host ms a unit inside each span name, children included."""
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
    return {k: v / units for k, v in out.items()} if units else {}


def context(d: Digest, traced: Traced, spans, window_spans, window_units: int,
            port: Callable[[str], bool]) -> Dict:
    """What the span readers read (``ctx["program_spans"]``): host ms a
    unit by span from the span window, and launches, device ms and idle ms
    a unit by span from the traced window; with the checks that the
    attribution closes."""
    clock = Clock(traced.brackets)
    main = on_clock(spans, clock)
    line = Timeline(main)
    lo, hi = traced.window
    att = attribute(d, line, traced.launch, port)
    own = counted(main, lo, hi)
    u = d.units
    return {
        "names": sorted({s.name for s in main} | set(att)),
        "host_ms": host_ms(window_spans, window_units),
        "launches": {k: v["launches"] / u for k, v in att.items()},
        "device_ms": {k: v["device_us"] * 1e-3 / u for k, v in att.items()},
        "idle_ms": {k: v["idle_us"] * 1e-3 / u for k, v in att.items()},
        "align_err_us": clock.err_us,
        "drift_us": clock.drift_us,
        # The least distance from a launch of the program's own kernels to
        # a change of innermost span: alignment errors below it move none.
        "margin_us": min((line.margin(traced.launch.get(e.start, e.start)) for e in d.device
                          if port(e.name)), default=None),
        "unmatched": traced.unmatched,
        "closes": {
            "launches": [sum(v["launches"] for v in att.values()), len(d.kernels())],
            "device_us": [sum(v["device_us"] for v in att.values()),
                          sum(e.dur for e in d.device)],
            "idle_us": [sum(v["idle_us"] for v in att.values()), d.window_us - d.busy_us()],
            "port": {k: [att.get(k, {}).get("port", 0), own.get(k, 0)]
                     for k in sorted(set(own) | {n for n, v in att.items() if v["port"]})},
        },
        "timeline": line,
    }


def value(ctx, what: str, args: Sequence[str]) -> Optional[float]:
    """The span readers' value ``what`` ("host_ms", "launches",
    "device_ms", "idle_ms") of span ``".".join(args)`` a unit: 0 for a span
    that opened but had none, None for a run without program spans or a
    span that never opened."""
    p = ctx.get("program_spans")
    name = ".".join(args)
    if p is None:
        return None
    known = p["host_ms"] if what == "host_ms" else p["names"]
    return p[what].get(name, 0.0) if name in known else None


def per_layer() -> List[Dict]:
    """The span metrics, as entries of BENCHMARK.json's per_layer."""
    return json.loads((HERE / "spans_per_layer.json").read_text())


def run(cell, seed: int, seconds: float, device, recorder, make_program=None,
        log=sys.stderr) -> Dict:
    """One cell with the program's spans: set-up and a measured window as
    harness.run makes them (the recorder off), then the traced window with
    the recorder on, then the span window (TURNS times ``trace_calls``
    calls with the recorder on, in turns with as many off, no profiler).
    Returns the span metrics of the cell, the cell's own per-layer metrics
    read from the same traced window, the checks that the attribution
    closes, and the breakdown by span."""
    import torch

    from fluidbench import harness, metrics, program
    from fluidbench.traffic.generator import generate
    from fluidbench.work import kernel_pass

    seed = int(seed) % (1 << 63)
    traffic = generate(cell.mix, cell.cfg, seed)
    prog = (make_program or program.Program)(cell.cfg, cell.mix, traffic, [device])
    stride, length = prog.steps, traffic.splats.shape[0]
    state, _ = prog.call(prog.init(), 0)
    t = stride % length
    for _ in range(cell.mix["warm_calls"]):
        state, _ = prog.call(state, t)
        t = (t + stride) % length
    harness._sync([device])
    state, t, window = harness.measure(prog, state, t, seconds, [], [], [])
    per_call = stride if cell.unit == "step" else 1
    units = window.calls * per_call
    n = cell.mix["trace_calls"]
    rows: List[int] = []
    box = [state, t, 0.0]

    def call():
        rows.append(box[1])
        box[0], _ = prog.call(box[0], box[1])
        box[1] = (box[1] + stride) % length
        box[2] += prog.host_s

    recorder.enable(CAPACITY)
    traced = (profile if device.type == "cuda" else profile_cpu)(call, n)
    spans, dropped = recorder.take(), recorder.dropped()
    recorder.disable()
    traced_rows = rows[EDGE:EDGE + n]
    d = devtrace.digest(traced.events, n * per_call, cell.unit)

    # The span window: trace_calls calls with the recorder on, in turns
    # with as many with it off (on, off, off, on, ...), no profiler. Its
    # host time a unit against the off turns' is the recorder's cost on.
    host = {True: 0.0, False: 0.0}
    window_spans: List = []
    call()                  # clear of the profiler's teardown
    for on in [True, False, False, True] * (TURNS // 2):
        if on:
            recorder.enable(CAPACITY)
        box[2] = 0.0
        for _ in range(n):
            call()
        harness._sync([device])
        host[on] += box[2]
        if on:
            window_spans += recorder.take()
            dropped += recorder.dropped()
            recorder.disable()
    if dropped:
        raise RuntimeError(f"the recorder dropped {dropped} spans")

    port = lambda name: kernel_pass(name) is not None  # noqa: E731
    ps = context(d, traced, spans, window_spans, TURNS * n * per_call, port)
    item = torch.empty((), dtype=prog.config.dtype).element_size()
    ctx = {"digest": d, "shape": harness.unit_shape(cell, traced_rows, traffic, item),
           "peaks": harness.load_json(HERE / "peaks.json"),
           "spans": {"host_s": window.host_s, "units": units, "window_s": window.seconds},
           "program_spans": ps}
    read = {}
    for m in cell.per_layer + [m for m in per_layer() if cell.name in m["workloads"]]:
        v = metrics.read(m["name"], ctx)
        if v is not None:
            read[m["name"]] = v
    span_host, off_host = (1e3 * host[k] / (TURNS * n * per_call) for k in (True, False))
    window_host = 1e3 * window.host_s / units if units else float("nan")
    print(f"span window host ms a {cell.unit} {span_host!r}; the same calls with the recorder "
          f"off {off_host!r} (recorder on costs {span_host - off_host!r}); measured window "
          f"{window_host!r}", file=log)
    print(f"alignment error {ps['align_err_us']!r} us, drift {ps['drift_us']!r} us, the "
          f"program's launches {ps['margin_us']!r} us from a span's edge; launches tied by "
          f"order {ps['unmatched']}", file=log)
    closes = ps["closes"]
    dev, idle = closes["device_us"], closes["idle_us"]
    ok = (closes["launches"][0] == closes["launches"][1]
          and abs(dev[0] - dev[1]) <= 1e-3 * dev[1]
          and abs(idle[0] - idle[1]) <= 1e-3 * max(1.0, idle[1])
          and all(a == b for a, b in closes["port"].values()))
    out = {"workload": cell.name, "seed": seed, "metrics": read, "closes": ok,
           "checks": closes, "align_err_us": ps["align_err_us"], "drift_us": ps["drift_us"],
           "margin_us": ps["margin_us"],
           "unmatched": ps["unmatched"],
           "span_window_host_ms": span_host, "off_window_host_ms": off_host,
           "measured_host_ms": window_host,
           "per_span": {k: {"host_ms": ps["host_ms"].get(k), "launches": ps["launches"].get(k, 0.0),
                            "device_ms": ps["device_ms"].get(k, 0.0),
                            "idle_ms": ps["idle_ms"].get(k, 0.0)}
                        for k in ps["names"]},
           "breakdown": breakdown(d, ps["timeline"]),
           "device": program.device_name(device)}
    del state, prog, box
    program.release()
    return out
