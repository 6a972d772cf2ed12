"""The device timeline of a traced window, read from torch.profiler.

The window runs ``calls`` calls of the cell's entry between two marker
kernels (torch.cuda._sleep's), with a few traced calls on either side so
that the window keeps clear of the trace's edges. Device events between the
markers are the window's: on one stream they run in launch order. Their
names are reduced to kernel stems ("void advect_kernel<float, ...>(...)" ->
"advect_kernel"); memory copies and fills keep their kind.

Only the device is traced (with the CUDA runtime's calls, which come with
it), not PyTorch's host operators: the cells are partly bound by the host,
and recording every operator slowed a traced window by 1.5-2.3 times, which
read as idle time on the card. The idle gaps are named by the runtime call
the host was in, or else as host time outside the runtime.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Tuple

MARKER = "spin_kernel"
EDGE = 2
SCAN = 8192
OUTSIDE = "(host outside the CUDA runtime)"


@dataclasses.dataclass
class Event:
    name: str
    device: bool
    start: float   # microseconds
    dur: float


@dataclasses.dataclass
class Digest:
    """What the readers read: the window's device events and host events,
    its length, and the units (steps or ticks) it holds."""

    window_us: float
    device: List[Event]
    host: List[Event]
    units: int
    unit: str                       # "step" or "tick"
    extra: Dict = dataclasses.field(default_factory=dict)

    def kernels(self) -> List[Event]:
        return [e for e in self.device if kind(e.name) == "kernel"]

    def busy_us(self) -> float:
        """Microseconds of the window in which a kernel, copy or fill ran."""
        spans = sorted((e.start, e.start + e.dur) for e in self.device)
        busy, end = 0.0, None
        lo_w, hi_w = self.extra["lo"], self.extra["hi"]
        for a, b in spans:
            a, b = max(a, lo_w), min(b, hi_w)
            if b <= a:
                continue
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's idle intervals on the device."""
        spans = sorted((e.start, e.start + e.dur) for e in self.device)
        out, t = [], self.extra["lo"]
        for a, b in spans:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.extra["hi"] > t:
            out.append((t, self.extra["hi"]))
        return out


def stem(name: str) -> str:
    """A kernel's name without its return type, template and parameters."""
    n = name.strip().replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return re.split(r"[<(\s]", n, maxsplit=1)[0]


def kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy_dtoh" if "DtoH" in name else "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def digest(events: List[Event], units: int, unit: str) -> Digest:
    """The window between the two marker kernels. Raises unless both were
    recorded."""
    marks = sorted((e for e in events if e.device and MARKER in e.name), key=lambda e: e.start)
    if len(marks) != 2:
        raise RuntimeError(f"traced window not found: {len(marks)} marker kernels")
    lo, hi = marks[0].start + marks[0].dur, marks[1].start
    device = [Event(stem(e.name) if kind(e.name) == "kernel" else e.name, True, e.start, e.dur)
              for e in events if e.device and lo <= e.start < hi and MARKER not in e.name]
    host = [e for e in events if not e.device and e.start < hi and e.start + e.dur > lo]
    return Digest(hi - lo, device, host, units, unit, {"lo": lo, "hi": hi})


def profile(call: Callable[[], None], calls: int) -> List[Event]:
    """Every device event, and the CUDA runtime's calls, of ``calls`` calls
    of ``call`` between two markers, with EDGE calls traced on either side."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(EDGE):
            call()
        torch.cuda._sleep(1000)
        for _ in range(calls):
            call()
        torch.cuda._sleep(1000)
        for _ in range(EDGE):
            call()
        torch.cuda.synchronize()
    return [Event(e.name, e.device_type == DeviceType.CUDA, float(e.time_range.start),
                  float(e.time_range.elapsed_us())) for e in prof.events()]


def profile_cpu(call: Callable[[], None], calls: int) -> List[Event]:
    """profile's plumbing on the CPU, for rehearsals: each outermost PyTorch
    operator stands in for a device event, and the markers are host ranges.
    Gives no device number."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    with _profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(EDGE):
            call()
        with record_function(MARKER):
            pass
        for _ in range(calls):
            call()
        with record_function(MARKER):
            pass
        for _ in range(EDGE):
            call()
    out = []
    for e in prof.events():
        parent = e.cpu_parent
        outer = e.name.startswith("aten::") and (parent is None or not parent.name.startswith("aten::"))
        out.append(Event(e.name, outer or e.name == MARKER, float(e.time_range.start),
                         float(e.time_range.elapsed_us())))
    return out


def breakdown(d: Digest, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, in seconds over the window: each gap named by the
    innermost host event (a CUDA runtime call) running at its middle, or,
    where none runs, as host time outside the runtime (Python and PyTorch's
    dispatch). The search for an enclosing event looks back SCAN events,
    more than one call makes."""
    import bisect

    ops: Dict[str, float] = {}
    for e in d.device:
        ops[e.name] = ops.get(e.name, 0.0) + e.dur
    host = sorted(d.host, key=lambda e: e.start)
    starts = [e.start for e in host]
    idle: Dict[str, float] = {}
    for a, b in d.gaps():
        t = 0.5 * (a + b)
        j = k = bisect.bisect_right(starts, t) - 1
        while j >= 0 and k - j < SCAN and host[j].start + host[j].dur < t:
            j -= 1
        inside = j >= 0 and host[j].start + host[j].dur >= t
        name = host[j].name if inside else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (b - a)

    def ranked(x):
        return [[k[:120], v * 1e-6] for k, v in sorted(x.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
